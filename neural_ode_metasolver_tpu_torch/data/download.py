"""Dataset fetcher (port of data/download.py, stdlib only, kept as the
port's own copy): place MNIST / CIFAR-10 / SVHN where the readers expect.

The reference delegates downloading to torchvision
(``datasets.MNIST(..., download=True)``, odenet_mnist/data.py:23-33;
``datasets.CIFAR10(..., download=True)``, odenet_cifar10/data.py:45-60).
The port's readers (``datasets.load_mnist`` / ``load_cifar10`` /
``load_svhn``) take the same on-disk artifacts (raw IDX files, the
``cifar-10-batches-py`` pickle directory, the ``*_32x32.mat`` files), so
this module fetches those artifacts from the canonical (torchvision)
sources, verifies the published MD5 checksums, and unpacks them into the
layout the readers probe.

Everything is stdlib (urllib/hashlib/tarfile) and optional: where no
mirror is reachable it raises a clear error listing the files to
provision by hand, and files already present and verified are never
fetched again (so pre-seeded data roots work offline).  The runners'
``--download`` calls ``ensure_dataset`` and falls back to their offline
datasets when it fails.

CLI::

    python -m neural_ode_metasolver_tpu_torch.data.download mnist --root data
    python -m neural_ode_metasolver_tpu_torch.data.download cifar10 svhn --root data
"""
from __future__ import annotations

import argparse
import hashlib
import os
import tarfile
import urllib.error
import urllib.request
from typing import Iterable, List, NamedTuple, Optional, Sequence

__all__ = ["download_dataset", "dataset_present", "ensure_dataset",
           "verify_md5", "DATASETS"]


class RemoteFile(NamedTuple):
    urls: tuple  # mirrors, tried in order
    md5: str
    relpath: str  # destination path relative to the data root


# Checksums are the ones torchvision publishes for these artifacts.
_MNIST_MIRRORS = (
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "http://yann.lecun.com/exdb/mnist/",
)


def _mnist_file(name: str, md5: str) -> RemoteFile:
    return RemoteFile(tuple(m + name for m in _MNIST_MIRRORS), md5, name)


DATASETS = {
    # load_mnist probes <root>/<prefix>-{images,labels}-idx?-ubyte[.gz]
    "mnist": [
        _mnist_file("train-images-idx3-ubyte.gz",
                    "f68b3c2dcbeaaa9fbdd348bbdeb94873"),
        _mnist_file("train-labels-idx1-ubyte.gz",
                    "d53e105ee54ea40749a09fcbcd1e9432"),
        _mnist_file("t10k-images-idx3-ubyte.gz",
                    "9fb629c4189551a2d022fa330f9573f3"),
        _mnist_file("t10k-labels-idx1-ubyte.gz",
                    "ec29112dd5afa0611ce80d1b7f02629c"),
    ],
    # load_cifar10 probes <root>/cifar-10-batches-py/{data_batch_*,test_batch}
    "cifar10": [
        RemoteFile(
            ("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",),
            "c58f30108f718f92721af3b95e74349a",
            "cifar-10-python.tar.gz",
        ),
    ],
    # load_svhn probes <root>/{train,test,extra}_32x32.mat
    "svhn": [
        RemoteFile(
            ("http://ufldl.stanford.edu/housenumbers/train_32x32.mat",),
            "e26dedcc434d2e4c54c9b2d4a06d8373",
            "train_32x32.mat",
        ),
        RemoteFile(
            ("http://ufldl.stanford.edu/housenumbers/test_32x32.mat",),
            "eb5a983be6a315427106f1b164d9cef3",
            "test_32x32.mat",
        ),
    ],
}

# Optional extras, fetched only on request (svhn 'extra' is 1.3 GB).
SVHN_EXTRA = RemoteFile(
    ("http://ufldl.stanford.edu/housenumbers/extra_32x32.mat",),
    "a93ce644f1a588dc4d68dda5feec44a7",
    "extra_32x32.mat",
)


def verify_md5(path: str, md5: str, chunk: int = 1 << 20) -> bool:
    """True iff ``path`` exists and hashes to ``md5``."""
    if not os.path.exists(path):
        return False
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest() == md5


def _fetch(
    remote: RemoteFile, root: str, quiet: bool = False, timeout: float = 30.0
) -> str:
    dest = os.path.join(root, remote.relpath)
    if verify_md5(dest, remote.md5):
        if not quiet:
            print(f"  {remote.relpath}: present, checksum OK")
        return dest
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    errors: List[str] = []
    for url in remote.urls:
        try:
            if not quiet:
                print(f"  fetching {url}")
            tmp = dest + ".part"
            # urlopen with an explicit socket timeout: a firewalled /
            # blackholed environment fails in seconds per mirror instead
            # of hanging in connect (urlretrieve accepts no timeout)
            try:
                with urllib.request.urlopen(url, timeout=timeout) as r, \
                        open(tmp, "wb") as f:
                    while True:
                        block = r.read(1 << 20)
                        if not block:
                            break
                        f.write(block)
                if not verify_md5(tmp, remote.md5):
                    errors.append(f"{url}: checksum mismatch")
                    continue
                os.replace(tmp, dest)
                return dest
            finally:
                # never leave a partial .part behind (mid-download error
                # or checksum mismatch); os.replace already moved it on
                # the success path
                if os.path.exists(tmp):
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
        except (urllib.error.URLError, OSError, ValueError) as e:
            errors.append(f"{url}: {e}")
    raise RuntimeError(
        f"could not fetch {remote.relpath} (no egress?). Tried:\n  "
        + "\n  ".join(errors)
        + f"\nProvision it manually at {dest} "
        f"(md5 {remote.md5}) and re-run."
    )


def _extract_cifar(archive: str, root: str, quiet: bool = False) -> None:
    """Unpack cifar-10-python.tar.gz -> <root>/cifar-10-batches-py/."""
    batch_dir = os.path.join(root, "cifar-10-batches-py")
    wanted = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    if all(os.path.exists(os.path.join(batch_dir, n)) for n in wanted):
        if not quiet:
            print("  cifar-10-batches-py: already extracted")
        return
    with tarfile.open(archive, "r:gz") as tf:
        members = [
            m for m in tf.getmembers()
            # only the plain batch files, placed under root (guards against
            # path traversal in a tampered archive)
            if m.isfile()
            and os.path.basename(m.name) in wanted + ["batches.meta"]
            and ".." not in m.name and not m.name.startswith("/")
        ]
        os.makedirs(batch_dir, exist_ok=True)
        for m in members:
            out = os.path.join(batch_dir, os.path.basename(m.name))
            src = tf.extractfile(m)
            assert src is not None
            with open(out, "wb") as f:
                f.write(src.read())
    missing = [n for n in wanted
               if not os.path.exists(os.path.join(batch_dir, n))]
    if missing:
        raise RuntimeError(
            f"{archive} did not contain the expected CIFAR batch files "
            f"(missing: {', '.join(missing)}) — corrupt or truncated "
            "archive?"
        )
    if not quiet:
        print(f"  extracted {len(members)} members -> {batch_dir}")


def dataset_present(name: str, root: str) -> bool:
    """True iff the *reader-level* artifacts already exist under ``root``
    (the same layouts ``load_mnist`` / ``load_cifar10`` / ``load_svhn``
    probe) — e.g. pre-extracted batches or uncompressed IDX files that
    have no source archive to checksum."""
    if name == "mnist":
        def pair(base, prefix):
            return any(
                os.path.exists(os.path.join(
                    base, f"{prefix}-images-idx3-ubyte{ext}"))
                and os.path.exists(os.path.join(
                    base, f"{prefix}-labels-idx1-ubyte{ext}"))
                for ext in ("", ".gz")
            )

        # both layouts load_mnist probes: flat, and torchvision MNIST/raw
        return any(
            pair(base, "train") and pair(base, "t10k")
            for base in (root, os.path.join(root, "MNIST", "raw"))
        )
    if name == "cifar10":
        base = os.path.join(root, "cifar-10-batches-py")
        wanted = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
        return all(os.path.exists(os.path.join(base, n)) for n in wanted)
    if name == "svhn":
        return all(
            os.path.exists(os.path.join(root, f"{s}_32x32.mat"))
            for s in ("train", "test")
        )
    return False


def download_dataset(
    name: str,
    root: str = "data",
    svhn_extra: bool = False,
    quiet: bool = False,
) -> List[str]:
    """Fetch + verify + unpack one dataset into ``root``.

    Returns the list of verified artifact paths. Raises ``ValueError`` for
    an unknown dataset and ``RuntimeError`` when fetching fails (offline).
    Safe to re-run: verified files are skipped, and a root that already
    holds the reader-level artifacts (even without the source archives)
    is accepted as-is.
    """
    if name not in DATASETS:
        raise ValueError(
            f"unknown dataset {name!r}; choose from {sorted(DATASETS)}"
        )
    if dataset_present(name, root) and not (name == "svhn" and svhn_extra):
        if not quiet:
            print(f"{name}: reader artifacts already present under {root}")
        return []
    files: List[RemoteFile] = list(DATASETS[name])
    if name == "svhn" and svhn_extra:
        files.append(SVHN_EXTRA)
    if not quiet:
        print(f"{name} -> {root}")
    paths = [_fetch(f, root, quiet=quiet) for f in files]
    if name == "cifar10":
        _extract_cifar(paths[0], root, quiet=quiet)
    return paths


def ensure_dataset(name: str, root: Optional[str]) -> Optional[str]:
    """Best-effort hook for runners' ``--download``: fetch ``name`` into
    ``root`` (default ``data/``), returning the root on success or ``None``
    if fetching failed (caller falls back to its offline datasets)."""
    root = root or "data"
    try:
        download_dataset(name, root)
        return root
    except (RuntimeError, ValueError) as e:
        print(f"dataset download failed: {e}")
        return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Fetch MNIST/CIFAR-10/SVHN into the layout "
                    "load_mnist/load_cifar10/load_svhn expect.")
    p.add_argument("datasets", nargs="+", choices=sorted(DATASETS))
    p.add_argument("--root", default="data")
    p.add_argument("--svhn_extra", action="store_true",
                   help="also fetch SVHN's 1.3 GB extra split")
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    for name in args.datasets:
        download_dataset(name, args.root, svhn_extra=args.svhn_extra,
                         quiet=args.quiet)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
