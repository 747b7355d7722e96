"""The port's dataset fetcher (``data/download.py``, its own copy of the
JAX module) with the cases of ``tests/test_download.py``, and the runners'
``--download`` fed from ``file://`` mirrors built in the test.  Nothing is
fetched from outside."""
import gzip
import hashlib
import io
import json
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.data import download as jdl
from neural_ode_metasolver_tpu_torch.data import load_cifar10, load_mnist
from neural_ode_metasolver_tpu_torch.data import download as dl
from neural_ode_metasolver_tpu_torch.data.download import (
    DATASETS,
    RemoteFile,
    _extract_cifar,
    _fetch,
    dataset_present,
    download_dataset,
    ensure_dataset,
    main,
    verify_md5,
)
from neural_ode_metasolver_tpu_torch.runners import cifar_runner, mnist_runner

torch.set_num_threads(1)

CIFAR_BATCHES = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]


def _md5(b: bytes) -> str:
    return hashlib.md5(b).hexdigest()


def test_sources_and_checksums_are_jax_s():
    assert DATASETS == jdl.DATASETS
    assert tuple(dl.SVHN_EXTRA) == tuple(jdl.SVHN_EXTRA)


def test_verify_md5(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello")
    assert verify_md5(str(p), _md5(b"hello"))
    assert not verify_md5(str(p), _md5(b"other"))
    assert not verify_md5(str(tmp_path / "missing"), _md5(b"hello"))


def test_fetch_from_file_url_and_skip_if_present(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"payload")
    rf = RemoteFile((src.as_uri(),), _md5(b"payload"), "dest.bin")
    root = tmp_path / "root"
    dest = _fetch(rf, str(root), quiet=True)
    assert open(dest, "rb").read() == b"payload"
    src.unlink()  # a second call short-circuits on the verified file
    assert _fetch(rf, str(root), quiet=True) == dest


def test_fetch_checksum_mismatch_and_offline_error(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"tampered")
    rf = RemoteFile((src.as_uri(),), _md5(b"expected"), "dest.bin")
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        _fetch(rf, str(tmp_path / "root"), quiet=True)
    assert not os.path.exists(tmp_path / "root" / "dest.bin.part")
    rf2 = RemoteFile(((tmp_path / "gone.bin").as_uri(),), _md5(b"x"),
                     "d.bin")
    with pytest.raises(RuntimeError, match="Provision it manually"):
        _fetch(rf2, str(tmp_path / "root"), quiet=True)


def test_fetch_uses_socket_timeout(tmp_path, monkeypatch):
    seen = {}

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self, n):
            return b""

    def fake_urlopen(url, timeout=None):
        seen["timeout"] = timeout
        return _Resp()

    monkeypatch.setattr(dl.urllib.request, "urlopen", fake_urlopen)
    rf = RemoteFile(("http://example.invalid/f",), _md5(b""), "f.bin")
    _fetch(rf, str(tmp_path), quiet=True)
    assert seen["timeout"] is not None and seen["timeout"] > 0


def _cifar_archive(tmp_path, n=2):
    """cifar-10-python.tar.gz with n-image batches in the real schema."""
    buf = io.BytesIO()
    rs = np.random.RandomState(0)
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name in CIFAR_BATCHES:
            data = pickle.dumps({
                b"data": rs.randint(0, 256, (n, 3072)).astype(np.uint8),
                b"labels": [int(v) for v in rs.randint(0, 10, n)],
            })
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    raw = buf.getvalue()
    p = tmp_path / "cifar-10-python.tar.gz"
    p.write_bytes(raw)
    return p, _md5(raw)


def test_cifar_download_extract_read_roundtrip(tmp_path, monkeypatch):
    archive, md5 = _cifar_archive(tmp_path)
    monkeypatch.setitem(
        DATASETS, "cifar10",
        [RemoteFile((archive.as_uri(),), md5, "cifar-10-python.tar.gz")])
    root = tmp_path / "root"
    download_dataset("cifar10", str(root), quiet=True)
    ds = load_cifar10(str(root), train=True)
    assert len(ds) == 10 and ds.images.shape == (10, 32, 32, 3)
    archive.unlink()  # idempotent with the mirror gone
    download_dataset("cifar10", str(root), quiet=True)


def _idx_gz(dims, values):
    magic = struct.pack(">I", (0x08 << 8) | len(dims))
    body = magic + b"".join(struct.pack(">I", d) for d in dims)
    return gzip.compress(body + np.asarray(values, np.uint8).tobytes())


def _mnist_mirror(tmp_path, n_train, n_test):
    rs = np.random.RandomState(1)
    files = {
        "train-images-idx3-ubyte.gz": _idx_gz(
            (n_train, 28, 28), rs.randint(0, 256, n_train * 784)),
        "train-labels-idx1-ubyte.gz": _idx_gz(
            (n_train,), rs.randint(0, 10, n_train)),
        "t10k-images-idx3-ubyte.gz": _idx_gz(
            (n_test, 28, 28), rs.randint(0, 256, n_test * 784)),
        "t10k-labels-idx1-ubyte.gz": _idx_gz(
            (n_test,), rs.randint(0, 10, n_test)),
    }
    remotes = []
    for name, raw in files.items():
        p = tmp_path / ("mirror_" + name)
        p.write_bytes(raw)
        remotes.append(RemoteFile((p.as_uri(),), _md5(raw), name))
    return remotes


def test_mnist_download_feeds_reader(tmp_path, monkeypatch):
    monkeypatch.setitem(DATASETS, "mnist", _mnist_mirror(tmp_path, 2, 3))
    root = tmp_path / "root"
    assert len(download_dataset("mnist", str(root), quiet=True)) == 4
    assert load_mnist(str(root), train=True).images.shape == (2, 28, 28, 1)
    assert len(load_mnist(str(root), train=False)) == 3


def test_unknown_dataset_and_ensure_fallback(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="unknown dataset"):
        download_dataset("imagenet", str(tmp_path))
    bad = RemoteFile(((tmp_path / "none").as_uri(),), "0" * 32, "x.bin")
    monkeypatch.setitem(DATASETS, "mnist", [bad])
    assert ensure_dataset("mnist", str(tmp_path / "r")) is None
    assert ensure_dataset("imagenet", str(tmp_path / "r")) is None


def test_extract_guards_path_traversal(tmp_path):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        data = b"evil"
        info = tarfile.TarInfo("../../cifar-10-batches-py/data_batch_1")
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    p = tmp_path / "evil.tar.gz"
    p.write_bytes(buf.getvalue())
    root = tmp_path / "root"
    with pytest.raises(RuntimeError, match="missing"):
        _extract_cifar(str(p), str(root), quiet=True)
    assert os.listdir(root / "cifar-10-batches-py") == []
    assert not (tmp_path.parent / "cifar-10-batches-py").exists()


def test_dataset_present_short_circuits_fetch(tmp_path, monkeypatch):
    root = tmp_path / "root"
    base = root / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for n in CIFAR_BATCHES:
        (base / n).write_bytes(b"x")
    assert dataset_present("cifar10", str(root))
    monkeypatch.setitem(DATASETS, "cifar10", [
        RemoteFile(((tmp_path / "gone").as_uri(),), "0" * 32, "x.tar.gz")])
    assert download_dataset("cifar10", str(root), quiet=True) == []
    for p in ("train", "t10k"):
        (root / f"{p}-images-idx3-ubyte").write_bytes(b"x")
        (root / f"{p}-labels-idx1-ubyte").write_bytes(b"x")
    assert dataset_present("mnist", str(root))
    assert not dataset_present("svhn", str(root))
    raw = tmp_path / "tv" / "MNIST" / "raw"
    raw.mkdir(parents=True)
    for p in ("train", "t10k"):
        (raw / f"{p}-images-idx3-ubyte.gz").write_bytes(b"x")
        (raw / f"{p}-labels-idx1-ubyte.gz").write_bytes(b"x")
    assert dataset_present("mnist", str(tmp_path / "tv"))


def test_cli_fetches_into_root(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(DATASETS, "mnist", _mnist_mirror(tmp_path, 2, 2))
    assert main(["mnist", "--root", str(tmp_path / "d"), "-q"]) == 0
    assert dataset_present("mnist", str(tmp_path / "d"))
    assert capsys.readouterr().out == ""


def _epoch_lines(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(l) for l in f if '"epoch"' in l]


def _steps(save_dir):
    """The epochs logged and the last step: a run on the fetched images
    takes len(train) // batch steps an epoch."""
    lines = _epoch_lines(save_dir)
    return {l["epoch"] for l in lines}, max(l["step"] for l in lines)


def test_mnist_runner_download_from_a_file_mirror(tmp_path, monkeypatch):
    """--download fetches into --data_root and trains on what it fetched;
    with no reachable mirror it logs the failure and falls back to the
    synthetic data, as the JAX runner does."""
    monkeypatch.setitem(DATASETS, "mnist", _mnist_mirror(tmp_path, 32, 16))
    root = tmp_path / "data"
    argv = ["--device", "cpu", "--solvers", "rk2,u,1,-1,0.5,-1",
            "--nepochs", "1", "--batch_size", "16", "--optim", "sgd",
            "--lr", "0.01", "--download"]
    mnist_runner.main(argv + ["--data_root", str(root),
                              "--save_dir", str(tmp_path / "run")])
    assert dataset_present("mnist", str(root))
    assert _steps(str(tmp_path / "run")) == ({0}, 32 // 16)
    log = open(tmp_path / "run" / "logs").read()
    assert "falling back" not in log

    monkeypatch.setitem(DATASETS, "mnist", [RemoteFile(
        ((tmp_path / "gone").as_uri(),), "0" * 32, "x.gz")])
    (tmp_path / "cwd").mkdir()
    monkeypatch.chdir(tmp_path / "cwd")  # the default root data/ is empty
    mnist_runner.main(argv + ["--synthetic_train_size", "32",
                              "--synthetic_test_size", "16",
                              "--save_dir", str(tmp_path / "run2")])
    assert "falling back to synthetic" in open(
        tmp_path / "run2" / "logs").read()


def test_cifar_runner_download_from_a_file_mirror(tmp_path, monkeypatch):
    archive, md5 = _cifar_archive(tmp_path, n=8)
    monkeypatch.setitem(
        DATASETS, "cifar10",
        [RemoteFile((archive.as_uri(),), md5, "cifar-10-python.tar.gz")])
    root = tmp_path / "data"
    cifar_runner.main([
        "--device", "cpu", "--in_planes", "8", "--solvers",
        "rk2,u,1,-1,0.5,-1", "--nepochs", "1", "--batch_size", "16",
        "--download", "--data_root", str(root),
        "--save_dir", str(tmp_path / "run")])
    assert dataset_present("cifar10", str(root))
    epochs, _ = _steps(str(tmp_path / "run"))
    assert epochs == {0}
    assert "falling back" not in open(tmp_path / "run" / "logs").read()
