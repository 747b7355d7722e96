"""Input pipelines: MNIST / CIFAR-10 / SVHN from disk, synthetic fallback
(port of data/datasets.py, plain numpy, kept as the port's own copy).

NHWC float32 batches, as the JAX package's:

  * MNIST/SVHN parity: ToTensor() scaling to [0,1]; optional
    RandomCrop(28, p=4) train augmentation (odenet_mnist/data.py:7-19).
  * CIFAR-10 parity: RandomCrop(32, p=4) + RandomHorizontalFlip + Normalize
    with the canonical mean/std (odenet_cifar10/data.py:40-57); train/val
    split by shuffled-index percentage (:62-72); drop_last batching.
  * Readers for the standard on-disk formats (IDX for MNIST, the python
    pickle batches for CIFAR-10, the .mat files of SVHN); without a
    ``data_root`` the runners use ``synthetic_dataset`` (class-conditional
    Gaussian blobs) or scikit-learn's bundled digits.  Nothing is
    downloaded.

For the same seed, ``batch_iterator`` yields the JAX package's batches bit
for bit on either backend: the same numpy ``RandomState`` stream, and the
same C++ source (``native/nodems_data.cc``, built by ``data/native.py``).
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct as pystruct
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "load_mnist",
    "load_cifar10",
    "load_svhn",
    "load_digits_dataset",
    "synthetic_dataset",
    "Dataset",
    "batch_iterator",
    "inf_generator",
    "augment_batch",
    "normalize_images",
    "train_val_split",
    "data_backend",
]

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)


class Dataset:
    """A simple in-memory dataset of NHWC images + integer labels."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        assert images.ndim == 4 and images.shape[0] == labels.shape[0]
        self.images = images.astype(np.float32)
        self.labels = labels.astype(np.int32)

    def __len__(self):
        return self.images.shape[0]


# ------------------------------------------------------------- readers ----


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = pystruct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = pystruct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_mnist(data_root: str, train: bool = True) -> Dataset:
    """Read raw IDX MNIST files (accepts .gz or uncompressed)."""
    prefix = "train" if train else "t10k"
    candidates = [data_root, os.path.join(data_root, "MNIST", "raw")]
    for root in candidates:
        img = os.path.join(root, f"{prefix}-images-idx3-ubyte")
        lbl = os.path.join(root, f"{prefix}-labels-idx1-ubyte")
        for ext in ("", ".gz"):
            if os.path.exists(img + ext) and os.path.exists(lbl + ext):
                images = _read_idx(img + ext).astype(np.float32) / 255.0
                labels = _read_idx(lbl + ext)
                return Dataset(images[..., None], labels)
    raise FileNotFoundError(f"MNIST IDX files not found under {data_root}")


def load_cifar10(data_root: str, train: bool = True) -> Dataset:
    """Read the standard cifar-10-batches-py pickles."""
    base = os.path.join(data_root, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = data_root
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    )
    xs, ys = [], []
    for name in files:
        path = os.path.join(base, name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[b"labels"]))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return Dataset(x.astype(np.float32) / 255.0, np.concatenate(ys))


def load_svhn(data_root: str, split: str = "train") -> Dataset:
    """Read the standard SVHN cropped-digit .mat files
    (reference get_svhn_loaders, odenet_mnist/data.py:39-69)."""
    from scipy.io import loadmat

    path = os.path.join(data_root, f"{split}_32x32.mat")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    mat = loadmat(path)
    x = mat["X"].transpose(3, 0, 1, 2).astype(np.float32) / 255.0  # HWCN->NHWC
    y = mat["y"].reshape(-1).astype(np.int32)
    y[y == 10] = 0  # SVHN labels digits 1..10 with '0' stored as 10
    return Dataset(x, y)


def load_digits_dataset(upscale: int = 28, test_frac: float = 0.2,
                        seed: int = 0):
    """Real handwritten digits without network access: scikit-learn's bundled
    UCI digits (1797 8x8 grayscale images), bilinearly upscaled to the MNIST
    geometry.  Returns (train Dataset, test Dataset).  Used as the offline
    stand-in for MNIST in golden end-to-end learning tests."""
    from scipy.ndimage import zoom
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = d.images.astype(np.float32) / 16.0
    factor = upscale / imgs.shape[1]
    imgs = zoom(imgs, (1, factor, factor), order=1)[..., None]
    imgs = np.clip(imgs, 0.0, 1.0)
    labels = d.target.astype(np.int32)
    idx = np.random.RandomState(seed).permutation(len(labels))
    n_test = int(len(labels) * test_frac)
    test_idx, train_idx = idx[:n_test], idx[n_test:]
    return (
        Dataset(imgs[train_idx], labels[train_idx]),
        Dataset(imgs[test_idx], labels[test_idx]),
    )


def synthetic_dataset(
    n: int,
    image_shape: Tuple[int, int, int],
    num_classes: int = 10,
    seed: int = 0,
    noise: float = 0.35,
    template_seed: int = 1234,
) -> Dataset:
    """Class-conditional smooth Gaussian blobs in [0, 1] — learnable by small
    conv nets, used when no real dataset is on disk.

    ``template_seed`` fixes the class definitions independently of ``seed``
    (the sample draw), so differently-seeded datasets share label semantics
    (train/test splits of the same synthetic task).
    """
    rs = np.random.RandomState(seed)
    rs_t = np.random.RandomState(template_seed)
    h, w, c = image_shape
    labels = rs.randint(0, num_classes, size=n)
    # per-class low-frequency template
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    templates = []
    for k in range(num_classes):
        cx, cy = rs_t.uniform(0.2, 0.8, 2)
        fx, fy = rs_t.uniform(1.0, 3.0, 2)
        t = 0.5 + 0.5 * np.sin(
            fx * 2 * np.pi * (xx / w - cx) + fy * 2 * np.pi * (yy / h - cy)
        )
        templates.append(np.repeat(t[..., None], c, axis=-1))
    templates = np.stack(templates)
    images = templates[labels] + noise * rs.randn(n, h, w, c).astype(
        np.float32
    )
    return Dataset(np.clip(images, 0.0, 1.0), labels)


# ------------------------------------------------------ transforms/split ---


def augment_batch(
    rs: np.random.RandomState,
    x: np.ndarray,
    crop_padding: int = 0,
    hflip: bool = False,
) -> np.ndarray:
    """torchvision-parity RandomCrop(size, padding) + RandomHorizontalFlip."""
    n, h, w, c = x.shape
    if crop_padding > 0:
        p = crop_padding
        xp = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
        out = np.empty_like(x)
        tops = rs.randint(0, 2 * p + 1, size=n)
        lefts = rs.randint(0, 2 * p + 1, size=n)
        for i in range(n):
            out[i] = xp[i, tops[i] : tops[i] + h, lefts[i] : lefts[i] + w]
        x = out
    if hflip:
        flips = rs.rand(n) < 0.5
        x = np.where(flips[:, None, None, None], x[:, :, ::-1, :], x)
    return x


def normalize_images(x: np.ndarray, mean, std) -> np.ndarray:
    m = np.asarray(mean, np.float32).reshape(1, 1, 1, -1)
    s = np.asarray(std, np.float32).reshape(1, 1, 1, -1)
    return (x - m) / s


def train_val_split(
    ds: Dataset, val_perc: float, seed: Optional[int] = None,
    shuffle: bool = True,
) -> Tuple[Dataset, Dataset]:
    """Shuffled-index split (odenet_cifar10/data.py:62-72 semantics)."""
    n = len(ds)
    idx = np.arange(n)
    split = int(np.floor(val_perc * n))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    train_idx, val_idx = idx[split:], idx[:split]
    return (
        Dataset(ds.images[train_idx], ds.labels[train_idx]),
        Dataset(ds.images[val_idx], ds.labels[val_idx]),
    )


# ------------------------------------------------------------ batching ----


def data_backend(backend: str = "auto") -> str:
    """The augmentation path ``batch_iterator(backend=...)`` takes:
    'native' where the C++ library builds and loads ('auto' or 'native'),
    else 'numpy'; ``backend="native"`` without it raises."""
    if backend not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown data backend {backend!r}")
    if backend == "numpy":
        return "numpy"
    from .native import native_available

    if native_available():
        return "native"
    if backend == "native":
        raise RuntimeError("native data pipeline unavailable")
    return "numpy"


def batch_iterator(
    ds: Dataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    crop_padding: int = 0,
    hflip: bool = False,
    mean=None,
    std=None,
    backend: str = "auto",
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of (x, y) NHWC float32 batches (drop_last parity with the
    reference loaders).

    ``backend``: 'auto' uses the multithreaded C++ pipeline
    (data/native.py) when it is built/buildable, else NumPy; 'numpy' /
    'native' force a path (``data_backend`` says which one runs).  The two
    paths implement identical transforms with independent deterministic RNG
    streams.
    """
    if (mean is None) != (std is None):
        # without it the NumPy path would divide by np.asarray(None) == nan
        raise ValueError("mean and std must be given together")
    use_native = data_backend(backend) == "native"
    if use_native:
        from .native import augment_batch_native

    rs = np.random.RandomState(seed)
    idx = np.arange(len(ds))
    if shuffle:
        rs.shuffle(idx)
    n_batches = (
        len(ds) // batch_size if drop_last else -(-len(ds) // batch_size)
    )
    for b in range(n_batches):
        sel = idx[b * batch_size : (b + 1) * batch_size]
        if use_native:
            x = augment_batch_native(
                ds.images, sel, crop_padding=crop_padding, hflip=hflip,
                mean=mean, std=std, seed=(seed * 100003 + b),
            )
        else:
            x = ds.images[sel]
            if crop_padding or hflip:
                x = augment_batch(rs, x, crop_padding, hflip)
            if mean is not None:
                x = normalize_images(x, mean, std)
        yield x, ds.labels[sel]


def inf_generator(make_iter):
    """Infinite restarting iterator (odenet_mnist/data.py:72-81).

    ``make_iter``: zero-arg callable returning a fresh epoch iterator.
    Raises if an epoch yields no batches (e.g. batch_size > dataset size
    with drop_last) — the alternative is an infinite busy-loop.
    """
    epoch = 0
    while True:
        yielded = False
        for batch in make_iter(epoch):
            yielded = True
            yield batch
        if not yielded:
            raise ValueError(
                "epoch iterator produced no batches (batch_size larger "
                "than the dataset with drop_last?)"
            )
        epoch += 1
