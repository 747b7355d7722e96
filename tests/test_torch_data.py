"""The data layer of the PyTorch port against the JAX package's, on the CPU:
``batch_iterator`` bit for bit on the numpy and the native backend (crop,
flip, normalize, shuffle, ``drop_last`` both ways), the readers on tiny
files written here, ``synthetic_dataset``, ``train_val_split``, the
digits fallback, and the prefetch's CPU path."""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu import data as jdata
from neural_ode_metasolver_tpu.data import native as jnative
from neural_ode_metasolver_tpu_torch import data as pdata
from neural_ode_metasolver_tpu_torch.data import native as pnative
from neural_ode_metasolver_tpu_torch.data.prefetch import prefetch_to_device
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)


def _pair(shape, n=37, seed=3):
    return (jdata.synthetic_dataset(n, shape, seed=seed),
            pdata.synthetic_dataset(n, shape, seed=seed))


def test_synthetic_dataset_and_constants_equal():
    for shape in ((28, 28, 1), (32, 32, 3)):
        j, p = _pair(shape)
        np.testing.assert_array_equal(j.images, p.images)
        np.testing.assert_array_equal(j.labels, p.labels)
        assert p.images.dtype == np.float32 and p.labels.dtype == np.int32
    assert pdata.CIFAR10_MEAN == jdata.CIFAR10_MEAN
    assert pdata.CIFAR10_STD == jdata.CIFAR10_STD


def test_train_val_split_equal():
    j, p = _pair((32, 32, 3), n=50)
    for perc, seed in ((0.1, 602), (0.3, 0)):
        (jt, jv), (pt, pv) = (jdata.train_val_split(j, perc, seed=seed),
                              pdata.train_val_split(p, perc, seed=seed))
        for a, b in ((jt, pt), (jv, pv)):
            np.testing.assert_array_equal(a.images, b.images)
            np.testing.assert_array_equal(a.labels, b.labels)


# (image shape, crop padding, hflip, normalize, shuffle, drop_last)
_ITER_CASES = [
    ((28, 28, 1), 4, False, False, True, True),
    ((28, 28, 1), 0, False, False, False, False),
    ((32, 32, 3), 4, True, True, True, True),
    ((32, 32, 3), 4, True, True, True, False),
    ((32, 32, 3), 0, False, True, False, False),
]


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("case", _ITER_CASES,
                         ids=[f"case{i}" for i in range(len(_ITER_CASES))])
def test_batch_iterator_bit_equal(backend, case):
    """For the same seed the port yields the JAX package's batches bit for
    bit: the same RandomState stream (numpy) or the same C++ source and
    per-sample SplitMix64 stream (native, built here with g++)."""
    if backend == "native" and not (jnative.native_available()
                                    and pnative.native_available()):
        pytest.fail("g++ could not build the native data library")
    shape, crop, hflip, norm, shuffle, drop_last = case
    j, p = _pair(shape)
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=11,
              crop_padding=crop, hflip=hflip, backend=backend)
    if norm:
        kw.update(mean=jdata.CIFAR10_MEAN[:shape[-1]],
                  std=jdata.CIFAR10_STD[:shape[-1]])
    jb = list(jdata.batch_iterator(j, 8, **kw))
    pb = list(pdata.batch_iterator(p, 8, **kw))
    assert len(jb) == len(pb) == (4 if drop_last else 5)
    for (jx, jy), (px, py) in zip(jb, pb):
        assert px.dtype == np.float32 and px.shape == jx.shape
        np.testing.assert_array_equal(jx, px)
        np.testing.assert_array_equal(jy, py)
    if crop or hflip:  # the augmentation really moved pixels
        plain = list(pdata.batch_iterator(
            p, 8, shuffle=shuffle, drop_last=drop_last, seed=11,
            backend=backend, **{k: kw[k] for k in ("mean", "std") if k in kw}))
        assert any(not np.array_equal(a[0], b[0]) for a, b in zip(pb, plain))


def test_native_library_builds_in_the_package():
    assert pnative.native_available()
    path = pnative.library_path()
    assert os.path.dirname(path).endswith(
        os.path.join("neural_ode_metasolver_tpu_torch", "_build_out"))
    assert os.path.exists(path)
    assert pdata.data_backend("auto") == "native"
    assert pdata.data_backend("numpy") == "numpy"
    with pytest.raises(ValueError):
        pdata.data_backend("gpu")
    imgs = np.zeros((4, 8, 8, 1), np.float32)
    with pytest.raises(IndexError):
        pnative.augment_batch_native(imgs, np.array([0, 4]))
    with pytest.raises(ValueError, match="together"):
        list(pdata.batch_iterator(pdata.Dataset(imgs, np.zeros(4)), 2,
                                  mean=(0.5,)))


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_readers_equal_on_tiny_files(tmp_path):
    rs = np.random.RandomState(0)
    mroot = tmp_path / "mnist" / "MNIST" / "raw"
    mroot.mkdir(parents=True)
    for prefix, n in (("train", 6), ("t10k", 4)):
        _write_idx(str(mroot / f"{prefix}-images-idx3-ubyte.gz"),
                   rs.randint(0, 256, (n, 28, 28)))
        _write_idx(str(mroot / f"{prefix}-labels-idx1-ubyte.gz"),
                   rs.randint(0, 10, n))
    croot = tmp_path / "cifar" / "cifar-10-batches-py"
    croot.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(croot / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (3, 3072)).astype(
                np.uint8), b"labels": list(rs.randint(0, 10, 3))}, f)
    sroot = tmp_path / "svhn"
    sroot.mkdir()
    from scipy.io import savemat

    for split in ("train", "test"):
        savemat(str(sroot / f"{split}_32x32.mat"),
                {"X": rs.randint(0, 256, (32, 32, 3, 5)).astype(np.uint8),
                 "y": rs.randint(1, 11, (5, 1))})
    pairs = [
        (jdata.load_mnist(str(tmp_path / "mnist"), train=t),
         pdata.load_mnist(str(tmp_path / "mnist"), train=t))
        for t in (True, False)
    ] + [
        (jdata.load_cifar10(str(tmp_path / "cifar"), train=t),
         pdata.load_cifar10(str(tmp_path / "cifar"), train=t))
        for t in (True, False)
    ] + [
        (jdata.load_svhn(str(sroot), split=s), pdata.load_svhn(str(sroot),
                                                               split=s))
        for s in ("train", "test")
    ]
    sizes = []
    for j, p in pairs:
        np.testing.assert_array_equal(j.images, p.images)
        np.testing.assert_array_equal(j.labels, p.labels)
        sizes.append((len(p),) + p.images.shape[1:])
    assert sizes == [(6, 28, 28, 1), (4, 28, 28, 1), (15, 32, 32, 3),
                     (3, 32, 32, 3), (5, 32, 32, 3), (5, 32, 32, 3)]
    assert set(np.unique(pairs[-1][1].labels)) <= set(range(10))
    with pytest.raises(FileNotFoundError):
        pdata.load_mnist(str(tmp_path))


def test_digits_fallback_and_inf_generator_equal():
    (jtr, jte), (ptr, pte) = (jdata.load_digits_dataset(seed=3),
                              pdata.load_digits_dataset(seed=3))
    for a, b in ((jtr, ptr), (jte, pte)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert pte.images.shape[1:] == (28, 28, 1) and len(pte) == 359
    _, p = _pair((28, 28, 1), n=10)
    it = pdata.inf_generator(lambda e: pdata.batch_iterator(p, 4, seed=e))
    got = [next(it)[1] for _ in range(5)]  # 2 batches an epoch, restarts
    np.testing.assert_array_equal(
        got[2], next(iter(pdata.batch_iterator(p, 4, seed=1)))[1])
    empty = pdata.inf_generator(lambda e: pdata.batch_iterator(p, 32))
    with pytest.raises(ValueError, match="no batches"):
        next(empty)


@pytest.mark.parametrize("thread", [False, True])
def test_prefetch_cpu_path_yields_the_batches_as_tensors(thread):
    _, p = _pair((28, 28, 1), n=20)
    want = list(pdata.batch_iterator(p, 4, seed=2))
    got = list(prefetch_to_device(pdata.batch_iterator(p, 4, seed=2),
                                  size=2, device="cpu", thread=thread))
    assert len(got) == len(want) == 5
    for (wx, wy), (gx, gy) in zip(want, got):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(wx, gx.numpy())
        np.testing.assert_array_equal(wy, gy.numpy())
    with pytest.raises(ValueError):
        prefetch_to_device(iter([]), size=0, device="cpu")

    def broken():
        yield want[0]
        raise KeyError("producer failed")

    with pytest.raises(KeyError):  # the producer's error reaches the consumer
        list(prefetch_to_device(broken(), size=2, device="cpu",
                                thread=thread))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prefetch_to_device(iter(want), size=2)
