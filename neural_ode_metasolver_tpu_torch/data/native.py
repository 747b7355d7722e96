"""ctypes binding to the native (C++) input-pipeline kernels (port of
data/native.py).

``native/nodems_data.cc`` implements the per-batch hot loop (index gather +
RandomCrop(pad) + RandomHorizontalFlip + Normalize) as a multithreaded C++
kernel.  This module compiles that source with ``g++`` at first use into the
package's ``_build_out/`` (named by a hash of the source, the flags and the
host's CPU model, since ``-march=native`` ties the library to it; the
repo's ``native/`` is only read), loads it with ctypes and exposes the
augmented-batch function.  The source, flags and per-sample SplitMix64
stream keyed by ``seed * 100003 + batch`` are the JAX package's, so its
batches are equal bit for bit to the JAX package's native batches.  Where
``g++`` or the library is missing, ``native_available()`` is False and
``batch_iterator(backend="auto")`` takes the numpy path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["native_available", "augment_batch_native", "library_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "nodems_data.cc")
_BUILD_DIR = os.path.join(_PKG, "_build_out")
_FLAGS = ["-O3", "-march=native", "-Wall", "-fPIC", "-shared", "-pthread"]
_ABI = 1

_lib = None
_lock = threading.Lock()
_build_failed = False


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` ties a library to it,
    so a copy of the package on another host builds its own."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Optional[str]:
    """Where the library for the current source, flags and host CPU lives
    (None without the source)."""
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(
                _FLAGS + [_cpu_model()]).encode())
    except OSError:
        return None
    return os.path.join(_BUILD_DIR,
                        f"libnodems_data-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile to a temp name, then rename: concurrent processes may race
    on ``path``, and a half-written library must never load."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if path is None or (not os.path.exists(path) and not _build(path)):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.nodems_abi_version.argtypes = []
            lib.nodems_abi_version.restype = ctypes.c_int
            ok = lib.nodems_abi_version() == _ABI
        except (OSError, AttributeError):
            ok = False
        if not ok:
            _build_failed = True
            return None
        lib.nodems_augment_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.nodems_augment_batch.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def augment_batch_native(
    images: np.ndarray,
    indices: np.ndarray,
    *,
    crop_padding: int = 0,
    hflip: bool = False,
    mean=None,
    std=None,
    seed: int = 0,
    num_threads: int = 0,
) -> np.ndarray:
    """Gather ``images[indices]`` with augmentation+normalization, natively."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native pipeline unavailable (g++ build failed)")
    if (mean is None) != (std is None):
        raise ValueError("mean and std must be given together")
    images = np.ascontiguousarray(images, np.float32)
    idx = np.ascontiguousarray(indices, np.int64)
    n, h, w, c = images.shape
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        # the C++ kernel does raw pointer arithmetic
        raise IndexError(
            f"indices out of range [0, {n}): "
            f"[{int(idx.min())}, {int(idx.max())}]"
        )
    out = np.empty((idx.shape[0], h, w, c), np.float32)
    if mean is not None:
        mean_a = np.ascontiguousarray(mean, np.float32)
        std_a = np.ascontiguousarray(std, np.float32)
        mean_p, std_p = _fptr(mean_a), _fptr(std_a)
    else:
        mean_p = ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
        std_p = mean_p
    if num_threads <= 0:
        num_threads = min(8, os.cpu_count() or 1)
    lib.nodems_augment_batch(
        _fptr(images), n, h, w, c,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), idx.shape[0],
        crop_padding, int(hflip), mean_p, std_p,
        ctypes.c_uint64(seed), _fptr(out), num_threads,
    )
    return out
