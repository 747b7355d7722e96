"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``.  Libraries are built at first use into ``_build_out/`` inside
the package (listed in ``.gitignore``), named by a hash of their sources
and flags, so a changed source rebuilds and an unchanged one loads as is.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

The C entry points take pointers, ints, floats and the CUDA stream, and
return ``cudaGetLastError()`` after the launch; the wrappers raise when it
is not 0 (see ``check``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Tuple

import torch

__all__ = ["SOURCES", "DTYPE_CODES", "build_all", "build_log",
           "sass_opcode_counts", "kernel_names", "load", "check",
           "check_cuda_tensors", "stream_handle"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build_out")

# library name -> (source, headers it includes)
SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "conv3x3": ("conv3x3.cu", ("conv3x3_f32.cuh", "conv3x3.cuh",
                               "common.cuh")),
    "conv3x3_wgrad": ("conv3x3_wgrad.cu", ("conv3x3.cuh", "common.cuh")),
    "ode_block_rk2": ("ode_block_rk2.cu", ("conv3x3_f32.cuh", "conv3x3.cuh",
                                           "common.cuh")),
    "group_norm_act": ("group_norm_act.cu", ("group_norm_act.cuh",
                                             "common.cuh")),
    "group_norm_act_bwd": ("group_norm_act_bwd.cu", ("group_norm_act.cuh",
                                                     "common.cuh")),
    "gelu_poly": ("gelu_poly.cu", ("common.cuh",)),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C signatures of the entry points, by library
_SIGNATURES = {
    "conv3x3": {
        # dtype, x, w, out, S (members), N, H, W, Cin, Cout, w's row
        # stride, then the f32 plan (path, rows, cols, ksplit, stages),
        # device, stream
        "conv3x3_same_launch": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _P],
        # dtype, N, H, W, Cin, Cout, the f32 plan, device
        "conv3x3_path": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I],
    },
    "conv3x3_wgrad": {
        # dtype, x, dy, workspace, out, S (members), N, H, W, Cin, Cout,
        # then the plan (path, splits, rows, stages, cluster), device, stream
        "conv3x3_wgrad_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _P],
    },
    "ode_block_rk2": {
        # dtype, epilogue, x, w, out, y, k1, aux, N, H, W, C, a, b1, b2,
        # the f32 plan (path, rows, cols, ksplit, stages), device, stream
        "ode_block_rk2_conv_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _F, _F, _F, _I, _I, _I,
                                      _I, _I, _I, _P],
        # dtype, x, out, n, device, stream
        "ode_block_rk2_gelu_launch": [_I, _P, _P, _LL, _I, _P],
    },
    "group_norm_act": {
        # dtype, act, x, scale, bias, out, S (members), N, HW, C, G, eps,
        # then the plan (path, vec, warps, cluster, regs), device, stream
        "group_norm_act_launch": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _F, _I, _I, _I, _I, _I, _I, _P],
    },
    "group_norm_act_bwd": {
        # dtype, act, x, dout, scale, bias, dx, part, dscale, dbias, S
        # (members), N, HW, C, G, eps, then the plan (path, vec, warps,
        # cluster, regs, stash), device, stream
        "group_norm_act_bwd_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                                      _I, _I, _I, _P],
    },
    "gelu_poly": {
        # dtype, x, y, n, device, stream
        "gelu_poly_launch": [_I, _P, _P, _LL, _I, _P],
        # dtype, x, g, dx, n, device, stream
        "gelu_poly_bwd_launch": [_I, _P, _P, _P, _LL, _I, _P],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


def _lib_path(name: str) -> str:
    src, headers = SOURCES[name]
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (src,) + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str, out: str) -> Tuple[subprocess.Popen, str, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = out[:-3] + ".log"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, SOURCES[name][0])]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, log


def _finish(name: str, proc: subprocess.Popen, tmp: str, out: str,
            log: str) -> None:
    rc = proc.wait()
    if rc != 0:
        with open(log) as fh:
            msg = fh.read()
        raise RuntimeError(f"nvcc failed for {name} (rc {rc}):\n{msg}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> Dict[str, float]:
    """Build every library that is not built yet, one ``nvcc`` per source,
    all at once.  Returns the seconds spent, by library (0 if cached)."""
    with _LOCK:
        t0 = time.perf_counter()
        started: List[tuple] = []
        try:
            for name in SOURCES:
                out = _lib_path(name)
                if not os.path.exists(out):
                    started.append((name, out, *_start(name, out)))
            for name, out, proc, tmp, log in started:
                _finish(name, proc, tmp, out, log)
        finally:
            for _, _, proc, _, _ in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        dt = time.perf_counter() - t0
        return {name: (dt if any(s[0] == name for s in started) else 0.0)
                for name in SOURCES}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for a
    library built in this checkout, or '' if it was never built here."""
    log = _lib_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as fh:
        return fh.read()


def _sass(name: str) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "--dump-sass", _lib_path(name)],
                          capture_output=True, text=True, check=True).stdout


def kernel_names(name: str) -> List[str]:
    """The (mangled) names of the kernels library ``name`` holds, from
    ``cuobjdump --dump-sass`` of its build."""
    return [line.split(":", 1)[1].strip() for line in _sass(name).splitlines()
            if line.strip().startswith("Function :")]


def sass_opcode_counts(name: str, opcodes: Tuple[str, ...]) -> Dict[str, int]:
    """How many instructions of each SASS opcode (``HMMA``, ``HGMMA``, ...)
    library ``name`` holds, from ``cuobjdump --dump-sass`` of its build."""
    counts = dict.fromkeys(opcodes, 0)
    for line in _sass(name).splitlines():
        # an instruction line: /*0a30*/  HMMA.16816.F32.BF16 R4, R8, ... ;
        parts = line.split("*/", 1)
        if len(parts) != 2:
            continue
        words = parts[1].replace("{", " ").split()
        if words and words[0].startswith("@"):  # predicate guard
            words = words[1:]
        if words:
            op = words[0].split(".")[0]
            if op in counts:
                counts[op] += 1
    return counts


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all()
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.nodems_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nodems_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.nodems_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# dtype codes of the C entry points (NODEMS_F32 / NODEMS_BF16 in common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda_tensors(what: str, dtype: torch.dtype, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype`` on
    one device (the kernels take no strides and no other types)."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{what}: tensors must share one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    for k, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {k} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {k} must be contiguous")


def stream_handle(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device (read
    without making a ``torch.cuda.Stream``: a launch's host cost).
    ``torch._C._cuda_getCurrentRawStream`` is private (TorchInductor's
    generated code reads the stream with it); checked on torch
    2.11.0+cu128."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
