"""ctypes binding for the C++ data-loader core (csrc/mvp_loader.cpp).

Compiled at first use with g++ into a cached shared library — the host-side
analogue of the reference JIT-compiling its CUDA metric extensions at import
(``utils/metrics/CD/chamfer3D/dist_chamfer_3D.py:11-16``). No pybind11: a C
ABI + ctypes keeps the build one compiler invocation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ABI_VERSION = 1
# Build output inside the checkout (gitignored).
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _source_path() -> str:
    return os.path.join(os.path.dirname(__file__), "csrc", "mvp_loader.cpp")


def _build_dir() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def _compile() -> Optional[ctypes.CDLL]:
    src = _source_path()
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_build_dir(), f"mvp_loader_{digest}.so")
    if not os.path.exists(out):
        cmd = [
            "g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-o", out + ".tmp", src,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception:
            return None
        os.replace(out + ".tmp", out)
    try:
        lib = ctypes.CDLL(out)
    except OSError:
        return None
    if lib.mvp_loader_abi_version() != _ABI_VERSION:
        return None

    lib.gather_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
    ]
    lib.se3_augment_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        with _lock:
            if _lib is None and not _tried:
                _lib = _compile()
                _tried = True
    return _lib


def is_available() -> bool:
    return _get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def gather_batch(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[i] = src[idx[i]] — contiguous batch assembly.

    src: (n, ...) float32 contiguous; idx: (m,) int. Falls back to numpy
    fancy indexing when the native lib is unavailable.
    """
    lib = _get_lib()
    src = np.ascontiguousarray(src, np.float32)
    idx64 = np.ascontiguousarray(idx, np.int64)
    if lib is None:
        return src[idx64]
    out = np.empty((len(idx64),) + src.shape[1:], np.float32)
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    lib.gather_batch_f32(
        _fptr(src), idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _fptr(out), len(idx64), row,
    )
    return out


def se3_augment_batch(
    src: np.ndarray, tgt: np.ndarray, max_angle: float, max_trans: float,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched train-time registration augmentation (C++ core).

    src/tgt: (B, N, 3) float32. Returns (src', tgt', transform (B, 4, 4)).
    Same pose distributions as data.augment.augment_pair; per-item seeds are
    derived from `seed` so results are reproducible. Returns None when the
    native lib is unavailable (callers fall back to the numpy path).
    """
    lib = _get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.float32)
    tgt = np.ascontiguousarray(tgt, np.float32)
    B, N, _ = src.shape
    out_src = np.empty_like(src)
    out_tgt = np.empty_like(tgt)
    out_T = np.empty((B, 4, 4), np.float32)
    lib.se3_augment_batch(
        _fptr(src), _fptr(tgt), B, N, float(max_angle), float(max_trans),
        ctypes.c_uint64(seed & (2**64 - 1)),
        _fptr(out_src), _fptr(out_tgt), _fptr(out_T),
    )
    return out_src, out_tgt, out_T
