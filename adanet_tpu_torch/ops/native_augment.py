"""ctypes binding for the native augmentation library (ops/csrc/augment.cc).

Copy of adanet_tpu/ops/native_augment.py, the source and the build place
excepted: the port keeps its own copy of `csrc/augment.cc` at
`adanet_tpu_torch/ops/csrc/augment.cc` and builds it on first use with
`g++ -O3 -shared -fPIC` into the gitignored `ops/.build/` (beside the
CUDA kernels), writing a private temporary file that is renamed into
place, so that concurrent processes never load a half-written library.
This is host C++, not a card kernel. `get_lib` returns None when no
compiler is available; callers keep the numpy path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOG = logging.getLogger("adanet_tpu_torch")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "augment.cc")
_SO = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".build", "libadanet_augment.so")


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # Compile to a private temp path then atomically rename, so concurrent
    # processes can never dlopen a half-written library.
    tmp = "%s.%d.tmp" % (_SO, os.getpid())
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.CalledProcessError) as e:
        _LOG.warning("Native augment build failed (%s); using numpy.", e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first call; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SRC):
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.adanet_augment_apply.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.adanet_augment_apply.restype = None
        _LIB = lib
        return _LIB


def augment_apply(
    images: np.ndarray,
    tops: np.ndarray,
    lefts: np.ndarray,
    flips: np.ndarray,
    cut_ys: np.ndarray,
    cut_xs: np.ndarray,
    pad: int,
    cutout: int,
) -> Optional[np.ndarray]:
    """Applies crop/flip/cutout with the given per-image offsets.

    Returns None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    images = np.ascontiguousarray(images, np.float32)
    n, h, w, c = images.shape
    out = np.empty_like(images)

    def ptr(arr, ctype):
        return np.ascontiguousarray(arr).ctypes.data_as(
            ctypes.POINTER(ctype)
        )

    lib.adanet_augment_apply(
        ptr(images, ctypes.c_float),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        h,
        w,
        c,
        pad,
        cutout,
        ptr(tops.astype(np.int32), ctypes.c_int32),
        ptr(lefts.astype(np.int32), ctypes.c_int32),
        ptr(flips.astype(np.uint8), ctypes.c_uint8),
        ptr(cut_ys.astype(np.int32), ctypes.c_int32),
        ptr(cut_xs.astype(np.int32), ctypes.c_int32),
    )
    return out
