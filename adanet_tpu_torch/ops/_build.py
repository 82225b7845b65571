"""Builds the port's CUDA kernels with nvcc and binds them with ctypes.

Each `csrc/*.cu` source has a plain C interface and is compiled on its
own into a shared library (`nvcc -gencode arch=compute_90a,code=sm_90a
-std=c++17 -O3 -shared -Xcompiler -fPIC`), at first use, into
`ops/.build/` (listed in `.gitignore`). The library's file name carries a
digest of its source and flags, so an edited source is rebuilt and a
stale library is never loaded. All missing sources compile in parallel,
one nvcc process each.

Every C entry point launches on the stream it is given, returns
`cudaGetLastError()` right after the launch, and the Python wrapper
raises on a non-zero code: a refused launch never passes silently.

K0, the copy kernel, is the build's self-test: `library()` launches it
once per process before it hands out any other kernel, and `self_test()` runs it
again wherever a caller wants proof that the kernels launch on a device
(the serving loader does, before it smokes a generation).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, Optional

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".build")

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

#: Library name -> (source file, {C function: argtypes}).
KERNELS = {
    "copy": ("copy_kernel.cu", {"copy_forward": [_P, _P, ctypes.c_longlong, _P]}),
    "combine": ("combine_kernel.cu", {"combine_forward": [_P] * 4 + [_I] * 4 + [_P]}),
    "sepconv": ("sepconv_kernel.cu", {"sepconv_forward": [_P] * 4 + [_I] * 14 + [_P]}),
    "cell": (
        "cell_kernel.cu",
        {
            "cell_conv1x1": [_P, _I, _P, _P, _P, _P, _I, _I] + [_I] * 13 + [_P],
            "cell_sep_layer": [_P, _I, _P, _P, _P, _P, _P, _I, _I] + [_I] * 14 + [_P],
            "cell_pool": [_P, _I, _P, _I, _I] + [_I] * 12 + [_P],
            "cell_cast_bf16": [_P, _P, ctypes.c_longlong, _P],
        },
    ),
}

#: nvcc's output (ptxas register and shared-memory report) per library
#: built by this process.
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_functions: Dict[str, Dict[str, ctypes._CFuncPtr]] = {}
_error_string = None  # copy library's error_string(code) -> message
_self_tested = False


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in %s and on PATH); the port's CUDA "
            "kernels are built on the machine with the card" % candidate
        )
    return found


def library_path(name: str) -> str:
    source = KERNELS[name][0]
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compiles every named library that is not built yet, all in
    parallel; returns name -> library path. Raises on any failure."""
    names = list(KERNELS if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not os.path.exists(paths[name])]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, KERNELS[name][0])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs[name] = (proc, tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        output, _ = proc.communicate()
        BUILD_LOG[name] = output
        if proc.returncode != 0:
            failures.append("%s (rc=%d):\n%s" % (name, proc.returncode, output))
            os.unlink(tmp)
        else:
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return paths


def library(name: str, function: Optional[str] = None):
    """A bound C entry point of one kernel library (`function` may be
    left out where the library has one); builds all kernels that are
    missing on first use and runs the K0 self-test once per process
    before handing out any other kernel."""
    global _error_string, _self_tested
    with _lock:
        if not _functions:
            paths = build()
            for lib_name, path in paths.items():
                lib = ctypes.CDLL(path)
                bound = {}
                for fn_name, argtypes in KERNELS[lib_name][1].items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    bound[fn_name] = fn
                _functions[lib_name] = bound
                if lib_name == "copy":
                    _error_string = lib.error_string
                    _error_string.argtypes = [_I]
                    _error_string.restype = ctypes.c_char_p
        bound = _functions[name]
        if function is None:
            (fn,) = bound.values()
        else:
            fn = bound[function]
    if name != "copy" and not _self_tested:
        self_test()
        _self_tested = True
    return fn


def check(code: int, what: str) -> None:
    """Raises if a C entry point returned a CUDA error code."""
    if code != 0:
        message = _error_string(code) if _error_string is not None else b"?"
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, code, message.decode()))


def copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K0."""
    return x.clone()


def copy_tensor(x: torch.Tensor) -> torch.Tensor:
    """K0: identity copy. CPU tensors take the plain version; a CUDA
    tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return copy_reference(x)
    if x.device.type != "cuda":
        raise ValueError("copy_tensor: unsupported device %s" % x.device)
    x = x.contiguous()
    out = torch.empty_like(x)
    fn = library("copy")
    code = fn(
        x.data_ptr(),
        out.data_ptr(),
        x.numel() * x.element_size(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(code, "copy_forward")
    copy_tensor.launches += 1
    return out


copy_tensor.launches = 0


def self_test(device="cuda") -> None:
    """Launches K0 on an [8] f32 tensor and checks the copy (the port's
    counterpart of the TPU package's lowering probe)."""
    x = torch.arange(8, dtype=torch.float32, device=device)
    y = copy_tensor(x)
    if not torch.equal(x, y):
        raise RuntimeError("K0 self-test: the copy kernel returned wrong data")
