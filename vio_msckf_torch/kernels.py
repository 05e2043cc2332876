"""Build and load libvio_kernels.so, the port's hand-written CUDA kernels.

The sources under csrc/ are compiled with nvcc for Hopper (sm_90a) into
one shared library with a plain C interface, loaded with ctypes. The build
runs at first use, into vio_msckf_torch/build/<source hash>/, so a fresh
checkout builds itself and an edited source rebuilds. Nothing here runs
at import time.

Every C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` turns a nonzero code into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# name -> argtypes; every function returns a CUDA error code (int).
_SIGNATURES = {
    "vio_fast_nms": [_P, _P, _I, _I, _F, _P],
    "vio_spd_gj": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vio_lk_level": [_P] * 11 + [_I] * 6 + [_F, _F, _P],
}

_loaded = {}  # "lib" -> ctypes.CDLL; a loaded .so is process-wide anyway


def sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash():
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc():
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "vio_msckf_torch are built from source at first use")
    return found


def library_path():
    return BUILD / source_hash() / "libvio_kernels.so"


def build():
    """Compile csrc/*.cu unless the library for these sources exists.

    Returns (path, seconds spent compiling, compiler log). The library is
    written under a temporary name and renamed, so a concurrent or
    interrupted build never leaves a half-written file behind."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


def lib():
    """The loaded kernel library, built at the first call of the process.
    Later calls return it without touching the sources."""
    so = _loaded.get("lib")
    if so is None:
        path, _, _ = build()
        so = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        so.vio_error_string.argtypes = [ctypes.c_int]
        so.vio_error_string.restype = ctypes.c_char_p
        _loaded["lib"] = so
    return so


def check(code, name):
    if code != 0:
        msg = lib().vio_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(t):
    """The current CUDA stream of tensor t's device, as a pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def require(t, name, dtype, shape=None):
    """Check what a kernel takes: a contiguous CUDA tensor of one dtype
    and, where given, one shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
