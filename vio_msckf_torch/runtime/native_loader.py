"""ctypes binding of the native data runtime (runtime/euroc_loader.cc), and
its fallbacks. The port's counterpart of vio_msckf_tpu/runtime/
native_loader.py.

The library is built at first use with g++ (libpng, zlib, pthread) into
vio_msckf_torch/build/runtime-<source hash>/libvio_runtime.so, never at
import. Where it cannot be built (no compiler, no libpng headers),
`available()` is False and the readers decode as the reference does
there (vio_msckf_tpu/data/euroc.py:load_png_gray), with PIL; only where
PIL does not import either, with data/png.py, the port's numpy + zlib
decoder. `open_loader` then runs that decoder on a thread pool behind the
same in-order interface (PIL and zlib release the interpreter lock while
they decode). `decoder_name()` says which of the three runs. This is
host-side image decoding; the GPU path is the same either way.
"""

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from vio_msckf_torch.data.png import decode_png_gray

_SRC = Path(__file__).resolve().parent / "euroc_loader.cc"
_BUILD = Path(__file__).resolve().parent.parent / "build"
_CXX = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lpng", "-lz", "-lpthread")

_lock = threading.Lock()
_state = {}  # "lib": ctypes.CDLL or None once tried, "error": why not


def library_path():
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX + _LIBS).encode())
    return _BUILD / f"runtime-{h.hexdigest()[:16]}" / "libvio_runtime.so"


def _build(path):
    """Compile into a name unique to this process, then rename into place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([*_CXX, str(_SRC), "-o", str(tmp), *_LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()[-500:]}")
    os.replace(tmp, path)


def _load():
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    lib.vio_decode_png_gray.restype = ctypes.c_int
    lib.vio_decode_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
    lib.vio_loader_create.restype = ctypes.c_void_p
    lib.vio_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32]
    lib.vio_loader_next.restype = ctypes.c_int
    lib.vio_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)]
    lib.vio_loader_destroy.restype = None
    lib.vio_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib():
    with _lock:
        if "lib" not in _state:
            try:
                _state["lib"] = _load()
            except OSError as e:          # no compiler or libpng; a failed dlopen
                _state["lib"], _state["error"] = None, str(e)
    return _state["lib"]


def available():
    return _get_lib() is not None


def _pil_image():
    """PIL.Image, or None where PIL does not import."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decoder_name():
    """Which PNG decoder the readers use in this process."""
    if available():
        return "libpng (runtime/euroc_loader.cc, native prefetch ring)"
    why = f"the native loader did not build: {_state.get('error', '')[:200]}"
    Image = _pil_image()
    if Image is not None:
        import PIL

        return f"PIL {PIL.__version__} (thread pool); {why}"
    return f"numpy+zlib (data/png.py, thread pool; PIL does not import); {why}"


def decode_fallback(path):
    """Decode one grayscale PNG where the native loader is unavailable:
    with PIL where it imports, else with data/png.py."""
    Image = _pil_image()
    if Image is None:
        return decode_png_gray(path)
    with Image.open(path) as im:
        return np.array(im.convert("L"), np.uint8)      # writable, for torch.from_numpy


def load_png_gray(path, max_bytes=8 * 1024 * 1024):
    """Decode one grayscale PNG through the native library."""
    lib = _get_lib()
    buf = np.empty(max_bytes, np.uint8)
    w, h = ctypes.c_uint32(0), ctypes.c_uint32(0)
    status = lib.vio_decode_png_gray(
        str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        ctypes.byref(w), ctypes.byref(h))
    if status != 0:
        raise IOError(f"PNG decode failed ({status}): {path}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class PrefetchingLoader:
    """Ordered multi-threaded PNG prefetcher over a bounded ring, in C++:
    iterating yields (index, (H, W) uint8) in path order."""

    def __init__(self, paths, width, height, ring=8, threads=4):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_state.get('error')}")
        self._lib = lib
        self._paths = [str(p).encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._n = len(paths)
        self._w, self._h = width, height
        self._handle = lib.vio_loader_create(arr, self._n, width, height, ring, threads)
        self._closed = False

    def __iter__(self):
        out = np.empty((self._h, self._w), np.uint8)
        idx = ctypes.c_int64(0)
        for _ in range(self._n):
            status = self._lib.vio_loader_next(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(idx))
            if status == -100:
                return
            if status != 0:
                raise IOError(f"decode failed ({status}) at frame {idx.value}")
            yield idx.value, out.copy()

    def close(self):
        if not getattr(self, "_closed", True):
            self._lib.vio_loader_destroy(self._handle)
            self._closed = True

    def __del__(self):
        self.close()


class PoolLoader:
    """The same interface over `decode_fallback` (PIL, else data/png.py):
    `threads` workers decode at most `ring` frames ahead of the consumer,
    in path order."""

    def __init__(self, paths, width, height, ring=8, threads=4):
        self._paths = list(paths)
        self._shape = (height, width)
        self._ring = max(ring, 1)
        self._pool = concurrent.futures.ThreadPoolExecutor(threads)

    def _decode(self, path):
        img = decode_fallback(path)
        if img.shape != self._shape:
            raise IOError(f"{path}: {img.shape[::-1]} pixels, expected {self._shape[::-1]}")
        return img

    def __iter__(self):
        pending = collections.deque()
        ahead = iter(enumerate(self._paths))
        for i, p in ahead:
            pending.append((i, self._pool.submit(self._decode, p)))
            if len(pending) == self._ring:
                break
        while pending:
            i, fut = pending.popleft()
            nxt = next(ahead, None)
            if nxt is not None:
                pending.append((nxt[0], self._pool.submit(self._decode, nxt[1])))
            yield i, fut.result()

    def close(self):
        if hasattr(self, "_pool"):
            self._pool.shutdown(wait=True, cancel_futures=True)

    def __del__(self):
        self.close()


def open_loader(paths, width, height, ring=8, threads=4):
    """The native ring where it builds, else the thread-pool ring."""
    cls = PrefetchingLoader if available() else PoolLoader
    return cls(paths, width, height, ring, threads)
