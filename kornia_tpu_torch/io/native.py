"""ctypes bindings to the native C++ image IO library (``native/``):
libjpeg / libpng decoding, a bilinear resize, and a threaded batch
decoder (counterpart of ``kornia_tpu/io/native.py``, bound to the same
library). The library is built with ``make -C native`` at first use;
where that fails (no compiler, no libjpeg or libpng headers) the native
path is unavailable and ``native_available()`` says so."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["native_available", "read_image_native", "write_image_native",
           "read_batch_native", "NativeBatchLoader"]

_LIB = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    native_dir = os.path.join(_repo_root(), "native")
    so_path = os.path.join(native_dir, "libkornia_io.so")
    if not os.path.exists(so_path):
        try:
            subprocess.run(["make", "-C", native_dir], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.kio_image_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p,
                                   c_int_p]
    lib.kio_image_info.restype = ctypes.c_int
    lib.kio_image_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.kio_image_read.restype = ctypes.c_int
    lib.kio_jpeg_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.kio_jpeg_write.restype = ctypes.c_int
    lib.kio_png_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.kio_png_write.restype = ctypes.c_int
    lib.kio_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, c_int_p, ctypes.c_int]
    lib.kio_read_batch.restype = ctypes.c_int
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native io backend unavailable")
    return lib


def read_image_native(path: str) -> np.ndarray:
    """A JPEG or PNG file → (H, W, 3) uint8 RGB."""
    lib = _lib()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.kio_image_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c))
    if rc != 0:
        raise IOError(f"cannot read image info: {path} (rc={rc})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.kio_image_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise IOError(f"cannot decode image: {path} (rc={rc})")
    return out


def write_image_native(path: str, image: np.ndarray, quality: int = 95
                       ) -> None:
    """(H, W, C) uint8 → a PNG (by the suffix) or a JPEG file."""
    lib = _lib()
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"expected a uint8 image, got {img.dtype}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    buf = img.ctypes.data_as(ctypes.c_void_p)
    if path.lower().endswith(".png"):
        rc = lib.kio_png_write(path.encode(), buf, w, h, c)
    else:
        rc = lib.kio_jpeg_write(path.encode(), buf, w, h, quality)
    if rc != 0:
        raise IOError(f"cannot write image: {path} (rc={rc})")


def read_batch_native(paths: List[str], size: Tuple[int, int],
                      num_threads: int = 0) -> np.ndarray:
    """Decode and bilinearly resize a batch on host threads → (N, H, W, 3)
    uint8, one fixed-shape array for one host→device copy."""
    lib = _lib()
    h, w = size
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    status = (ctypes.c_int * n)()
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.kio_read_batch(arr, n, w, h, out.ctypes.data_as(ctypes.c_void_p),
                       status, num_threads)
    bad = [paths[i] for i in range(n) if status[i] != 0]
    if bad:
        raise IOError(
            f"failed to decode: {bad[:3]}{'...' if len(bad) > 3 else ''}")
    return out


class NativeBatchLoader:
    """Double-buffered loader: decodes batch k + 1 on a host thread while
    the caller works on batch k."""

    def __init__(self, paths: List[List[str]], size: Tuple[int, int],
                 num_threads: int = 0):
        self.batches = paths
        self.size = size
        self.num_threads = num_threads

    def __iter__(self):
        import concurrent.futures as cf
        if not self.batches:
            return
        with cf.ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(read_batch_native, self.batches[0], self.size,
                              self.num_threads)
            for i in range(len(self.batches)):
                cur = fut.result()
                if i + 1 < len(self.batches):
                    fut = pool.submit(read_batch_native, self.batches[i + 1],
                                      self.size, self.num_threads)
                yield cur
