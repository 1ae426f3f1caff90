"""ctypes bindings to the native C++ encoder library (native/fastimg.cpp).

The reference's encoder is a native component (ravif/rav1e, src/lib.rs:12-20);
ours is a C++ shared library providing a libpng PNG writer and an AVIF
encoder over dlopen()ed system libheif→libaom (the reference's AV1 encode,
src/lib.rs:326-333).  Falls back cleanly (``available() == False`` /
``avif_available() == False``) when the library or libheif is missing —
the PNG writer of io/image_out.py and (for AVIF) Pillow then take over.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", "libfastimg.so")


def _try_build(path: str) -> None:
    """Build libfastimg.so from source on first use (fresh checkouts have
    no binaries).  Silent no-op on any failure — see the module docstring."""
    import shutil
    import subprocess

    src_dir = os.path.dirname(path)
    if not os.path.exists(os.path.join(src_dir, "fastimg.cpp")):
        return
    if shutil.which("make") is None:
        return
    try:
        subprocess.run(
            ["make", "-C", src_dir, "libfastimg.so"],
            capture_output=True, timeout=120, check=False,
        )
    except Exception:
        pass


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        _try_build(path)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.fastimg_write_png.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.fastimg_write_png.restype = ctypes.c_int
        lib.fastimg_avif_available.argtypes = []
        lib.fastimg_avif_available.restype = ctypes.c_int
        lib.fastimg_write_avif.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.fastimg_write_avif.restype = ctypes.c_int
        _LIB = lib
    except (OSError, AttributeError):
        # AttributeError: a stale pre-AVIF libfastimg.so — rebuild by
        # deleting it; until then treat native as unavailable.
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def avif_available() -> bool:
    lib = _load()
    return lib is not None and bool(lib.fastimg_avif_available())


def write_png(img: np.ndarray, path: str, compression: int = 6) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native encoder not built")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    assert c == 3
    rc = lib.fastimg_write_png(
        path.encode(),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w,
        h,
        compression,
    )
    if rc != 0:
        raise RuntimeError(f"native PNG encode failed (rc={rc})")


def write_avif(img: np.ndarray, path: str, quality: int = 100,
               speed: int = 8) -> None:
    """AVIF encode via system libheif→libaom (reference ravif settings:
    quality 100, speed 8, YCbCr — src/lib.rs:326-333)."""
    lib = _load()
    if lib is None or not lib.fastimg_avif_available():
        raise RuntimeError("native AVIF encoder not available")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    assert c == 3
    rc = lib.fastimg_write_avif(
        path.encode(),
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w,
        h,
        quality,
        speed,
    )
    if rc != 0:
        raise RuntimeError(f"native AVIF encode failed (rc={rc})")
