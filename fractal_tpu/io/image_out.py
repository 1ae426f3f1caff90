"""Image encoding — AVIF (reference parity) and PNG.

The reference encodes AVIF via ravif with speed 8, quality 100.0, all-core
threading, YCbCr color space (src/lib.rs:326-333), and unconditionally
appends ".avif" to the output name (src/lib.rs:192-195) — even if it already
ends in .avif.  Both behaviors are replicated (the suffix rule only for the
avif format; the PNG extension follows the same always-append rule).

AVIF parity notes (vs ravif's Config, src/lib.rs:326-333): the primary
encode path is our native C++ shim (native/fastimg.cpp) over the system
libheif→libaom AV1 encoder — the same native-encoder architecture as the
reference's ravif→rav1e.  Settings map one-for-one: quality 100 / speed 8
(aom cpu-used); color space: libheif converts RGB→YCbCr for AV1 exactly as
ravif's `ColorSpace::YCbCr`, chroma 4:4:4 (no subsampling) requested to
match ravif; threads 0 = encoder default all-core behavior.  Near-lossless:
YCbCr round-trip error ≤ ~2/255, covered by the decode-roundtrip tests in
tests/test_native_io.py.  Fallback when the shim or libheif is missing:
Pillow's native `_avif` C extension over libavif+libaom with the same
knobs (``subsampling="4:4:4"``, ``range="full"``) — AVIF is optional, and
without either encoder it fails with an error naming both.

PNG needs nothing beyond numpy: the native shim (libpng) when built, else
a numpy + zlib writer.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# Reference encoder settings (src/lib.rs:326-333).
AVIF_QUALITY = 100
AVIF_SPEED = 8
AVIF_SUBSAMPLING = "4:4:4"   # ravif encodes RGB without chroma subsampling
AVIF_RANGE = "full"


def output_filename(name: str, fmt: str = "avif") -> str:
    """Append the format suffix unconditionally — `format!("{}.avif", f)`
    (src/lib.rs:192-195): "output" → "output.avif", "a.avif" → "a.avif.avif"."""
    return f"{name}.{fmt}"


def _check_rgb(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape} {img.dtype}")
    return img


def png_bytes(img: np.ndarray) -> bytes:
    """PNG encoding of an (H, W, 3) uint8 image: 8-bit RGB, filter 0 on
    every row, one zlib stream."""
    img = _check_rgb(img)
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # leading filter byte 0
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def encode_image(img: np.ndarray, path: str) -> None:
    """Encode (H, W, 3) uint8 to `path`; format chosen by extension."""
    from fractal_tpu.io import native

    lower = path.lower()
    img = _check_rgb(img)
    if lower.endswith(".png"):
        if native.available():
            native.write_png(img, path)
            return
        with open(path, "wb") as f:
            f.write(png_bytes(img))
    elif lower.endswith(".avif"):
        if native.avif_available():
            native.write_avif(img, path, quality=AVIF_QUALITY,
                              speed=AVIF_SPEED)
            return
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError(
                "AVIF output needs the native encoder (native/libfastimg.so "
                "built against libheif) or Pillow; neither is available — "
                "use --format png") from None
        Image.fromarray(img, mode="RGB").save(
            path, format="AVIF", quality=AVIF_QUALITY, speed=AVIF_SPEED,
            subsampling=AVIF_SUBSAMPLING, range=AVIF_RANGE,
        )
    else:
        raise ValueError(f"unsupported image format: {path!r} "
                         f"(png or avif)")


def write_image(img: np.ndarray, name: str, fmt: str = "avif", verbose: bool = True) -> str:
    """Full write path (reference write_image/image_to_data,
    src/lib.rs:245-251, 324-344), including its progress prints."""
    path = output_filename(name, fmt)
    if verbose:
        print("Starting encode.")
    encode_image(img, path)
    if verbose:
        print(f'Finished encode. Writing file "{path}".')
    return path
