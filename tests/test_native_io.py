"""Native C++ encoder tests (native/fastimg.cpp via ctypes bindings).

The .so is built on demand from source; if the toolchain is missing the
tests skip and Pillow covers encoding (io/image_out.py fallback order).
"""

import numpy as np
import pytest

from fractal_tpu.io import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native encoder not built (no toolchain?)"
)


def _rand_img(h, w, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(h, w, 3), dtype=np.uint8
    )


def test_png_roundtrip(tmp_path):
    from PIL import Image

    img = _rand_img(37, 53)
    p = str(tmp_path / "x.png")
    native.write_png(img, p)
    back = np.asarray(Image.open(p))
    np.testing.assert_array_equal(back, img)


def test_png_compression_levels(tmp_path):
    from PIL import Image

    img = _rand_img(64, 64, seed=1)
    sizes = {}
    for lvl in (1, 6, 9):
        p = str(tmp_path / f"l{lvl}.png")
        native.write_png(img, p, compression=lvl)
        back = np.asarray(Image.open(p))
        np.testing.assert_array_equal(back, img)
        sizes[lvl] = len(open(p, "rb").read())
    assert sizes[9] <= sizes[1] * 1.2  # lossless at every level, sane sizes


def test_encode_image_prefers_native(tmp_path):
    from fractal_tpu.io.image_out import encode_image
    from PIL import Image

    img = _rand_img(20, 30, seed=2)
    p = str(tmp_path / "y.png")
    encode_image(img, p)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)


def test_avif_decode_roundtrip_near_lossless(tmp_path):
    """AVIF with the reference's settings (quality 100,
    speed 8, YCbCr 4:4:4 full-range — src/lib.rs:326-333) must decode back
    within YCbCr round-trip error of the source array."""
    import numpy as np
    from PIL import Image

    from fractal_tpu.io.image_out import write_image

    rng = np.random.default_rng(3)
    # fractal-like content: smooth ramps + hard edges
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([
        (xx * 255 / w), (yy * 255 / h), ((xx ^ yy) & 0xFF),
    ], axis=-1).astype(np.uint8)
    img[16:32, 16:32] = rng.integers(0, 255, (16, 16, 3), np.uint8)

    path = write_image(img, str(tmp_path / "rt"), "avif", verbose=False)
    back = np.asarray(Image.open(path).convert("RGB"))
    assert back.shape == img.shape
    err = np.abs(back.astype(int) - img.astype(int))
    # smooth regions: YCbCr 4:4:4 full-range round-trip stays within ~2;
    # the random block is the AV1 lossy worst case — bound it loosely
    smooth = np.ones((h, w), bool); smooth[14:34, 14:34] = False
    assert err[smooth].max() <= 4, f"smooth-region max err {err[smooth].max()}"
    assert np.percentile(err, 99) <= 8


@pytest.mark.skipif(not native.avif_available(),
                    reason="libheif AV1 encoder not available")
def test_native_avif_direct_roundtrip(tmp_path):
    """The C++ libheif shim itself (not the Pillow fallback): encode with
    the reference's quality/speed and decode back near-losslessly."""
    from PIL import Image

    h, w = 48, 72
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 / w), (255 - yy * 255 / h),
                    (xx + yy) % 256], axis=-1).astype(np.uint8)
    p = str(tmp_path / "n.avif")
    native.write_avif(img, p, quality=100, speed=8)
    back = np.asarray(Image.open(p).convert("RGB"))
    assert back.shape == img.shape
    assert np.abs(back.astype(int) - img.astype(int)).max() <= 4


@pytest.mark.skipif(not native.avif_available(),
                    reason="libheif AV1 encoder not available")
def test_encode_image_avif_routes_native(tmp_path, monkeypatch):
    """encode_image prefers the native shim for .avif (Pillow is the
    fallback only) — pin the dispatch so a refactor can't silently
    demote the native path."""
    from fractal_tpu.io import image_out

    calls = []
    real = native.write_avif

    def spy(img, path, quality=100, speed=8):
        calls.append(path)
        real(img, path, quality=quality, speed=speed)

    monkeypatch.setattr(native, "write_avif", spy)
    img = _rand_img(16, 24, seed=4)
    p = str(tmp_path / "z.avif")
    image_out.encode_image(img, p)
    assert calls == [p]
