"""Barnsley fern chaos-game tests (src/lib.rs:418-463 semantics)."""

import numpy as np
import pytest

from fractal_tpu.config import scene_defaults
from fractal_tpu.models import fern as fern_mod
from fractal_tpu.render import render
from tests import reference_impl as ref


def _small_scene(**kw):
    kw.setdefault("iterations", 150_000)
    return scene_defaults("fern").replace(width=96, height=96, **kw)


def test_seeded_determinism():
    s = _small_scene(seed=7)
    a = render(s)
    b = render(s)
    np.testing.assert_array_equal(a, b)
    c = render(s.replace(seed=8))
    assert (a != c).any()


def test_darkening_curve_matches_iterated_subtract_pixel():
    bg = (240, 240, 240)
    prim = (4, 3, 100)
    w = 0.01
    curve = fern_mod.darkening_curve(bg, prim, w)
    p = bg
    for n in range(min(len(curve), 200)):
        assert tuple(curve[n]) == p, f"hit {n}"
        p = ref.subtract_pixel_once(p, prim, w)


def test_darkening_curve_zero_channel_and_cycle():
    curve = fern_mod.darkening_curve((200, 200, 200), (0, 128, 255), 0.5)
    assert curve[1][0] == 0          # v=0 ⇒ factor 0 ⇒ black after one hit
    # per hit: g ← b·f(v.b)=b·1, b ← g·f(v.g) — channels alternate, both decay
    assert curve[1][1] == 200 and curve[1][2] < 200
    assert len(curve) <= 1025
    # the two-step subsequences are monotone nonincreasing per channel
    g = curve[:, 1].astype(int)
    assert (np.diff(g[0::2]) <= 0).all() and (np.diff(g[1::2]) <= 0).all()
    # terminal 2-cycle invariant used by lut_index: step(last) == second-last
    from tests import reference_impl as ref
    assert ref.subtract_pixel_once(tuple(curve[-1]), (0, 128, 255), 0.5) == \
        tuple(curve[-2])


def test_darkening_alternating_swap_matches_reference_recurrence():
    """the reference's subtract_pixel feeds its result back
    through the swapped RGB::new, so g/b alternate across hits — the LUT
    must reproduce that, not straight per-channel powers."""
    bg, prim, w = (240, 230, 220), (4, 3, 100), 0.01
    curve = fern_mod.darkening_curve(bg, prim, w)
    p = bg
    for n in range(len(curve)):
        assert tuple(curve[n]) == tuple(p), f"hit {n}"
        p = ref.subtract_pixel_once(p, prim, w)
    # with f(v.b)≈0.985 vs f(v.g)≈0.54 the channels visibly alternate
    assert curve[1][1] != curve[1][2]


def test_lut_index_parity_extension():
    import jax.numpy as jnp

    curve = fern_mod.darkening_curve((240, 240, 240), (4, 3, 100), 0.01)
    L = len(curve)
    n = jnp.asarray([0, 1, L - 2, L - 1, L, L + 1, L + 2, L + 7])
    idx = np.asarray(fern_mod.lut_index(n, L))
    assert list(idx[:4]) == [0, 1, L - 2, L - 1]
    assert list(idx[4:]) == [L - 2, L - 1, L - 2, L - 1]


def test_untouched_pixels_keep_background():
    s = _small_scene(iterations=5_000)
    img = render(s)
    # corners are never hit by the fern attractor under default geometry
    assert tuple(img[0, 0]) == (240, 240, 240)
    assert tuple(img[-1, -1]) == (240, 240, 240)


def test_attractor_lands_in_expected_region():
    """Density check: hits must lie within the fern's mapped bounding box.

    The attractor spans x∈[−2.182, 2.6558], y∈[0, 9.9983]; through the
    plotting transform (src/lib.rs:433-437) with defaults this lands inside
    the image with margins; assert the fern occupies the expected band."""
    s = _small_scene(iterations=400_000)
    img = render(s)
    hit = (img != 240).any(axis=2)
    assert hit.mean() > 0.05                      # plenty of attractor pixels
    ys, xs = np.where(hit)
    w, h = s.width, s.height
    # mapped bounds: px = x_attr·(65·0.4·h·0.006) + w/2, etc.
    esx = 65.0 * 0.4 * h * 0.006
    esy = 37.0 * 0.4 * h * 0.006
    px_lo, px_hi = -2.182 * esx + w / 2, 2.6558 * esx + w / 2
    py_lo = h - ((9.9983 - 5.5) * esy + h / 2)
    py_hi = h - ((0.0 - 5.5) * esy + h / 2)
    assert xs.min() >= px_lo - 2 and xs.max() <= px_hi + 2
    assert ys.min() >= py_lo - 2 and ys.max() <= py_hi + 2


def test_replicas_saturating_sum():
    s = _small_scene(iterations=100_000, fern_replicas=2)
    img = render(s)
    # background pixels: 240 + 240 saturates to 255 (src/lib.rs:272-284)
    assert tuple(img[0, 0]) == (255, 255, 255)


def test_more_iterations_darker():
    light = render(_small_scene(iterations=50_000))
    dark = render(_small_scene(iterations=800_000))
    assert dark.mean() < light.mean()


def test_color_weight_darkens():
    a = render(_small_scene(color_weight=0.01))
    b = render(_small_scene(color_weight=0.2))
    assert b.mean() < a.mean()


def test_fern_offset_start_no_transient_artifacts():
    """Regression: with the CLI's default pos=(-0.6, 0) all walkers start at
    x = -0.6*W (far off-attractor); burn-in must scale with the start
    distance or 65536 parallel transients blacken column 0."""
    import numpy as np
    from fractal_tpu.config import scene_defaults
    from fractal_tpu.models.fern import render_fern

    scene = scene_defaults("fern").replace(
        width=200, height=200, iterations=1_000_000, pos=(-0.6, 0.0))
    img = np.asarray(render_fern(scene))
    assert tuple(img[0, 0]) == (240, 240, 240)     # corner is background
    assert tuple(img[-1, 0]) == (240, 240, 240)
    # column 0 collects every off-left transient point (Rust `as usize`
    # clamp, src/lib.rs:433-437): it must stay clean
    col0_dark = (img[:, 0].sum(-1) < 600).mean()
    assert col0_dark < 0.05, f"transient streak on column 0: {col0_dark:.2f}"
    # overall density must match the centered fern (no transient inflation)
    centered = np.asarray(render_fern(scene.replace(pos=(0.0, 0.0))))
    d_off = (img.sum(-1) < 600).mean()
    d_ctr = (centered.sum(-1) < 600).mean()
    assert abs(d_off - d_ctr) < 0.05, (d_off, d_ctr)


def test_fern_supersample():
    import numpy as np
    from fractal_tpu.config import scene_defaults
    from fractal_tpu.models.fern import render_fern

    scene = scene_defaults("fern").replace(width=80, height=80,
                                           iterations=400_000, supersample=2)
    img = np.asarray(render_fern(scene))
    assert img.shape == (80, 80, 3) and img.dtype == np.uint8
    assert tuple(img[0, 0]) == (240, 240, 240)
    assert (img.sum(-1) < 600).any()  # the fern is there
