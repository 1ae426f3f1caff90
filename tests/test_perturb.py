"""Perturbation-path tests (SURVEY.md §4 "precision tests" + §2 C10).

The δ-orbit method is validated three ways:
  * moderate zoom vs the f64 oracle — well-conditioned (low-count) pixels
    must match exactly; overall disagreement is bounded (the late-escape
    chaotic band is ill-conditioned at ANY precision: even f64-delta vs
    direct-f64 disagree there);
  * beyond-f64 zoom (1e16×) vs direct mpmath iteration at 45 digits —
    the capability the reference's stalled GPU port never reached
    (reference README.md:20-22);
  * end-to-end render + auto-policy resolution.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fractal_tpu.config import Scene
from fractal_tpu.ops import perturb as pt
from fractal_tpu.render import render_u8, resolve_precision


def _oracle_counts_f64(scene, w, h):
    from fractal_tpu.models.rules import get_rule
    from fractal_tpu.ops import viewport
    from fractal_tpu.ops.escape_jnp import iterate

    cr, ci = viewport.pixel_grid(w, h, scene.pos, scene.scale,
                                 dtype=jnp.float64)
    rule = get_rule(scene.algo, scene.power)
    if scene.algo == "julia":
        c_r = jnp.float64(scene.julia_set[0])
        c_i = jnp.float64(scene.julia_set[1])
        _, _, cnt = iterate(cr, ci, c_r, c_i, scene.iterations, scene.limit, rule)
    else:
        _, _, cnt = iterate(cr, ci, cr, ci, scene.iterations, scene.limit, rule)
    return np.asarray(cnt)


def test_perturb_exterior_window_exact():
    """Exterior window: low, well-conditioned counts — perturbation must
    match the f64 oracle on every pixel."""
    scene = Scene(width=96, height=72, iterations=600,
                  pos=(-0.735, 0.196), scale=(1e8, 1e8))
    _, _, cnt, n_glitch = pt.iterate_perturb(scene, 72, 96, use_pallas=False)
    cnt = np.asarray(cnt)
    c64 = _oracle_counts_f64(scene, 96, 72)
    np.testing.assert_array_equal(cnt, c64)
    assert n_glitch == 0


def test_perturb_structured_view_vs_f64():
    """Structured boundary view at 1e6×: counts in the late-escape band are
    chaotic at ANY precision (f64-delta vs direct-f64 disagree there too),
    so the contract is statistical: bounded disagreement overall and
    near-total agreement on the interior/exterior classification."""
    scene = Scene(width=96, height=72, iterations=600,
                  pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6))
    _, _, cnt, _ = pt.iterate_perturb(scene, 72, 96, use_pallas=False)
    cnt = np.asarray(cnt)
    c64 = _oracle_counts_f64(scene, 96, 72)
    assert (cnt != c64).mean() < 0.30
    assert ((cnt == 600) == (c64 == 600)).mean() > 0.97


def test_perturb_julia_moderate_zoom():
    scene = Scene(algo="julia", width=64, height=48, iterations=400,
                  julia_set=(-0.8, 0.156), pos=(0.1994, -0.01), scale=(1e8, 1e8))
    zr, zi, cnt, _ = pt.iterate_perturb(scene, 48, 64, use_pallas=False)
    cnt = np.asarray(cnt)
    c64 = _oracle_counts_f64(scene, 64, 48)
    low = c64 < 100
    assert ((cnt == c64) | ~low).all()
    assert (cnt != c64).mean() < 0.30


def _mpmath_count(c0r_frac, c0i_frac, iterations, limit):
    import mpmath as mp

    with mp.workdps(45):
        cr = mp.mpf(c0r_frac.numerator) / c0r_frac.denominator
        ci = mp.mpf(c0i_frac.numerator) / c0i_frac.denominator
        zr, zi = cr, ci
        lim_sq = mp.mpf(limit) ** 2
        for i in range(iterations):
            zr, zi = zr * zr - zi * zi + cr, 2 * zr * zi + ci
            if zr * zr + zi * zi > lim_sq:
                return i
        return iterations


def test_perturb_beyond_f64_vs_mpmath():
    """1e16× zoom: pixel spacing ~6e-18 — far past f64.  Perturbation counts
    must match direct 45-digit mpmath iteration on sampled pixels.  The
    view straddles the needle tip at c = -2, where the boundary crosses the
    window and every count (30..139) is low and well-conditioned."""
    w, h = 16, 12
    scene = Scene(width=w, height=h, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16))
    assert resolve_precision(scene) == "perturb"
    zr, zi, cnt, _ = pt.iterate_perturb(scene, h, w, use_pallas=False)
    cnt = np.asarray(cnt)
    assert len(np.unique(cnt)) > 3  # the view resolves sub-f64 structure
    (Ar, Cr), (Ai, Ci) = pt._affine_fractions(w, h, scene.pos, scene.scale)
    rng = np.random.default_rng(0)
    pts = [(int(x), int(y)) for x, y in
           zip(rng.integers(0, w, 8), rng.integers(0, h, 8))]
    checked = 0
    for (x, y) in pts:
        truth = _mpmath_count(Ar * x + Cr, Ai * y + Ci,
                              scene.iterations, scene.limit)
        if truth < 250:  # well-conditioned only
            assert cnt[y, x] == truth, (x, y, cnt[y, x], truth)
            checked += 1
    assert checked >= 4  # the test must not pass vacuously


def test_perturb_render_e2e_and_policy():
    scene = Scene(width=64, height=48, iterations=200,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15))
    assert resolve_precision(scene) == "perturb"
    img = np.asarray(render_u8(scene))
    assert img.shape == (48, 64, 3) and img.dtype == np.uint8
    # deep views this close to the set boundary are never monochrome
    assert img.std() > 1.0


def test_reference_orbit_padding_and_escape():
    scene = Scene(width=32, height=24, iterations=100,
                  pos=(0.5, 0.5), scale=(10.0, 10.0))  # exterior: escapes fast
    orbit = pt.reference_orbit(scene, (16, 12), 32, 24)
    assert orbit.n_steps < 100
    assert orbit.packed.shape[0] >= scene.iterations
    # rows past n_steps are zero padding
    assert (orbit.packed[orbit.n_steps + 1:] == 0).all()


def test_glitch_fallback_exactness():
    """Every glitched pixel is re-rendered by the exact ds32 kernel, so the
    merged counts equal the ds32 whole-image render on those pixels."""
    scene = Scene(width=64, height=48, iterations=500,
                  pos=(-0.7436447860, 0.1318252536), scale=(1e8, 1e8))
    h, w = 48, 64
    ref_px = pt.choose_reference(scene, w, h)
    orbit = pt.reference_orbit(scene, ref_px, w, h)
    P = pt._pert_params(scene, ref_px, w, h)
    _, _, _, gl = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=500, height=h, width=w)
    gl = np.asarray(gl)
    _, _, cnt, _ = pt.iterate_perturb(scene, h, w, use_pallas=False)
    cnt = np.asarray(cnt)

    from fractal_tpu.ops.escape_pallas import iterate_whole_jnp, scene_params
    params = scene_params(scene, h, w)
    _, _, c_ds = jax.jit(
        lambda p: iterate_whole_jnp(p, algo="mandelbrot", power=2,
                                    iterations=500, precision="ds32",
                                    height=h, width=w)
    )(params)
    c_ds = np.asarray(c_ds)
    if gl.any():
        np.testing.assert_array_equal(cnt[gl == 1], c_ds[gl == 1])


def test_exact_string_center_beyond_f64():
    """A 30-digit center string must position the view exactly: two scenes
    whose pos_str differ below f64 resolution render different deep views
    (with plain floats they would collapse to the same image)."""
    # near the needle tip: structure at every scale, and |x| ~ 2 makes a
    # 1e-27 shift ~11 orders below f64's ulp — yet it moves the view by
    # ~1.6 pixels at 1e26x
    base = "-1.999999999999999999999999999"
    other = "-1.999999999999999999999999998"
    assert float(__import__("fractions").Fraction(base)) == \
           float(__import__("fractions").Fraction(other))  # same f64!
    imgs = []
    for ps in (base, other):
        scene = Scene(width=24, height=16, iterations=300,
                      pos_str=(ps, "0.0000000000000000000000000035"),
                      scale=(1e26, 1e26))
        assert resolve_precision(scene) == "perturb"
        imgs.append(np.asarray(render_u8(scene)))
    assert imgs[0].shape == (16, 24, 3)
    assert (imgs[0] != imgs[1]).any(), "sub-f64 center shift had no effect"


def test_multiref_fallback_resolves_bad_reference():
    """Force a terrible reference (corner pixel, orbit escapes in ~30
    steps): most pixels outlive it and flag as glitches.  The multi-
    reference resolver must reconstruct counts identical to the good-
    reference render — on this needle view every count is well-conditioned
    and pinned to mpmath by test_perturb_beyond_f64_vs_mpmath."""
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16))
    # good-reference counts
    _, _, good, _ = pt.iterate_perturb(scene, h, w, use_pallas=False)
    good = np.asarray(good)

    bad_ref = (0, 0)
    orbit = pt.reference_orbit(scene, bad_ref, w, h)
    assert orbit.n_steps < 100  # the corner escapes early: orbit too short
    P = pt._pert_params(scene, bad_ref, w, h)
    zr, zi, cnt, gl = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=300, height=h, width=w)
    gl = np.asarray(gl)
    assert gl.sum() > 50  # most of the image outlived the bad orbit

    idx = np.flatnonzero(gl)
    fzr, fzi, fcnt, _ = pt._multiref_resolve(scene, idx, w, h)
    merged = np.asarray(cnt).ravel().copy()
    merged[idx] = fcnt
    merged = merged.reshape(h, w)
    # every ESCAPING pixel (well-conditioned) must match exactly; the one
    # non-escaping pixel is exactly c=-2, a measure-zero parabolic point
    # that only its own reference orbit can resolve (the good render has
    # it as the reference; see test_dd.py for the same phenomenon)
    esc = good < 300
    np.testing.assert_array_equal(merged[esc], good[esc])
    assert (merged[~esc] != good[~esc]).sum() <= 2


def test_deep_glitch_routing_uses_multiref(monkeypatch):
    """Past ds32's spacing wall the fallback must NOT use ds32 (coordinate-
    collapsed garbage); _apply_fallback routes to the multi-reference
    resolver instead."""
    calls = {}
    real = pt._multiref_resolve

    def spy(*a, **k):
        calls["hit"] = True
        return real(*a, **k)

    monkeypatch.setattr(pt, "_multiref_resolve", spy)
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16))
    bad_ref = (0, 0)
    orbit = pt.reference_orbit(scene, bad_ref, w, h)
    P = pt._pert_params(scene, bad_ref, w, h)
    zr, zi, cnt, gl = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=300, height=h, width=w)
    pt._apply_fallback(scene, zr, zi, cnt, gl, w, h)
    assert calls.get("hit"), "deep glitches fell back to ds32"


def test_deep_multiref_e2e_render(monkeypatch):
    """Full render_u8 path with a forced-bad reference at a beyond-ds32
    depth: the deep multiref branch (glitch resolve + recolor) must run and
    produce the same image as the good-reference render on escaping pixels."""
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16), inside=False)
    good = np.asarray(render_u8(scene))

    monkeypatch.setattr(pt, "choose_reference", lambda s, ww, hh: (0, 0))
    pt._ORBIT_CACHE.clear()
    pt._BLA_CACHE.clear()
    bad = np.asarray(render_u8(scene))
    diff = (bad != good).any(-1)
    # row h//2 lies exactly ON the needle (ci = 0): every pixel there is a
    # measure-zero non-escaping point that only a same-row reference can
    # resolve (see test_multiref_fallback_resolves_bad_reference); all
    # escaping (well-conditioned) pixels must reconstruct identically.
    diff[h // 2, :] = False
    assert diff.sum() == 0, f"{diff.sum()} off-needle pixels differ"


def test_orbit_table_final_row():
    """Regression: the δ-orbit kernel's last step (n = n_steps−1) reads
    Z_{n_steps} from columns 2:4 of orbit row n_steps−1 — the packed table
    must carry the orbit's final value there (a zero would make the final
    step spuriously glitch-flag nearly every surviving pixel), and the
    kernel must agree with the twin on an orbit that escapes early."""
    scene = Scene(width=32, height=24, iterations=100,
                  pos=(-0.5, 0.0), scale=(0.4, 0.4))
    ref = (16, 6)
    orbit = pt.reference_orbit(scene, ref, 32, 24)
    n = orbit.n_steps
    assert n < scene.iterations  # the reference escapes: a short table
    z = complex(orbit.packed[n - 1, 0], orbit.packed[n - 1, 1])
    c = complex(orbit.packed[0, 0], orbit.packed[0, 1])
    want = z * z + c
    assert abs(complex(orbit.packed[n - 1, 2], orbit.packed[n - 1, 3])
               - want) <= 1e-5 * abs(want)
    assert abs(want) > scene.limit  # Z_{n_steps} is the escaped value
    P = pt._pert_params(scene, ref, 32, 24, orbit=orbit)
    args = (jnp.asarray(orbit.packed), P, jnp.int32(n))
    kw = dict(iterations=100, height=24, width=32)
    twin = pt.perturb_whole_jnp(*args, chunk=16, **kw)
    kern = pt.perturb_kernel(*args, interpret=True, chunk=16, **kw)
    for name, a, b in zip(("zr", "zi", "cnt", "gl"), twin, kern):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_multiref_device_fallback_matches_host():
    """The warm-frame device-resident multiref pass must produce the same
    image as the cold host-driven resolve, given the refs it discovered."""
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16), inside=False)
    bad_ref = (0, 0)
    orbit = pt.reference_orbit(scene, bad_ref, w, h)
    P = pt._pert_params(scene, bad_ref, w, h)
    zr, zi, cnt, gl = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=300, height=h, width=w)
    gl_np = np.asarray(gl)
    assert gl_np.sum() > 50

    # host resolve (discovering refs)
    refs = []
    idx = np.flatnonzero(gl_np)
    hzr, hzi, hcnt, _ = pt._multiref_resolve(scene, idx, w, h, refs_out=refs)
    assert refs
    zr_h, zi_h, cnt_h = pt._scatter_fixed(
        zr, zi, cnt, jnp.asarray(idx.astype(np.int32)),
        jnp.asarray(hzr), jnp.asarray(hzi), jnp.asarray(hcnt),
        height=h, width=w)
    img_host = np.asarray(pt._color_jit(scene, zr_h, zi_h, cnt_h))

    # device-resident resolve with the cached refs ((ref_px, orbit) pairs)
    orbs = [pt._sliced_orbit(o, 300) for _, o in refs]
    orbits = jnp.asarray(np.stack([o.packed for o in orbs]))
    Ps = jnp.stack([pt._pert_params(scene, r, w, h) for r, _ in refs])
    n_stepss = jnp.asarray(np.array([o.n_steps for o in orbs], np.int32))
    kpad = 1 << max(7, (int(gl_np.sum()) - 1).bit_length())
    img_dev, _, _, _, nres = pt._multiref_fallback_color_jit(
        scene, zr, zi, cnt, gl, orbits, Ps, n_stepss,
        iterations=300, kpad=kpad, n_refs=len(refs), height=h, width=w)
    np.testing.assert_array_equal(np.asarray(img_dev), img_host)
    assert int(nres) <= 2  # at most the measure-zero needle pixels


def test_p32_fast_tier_matches_perturb_on_clean_pixels():
    """p32 disables glitch handling only — every pixel the exact path does
    NOT flag must be bit-identical between the two tiers."""
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16), inside=False,
                  precision="perturb")
    ref_px = pt.choose_reference(scene, w, h)
    orbit = pt.reference_orbit(scene, ref_px, w, h)
    P = pt._pert_params(scene, ref_px, w, h)
    _, _, _, gl = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=300, height=h, width=w)
    clean = np.asarray(gl) == 0
    assert clean.sum() > 300  # nearly the whole view
    exact = np.asarray(render_u8(scene))
    fast = np.asarray(render_u8(scene.replace(precision="p32")))
    np.testing.assert_array_equal(fast[clean], exact[clean])


def test_p32_requires_supported_rule():
    # z^1 + c is affine — no δ-recurrence (powers >= 2 all supported r3)
    with pytest.raises(ValueError):
        render_u8(Scene(algo="julia", power=1, julia_set=(-0.8, 0.156),
                        width=8, height=8, precision="p32"))


def test_p32_quality_envelope_vs_f64_oracle():
    """Pin the p32 fast tier's documented quality claims (PERF.md) on a
    downscaled headline view: interior/escape classification stays >99.5 %
    exact and count agreement stays within the measured envelope."""
    w = h = 160
    scene = Scene(width=w, height=h, iterations=1500,
                  pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                  inside=False, precision="p32")
    from fractal_tpu.render import render_u8  # noqa: F811

    # f64 oracle counts
    cnt_ex = _oracle_counts_f64(scene, w, h)

    ref_px = pt.choose_reference(scene, w, h)
    orbit = pt.reference_orbit(scene, ref_px, w, h)
    P = pt._pert_params(scene, ref_px, w, h)
    packed = orbit.packed.copy()
    packed[:, 4] = 0.0  # p32: glitch test disabled
    _, _, cnt, _ = pt.perturb_whole_jnp(
        jnp.asarray(packed), P, jnp.int32(orbit.n_steps),
        iterations=scene.iterations, height=h, width=w)
    cnt = np.asarray(cnt)

    interior_ex = cnt_ex == scene.iterations
    interior_p = cnt == scene.iterations
    class_agree = (interior_ex == interior_p).mean()
    cnt_agree = (cnt == cnt_ex).mean()
    assert class_agree > 0.995, f"classification agreement {class_agree:.4f}"
    assert cnt_agree > 0.80, f"count agreement {cnt_agree:.4f}"
    # errors are boundary texture noise, not structural: escaped-pixel
    # count deltas stay small in the typical case
    esc = ~interior_ex & ~interior_p
    d = np.abs(cnt[esc].astype(int) - cnt_ex[esc].astype(int))
    assert np.percentile(d, 50) == 0


def test_fallback_banded_row0_multiref_branch():
    """The banded-persistence path (fractal_tpu.tiled) resolves a band's
    glitches with GLOBAL pixel coordinates: _apply_fallback(row0,
    full_height) on a band slab past ds32's wall must route to the multi-
    reference resolver and reproduce the ground-truth counts."""
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16))
    bad_ref = (0, 0)
    orbit = pt.reference_orbit(scene, bad_ref, w, h)
    P = pt._pert_params(scene, bad_ref, w, h)
    zr, zi, cnt, gl = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=300, height=h, width=w)
    row0, rows = 8, 8
    sl = slice(row0, row0 + rows)
    assert int(np.asarray(gl)[sl].sum()) > 10  # the band has glitches
    _, _, band_cnt, _ = pt._apply_fallback(
        scene, zr[sl], zi[sl], cnt[sl], gl[sl], w, rows,
        row0=row0, full_height=h)
    band_cnt = np.asarray(band_cnt)
    # Secondary-reference CHOICE is set-dependent (band-local medoids ≠
    # whole-image medoids), so the contract is against ground truth: the
    # good-reference render.  Escaping pixels must match exactly; the
    # measure-zero parabolic c=-2 pixel may differ (see
    # test_multiref_fallback_resolves_bad_reference).
    _, _, good, _ = pt.iterate_perturb(scene, h, w, use_pallas=False)
    good = np.asarray(good)[sl]
    esc = good < 300
    np.testing.assert_array_equal(band_cnt[esc], good[esc])
    assert (band_cnt[~esc] != good[~esc]).sum() <= 2


def test_fallback_banded_row0_ds32_branch():
    """Mid-depth band slab: _apply_fallback(row0, full_height) re-renders
    glitched pixels with the exact ds32 kernel at their GLOBAL coordinates
    — values must equal the whole-image fallback's on those rows (the
    ds32 branch is deterministic per pixel, so bit-equality holds).
    A hand-crafted flag mask keeps it deterministic — the fallback
    re-renders whatever is flagged, regardless of why."""
    w2, h2 = 32, 24
    scene2 = Scene(width=w2, height=h2, iterations=300,
                   pos=(-0.7436447860, 0.1318252536), scale=(1e8, 1e8))
    ref2 = pt.choose_reference(scene2, w2, h2)
    orbit2 = pt.reference_orbit(scene2, ref2, w2, h2)
    P2 = pt._pert_params(scene2, ref2, w2, h2)
    zr2, zi2, cnt2, _ = pt.perturb_whole_jnp(
        jnp.asarray(orbit2.packed), P2, jnp.int32(orbit2.n_steps),
        iterations=300, height=h2, width=w2)
    rng = np.random.default_rng(3)
    gl2 = jnp.asarray((rng.random((h2, w2)) < 0.15).astype(np.int32))
    row0, rows = 8, 8
    sl = slice(row0, row0 + rows)
    assert int(np.asarray(gl2)[sl].sum()) > 10
    _, _, fc2, _ = pt._apply_fallback(scene2, zr2, zi2, cnt2, gl2, w2, h2)
    _, _, bc2, _ = pt._apply_fallback(
        scene2, zr2[sl], zi2[sl], cnt2[sl], gl2[sl], w2, rows,
        row0=row0, full_height=h2)
    np.testing.assert_array_equal(np.asarray(bc2), np.asarray(fc2)[sl])


# --- Series approximation (SA prefix skip) ---------------------------------


def test_series_skip_matches_brute_force_delta():
    """The scaled cubic series at n_skip must reproduce the f64 δ-orbit
    recurrence within SERIES_TOL for every view pixel (worst case |u|=1).
    Checks corner + interior pixels against a brute-force f64 walk."""
    import math

    from fractal_tpu.config import exact_pos

    sc = Scene(width=96, height=64, iterations=4000,
               pos=(-0.74364388703715871, 0.13182590420531198),
               scale=(1e14, 1e14), inside=False)
    h, w = sc.height, sc.width
    ref = pt.choose_reference(sc, w, h)
    orbit = pt.reference_orbit(sc, ref, w, h)
    (Ar, _), (Ai, _) = pt._affine_fractions(w, h, exact_pos(sc), sc.scale)
    Ar, Ai = float(Ar), float(Ai)
    dcm = math.hypot(max(ref[0], w - 1 - ref[0]) * abs(Ar),
                     max(ref[1], h - 1 - ref[1]) * abs(Ai))
    n_skip, (A, B, C) = pt.series_skip(orbit.packed[:, :2], 4000, dcm,
                                       False, align=pt.PERT_CHUNK)
    assert n_skip >= pt.SERIES_MIN_SKIP  # the deep view must admit a skip
    assert n_skip % pt.PERT_CHUNK == 0
    Z = orbit.packed[:, :2].astype(np.float64)
    for px, py in [(0, 0), (w - 1, h - 1), (w - 1, 0), (w // 3, h // 2)]:
        dc = complex((px - ref[0]) * Ar, (py - ref[1]) * Ai)
        dz = dc
        for n in range(n_skip):
            dz = (2 * complex(Z[n, 0], Z[n, 1]) + dz) * dz + dc
        u = dc / dcm
        dz_sa = ((C * u + B) * u + A) * u
        assert abs(dz - dz_sa) <= 4 * pt.SERIES_TOL * max(
            abs(A), abs(B), abs(C)), (px, py, dz, dz_sa)


def test_series_skip_render_bit_identical():
    """SA-on vs SA-off on a deep view: counts, glitch flags, and the
    COLORED u8 image are bit-identical (measured contract).  The raw final
    z of escaped pixels may carry a ≤~2e-6 deviation (the series start is
    within one f32 ulp of the iterated δz; escaped trajectories keep that
    sub-noise offset) — invisible after the smooth-color quantization."""
    sc = Scene(width=192, height=128, iterations=5000,
               pos=(-0.74364388703715871, 0.13182590420531198),
               scale=(1e15, 1e15), inside=False)
    h, w = sc.height, sc.width
    ref = pt.choose_reference(sc, w, h)
    orbit = pt.reference_orbit(sc, ref, w, h)
    P_on = pt._pert_params(sc, ref, w, h, orbit=orbit)
    assert float(P_on[8]) >= pt.SERIES_MIN_SKIP  # SA actually fires
    P_off = pt._pert_params(sc, ref, w, h)       # trivial series
    packed = jnp.asarray(orbit.packed)
    ns = jnp.int32(orbit.n_steps)
    on = pt.perturb_whole_jnp(packed, P_on, ns, iterations=sc.iterations,
                              height=h, width=w)
    off = pt.perturb_whole_jnp(packed, P_off, ns, iterations=sc.iterations,
                               height=h, width=w)
    np.testing.assert_array_equal(np.asarray(on[2]), np.asarray(off[2]))
    np.testing.assert_array_equal(np.asarray(on[3]), np.asarray(off[3]))
    np.testing.assert_allclose(np.asarray(on[0]), np.asarray(off[0]),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(on[1]), np.asarray(off[1]),
                               atol=1e-5)
    img_on = np.asarray(pt._color_jit(sc, on[0], on[1], on[2]))
    img_off = np.asarray(pt._color_jit(sc, off[0], off[1], off[2]))
    np.testing.assert_array_equal(img_on, img_off)


def test_trivial_series_init_is_exact_dc():
    """The trivial SA slots (no orbit) must make _series_init return δz₀ =
    δc BIT-exactly — the uniform init path cannot perturb shallow renders."""
    sc = Scene(width=32, height=24, iterations=100,
               pos=(-0.5, 0.1), scale=(10.0, 10.0))
    ref = (16, 12)
    P = pt._pert_params(sc, ref, 32, 24)
    xx = jnp.arange(32, dtype=jnp.float32)[None, :] * jnp.ones((24, 1), jnp.float32)
    yy = jnp.arange(24, dtype=jnp.float32)[:, None] * jnp.ones((1, 32), jnp.float32)
    dcr = (xx - P[2]) * P[0]
    dci = (yy - P[3]) * P[1]
    dzr, dzi, n0 = pt._series_init(P, dcr, dci)
    assert int(n0) == 0
    np.testing.assert_array_equal(np.asarray(dzr), np.asarray(dcr))
    np.testing.assert_array_equal(np.asarray(dzi), np.asarray(dci))


def test_fix_cache_warm_frames_match_cold(monkeypatch):
    """Warm frames of a glitchy deep view resolve through the dense fix
    cache (fused mask-select + color) and must reproduce the cold frame's
    image exactly — and the cache must actually be exercised."""
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16), inside=False)
    monkeypatch.setattr(pt, "choose_reference", lambda s, ww, hh: (0, 0))
    for c in (pt._ORBIT_CACHE, pt._BLA_CACHE, pt._FIX_CACHE,
              pt._MULTIREF_CACHE, pt._SERIES_CACHE):
        c.clear()
    cold = np.asarray(render_u8(scene))
    fkey = pt._orbit_key(scene, ("fix", 0, 0), w, h)
    assert fkey in pt._FIX_CACHE and pt._FIX_CACHE[fkey] != ()
    warm1 = np.asarray(render_u8(scene))
    warm2 = np.asarray(render_u8(scene))
    np.testing.assert_array_equal(warm1, cold)
    np.testing.assert_array_equal(warm2, cold)


def test_orbit_reuse_across_pan(monkeypatch):
    """Interactive deep-zoom pan: after rendering a view, a sub-f64 pan
    must NOT repay the high-precision host walk — the cached orbit is
    reused at fractional reference coordinates — and the panned render's
    counts must still match 45-digit mpmath exactly on well-conditioned
    pixels (the fractional-reference δc math is exact)."""
    w, h = 16, 12
    for c in (pt._ORBIT_CACHE, pt._C_ORBIT_CACHE, pt._REF_CACHE,
              pt._FIX_CACHE, pt._MULTIREF_CACHE, pt._SERIES_CACHE):
        c.clear()  # earlier tests seed orbits near this view's center
    a = Scene(width=w, height=h, iterations=300,
              pos_str=("-2.0", "0.0"), scale=(1e16, 1e16))
    np.asarray(render_u8(a))  # populate the exact-c orbit index

    b = a.replace(pos_str=("-1.99999999999999999", "0.0"))  # ~1.2 px pan
    ru = pt.reuse_reference(b, w, h)
    assert ru is not None, "pan within the view must reuse the orbit"
    (u, v), orbit = ru
    assert orbit.n_steps >= 300
    assert abs(u - w // 2) > 0.5  # the reference moved off the old center

    walks = []
    real_orbit = pt.reference_orbit
    monkeypatch.setattr(
        pt, "reference_orbit",
        lambda sc, ref, ww, hh: walks.append(ref) or
        real_orbit(sc, ref, ww, hh))
    img = np.asarray(render_u8(b))
    # zero high-precision walks: the primary reuses the panned-from orbit
    # (resolve_reference) and the glitched needle pixels resolve against
    # view A's cached secondary orbits (_candidate_refs)
    assert walks == [], f"pan re-ran high-precision walks: {walks}"
    assert img.shape == (h, w, 3)

    # exactness through the fractional reference: sampled counts vs mpmath
    from fractal_tpu.ops.escape_pallas import viewport_affine  # noqa: F401
    (Ar, Cr), (Ai, Ci) = pt._affine_fractions(w, h, pt.exact_pos(b), b.scale)
    h2, w2 = h, w
    ref_px, orbit2 = pt.resolve_reference(b, w2, h2)
    assert isinstance(ref_px[0], float)
    P = pt._pert_params(b, ref_px, w2, h2, orbit=orbit2)
    got, _, gcnt, _ = pt.perturb_whole_jnp(
        jnp.asarray(orbit2.packed), P, jnp.int32(orbit2.n_steps),
        iterations=300, height=h2, width=w2)
    gcnt = np.asarray(gcnt)
    rng = np.random.default_rng(1)
    checked = 0
    for x, y in zip(rng.integers(0, w, 8), rng.integers(0, h, 8)):
        truth = _mpmath_count(Ar * int(x) + Cr, Ai * int(y) + Ci, 300,
                              b.limit)
        if truth < 250:
            assert gcnt[y, x] == truth, (x, y, gcnt[y, x], truth)
            checked += 1
    assert checked >= 4


def test_orbit_reuse_across_zoom_and_budget():
    """Zoom-in reuses the orbit (the center c stays in view), and a SMALLER
    iteration budget reuses a larger-budget orbit via row slicing — in both
    cases bit-identical to a fresh render (the cached walk's prefix equals
    the fresh walk)."""
    for c in (pt._ORBIT_CACHE, pt._C_ORBIT_CACHE, pt._REF_CACHE,
              pt._FIX_CACHE, pt._MULTIREF_CACHE, pt._SERIES_CACHE):
        c.clear()
    w, h = 32, 24
    a = Scene(width=w, height=h, iterations=600,
              pos_str=("-0.74364388703715871", "0.13182590420531198"),
              scale=(1e15, 1e15), inside=False)
    np.asarray(render_u8(a))  # cache a 600-budget orbit at this c

    walks = []
    real_orbit = pt.reference_orbit
    zoomed = a.replace(scale=(4e15, 4e15), iterations=300)
    try:
        pt.reference_orbit = lambda sc, r, ww, hh: walks.append(r) or \
            real_orbit(sc, r, ww, hh)
        reused = np.asarray(render_u8(zoomed))
    finally:
        pt.reference_orbit = real_orbit
    assert walks == [], f"zoom re-walked: {walks}"

    for c in (pt._ORBIT_CACHE, pt._C_ORBIT_CACHE, pt._REF_CACHE,
              pt._FIX_CACHE, pt._MULTIREF_CACHE, pt._SERIES_CACHE):
        c.clear()
    fresh = np.asarray(render_u8(zoomed))
    np.testing.assert_array_equal(reused, fresh)


# --- Multibrot (z^d + c) perturbation --------------------------------------


def test_multibrot_perturb_vs_f64_midzoom():
    """d=3 δ-recurrence vs the direct f64 oracle at 1e5×: well-conditioned
    (low-count) pixels must match exactly, like the quadratic analog
    (measured: 58/58 exact below count 360, 99.1 % agreement overall)."""
    sc = Scene(algo="multibrot", power=3, width=48, height=36,
               iterations=600,
               pos=(0.44304637997136528, 0.55830853647684602),
               scale=(1e5, 1e5), precision="perturb")
    _, _, cnt, _ = pt.iterate_perturb(sc, 36, 48, use_pallas=False)
    cnt = np.asarray(cnt)
    c64 = _oracle_counts_f64(sc, 48, 36)
    low = c64 < 360
    assert low.sum() > 40  # the window must be discriminative
    np.testing.assert_array_equal(cnt[low], c64[low])
    assert (cnt != c64).mean() < 0.05


def test_multibrot_perturb_beyond_f64_vs_mpmath():
    """d=3 at 1e15× (far past f64): the view straddles the z³ boundary
    (bisected to 2⁻⁷⁰ along a ray), resolves hundreds of distinct counts,
    and sampled pixels match 45-digit mpmath.  At these depths every pixel
    escapes late (counts ≥1200), so the chaotic ±few-count class is larger
    than in the quadratic needle test — the contract is majority-exact
    with bounded disagreement."""
    import mpmath as mp

    sc = Scene(algo="multibrot", power=3, width=32, height=24,
               iterations=2500,
               pos_str=("0.443046379971365280901244412109",
                        "0.558308536476846021719895522933"),
               scale=(1e15, 1e15), inside=False)
    assert resolve_precision(sc) == "perturb"
    _, _, cnt, _ = pt.iterate_perturb(sc, 24, 32, use_pallas=False)
    cnt = np.asarray(cnt)
    assert len(np.unique(cnt)) > 300  # sub-f64 structure resolved
    (Ar, Cr), (Ai, Ci) = pt._affine_fractions(32, 24, pt.exact_pos(sc),
                                              sc.scale)
    pts = [(0, 0), (31, 23), (8, 17), (20, 5), (16, 12), (3, 21), (28, 9),
           (11, 2)]
    exact = 0
    with mp.workdps(45):
        for x, y in pts:
            cf, cif = Ar * x + Cr, Ai * y + Ci
            z = mp.mpc(mp.mpf(cf.numerator) / cf.denominator,
                       mp.mpf(cif.numerator) / cif.denominator)
            c = z
            truth = 2500
            for i in range(2500):
                z = z * z * z + c
                if (z.real * z.real + z.imag * z.imag) > 65536.0 ** 2:
                    truth = i
                    break
            if int(cnt[y, x]) == truth:
                exact += 1
    assert exact >= 5, f"only {exact}/8 sampled pixels mpmath-exact"


def test_multibrot_perturb_e2e_render():
    """Full render_u8 at d=3 perturbation depth: structured output, and the
    banded path matches one-shot on non-multiref pixels."""
    sc = Scene(algo="multibrot", power=3, width=32, height=24,
               iterations=1500,
               pos_str=("0.443046379971365280901244412109",
                        "0.558308536476846021719895522933"),
               scale=(1e14, 1e14), inside=False)
    img = np.asarray(render_u8(sc))
    assert img.std() > 1.0  # structured, not monochrome


# --- Julia z^d + c (power extension) perturbation --------------------------

# The f64 value of the z³-multibrot boundary point the multibrot tests pin;
# as a julia constant it yields a connected cubic julia set whose boundary
# was bisected (max-escape-count descent) to the centers below.
_CJ3 = (0.44304637997136526, 0.558308536476846)


def test_julia_power3_perturb_shallow_exact():
    """Cubic julia (z³ + c, δc only through δz₀): forced perturbation on a
    shallow boundary view must match the direct f64 oracle exactly on the
    well-conditioned low-count window (measured: 259/259 exact below count
    150, 99.1 % agreement overall)."""
    sc = Scene(algo="julia", power=3, width=48, height=36, iterations=400,
               julia_set=_CJ3, pos=(0.292780200657262, 0.263840774699702),
               scale=(200.0, 200.0), precision="perturb")
    _, _, cnt, _ = pt.iterate_perturb(sc, 36, 48, use_pallas=False)
    cnt = np.asarray(cnt)
    c64 = _oracle_counts_f64(sc, 48, 36)
    low = c64 < 150
    assert low.sum() > 200  # the window must be discriminative
    np.testing.assert_array_equal(cnt[low], c64[low])
    assert (cnt != c64).mean() < 0.05


def test_julia_power3_perturb_beyond_f64_vs_mpmath():
    """Cubic julia at 1e15× (far past f64): the view straddles the julia
    boundary (descended with the exact f64 c — at this depth the fractal
    is structurally sensitive to c at the 1e-17 level, so the constant
    must be the f64 value the framework iterates with), resolves a mix of
    interior and late-escaping pixels, and sampled pixels match 45-digit
    mpmath."""
    import mpmath as mp

    w, h = 32, 24
    sc = Scene(algo="julia", power=3, width=w, height=h, iterations=2500,
               julia_set=_CJ3,
               pos_str=("164820600322731/562949953421312",
                        "445587455483899/1688849860263936"),
               scale=(1e15, 1e15), inside=False)
    assert resolve_precision(sc) == "perturb"
    _, _, cnt, _ = pt.iterate_perturb(sc, h, w, use_pallas=False)
    cnt = np.asarray(cnt)
    assert (cnt < 2500).sum() > 100  # escaping filaments in view
    assert len(np.unique(cnt)) >= 8
    (Ar, Cr), (Ai, Ci) = pt._affine_fractions(w, h, pt.exact_pos(sc),
                                              sc.scale)
    pts = [(0, 0), (31, 23), (8, 17), (20, 5), (16, 12), (3, 21), (28, 9),
           (11, 2)]
    exact = 0
    with mp.workdps(45):
        c = mp.mpc(mp.mpf(_CJ3[0]), mp.mpf(_CJ3[1]))
        for x, y in pts:
            zrf, zif = Ar * x + Cr, Ai * y + Ci
            z = mp.mpc(mp.mpf(zrf.numerator) / zrf.denominator,
                       mp.mpf(zif.numerator) / zif.denominator)
            truth = 2500
            for i in range(2500):
                z = z * z * z + c
                if (z.real * z.real + z.imag * z.imag) > 65536.0 ** 2:
                    truth = i
                    break
            if int(cnt[y, x]) == truth:
                exact += 1
    assert exact >= 6, f"only {exact}/8 sampled pixels mpmath-exact"


def test_julia_power3_e2e_render_structured():
    """Full render_u8 of the cubic julia at perturbation depth: the u8
    output must be structured (both escaped filaments and interior)."""
    sc = Scene(algo="julia", power=3, width=32, height=24, iterations=2500,
               julia_set=_CJ3,
               pos_str=("164820600322731/562949953421312",
                        "445587455483899/1688849860263936"),
               scale=(1e15, 1e15), inside=False)
    img = np.asarray(render_u8(sc))
    assert img.std() > 10.0


# --- Burning ship & tricorn perturbation -----------------------------------


@pytest.mark.parametrize("algo", ["burningship", "tricorn"])
def test_bs_tricorn_perturb_beyond_f64_vs_mpmath(algo):
    """Deep-zoom δ-recurrences for burning ship (diffabs imaginary part)
    and tricorn (conjugate square) at 1e16×: on the real axis both maps
    coincide with the quadratic needle (abs/conj are no-ops there), so the
    c = −2 tip view has low, well-conditioned counts — sampled pixels must
    match 45-digit mpmath exactly."""
    import mpmath as mp

    w, h = 16, 12
    sc = Scene(algo=algo, width=w, height=h, iterations=300,
               pos=(-2.0, 0.0), scale=(1e16, 1e16))
    assert resolve_precision(sc) == "perturb"
    _, _, cnt, _ = pt.iterate_perturb(sc, h, w, use_pallas=False)
    cnt = np.asarray(cnt)
    assert len(np.unique(cnt)) > 3
    (Ar, Cr), (Ai, Ci) = pt._affine_fractions(w, h, pt.exact_pos(sc),
                                              sc.scale)
    step = pt._host_step(algo, 2)
    checked = 0
    with mp.workdps(45):
        for x in range(0, w, 3):
            for y in (0, 4, 6, 11):
                cf, cif = Ar * x + Cr, Ai * y + Ci
                z = mp.mpc(mp.mpf(cf.numerator) / cf.denominator,
                           mp.mpf(cif.numerator) / cif.denominator)
                c = z
                truth = 300
                for i in range(300):
                    z = step(z, c)
                    if (z.real * z.real + z.imag * z.imag) > 65536.0 ** 2:
                        truth = i
                        break
                if truth < 250:  # well-conditioned only
                    assert int(cnt[y, x]) == truth, (x, y, cnt[y, x], truth)
                    checked += 1
    assert checked >= 15


def test_burningship_diffabs_recurrence_exact_f64():
    """The diffabs δ-recurrence, run in f64, must track the direct f64
    burning-ship iteration exactly through many axis crossings (the map is
    only C⁰; any branch error diverges immediately).  This pins the
    recurrence itself — the f32 kernel inherits the usual noise class."""
    w = h = 12
    sc = Scene(algo="burningship", width=w, height=h, iterations=400,
               pos_str=("-0.45", "-0.829977217668251374661143257379"),
               scale=(1e5, 1e5), precision="perturb", inside=False)
    ref = (w // 2, h // 2)
    orbit = pt.reference_orbit(sc, ref, w, h)
    Z = orbit.packed[:, :2].astype(np.float64)
    (Ar, Cr), (Ai, Ci) = pt._affine_fractions(w, h, pt.exact_pos(sc),
                                              sc.scale)
    c0r = float(Ar * ref[0] + Cr)
    c0i = float(Ai * ref[1] + Ci)
    # λ ≈ ln 2 per step: even pure-f64 rounding differences reach O(1) by
    # ~50 steps, so the pointwise window is 40 steps — enough for several
    # sign crossings of Z_r·Z_i (both diffabs branches must fire).
    crossings = 0
    for px, py in [(0, 0), (2, 3), (11, 11), (7, 1), (4, 9)]:
        cr = float(Ar * px + Cr)
        ci = float(Ai * py + Ci)
        dcr, dci = cr - c0r, ci - c0i
        zr, zi = cr, ci
        dr, di = dcr, dci
        last_sign = None
        for n in range(min(orbit.n_steps, 40)):
            a, b = abs(zr), abs(zi)
            zr, zi = a * a - b * b + cr, 2 * a * b + ci
            Zr, Zi = Z[n]
            ndr = (2 * Zr + dr) * dr - (2 * Zi + di) * di + dcr
            X = Zr * Zi
            x = Zr * di + Zi * dr + dr * di
            s = X + x
            if X >= 0:
                dab = x if s >= 0 else -(2 * X + x)
            else:
                dab = -x if s <= 0 else 2 * X + x
            if last_sign is not None and (X >= 0) != last_sign:
                crossings += 1
            last_sign = X >= 0
            dr, di = ndr, 2 * dab + dci
            # reconstruct and compare against the direct walk (tolerance
            # follows the f32-orbit noise floor amplified by 2^n)
            tol = 1e-7 * (2.0 ** (n / 2.0))
            rzr, rzi = Z[n + 1][0] + dr, Z[n + 1][1] + di
            assert abs(rzr - zr) < tol, (px, py, n, rzr, zr)
            assert abs(rzi - zi) < tol, (px, py, n, rzi, zi)
            if zr * zr + zi * zi > float(sc.limit) ** 2:
                break
    assert crossings >= 10  # the window truly exercises the fold branches


def test_tricorn_perturb_vs_f64_midzoom():
    """Tricorn δ-orbits at a bisected boundary view: full agreement with
    the f64 oracle (measured 100 %, with the glitch fallback resolving the
    symmetric-axis pixels)."""
    sc = Scene(algo="tricorn", width=48, height=36, iterations=800,
               pos_str=("0.268365245537282474021542748732",
                        "0.268365245537282474021542748732"),
               scale=(1e5, 1e5), precision="perturb", inside=False)
    _, _, cnt, _ = pt.iterate_perturb(sc, 36, 48, use_pallas=False)
    cnt = np.asarray(cnt)
    c64 = _oracle_counts_f64(sc, 48, 36)
    assert (cnt == c64).mean() > 0.99
    assert len(np.unique(c64)) > 50  # discriminative view


def test_burningship_deep_e2e_render():
    """Structured burning-ship render at 1e15× through render_u8 (1101
    distinct counts measured at this bisected-boundary view)."""
    sc = Scene(algo="burningship", width=48, height=36, iterations=3000,
               pos_str=("-0.45", "-0.829977217668251374661143257379"),
               scale=(1e15, 1e15), inside=False)
    assert resolve_precision(sc) == "perturb"
    img = np.asarray(render_u8(sc))
    assert img.std() > 1.0


# --- Extreme depth (floatexp δ-orbits, past the f32-δc wall) ---------------


@pytest.mark.parametrize("zoom", [1e40, 1e100])
def test_extreme_depth_vs_mpmath(zoom):
    """Past ~1e30× the δ quantities leave f32's exponent range and the
    floatexp tile takes over (ops/floatexp.py).  Needle-tip views at 1e40×
    and 1e100× must match mpmath (125 digits at 1e100) on every
    well-conditioned pixel — about 70 orders of magnitude past the f64
    wall that stalled the reference's GPU port."""
    import mpmath as mp

    w, h = 16, 12
    sc = Scene(width=w, height=h, iterations=300,
               pos_str=("-2.0", "0.0"), scale=(zoom, zoom))
    assert resolve_precision(sc) == "perturb"
    assert pt._is_extreme(sc)
    _, _, cnt, _ = pt.iterate_perturb(sc, h, w, use_pallas=False)
    cnt = np.asarray(cnt)
    assert len(np.unique(cnt)) > 3
    (Ar, Cr), (Ai, Ci) = pt._affine_fractions(w, h, pt.exact_pos(sc),
                                              sc.scale)
    checked = 0
    with mp.workdps(int(math.log10(zoom)) + 25):
        for x in range(0, w, 3):
            for y in (0, 5, 11):
                cf, cif = Ar * x + Cr, Ai * y + Ci
                z = mp.mpc(mp.mpf(cf.numerator) / cf.denominator,
                           mp.mpf(cif.numerator) / cif.denominator)
                c = z
                truth = 300
                for i in range(300):
                    z = z * z + c
                    if (z.real * z.real + z.imag * z.imag) > 65536.0 ** 2:
                        truth = i
                        break
                if truth < 250:
                    assert int(cnt[y, x]) == truth, (x, y, cnt[y, x], truth)
                    checked += 1
    assert checked >= 12


def test_extreme_depth_exact_centers_resolve():
    """Two centers differing by ~1e-45 (29 orders below f64's ulp at |x|≈2)
    must render different views at 1e44× — exact Fraction coordinates and
    floatexp δc resolve sub-f64 structure end-to-end."""
    # same (16, 12, 300) program shape as test_extreme_depth_vs_mpmath so
    # the floatexp compile is shared within the test session
    imgs = []
    for tail in ("1", "2"):
        sc = Scene(width=16, height=12, iterations=300,
                   pos_str=("-1.99999999999999999999999999999999999999999999"
                            + tail, "0.0"),
                   scale=(1e44, 1e44))
        assert pt._is_extreme(sc)
        imgs.append(np.asarray(render_u8(sc)))
    assert (imgs[0] != imgs[1]).any(), "sub-f64 center shift had no effect"


def test_extreme_rejects_nonquadratic():
    with pytest.raises(ValueError, match="1e30"):
        render_u8(Scene(algo="burningship", width=8, height=8,
                        iterations=50, pos_str=("-2.0", "0.0"),
                        scale=(1e40, 1e40), precision="perturb"))


def test_extreme_depth_p32_fast_tier():
    """The p32 fast tier composes with the floatexp regime (glitch
    detection off, same fe tile): structured output at 1e40×."""
    sc = Scene(width=16, height=12, iterations=300, pos_str=("-2.0", "0.0"),
               scale=(1e40, 1e40), precision="p32")
    img = np.asarray(render_u8(sc))
    assert img.std() > 1.0


# --- round-3 advisor-fix regression tests ---------------------------------


def test_sliced_orbit_pads_short_tables():
    """A cached ESCAPED orbit from a smaller iteration budget has fewer
    packed rows than the current budget's static shape; _sliced_orbit must
    zero-pad so every pack in _refs_device_pack stacks to one shape
    (advisor r2 medium: np.stack used to raise ValueError)."""
    pad = pt.ORBIT_PAD
    short = pt.RefOrbit(np.ones((100 + pad, 8), np.float32), 40, (0, 0))
    out = pt._sliced_orbit(short, 300)
    assert out.packed.shape == (300 + pad, 8)
    assert out.n_steps == 40
    np.testing.assert_array_equal(out.packed[: 100 + pad],
                                  short.packed)
    assert (out.packed[100 + pad:] == 0).all()
    # stacking with a full-budget table must now work
    full = pt.RefOrbit(np.zeros((300 + pad, 8), np.float32), 300, (1, 1))
    np.stack([out.packed, pt._sliced_orbit(full, 300).packed])


def test_cross_budget_candidate_pack_no_crash():
    """End-to-end reproduction of the advisor r2 medium finding: an escaped
    orbit cached under a SMALLER budget is admitted as a multiref candidate
    for a larger-budget view; the device pack must not crash on shape
    mismatch."""
    w, h = 24, 16
    pos = (-2.0, 0.0)
    # budget-1000 view walks and caches an escaped corner orbit
    sc1 = Scene(width=w, height=h, iterations=250, pos=pos,
                scale=(1e16, 1e16))
    pt.reference_orbit(sc1, (0, 0), w, h)  # corner: escapes early
    # larger-budget overlapping view resolves candidates incl. short orbits
    sc2 = sc1.replace(iterations=300)
    cands = pt._candidate_refs(sc2, w, h)
    if not cands:  # cache evicted by other tests: nothing to pack
        pytest.skip("no cached candidates survived")
    packed = pt._refs_device_pack(sc2, cands, w, h)
    rows = 300 + pt.ORBIT_PAD
    assert packed[0].shape[1:] == (rows, 8)


def test_series_skip_escape_bound_enforced():
    """series_skip must break when |Z_n| + (|A'|+|B'|+|C'|) could exceed the
    escape radius (advisor r2 low: the safety invariant was claimed, not
    checked)."""
    z = np.zeros((64, 2), np.float32)
    # dc_max alone exceeds the radius: no step can be certified skip-safe
    n, _ = pt.series_skip(z, 32, dc_max=3.0, julia=False, esc_radius=2.0)
    assert n == 0
    # same walk unconstrained accepts steps (truncation-only criterion)
    n2, _ = pt.series_skip(z, 32, dc_max=3.0, julia=False)
    assert n2 > 0


def _force_all_glitched(monkeypatch):
    walked = []
    real_orbit = pt.reference_orbit

    def spy_orbit(sc, ref, ww, hh):
        walked.append(ref)
        return real_orbit(sc, ref, ww, hh)

    real_fb = pt._pert_fallback_1d_jit

    def all_glitched(*a, **k):
        zr, zi, cnt, gl = real_fb(*a, **k)
        return zr, zi, cnt, jnp.ones_like(gl)  # nothing ever resolves

    monkeypatch.setattr(pt, "reference_orbit", spy_orbit)
    monkeypatch.setattr(pt, "_pert_fallback_1d_jit", all_glitched)
    monkeypatch.setattr(pt, "_candidate_refs", lambda *a, **k: [])
    return walked


def test_multiref_residual_direct_resolve(monkeypatch):
    """r3: when no reference resolves the glitched pixels, a residual set
    within the pixel-iteration budget is finished EXACTLY by direct
    high-precision iteration — zero residuals, no warning, and the counts
    equal the unglitched twin's on this well-conditioned needle view."""
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300, pos=(-2.0, 0.0),
                  scale=(1e16, 1e16))
    # ground truth BEFORE forcing glitches: the real fallback resolve
    ref, orbit = pt.resolve_reference(scene, w, h)
    P = pt._pert_params(scene, ref, w, h)
    idx = np.arange(6)
    xs = (idx % w).astype(np.float32)
    ys = (idx // w).astype(np.float32)
    k = 128
    xs_p = np.full(k, float(w), np.float32)
    ys_p = np.full(k, float(h), np.float32)
    xs_p[:6], ys_p[:6] = xs, ys
    _, _, cnt_t, gl_t = pt._pert_fallback_1d_jit(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        jnp.asarray(xs_p), jnp.asarray(ys_p), iterations=300, k=k,
        power=2, algo="mandelbrot", extreme=False)
    cnt_t = np.asarray(cnt_t).ravel()[:6]
    assert (np.asarray(gl_t).ravel()[:6] == 0).all()  # well-conditioned

    walked = _force_all_glitched(monkeypatch)
    refs = []
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("error")  # any warning fails the test
        _, _, cnt_d, nres = pt._multiref_resolve(scene, idx, w, h,
                                                 refs_out=refs)
    assert nres == 0
    np.testing.assert_array_equal(cnt_d, cnt_t)
    assert refs == []  # no-op rounds must not pollute the warm-frame pack
    assert len(walked) == len(set(walked))  # failed medoids never re-picked


def test_multiref_residual_always_resolved_exactly(monkeypatch):
    """there is NO best-effort path anymore.  Even when the
    projected direct-resolve wall exceeds the warning threshold (forced to
    0 here), every residual pixel is finished exactly — the warning names
    the projection, n_residual is 0, and counts equal the exact twin's."""
    w, h = 24, 16
    scene = Scene(width=w, height=h, iterations=300, pos=(-2.0, 0.0),
                  scale=(1e16, 1e16))
    ref, orbit = pt.resolve_reference(scene, w, h)
    P = pt._pert_params(scene, ref, w, h)
    idx = np.arange(6)
    k = 128
    xs_p = np.full(k, float(w), np.float32)
    ys_p = np.full(k, float(h), np.float32)
    xs_p[:6] = (idx % w).astype(np.float32)
    ys_p[:6] = (idx // w).astype(np.float32)
    _, _, cnt_t, gl_t = pt._pert_fallback_1d_jit(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        jnp.asarray(xs_p), jnp.asarray(ys_p), iterations=300, k=k,
        power=2, algo="mandelbrot", extreme=False)
    cnt_t = np.asarray(cnt_t).ravel()[:6]
    assert (np.asarray(gl_t).ravel()[:6] == 0).all()

    _force_all_glitched(monkeypatch)
    monkeypatch.setattr(pt, "DIRECT_RESOLVE_WARN_S", 0.0)
    with pytest.warns(UserWarning, match="finished exactly"):
        _, _, cnt_d, nres = pt._multiref_resolve(scene, idx, w, h)
    assert nres == 0
    np.testing.assert_array_equal(cnt_d, cnt_t)


# --- the δ-orbit kernel (interpreter) against the XLA twin ----------------


def _kernel_vs_twin(sc, chunk=16):
    w, h = sc.width, sc.height
    ref, orbit = pt.resolve_reference(sc, w, h)
    P = pt._pert_params(sc, ref, w, h, orbit=orbit)
    ns = jnp.int32(orbit.n_steps)
    pw = pt.eff_power(sc.algo, sc.power)
    twin = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, ns, iterations=sc.iterations,
        height=h, width=w, chunk=chunk, power=pw, algo=sc.algo)
    kern = pt.perturb_kernel(
        jnp.asarray(orbit.packed), P, ns, iterations=sc.iterations,
        height=h, width=w, glitch=True, interpret=True, chunk=chunk,
        power=pw, algo=sc.algo)
    return [np.asarray(a) for a in twin], [np.asarray(a) for a in kern]


def test_pallas_v2_kernel_matches_twin_multibrot_tricorn():
    """The δ-orbit kernel carries every plain-f32 δ-recurrence.  For the
    binomial-Horner (multibrot) and conjugate (tricorn) forms the kernel
    is bit-identical to the XLA twin — both evaluate ``_delta_step``'s
    expressions in the same fl() order."""
    for sc in (
        Scene(algo="multibrot", power=3, width=48, height=36, iterations=250,
              pos=(0.44304637997136528, 0.55830853647684602),
              scale=(1e14, 1e14), precision="perturb"),
        Scene(algo="tricorn", width=48, height=36, iterations=250,
              pos=(-0.45, 0.6), scale=(1e13, 1e13), precision="perturb"),
        # julia z³+c: the Horner branch with δc folded into δz₀ only
        Scene(algo="julia", power=3, width=48, height=36, iterations=250,
              julia_set=(0.44304637997136526, 0.558308536476846),
              pos_str=("61807725121025/211106232532992",
                       "18130999979/68719476736"),
              scale=(1e14, 1e14), precision="perturb"),
    ):
        twin, kern = _kernel_vs_twin(sc)
        for name, a, b in zip(("zr", "zi", "cnt", "gl"), twin, kern):
            np.testing.assert_array_equal(a, b, err_msg=f"{sc.algo}:{name}")


def test_pallas_v2_kernel_burningship_bit_parity():
    """Burning ship holds the same full bit-parity contract as every other
    algo.  XLA:CPU used to contract the diffabs
    select tree's mul+add chains into FMAs differently at different unroll
    depths (twin chunk-4 vs chunk-16 disagreed on 24% of counts at a 1e14
    boundary view); every product feeding an add in the burning-ship branch
    is now pinned through a traced 1.0 multiply (exact, backend-invariant),
    which forces the uncontracted rounding everywhere.  Twin is
    chunk-stable and the kernel matches it bit-for-bit."""
    for sc in (
        Scene(algo="burningship", width=16, height=12, iterations=300,
              pos=(-2.0, 0.0), scale=(1e16, 1e16), precision="perturb"),
        Scene(algo="burningship", width=16, height=12, iterations=1500,
              pos_str=("-0.45", "-0.829977217668251374661143257379"),
              scale=(1e14, 1e14), precision="perturb"),
    ):
        twin, kern = _kernel_vs_twin(sc)
        for name, a, b in zip(("zr", "zi", "cnt", "gl"), twin, kern):
            np.testing.assert_array_equal(a, b, err_msg=name)
        # chunk-stability of the twin itself (the r3 failure mode)
        twin4, kern4 = _kernel_vs_twin(sc, chunk=4)
        for name, a, b in zip(("zr", "zi", "cnt", "gl"), twin, twin4):
            np.testing.assert_array_equal(a, b, err_msg=f"chunk:{name}")
        for name, a, b in zip(("zr", "zi", "cnt", "gl"), kern, kern4):
            np.testing.assert_array_equal(a, b, err_msg=f"kchunk:{name}")


def test_pallas_v2_dist_only_matches_full_kernel():
    """The p32 fast tier's dist-only kernel form (zfr/zfi freeze selects
    and outputs dropped — the coloring epilogue consumes |z|² alone) must
    produce the same counts and the same colored image as the full kernel
    + the zr/zi coloring path, for every δ-recurrence family."""
    from fractal_tpu.render import _color_and_downsample, \
        _color_and_downsample_dist

    for sc in (
        Scene(width=48, height=36, iterations=400,
              pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
              precision="p32", inside=False),
        Scene(algo="burningship", width=32, height=24, iterations=300,
              pos=(-2.0, 0.0), scale=(1e16, 1e16), precision="p32"),
        Scene(algo="julia", power=3, width=32, height=24, iterations=250,
              julia_set=(0.44304637997136526, 0.558308536476846),
              pos_str=("61807725121025/211106232532992",
                       "18130999979/68719476736"),
              scale=(1e14, 1e14), precision="p32"),
    ):
        w, h = sc.width, sc.height
        ref, orbit = pt.resolve_reference(sc, w, h)
        P = pt._pert_params(sc, ref, w, h, orbit=orbit)
        ns = jnp.int32(orbit.n_steps)
        pw = pt.eff_power(sc.algo, sc.power)
        packed = jnp.asarray(orbit.packed)
        zr, zi, cnt, _gl = pt.perturb_kernel(
            packed, P, ns, iterations=sc.iterations, height=h, width=w,
            glitch=False, interpret=True, power=pw, algo=sc.algo)
        d, cnt2 = pt.perturb_kernel(
            packed, P, ns, iterations=sc.iterations, height=h, width=w,
            glitch=False, interpret=True, power=pw, algo=sc.algo,
            dist_only=True)
        np.testing.assert_array_equal(np.asarray(cnt), np.asarray(cnt2),
                                      err_msg=f"{sc.algo}:cnt")
        img_full = np.asarray(jax.jit(_color_and_downsample)(sc, zr, zi,
                                                             cnt))
        img_dist = np.asarray(jax.jit(_color_and_downsample_dist)(sc, d,
                                                                  cnt2))
        np.testing.assert_array_equal(img_full, img_dist,
                                      err_msg=f"{sc.algo}:img")
        # the fused fast-tier program lands on the same image
        img_fast = np.asarray(pt._render_perturb_kernel_fast_jit(
            sc, packed, P, jnp.asarray([orbit.n_steps], jnp.int32)[0],
            height=h, width=w, power=pw, algo=sc.algo, interpret=True))
        np.testing.assert_array_equal(img_full, img_fast,
                                      err_msg=f"{sc.algo}:fused")


def test_perturb_band_dist_only_matches_full_kernel_band():
    """The banded p32 fast tier rides the dist-only kernel form like the
    one-shot and sharded fast tiers: a band's dist-colored
    image must equal the full kernel band's zr/zi-colored image bit-for-
    bit (same frozen |z|² argument as the one-shot parity test)."""
    sc = Scene(width=48, height=36, iterations=400,
               pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
               precision="p32", inside=False)
    w, h = sc.width, sc.height
    ref, orbit = pt.resolve_reference(sc, w, h)
    P = pt._pert_params(sc, ref, w, h, orbit=orbit)
    ns = jnp.int32(orbit.n_steps)
    packed = jnp.asarray(orbit.packed)
    start = jnp.float32(8.0)
    zr, zi, cnt, _gl = pt._perturb_band_kernel_jit(
        sc, packed, P, ns, start, rows=16, width=w, glitch=False,
        interpret=True)
    d, cnt2 = pt._perturb_band_kernel_jit(
        sc, packed, P, ns, start, rows=16, width=w, glitch=False,
        dist_only=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(cnt), np.asarray(cnt2))
    img_full = np.asarray(pt._color_jit(sc, zr, zi, cnt))
    img_dist = np.asarray(pt._color_dist_jit(sc, d, cnt2))
    np.testing.assert_array_equal(img_full, img_dist)
