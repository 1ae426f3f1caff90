"""Animation sweep tests (fractal_tpu.animate) — the BASELINE.json
julia-sweep config: N frames over a c-path batched into one program."""

import numpy as np
import pytest

from fractal_tpu.animate import julia_sweep, render_sweep
from fractal_tpu.config import Scene
from fractal_tpu.render import render


def test_julia_sweep_frames_match_single_renders():
    out = julia_sweep(frames=6, width=64, height=48, iterations=60)
    assert out.shape == (6, 48, 64, 3) and out.dtype == np.uint8
    # every frame must equal the standalone render of its scene
    from fractal_tpu.animate import julia_c_path

    cs = julia_c_path(np.linspace(0, 1, 6, endpoint=False))
    for i in (0, 3, 5):
        one = render(Scene(algo="julia", width=64, height=48, iterations=60,
                           julia_set=(float(cs[i, 0]), float(cs[i, 1])),
                           pos=(0.0, 0.0), scale=(0.4, 0.4)))
        np.testing.assert_array_equal(out[i], one)


def test_sweep_over_zoom_path():
    scenes = [Scene(width=48, height=32, iterations=50,
                    pos=(-0.6, 0.0), scale=(0.4 * 1.3 ** k, 0.4 * 1.3 ** k))
              for k in range(5)]
    out = render_sweep(scenes)
    assert out.shape == (5, 32, 48, 3)
    assert len({out[i].tobytes() for i in range(5)}) == 5


def test_sweep_rejects_static_mismatch():
    scenes = [Scene(width=48, height=32, iterations=50),
              Scene(width=48, height=32, iterations=60)]
    with pytest.raises(ValueError, match="static scene structure"):
        render_sweep(scenes)


def test_sweep_mid_depth_uses_ds32_not_f32():
    """sweeps must not silently downgrade to f32.  A
    mid-depth frame (past the f32 spacing limit) must render identically to
    its standalone (ds32) still."""
    deep = Scene(width=48, height=32, iterations=80,
                 pos=(-0.7436447860, 0.1318252536), scale=(5e5, 5e5))
    shallow = deep.replace(scale=(4e5, 4e5))
    out = render_sweep([shallow, deep])
    assert out.shape == (2, 32, 48, 3)
    np.testing.assert_array_equal(out[1], render(deep))
    np.testing.assert_array_equal(out[0], render(shallow))


def test_sweep_rejects_perturbation_depth():
    scenes = [Scene(width=24, height=16, iterations=50,
                    pos=(-0.74364388703715871, 0.13182590420531198),
                    scale=(s, s)) for s in (1e6, 1e15)]
    with pytest.raises(ValueError, match="render_zoom_sweep"):
        render_sweep(scenes)


def test_zoom_sweep_shared_orbit():
    """Deep-zoom video: frames ramp from whole-set view to 1e15x with one
    shared reference orbit; each frame must match the p32 still render."""
    from fractal_tpu.animate import render_zoom_sweep

    scene = Scene(width=32, height=24, iterations=200,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15), inside=False)
    scales = np.geomspace(0.4, 1e15, 4)
    out = render_zoom_sweep(scene, scales)
    assert out.shape == (4, 24, 32, 3) and out.dtype == np.uint8
    # frames are distinct (the two deepest may both land fully interior —
    # all black with inside=False — at this tiny test size)
    assert len({out[i].tobytes() for i in range(4)}) >= 3


def test_zoom_sweep_rejects_escaping_center():
    from fractal_tpu.animate import render_zoom_sweep

    scene = Scene(width=16, height=12, iterations=100,
                  pos=(0.5, 0.5), scale=(1e8, 1e8))  # exterior center
    with pytest.raises(ValueError, match="escapes"):
        render_zoom_sweep(scene, np.geomspace(0.4, 1e8, 3))


def test_animate_cli_flags():
    from fractal_tpu.cli import parse_options

    o = parse_options("-a julia --julia-real -0.8 --julia-imaginary 0.156 "
                      "--animate 8 64 48".split())
    assert o.animate == 8 and o.sweep == "julia"
    o = parse_options("--animate 4 --sweep zoom -s 1e12 "
                      "-x -0.74364388703715871 -y 0.13182590420531198 "
                      "32 24".split())
    assert o.animate == 4 and o.sweep == "zoom" and o.zoom_from is None
    with pytest.raises(SystemExit):
        parse_options("--animate 8 64 48".split())  # julia sweep needs -a julia


def test_zoom_sweep_rejects_extreme_depth_nonquadratic():
    """Past ~1e30x sweeps run the floatexp program, which (like stills) is
    quadratic-only — a non-quadratic extreme sweep must raise, not render
    garbage frames."""
    import numpy as np
    import pytest

    from fractal_tpu.animate import render_zoom_sweep
    from fractal_tpu.config import Scene

    sc = Scene(algo="burningship", width=16, height=12, iterations=100,
               pos_str=("-2.0", "0.0"), scale=(1e40, 1e40))
    with pytest.raises(ValueError, match="1e30"):
        render_zoom_sweep(sc, np.geomspace(1.0, 1e40, 4))


def test_zoom_sweep_extreme_frames_match_stills():
    """r3: sweeps past the f32-δc wall ride the floatexp program (the fe
    param layout's (m, e) affine gains stay exact where plain f32 gains
    underflow).  Exact frames must equal the still render of each zoom
    level bit-for-bit, spanning the wall mid-sweep."""
    import numpy as np

    from fractal_tpu.animate import render_zoom_sweep
    from fractal_tpu.config import Scene
    from fractal_tpu.ops.perturb import render_perturb

    sc = Scene(width=24, height=16, iterations=300,
               pos_str=("-1.9999999999999999999999999999999999999999999"
                        "91", "0.0"),
               scale=(1e44, 1e44), inside=False)
    scales = [1e38, 1e44]
    frames = render_zoom_sweep(sc, scales, exact=True)
    assert frames.shape == (2, 16, 24, 3)
    # the stills REUSE the sweep's deepest-walk orbit (central-preferring
    # cross-view reuse): a fresh re-walk at the shallower frame's fewer
    # mpmath digits would shadow a different chaotic tail — bit-for-still
    # holds through the shared orbit, exactly like interactive pans
    for i, s in enumerate(scales):
        still = np.asarray(render_perturb(
            sc.replace(scale=(float(s), float(s))), fast=False))
        np.testing.assert_array_equal(frames[i], still,
                                      err_msg=f"scale {s}")
    assert np.asarray(frames[1]).std() > 1.0  # deep frame structured
    # (the fast tier runs the same batched fe program with glitch
    # detection off — not separately compiled here: each fe program
    # shape costs a full per-process XLA compile)


def test_zoom_sweep_exact_frames_match_stills():
    """``exact=True`` zoom sweeps must match still
    quality — every frame equals the still render of that zoom level
    bit-for-bit (glitched frames re-rendered through the full exact
    fallback; clean frames already identical by the SA/BLA/banding
    bit-stability contracts)."""
    import numpy as np

    from fractal_tpu.animate import render_zoom_sweep
    from fractal_tpu.config import Scene
    from fractal_tpu.ops.perturb import render_perturb

    sc = Scene(width=96, height=72, iterations=1200,
               pos=(-0.74364388703715871, 0.13182590420531198),
               scale=(1e12, 1e12), inside=False)
    scales = [1e6, 1e11, 1e12]
    frames = render_zoom_sweep(sc, scales, exact=True)
    for i, s in enumerate(scales):
        still = np.asarray(render_perturb(
            sc.replace(scale=(float(s), float(s))), fast=False))
        np.testing.assert_array_equal(frames[i], still, err_msg=f"scale {s}")


def test_exact_sweep_cli_flag_parses():
    from fractal_tpu.cli import parse_options

    o = parse_options("--animate 4 --sweep zoom --exact-sweep 32 24".split())
    assert o.exact_sweep is True
    assert parse_options("32 24".split()).exact_sweep is False


def test_zoom_sweep_nonquadratic_algos():
    """r3: zoom sweeps carry every perturbation recurrence.  A multibrot
    z^3+c and a tricorn sweep must render structured, distinct frames
    (their δ-recurrences run inside the batched program), and each exact
    frame must match the still render of that zoom level."""
    from fractal_tpu.animate import render_zoom_sweep
    from fractal_tpu.ops.perturb import render_perturb

    sc = Scene(algo="multibrot", power=3, width=32, height=24,
               iterations=300,
               pos=(0.443046379971365280901244412109,
                    0.558308536476846021719895522933),
               scale=(1e14, 1e14), inside=False, precision="perturb")
    scales = [1e5, 1e14]
    frames = render_zoom_sweep(sc, scales, exact=True)
    assert frames.shape == (2, 24, 32, 3)
    assert len({frames[i].tobytes() for i in range(2)}) == 2
    for i, s in enumerate(scales):
        still = np.asarray(render_perturb(
            sc.replace(scale=(float(s), float(s))), fast=False))
        np.testing.assert_array_equal(frames[i], still,
                                      err_msg=f"multibrot scale {s}")


def test_zoom_sweep_tricorn_fast():
    from fractal_tpu.animate import render_zoom_sweep

    # a real-axis center: on the reals the conjugate recurrence reduces
    # to the quadratic one, so the needle segment never escapes
    sc = Scene(algo="tricorn", width=24, height=18, iterations=150,
               pos=(-1.99999999999, 0.0), scale=(1e13, 1e13), inside=False,
               precision="perturb")
    frames = render_zoom_sweep(sc, [1e4, 1e13])
    assert frames.shape == (2, 18, 24, 3)
    assert frames[0].std() > 0  # structured shallow frame


def test_zoom_sweep_fast_frames_ride_series_approximation(monkeypatch):
    """Fast-tier sweeps engage the per-frame SA (r3): with the still's
    reference pinned to the sweep's center, a deep fast frame must be
    bit-identical to the p32 still (same orbit, same per-scale series) —
    and the deep frame's series must actually skip a prefix."""
    from fractal_tpu import animate as an
    from fractal_tpu.animate import render_zoom_sweep
    from fractal_tpu.ops import perturb as pt
    from fractal_tpu.ops.perturb import render_perturb

    for c in (pt._ORBIT_CACHE, pt._C_ORBIT_CACHE, pt._REF_CACHE,
              pt._SERIES_CACHE, pt._FIX_CACHE, pt._SLICE_CACHE):
        c.clear()
    sc = Scene(width=32, height=24, iterations=600,
               pos=(-0.74364388703715871, 0.13182590420531198),
               scale=(1e13, 1e13), inside=False, precision="perturb")
    w, h = sc.width, sc.height
    monkeypatch.setattr(pt, "choose_reference",
                        lambda s, ww, hh: (ww // 2, hh // 2))
    deep = sc.replace(scale=(1e13, 1e13))
    ref, orbit = pt.resolve_reference(deep, w, h)
    import math

    (Ar, _), (Ai, _) = pt._affine_fractions(w, h, deep.pos, deep.scale)
    dcm = math.hypot(max(ref[0], w - 1 - ref[0]) * abs(float(Ar)),
                     max(ref[1], h - 1 - ref[1]) * abs(float(Ai)))
    n_skip, _ = pt._series_for(deep, orbit, ref, w, h, dcm)
    assert n_skip > 0  # the deep frame really skips a prefix
    frames = render_zoom_sweep(sc, [1e6, 1e13])
    still = np.asarray(render_perturb(deep, fast=True))
    np.testing.assert_array_equal(frames[1], still)
