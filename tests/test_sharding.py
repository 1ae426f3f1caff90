"""Multi-device sharding tests on the 8-virtual-device CPU mesh
(SURVEY.md §4: "Multi-device without a cluster").

Asserts the sharded renders equal the single-device renders — the
correctness contract for the spatial-DP escape engine and the fern's
psum ensemble reduce (SURVEY.md §2 C7/C9).
"""

import jax
import numpy as np
import pytest

from fractal_tpu.config import Scene, scene_defaults
from fractal_tpu.parallel.sharding import (
    make_mesh,
    render_escape_sharded,
    render_fern_sharded,
)
from fractal_tpu.render import render_u8


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_mesh(8)


def test_escape_sharded_matches_single_device(mesh):
    scene = Scene(width=96, height=64, iterations=64,
                  pos=(-0.6, 0.0), scale=(0.4, 0.4), precision="ds32")
    single = np.asarray(render_u8(scene))
    sharded = np.asarray(render_escape_sharded(scene, mesh, precision="ds32"))
    np.testing.assert_array_equal(sharded, single)


def test_escape_sharded_deep_zoom(mesh):
    # 1e6x zoom with height not divisible by 8 (padding path).
    scene = Scene(width=40, height=30, iterations=128,
                  pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                  precision="ds32")
    single = np.asarray(render_u8(scene))
    sharded = np.asarray(render_escape_sharded(scene, mesh, precision="ds32"))
    np.testing.assert_array_equal(sharded, single)


def test_escape_sharded_julia_f32(mesh):
    scene = Scene(algo="julia", width=64, height=48, iterations=60,
                  julia_set=(-0.8, 0.156), pos=(0.0, 0.0), scale=(0.4, 0.4),
                  precision="f32")
    # backend="pallas" (interpreted on CPU) so single-device uses the same
    # params-path viewport constants as the sharded kernel — the contract
    # tested here is "sharding changes nothing", not jnp-vs-params rounding.
    single = np.asarray(render_u8(scene, backend="pallas"))
    sharded = np.asarray(render_escape_sharded(scene, mesh, precision="f32"))
    np.testing.assert_array_equal(sharded, single)


def test_fern_sharded_background_and_attractor(mesh):
    scene = scene_defaults("fern").replace(width=64, height=64,
                                           iterations=80_000)
    img = np.asarray(render_fern_sharded(scene, mesh))
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    # corners never touched by the attractor -> background survives psum
    assert tuple(img[0, 0]) == (240, 240, 240)
    assert tuple(img[-1, -1]) == (240, 240, 240)
    # the fern did land somewhere: some pixels darkened
    assert (img < 200).any()


def test_fern_sharded_deterministic(mesh):
    scene = scene_defaults("fern").replace(width=48, height=48,
                                           iterations=40_000, seed=7)
    a = np.asarray(render_fern_sharded(scene, mesh))
    b = np.asarray(render_fern_sharded(scene, mesh))
    np.testing.assert_array_equal(a, b)


def test_fern_compat_replicas_mode(mesh):
    scene = scene_defaults("fern").replace(width=48, height=48,
                                           iterations=40_000)
    img = np.asarray(render_fern_sharded(scene, mesh, compat_replicas=True))
    assert img.shape == (48, 48, 3) and img.dtype == np.uint8
    # Reference semantics (src/lib.rs:294-318): every replica starts as a
    # full secondary_color image and the combine is a saturating add, so
    # with N=8 replicas the untouched background saturates to white.
    assert tuple(img[0, 0]) == (255, 255, 255)


def test_perturb_sharded_matches_single_device(mesh):
    """Deep zoom (1e15x, beyond f64) sharded over 8 devices must equal the
    single-device perturbation render bit-for-bit: the row-interleave map
    is exact integer f32 arithmetic, and the glitch fallback is shared."""
    from fractal_tpu.parallel.sharding import render_perturb_sharded

    scene = Scene(width=64, height=44, iterations=200,  # 44: padding path
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15), precision="perturb")
    single = np.asarray(render_u8(scene))
    sharded = np.asarray(render_perturb_sharded(scene, mesh))
    np.testing.assert_array_equal(sharded, single)


def test_perturb_sharded_multibrot_bs_match_single_device(mesh):
    """The generalized δ-recurrences (multibrot binomial, burning-ship
    diffabs) must shard identically: row-interleaved stripes equal the
    single-device render bit-for-bit."""
    from fractal_tpu.parallel.sharding import render_perturb_sharded

    for scene in (
        Scene(algo="multibrot", power=3, width=48, height=36,
              iterations=400,
              pos=(0.44304637997136528, 0.55830853647684602),
              scale=(1e14, 1e14), precision="perturb"),
        # center nudged a hair INSIDE the set so the primary reference
        # survives the budget — with a short (escaped) primary nearly every
        # pixel goes through the multiref fallback, whose secondary choice
        # is legitimately run-order-dependent (documented), breaking the
        # bit-equality this test is about
        Scene(algo="burningship", width=48, height=36, iterations=400,
              pos_str=("-0.45", "-0.8299772176682513"),
              scale=(1e14, 1e14), precision="perturb"),
        # julia z³+c (r3 --power extension): binomial δ with δc in δz₀ only
        Scene(algo="julia", power=3, width=48, height=36, iterations=400,
              julia_set=(0.44304637997136526, 0.558308536476846),
              pos_str=("164820600322731/562949953421312",
                       "445587455483899/1688849860263936"),
              scale=(1e14, 1e14), precision="perturb"),
    ):
        single = np.asarray(render_u8(scene))
        sharded = np.asarray(render_perturb_sharded(scene, mesh))
        np.testing.assert_array_equal(sharded, single)


def test_multihost_helpers_single_process():
    from fractal_tpu.parallel import multihost

    multihost.initialize()  # no-op in a single process
    assert not multihost.is_multihost()
    assert multihost.status().startswith(("single-host", "not-initialized",
                                          "joined"))
    lo, hi = multihost.local_row_range(100)
    assert (lo, hi) == (0, 100)


def test_multihost_explicit_coordinator_failure_raises(monkeypatch):
    """an explicit coordinator that cannot be joined must
    raise, not silently fall back to single-host."""
    import pytest

    from fractal_tpu.parallel import multihost

    monkeypatch.setattr(multihost, "_initialized", False)
    # the XLA backend is already up in this test process, so an explicit
    # join attempt fails fast (a real pod launch initializes first)
    with pytest.raises(RuntimeError, match="multi-host initialize failed"):
        multihost.initialize(coordinator_address="127.0.0.1:1",
                             num_processes=2, process_id=0,
                             initialization_timeout=1)


def test_multihost_local_row_range_math(monkeypatch):
    from fractal_tpu.parallel import multihost

    cases = {(1, 0, 100): (0, 100), (4, 0, 100): (0, 25),
             (4, 3, 100): (75, 100), (3, 2, 100): (68, 100),
             (8, 7, 10): (10, 10)}  # more hosts than rows: empty tail ok
    for (p, i, h), want in cases.items():
        monkeypatch.setattr(multihost.jax, "process_count", lambda p=p: p)
        monkeypatch.setattr(multihost.jax, "process_index", lambda i=i: i)
        assert multihost.local_row_range(h) == want, (p, i, h)


def test_sharded_rejects_f64_dd64(mesh):
    """A precision the mesh has no program for must raise, never be
    silently coerced: dd64 raises; f64 has a stripe program (the same
    params program as single-device f64 on the GPU) and renders."""
    import pytest
    from fractal_tpu.parallel.sharding import render_escape_sharded

    scene = scene_defaults("mandelbrot").replace(width=32, height=16)
    with pytest.raises(ValueError, match="sharded rendering supports"):
        render_escape_sharded(scene, mesh, precision="dd64")
    img = np.asarray(render_escape_sharded(scene, mesh, precision="f64"))
    assert img.shape == (16, 32, 3)


def test_escape_sharded_f64_matches_single_device(mesh):
    """f64 rows interleave over the mesh like every other tier: bit-equal
    to the single-device params-program render (the program single-device
    f64 runs on the GPU), at a deep view with a padded stripe."""
    import jax.numpy as jnp

    from fractal_tpu.ops.escape_pallas import scene_params
    from fractal_tpu.render import _render_escape_pallas_jit

    scene = Scene(width=40, height=30, iterations=400,
                  pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                  inside=False)
    single = np.asarray(_render_escape_pallas_jit(
        scene, scene_params(scene, dtype=jnp.float64), "f64", "xla"))
    sharded = np.asarray(render_escape_sharded(scene, mesh,
                                               precision="f64"))
    np.testing.assert_array_equal(sharded, single)
    assert len(np.unique(single.reshape(-1, 3), axis=0)) > 8


def test_mesh_for_devices_validation():
    """Negative counts must raise, not slice devs[:-n] into a silent
    wrong-size mesh (r4 review fix); the other contract points hold."""
    import pytest
    from fractal_tpu.parallel.sharding import mesh_for_devices

    with pytest.raises(ValueError, match=">= 0"):
        mesh_for_devices(-2)
    assert mesh_for_devices(1) is None
    assert mesh_for_devices(0).shape["rows"] == len(jax.devices())
    with pytest.raises(ValueError, match="device"):
        mesh_for_devices(len(jax.devices()) + 1)


def test_perturb_sharded_pallas_planes_matches_single_device(mesh):
    """The sharded deep-zoom path runs the δ-orbit kernel per stripe.
    Forced through the Pallas interpreter on the CPU mesh, it must equal
    the single-device render bit-for-bit (exact tier, glitch fallback
    shared)."""
    from fractal_tpu.parallel.sharding import render_perturb_sharded

    scene = Scene(width=64, height=44, iterations=150,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15), precision="perturb")
    single = np.asarray(render_u8(scene))
    sharded = np.asarray(render_perturb_sharded(scene, mesh,
                                                use_pallas=True))
    np.testing.assert_array_equal(sharded, single)


def test_perturb_sharded_p32_matches_single_device(mesh):
    """Sharded p32 must BE p32: same fast-tier semantics as the
    single-device render, bit-for-bit, on both the twin and the forced
    kernel path."""
    from fractal_tpu.ops.perturb import RENDER_STATS
    from fractal_tpu.parallel.sharding import (
        render_escape_sharded, render_perturb_sharded,
    )

    scene = Scene(width=64, height=44, iterations=150,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15), precision="p32")
    single = np.asarray(render_u8(scene))
    assert RENDER_STATS["tier"] == "p32"
    sharded = np.asarray(render_escape_sharded(scene, mesh))
    np.testing.assert_array_equal(sharded, single)
    forced = np.asarray(render_perturb_sharded(scene, mesh, fast=True,
                                               use_pallas=True))
    np.testing.assert_array_equal(forced, single)


def test_perturb_sharded_extreme_twin_matches_single_device(mesh):
    """Extreme depth (1e44x, floatexp) shards correctly: on the CPU mesh the
    default path runs the fe XLA twin row-interleaved; it must equal the
    single-device render bit-for-bit.  (The floatexp tier runs the twin
    on every platform.)"""
    from fractal_tpu.ops import perturb as pt
    from fractal_tpu.parallel.sharding import render_perturb_sharded

    # self-contained cache state: earlier tests leave cross-view orbits at
    # this same needle c, and the multiref resolver's secondary choice is
    # legitimately run-order-dependent (documented) — the single and
    # sharded renders must start from the same candidate landscape
    for c in (pt._ORBIT_CACHE, pt._C_ORBIT_CACHE, pt._REF_CACHE,
              pt._MULTIREF_CACHE, pt._FIX_CACHE, pt._SLICE_CACHE):
        c.clear()
    scene = Scene(width=32, height=20, iterations=120,
                  pos_str=("-1.9999999999999999999999999999999999999999999"
                           "91", "0.0"),
                  scale=(1e44, 1e44), precision="perturb")
    assert pt._is_extreme(scene)
    single = np.asarray(render_u8(scene))
    sharded = np.asarray(render_perturb_sharded(scene, mesh))
    np.testing.assert_array_equal(sharded, single)


def test_perturb_sharded_extreme_bla_matches_single_device(mesh):
    """A BLA-useful extreme view (contracting minibrot orbit) must ride the
    extended-exponent BLA twin on the mesh too (r4: the sharded path used
    to fall back to the plain fe program and leave the 6.8x macro-skip
    speedup on the table), and equal the single-device render bit-for-bit:
    striping never changes a pixel's step/skip sequence (skips are per-
    pixel masks; the row map is exact)."""
    from fractal_tpu.ops import perturb as pt
    from fractal_tpu.parallel.sharding import render_perturb_sharded
    from tests.test_bla import MINIBROT_1E40_X, MINIBROT_1E40_Y

    for c in (pt._ORBIT_CACHE, pt._C_ORBIT_CACHE, pt._REF_CACHE,
              pt._MULTIREF_CACHE, pt._FIX_CACHE, pt._SLICE_CACHE):
        c.clear()
    scene = Scene(width=32, height=20, iterations=400,
                  pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y),
                  scale=(1e40, 1e40), precision="perturb")
    assert pt._is_extreme(scene)
    w, h = scene.width, scene.height
    ref, orbit = pt.resolve_reference(scene, w, h)
    assert pt._fe_bla_useful(scene, orbit, ref, w, h)  # table engages
    single = np.asarray(render_u8(scene))
    sharded = np.asarray(render_perturb_sharded(scene, mesh))
    np.testing.assert_array_equal(sharded, single)


def test_perturb_sharded_populates_render_stats(mesh):
    """Mesh renders carry the same depth observability as single-device
    ones (--profile and the viewer status line read RENDER_STATS after
    every render): tier, a sharded-* kernel route, and the glitch count."""
    from fractal_tpu.ops.perturb import RENDER_STATS
    from fractal_tpu.parallel.sharding import render_perturb_sharded

    scene = Scene(width=32, height=24, iterations=100,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15), precision="perturb")
    np.asarray(render_perturb_sharded(scene, mesh))
    assert RENDER_STATS["tier"] == "perturb"
    assert RENDER_STATS["route"].startswith("sharded-")
    assert isinstance(RENDER_STATS["n_glitch"], int)

    np.asarray(render_perturb_sharded(scene.replace(precision="p32"),
                                      mesh, fast=True))
    assert RENDER_STATS["tier"] == "p32"
    assert RENDER_STATS["route"].startswith("sharded-")
    assert RENDER_STATS["n_glitch"] is None  # fast tier: detection off


# --- fern exact walker-sharded mode (default): bit-identical to 1-device ---


def test_fern_sharded_exact_matches_single_device(mesh):
    """Default sharded fern slices the single-device walker set across the
    mesh against the same RNG stream; the int32 histogram psum makes the
    render bit-identical to render_fern (SURVEY §4: "assert sharded output
    == single-device output" for the fern psum)."""
    from fractal_tpu.models.fern import render_fern

    scene = scene_defaults("fern").replace(width=48, height=48,
                                           iterations=20_000, seed=3)
    single = np.asarray(render_fern(scene))
    sharded = np.asarray(render_fern_sharded(scene, mesh))
    np.testing.assert_array_equal(sharded, single)


def test_fern_sharded_exact_replicas_and_padding(mesh):
    """fern_replicas > 1 runs the same per-replica folds; a walker count
    not divisible by the mesh (6666/8) exercises the padding-walker mask
    (slices past the real walker set must never plot)."""
    from fractal_tpu.models.fern import render_fern

    scene = scene_defaults("fern").replace(width=40, height=40,
                                           iterations=20_000,
                                           fern_replicas=3, seed=11)
    single = np.asarray(render_fern(scene))
    sharded = np.asarray(render_fern_sharded(scene, mesh))
    np.testing.assert_array_equal(sharded, single)


def test_fern_sharded_exact_supersample(mesh):
    from fractal_tpu.models.fern import render_fern

    scene = scene_defaults("fern").replace(width=24, height=24,
                                           iterations=10_000,
                                           supersample=2, seed=5)
    single = np.asarray(render_fern(scene))
    sharded = np.asarray(render_fern_sharded(scene, mesh))
    np.testing.assert_array_equal(sharded, single)


def test_fern_sharded_exact_fewer_walkers_than_devices(mesh):
    """iterations < mesh size still renders (k_dev=1; most devices carry
    only padding walkers) and matches single-device exactly."""
    from fractal_tpu.models.fern import render_fern

    scene = scene_defaults("fern").replace(width=16, height=16,
                                           iterations=5, seed=2)
    single = np.asarray(render_fern(scene))
    sharded = np.asarray(render_fern_sharded(scene, mesh))
    np.testing.assert_array_equal(sharded, single)


def test_fern_sharded_ensemble_mode_still_available(mesh):
    """exact=False keeps the fully-sharded ensemble mode (independent
    per-device streams psum'd into one global fern): deterministic, same
    statistics, documented as NOT the single-device point stream."""
    scene = scene_defaults("fern").replace(width=48, height=48,
                                           iterations=40_000, seed=7)
    a = np.asarray(render_fern_sharded(scene, mesh, exact=False))
    b = np.asarray(render_fern_sharded(scene, mesh, exact=False))
    np.testing.assert_array_equal(a, b)
    assert tuple(a[0, 0]) == (240, 240, 240)


# --- frame-parallel animation sweeps: bit-identical to unsharded ----------


def test_sweep_sharded_matches_unsharded(mesh):
    """Julia parameter sweep with the frame axis sharded across the mesh
    (6 frames on 8 devices exercises the repeat-last-frame padding) must
    equal the single-device batched sweep bit-for-bit — every frame runs
    the identical per-frame program."""
    from fractal_tpu.animate import julia_c_path, render_sweep

    cs = julia_c_path(np.linspace(0.0, 1.0, 6, endpoint=False))
    scenes = [Scene(algo="julia", width=40, height=30, iterations=60,
                    julia_set=(float(a), float(b)), pos=(0.0, 0.0),
                    scale=(0.4, 0.4))
              for a, b in cs]
    single = render_sweep(scenes)
    sharded = render_sweep(scenes, mesh=mesh)
    np.testing.assert_array_equal(sharded, single)
    assert sharded.shape[0] == 6  # padding frames sliced off


def test_sweep_sharded_ds32_params_path(mesh):
    """Mid-depth sweeps ride the ds32 params program; the sharded twin
    must keep the exact per-frame viewport constants."""
    from fractal_tpu.animate import render_sweep

    scenes = [Scene(width=32, height=24, iterations=80,
                    pos=(-0.7436447860, 0.1318252536),
                    scale=(s, s)) for s in (1e5, 3e5, 5e5)]
    single = render_sweep(scenes)
    sharded = render_sweep(scenes, mesh=mesh)
    np.testing.assert_array_equal(sharded, single)


def test_zoom_sweep_sharded_matches_unsharded(mesh):
    """Deep-zoom sweep (shared orbit replicated, frames sharded): the
    mesh render equals the single-device program bit-for-bit."""
    from fractal_tpu.animate import render_zoom_sweep

    scene = Scene(width=32, height=24, iterations=200,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15))
    scales = np.geomspace(0.4, 1e15, 5)
    single = render_zoom_sweep(scene, scales)
    sharded = render_zoom_sweep(scene, scales, mesh=mesh)
    np.testing.assert_array_equal(sharded, single)


def test_banded_sharded_matches_one_shot(mesh, tmp_path):
    """--bands + --devices: each band's rows interleave across the mesh;
    the band's global start composes with the stride through the exact
    integer row map, so banded+sharded == one-shot bit-for-bit.  Resume
    works across mesh sizes (bands are bit-identical either way)."""
    from fractal_tpu.tiled import render_tiled

    scene = Scene(width=64, height=50, iterations=96,
                  pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                  precision="ds32")
    one_shot = np.asarray(render_u8(scene))
    banded = render_tiled(scene, band_rows=16, mesh=mesh)
    np.testing.assert_array_equal(banded, one_shot)

    # checkpoint written by a sharded run resumes on a single device
    ck = str(tmp_path / "ck")
    render_tiled(scene, band_rows=16, ckpt_dir=ck, mesh=mesh)
    resumed = render_tiled(scene, band_rows=16, ckpt_dir=ck)
    np.testing.assert_array_equal(resumed, one_shot)


def test_banded_sharded_perturb_matches_single_device_bands(mesh):
    """Perturbation-depth bands on the mesh: the band start composes with
    the interleave stride through P[6:8]; glitches resolve in global
    coordinates — each band equals the single-device band bit-for-bit."""
    from fractal_tpu.ops.perturb import render_perturb_band
    from fractal_tpu.parallel.sharding import render_perturb_band_sharded
    from fractal_tpu.tiled import render_tiled

    scene = Scene(width=32, height=24, iterations=100,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15), precision="perturb")
    for start, rows in ((0, 8), (8, 8), (16, 8)):
        single = np.asarray(render_perturb_band(scene, start, rows))
        sharded = np.asarray(render_perturb_band_sharded(
            scene, start, rows, mesh=mesh))
        np.testing.assert_array_equal(sharded, single,
                                      err_msg=f"band {start}+{rows}")
    # end-to-end through render_tiled with a checkpoint dir (the perturb
    # banding trigger) — assembles to the same image as single-device bands
    import tempfile

    with tempfile.TemporaryDirectory() as ck_m, \
            tempfile.TemporaryDirectory() as ck_s:
        banded_mesh = render_tiled(scene, band_rows=8, ckpt_dir=ck_m,
                                   mesh=mesh)
        banded_single = render_tiled(scene, band_rows=8, ckpt_dir=ck_s)
    np.testing.assert_array_equal(banded_mesh, banded_single)


def test_zoom_sweep_sharded_extreme_fe_program(mesh):
    """Extreme-depth sweeps (>= ~1e30x, batched floatexp program) shard the
    frame axis too: the packed orbit and fe params replicate, 3 frames on 8
    devices exercise padding — bit-identical to the unsharded fe sweep."""
    from fractal_tpu.animate import render_zoom_sweep

    scene = Scene(width=24, height=16, iterations=300,
                  pos_str=("-1.99999999999999999999999999999999999999999"
                           "9991", "0.0"),
                  scale=(1e44, 1e44))
    scales = [1e38, 1e41, 1e44]
    single = render_zoom_sweep(scene, scales)
    sharded = render_zoom_sweep(scene, scales, mesh=mesh)
    np.testing.assert_array_equal(sharded, single)


def test_tiled_perturb_no_ckpt_keeps_mesh(mesh):
    """--bands + --devices at perturbation depth WITHOUT a checkpoint dir
    falls through to the one-shot program but must keep the requested
    mesh (it used to silently drop to one device)."""
    from fractal_tpu.tiled import render_tiled

    scene = Scene(width=32, height=24, iterations=100,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15), precision="perturb")
    single = np.asarray(render_u8(scene))
    out = render_tiled(scene, band_rows=8, mesh=mesh)
    np.testing.assert_array_equal(out, single)
