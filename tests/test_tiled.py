"""Banded checkpoint/resume rendering tests (fractal_tpu.tiled).

Contract: banded output is bit-identical to the one-shot render at every
tier (each band runs the one-shot program family for its tier, addressed
through an exact global-row map), resume skips completed bands, and a
stale checkpoint directory is rejected.
"""

import json
import os

import numpy as np
import pytest

from fractal_tpu.config import Scene
from fractal_tpu.render import render_u8
from fractal_tpu.tiled import render_tiled


SCENE = Scene(width=64, height=96, iterations=80,
              pos=(-0.6, 0.0), scale=(0.4, 0.4), precision="ds32")


def test_banded_matches_one_shot():
    one = np.asarray(render_u8(SCENE))
    banded = render_tiled(SCENE, band_rows=40)  # uneven last band
    np.testing.assert_array_equal(banded, one)


def test_checkpoint_and_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    full = render_tiled(SCENE, band_rows=32, ckpt_dir=d)
    m = json.load(open(os.path.join(d, "manifest.json")))
    assert sorted(m["done"]) == [0, 1, 2]

    # simulate an interrupted run: drop the last band, keep the first two
    os.remove(os.path.join(d, "band_2.npy"))
    m["done"] = [0, 1]
    json.dump(m, open(os.path.join(d, "manifest.json"), "w"))
    # poison band 0 on disk: resume must trust it (proves bands 0/1 are
    # loaded from the checkpoint, not recomputed)
    poisoned = np.load(os.path.join(d, "band_0.npy"))
    poisoned[0, 0] = [1, 2, 3]
    np.save(os.path.join(d, "band_0.npy"), poisoned)

    resumed = render_tiled(SCENE, band_rows=32, ckpt_dir=d)
    assert tuple(resumed[0, 0]) == (1, 2, 3)        # came from checkpoint
    np.testing.assert_array_equal(resumed[32:], full[32:])  # rest matches


def test_stale_checkpoint_rejected(tmp_path):
    d = str(tmp_path / "ckpt")
    render_tiled(SCENE, band_rows=32, ckpt_dir=d)
    other = SCENE.replace(iterations=81)
    with pytest.raises(ValueError, match="different render"):
        render_tiled(other, band_rows=32, ckpt_dir=d)


def test_supersample_band_alignment():
    scene = SCENE.replace(supersample=2, height=48)
    one = np.asarray(render_u8(scene))
    banded = render_tiled(scene, band_rows=33)  # rounded down to 32 (mult of 2)
    np.testing.assert_array_equal(banded, one)


def test_banded_f64_matches_one_shot_bit_exact():
    """r4 review fix: banded f64 used to run the params program's f32 form
    (dtype keyed on dd64 only), silently collapsing every pixel's c below
    the f32 ulp at mid-depth — a uniform wrong image, violating the
    no-silent-precision rule.  Bands now ride the jnp program
    (pixel_grid(row0=...) band), elementwise-identical to the one-shot
    slice, so banded f64 == one-shot f64 bit-exactly."""
    scene = Scene(width=48, height=32, iterations=3000,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e9, 1e9), precision="f64")
    one = np.asarray(render_u8(scene))
    # the view is structured (f32 would collapse it to one flat color)
    assert len(np.unique(one.reshape(-1, 3), axis=0)) > 8
    banded = render_tiled(scene, band_rows=8)
    np.testing.assert_array_equal(banded, one)


def test_band_jnp_program_compiles_once_across_starts():
    """The jnp band program takes the start row as a TRACED scalar (r4
    review: a static start would recompile the whole escape program per
    band — ~200 compiles for a 100MP poster)."""
    from fractal_tpu.render import _render_band_jnp_jit

    scene = Scene(width=32, height=24, iterations=60,
                  pos=(-0.6, 0.0), scale=(0.4, 0.4), precision="f64")
    one = np.asarray(render_u8(scene))
    before = _render_band_jnp_jit._cache_size()
    a = np.asarray(_render_band_jnp_jit(scene, "f64", 0, 8))
    b = np.asarray(_render_band_jnp_jit(scene, "f64", 8, 8))
    c = np.asarray(_render_band_jnp_jit(scene, "f64", 16, 8))
    np.testing.assert_array_equal(np.concatenate([a, b, c]), one)
    assert _render_band_jnp_jit._cache_size() - before <= 1


def test_banded_f32_cpu_near_one_shot():
    """The documented f32-on-CPU caveat (fractal_tpu/tiled.py module
    docstring): XLA:CPU's whole-program fusion rounds the escape loop
    shape-dependently, so differently-shaped programs (one-shot jnp vs
    band params) can flip a small fraction of chaotic boundary escape
    tests — measured ~0.05 % on this view, and present even between two
    jnp programs of different band shapes.  Pin the honest contract:
    identical on ≥ 99.5 % of pixels and structured output.  (On the GPU
    both routes run the same kernel and match bit-exactly.)"""
    scene = SCENE.replace(precision="f32")
    one = np.asarray(render_u8(scene))
    banded = render_tiled(scene, band_rows=40)
    assert banded.shape == one.shape
    frac = (banded != one).any(axis=-1).mean()
    assert frac <= 0.005, f"banded f32 differs on {frac:.2%} of pixels"
    assert len(np.unique(banded.reshape(-1, 3), axis=0)) > 8


def test_banded_dd64_matches_one_shot_bit_exact():
    scene = Scene(width=24, height=16, iterations=120,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15), precision="dd64")
    one = np.asarray(render_u8(scene))
    banded = render_tiled(scene, band_rows=8)
    np.testing.assert_array_equal(banded, one)


def test_banded_mesh_rejects_cpu_only_tiers():
    """--bands --devices must raise the same no-silent-downgrade error as
    the unbanded mesh path for a tier the mesh has no program for (dd64),
    and render the tiers it has — f64 included — bit-identical to the
    unbanded sharded render."""
    from fractal_tpu.parallel.sharding import make_mesh, render_escape_sharded

    mesh = make_mesh(2)
    scene = Scene(width=32, height=24, iterations=100,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e9, 1e9))  # auto → f64
    with pytest.raises(ValueError, match="sharded rendering supports"):
        render_tiled(scene.replace(precision="dd64"), band_rows=8,
                     mesh=mesh)
    banded = render_tiled(scene, band_rows=8, mesh=mesh)
    np.testing.assert_array_equal(
        banded, np.asarray(render_escape_sharded(scene, mesh)))


def test_fern_rejected():
    from fractal_tpu.config import scene_defaults

    with pytest.raises(ValueError, match="fern"):
        render_tiled(scene_defaults("fern"))


DEEP = Scene(width=48, height=36, iterations=200,
             pos=(-0.74364388703715871, 0.13182590420531198),
             scale=(1e15, 1e15))  # auto → perturbation (past the f64 wall)


def _assert_no_glitches(scene):
    """Bit-equality between banded and one-shot perturbation renders is the
    documented contract only for non-glitched pixels (multi-reference
    SECONDARY choice is glitch-set-local); these tests use a glitch-free
    view so full bit-equality is valid — pin that precondition so a future
    budget/tolerance tweak fails here with a clear message instead of a
    mysterious pixel diff."""
    import jax.numpy as jnp

    from fractal_tpu.ops import perturb as pt

    ss = scene.supersample
    h, w = scene.height * ss, scene.width * ss
    ref = pt.choose_reference(scene, w, h)
    orbit = pt.reference_orbit(scene, ref, w, h)
    P = pt._pert_params(scene, ref, w, h)
    _, _, _, gl = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=scene.iterations, height=h, width=w)
    assert int(np.asarray(gl).sum()) == 0, (
        "view now produces glitches: restrict the banded-vs-one-shot "
        "equality to non-glitched pixels (see render_perturb_band docstring)")


def test_tiled_perturbation_checkpoint_matches_one_shot(tmp_path):
    """Perturbation-depth renders band with persistence (r1 had none; r2
    initially only errored loudly): all bands share one reference orbit,
    glitches resolve in global coordinates, and the assembled image equals
    the one-shot render."""
    _assert_no_glitches(DEEP)
    one = np.asarray(render_u8(DEEP))
    d = str(tmp_path / "ck")
    banded = render_tiled(DEEP, band_rows=16, ckpt_dir=d)
    np.testing.assert_array_equal(banded, one)
    m = json.load(open(os.path.join(d, "manifest.json")))
    assert sorted(m["done"]) == [0, 1, 2]


def test_tiled_perturbation_resume_skips_done_bands(tmp_path):
    d = str(tmp_path / "ck")
    full = render_tiled(DEEP, band_rows=16, ckpt_dir=d)
    os.remove(os.path.join(d, "band_2.npy"))
    m = json.load(open(os.path.join(d, "manifest.json")))
    m["done"] = [0, 1]
    json.dump(m, open(os.path.join(d, "manifest.json"), "w"))
    poisoned = np.load(os.path.join(d, "band_0.npy"))
    poisoned[0, 0] = [9, 8, 7]
    np.save(os.path.join(d, "band_0.npy"), poisoned)
    resumed = render_tiled(DEEP, band_rows=16, ckpt_dir=d)
    assert tuple(resumed[0, 0]) == (9, 8, 7)       # loaded, not recomputed
    np.testing.assert_array_equal(resumed[16:], full[16:])


def test_tiled_perturbation_without_ckpt_uses_one_shot():
    # plain banded request (no persistence) renders via the perturbation
    # path's internal banding — same pixels, one program
    img = render_tiled(DEEP, 8, None)
    np.testing.assert_array_equal(img, np.asarray(render_u8(DEEP)))


def test_tiled_p32_fast_tier_bands(tmp_path):
    scene = DEEP.replace(precision="p32", supersample=2, height=32)
    one = np.asarray(render_u8(scene))
    banded = render_tiled(scene, band_rows=17,  # → 16 (ss-aligned)
                          ckpt_dir=str(tmp_path / "ck"))
    np.testing.assert_array_equal(banded, one)


def test_tiled_perturbation_rejects_unsupported_rule(tmp_path):
    """An explicit perturbation precision on a rule with no δ-recurrence
    (z^1 + c is affine; powers >= 2 are all covered since r3) must raise
    on the banded path exactly like the one-shot path — not silently
    render garbage."""
    scene = Scene(algo="julia", power=1, julia_set=(-0.8, 0.156), width=16,
                  height=12, iterations=50, scale=(0.8, 0.8),
                  precision="p32")
    with pytest.raises(ValueError, match="perturbation supports"):
        render_tiled(scene, 8, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="perturbation supports"):
        render_tiled(scene, 8, None)  # one-shot fall-through path too
