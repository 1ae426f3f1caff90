"""The escape-time kernel through the Pallas interpreter, the platform
decision, and the host-side pieces the GPU path relies on: the compile
cache location, the exact Fraction → raw-mpf conversion that feeds the
native orbit walker, the PNG writer, and the GPU-only entry points
refusing to measure anything else.

Kernels compiled for the card are checked by ``chip_smoke.py`` on the GPU;
the test marked ``gpu`` below runs only there.
"""

import os
import random
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fractal_tpu.config import Scene
from fractal_tpu.ops import route
from fractal_tpu.ops.escape_pallas import iterate_params, scene_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALGOS = {
    "mandelbrot": {},
    "julia": {"julia_set": (-0.8, 0.156)},
    "burningship": {},
    "tricorn": {},
    "multibrot": {"power": 3},
}


@pytest.mark.parametrize("precision", ["f32", "f64", "ds32"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_escape_kernel_interpret_matches_twin(algo, precision):
    """The escape-time kernel (Pallas interpreter, padded 16×32 blocks with
    per-block exit) computes what the whole-image twin computes.  Counts
    are bit-equal everywhere; so are f32/f64 final values.  ds32 final
    values may differ in the last bits: XLA:CPU contracts the unrolled
    kernel body and the rolled twin loop into FMAs differently, and the
    orbit amplifies that until escape (burning ship: ~1e-3 relative)."""
    sc = Scene(algo=algo, width=40, height=24, iterations=48,
               pos=(-0.6, 0.0), scale=(0.4, 0.4), **ALGOS[algo])
    dt = jnp.float64 if precision == "f64" else jnp.float32
    params = scene_params(sc, dtype=dt)

    def run(impl):
        return [np.asarray(a) for a in jax.jit(lambda p: iterate_params(
            p, algo=algo, power=sc.power, iterations=sc.iterations,
            precision=precision, height=sc.height, width=sc.width,
            impl=impl, chunk=4, periodicity=True))(params)]

    twin, kern = run(route.XLA), run(route.INTERPRET)
    np.testing.assert_array_equal(kern[2], twin[2])
    assert len(np.unique(twin[2])) > 5  # a structured view
    for a, b in zip(kern[:2], twin[:2]):
        assert a.shape == (24, 40)
        if precision == "ds32":
            np.testing.assert_allclose(a, b, rtol=1e-2)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("platform,impl", [
    ("cpu", route.XLA), ("gpu", route.TRITON), ("metal", route.XLA),
])
def test_kernel_impl_by_platform(platform, impl, monkeypatch):
    """One platform decision: the Triton kernels on the GPU, the XLA twins
    everywhere else (the CPU, or any other accelerator backend); a forced
    kernel off the GPU is the interpreter."""
    monkeypatch.setattr(route.jax, "default_backend", lambda: platform)
    assert route.kernel_impl() == impl
    assert route.forced_kernel_impl(None) == impl
    assert route.forced_kernel_impl(False) == route.XLA
    assert route.forced_kernel_impl(True) == (
        route.TRITON if platform == "gpu" else route.INTERPRET)


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_auto_precision_is_f64_on_gpu_and_cpu(platform, monkeypatch):
    """'auto' resolves a mid-depth view to f64 on both platforms (the
    reference's semantics, in hardware on each), f32 above and
    perturbation below it."""
    from fractal_tpu.render import escape_impl, resolve_precision

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    head = Scene(width=3000, height=3000, iterations=4000,
                 pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6))
    assert resolve_precision(head) == "f64"
    assert resolve_precision(head.replace(scale=(0.4, 0.4))) == "f32"
    assert resolve_precision(
        head.replace(scale=(1e12, 1e12))) == "perturb"
    assert escape_impl("f64") == (
        route.TRITON if platform == "gpu" else route.XLA)
    assert escape_impl("dd64") == route.XLA


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    from fractal_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    set_to = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_to.__setitem__(k, v))
    compile_cache.enable()
    assert set_to["jax_compilation_cache_dir"] == os.path.join(
        REPO, ".jax_cache")
    assert os.path.isdir(compile_cache.CACHE_DIR)


def test_compile_cache_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    from fractal_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    set_to = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: set_to.__setitem__(k, v))
    compile_cache.enable()
    assert set_to == {}


@pytest.mark.parametrize("digits", [20, 45, 125, 320])
def test_fraction_to_raw_mpf_matches_mpmath(digits):
    """The walker's inputs are built from exact Fractions with integer
    arithmetic, bit-identical to mpmath's mpf(num) / den at workdps."""
    import mpmath as mp

    from fractal_tpu.ops.native_walk import dps_to_prec, mpf_from_fraction

    rng = random.Random(digits)
    with mp.workdps(digits):
        prec = mp.mp.prec
        assert dps_to_prec(digits) == prec
        cases = [Fraction(0), Fraction(-3, 4), Fraction(0.156),
                 Fraction(10 ** digits + 1, 3 ** 40)]
        cases += [Fraction(rng.randint(-10 ** (digits + 4),
                                       10 ** (digits + 4)),
                           rng.randint(1, 10 ** (digits + 2)))
                  for _ in range(200)]
        for f in cases:
            want = (mp.mpf(f.numerator) / f.denominator)._mpf_
            assert mpf_from_fraction(f, prec) == tuple(want), f


def test_png_writer_round_trip(tmp_path):
    """PNG output needs only numpy and zlib: the written file decodes to
    the same pixels (Pillow as an independent decoder, and the reader
    chip_smoke.py uses)."""
    from PIL import Image

    sys.path.insert(0, REPO)
    import chip_smoke

    from fractal_tpu.io.image_out import png_bytes

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(png_bytes(img))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(chip_smoke.read_png(str(path)), img)
    with pytest.raises(ValueError, match="uint8"):
        png_bytes(img.astype(np.float32))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_cpu(script):
    """Neither script measures anything but the GPU: on a CPU backend each
    exits non-zero without printing a result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "GPU" in r.stderr


def test_chip_smoke_mesh_phase_on_virtual_devices():
    """The four-card phase of chip_smoke.py, at tiny sizes on four of the
    CPU backend's virtual devices: every sharded output lands on all four
    and equals the single-device render."""
    sys.path.insert(0, REPO)
    import chip_smoke

    from fractal_tpu.config import scene_defaults

    head = Scene(width=64, height=48, iterations=200,
                 pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                 exposure=5.0, inside=False)
    chip_smoke.mesh_phase(4, {
        "escape": head,
        "fern": scene_defaults("fern").replace(width=48, height=32,
                                               iterations=20_000),
        "deep": head.replace(scale=(1e12, 1e12),
                             pos=(-0.74364388703715871,
                                  0.13182590420531198)),
        "sweep": Scene(width=32, height=24, iterations=300,
                       pos=(-0.74364388703715871, 0.13182590420531198),
                       scale=(1e12, 1e12), inside=False),
    })


@pytest.mark.gpu
def test_kernels_compiled_for_gpu_match_twins():
    """On the card: the Triton-compiled escape-time and δ-orbit kernels
    against their twins on the same card (chip_smoke.py runs the full-size
    version of this)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernels compile only there")
    from fractal_tpu.ops import perturb as pt

    sc = Scene(width=256, height=192, iterations=500,
               pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
               inside=False)
    p = scene_params(sc, dtype=jnp.float64)
    got = [iterate_params(p, algo="mandelbrot", power=2, iterations=500,
                          precision="f64", height=192, width=256, impl=impl)
           for impl in (route.TRITON, route.XLA)]
    np.testing.assert_array_equal(np.asarray(got[0][2]),
                                  np.asarray(got[1][2]))
    deep = sc.replace(scale=(1e12, 1e12),
                      pos=(-0.74364388703715871, 0.13182590420531198))
    ref, orbit = pt.resolve_reference(deep, 256, 192)
    P = pt._pert_params(deep, ref, 256, 192, orbit=orbit)
    args = (jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps))
    kern = pt.perturb_kernel(*args, iterations=500, height=192, width=256)
    twin = pt.perturb_whole_jnp(*args, iterations=500, height=192,
                                width=256, chunk=pt.PERT_CHUNK)
    agree = (np.asarray(kern[2]) < 500) == (np.asarray(twin[2]) < 500)
    assert agree.mean() >= 0.999
