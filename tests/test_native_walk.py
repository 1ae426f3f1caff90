"""Native high-precision orbit walker (native/orbitwalk.cpp) must be
BIT-IDENTICAL to the mpmath loops it replaces — both the reference-orbit
walk (perturb.py::reference_orbit, row-for-row f64 equality incl. the
break index) and the direct per-pixel resolve (perturb.py::
_direct_resolve, mpf-exact escape test, escaping step not counted).

The oracle here is the literal Python/mpmath loop, not an abstraction:
any rounding divergence (nearest-even ties, mpf_add's perturbation
shortcut, mpc_square's exact-product subtraction) shows up as a hard
array mismatch.  If these tests fail after an mpmath upgrade, the C++
side needs re-syncing to mpmath's libmpf semantics.
"""

import random

import mpmath as mp
import numpy as np
import pytest

from fractal_tpu.ops import native_walk
from fractal_tpu.ops.perturb import _host_step

pytestmark = pytest.mark.skipif(not native_walk.available(),
                                reason="liborbitwalk.so not built")


def _py_walk(algo, power, z0, c, iters, limit_sq):
    """The exact mpmath loop from reference_orbit (perturb.py)."""
    step = _host_step(algo, power)
    zs = np.empty((iters + 1, 2), np.float64)
    z = z0
    n = 0
    zs[0] = (float(z.real), float(z.imag))
    while n < iters:
        z = step(z, c)
        n += 1
        zs[n] = (float(z.real), float(z.imag))
        if zs[n, 0] ** 2 + zs[n, 1] ** 2 > limit_sq:
            break
    return zs, n


def _py_direct(algo, power, z0, c, iters, limit_sq):
    """The exact mpmath loop from _direct_resolve (perturb.py)."""
    step = _host_step(algo, power)
    z = z0
    n = 0
    while n < iters:
        z2 = step(z, c)
        if z2.real * z2.real + z2.imag * z2.imag > limit_sq:
            z = z2
            break
        z = z2
        n += 1
    return float(z.real), float(z.imag), n


def _deep_point(rng, digits):
    """Boundary-adjacent point with a full-precision mantissa tail so the
    low limbs (and every rounding path) are exercised."""
    xr = mp.mpf(rng.uniform(-1.75, 0.5)) \
        + mp.mpf(rng.randint(1, 1000)) / mp.mpf(10) ** (digits - 5)
    xi = mp.mpf(rng.uniform(-1.2, 1.2)) \
        + mp.mpf(rng.randint(1, 1000)) / mp.mpf(10) ** (digits - 5)
    return mp.mpc(xr, xi)


@pytest.mark.parametrize("algo,power", [
    ("mandelbrot", 2), ("julia", 2), ("multibrot", 3), ("multibrot", 5),
    ("burningship", 2), ("tricorn", 2),
])
@pytest.mark.parametrize("digits", [25, 45, 125])
def test_walk_bit_identical_to_mpmath(algo, power, digits):
    rng = random.Random(digits * 1000 + power)
    with mp.workdps(digits):
        prec = mp.mp.prec
        for _ in range(3):
            z0 = _deep_point(rng, digits)
            c = mp.mpc(mp.mpf(-0.8), mp.mpf(0.156)) if algo == "julia" \
                else z0
            ref_zs, ref_n = _py_walk(algo, power, z0, c, 400, 4.0)
            got = native_walk.walk(algo, power, prec, z0._mpc_, c._mpc_,
                                   400, 4.0)
            assert got is not None
            zs, n = got
            assert n == ref_n
            np.testing.assert_array_equal(ref_zs[: ref_n + 1],
                                          zs[: n + 1])


def test_walk_long_interior_orbit_bit_identical():
    """Non-escaping orbit: every one of 5000 steps must match (chaotic
    amplification turns a single one-ulp divergence into a macroscopic
    mismatch within ~50 steps — this is the strongest equivalence test)."""
    with mp.workdps(80):
        prec = mp.mp.prec
        z0 = mp.mpc(mp.mpf("-0.1226") + mp.mpf(1) / mp.mpf(10) ** 72,
                    mp.mpf("0.7449") + mp.mpf(3) / mp.mpf(10) ** 72)
        ref_zs, ref_n = _py_walk("mandelbrot", 2, z0, z0, 5000, 4.0)
        assert ref_n == 5000  # stayed interior
        zs, n = native_walk.walk("mandelbrot", 2, prec, z0._mpc_,
                                 z0._mpc_, 5000, 4.0)
        assert n == ref_n
        np.testing.assert_array_equal(ref_zs, zs)


def test_walk_real_axis_special_case():
    """b == 0 exactly: mpc_pow_int short-circuits to mpf_pow_int(a, 2) —
    the layout of every y=0 extreme-depth view (e.g. the 1e44 recipe)."""
    with mp.workdps(60):
        prec = mp.mp.prec
        z0 = mp.mpc(
            mp.mpf("-1.9999999999999999999999999999999999999999999"),
            mp.mpf(0))
        ref_zs, ref_n = _py_walk("mandelbrot", 2, z0, z0, 500, 4.0)
        zs, n = native_walk.walk("mandelbrot", 2, prec, z0._mpc_,
                                 z0._mpc_, 500, 4.0)
        assert n == ref_n
        np.testing.assert_array_equal(ref_zs[: ref_n + 1], zs[: n + 1])


def test_walk_zpow_axis_exact_path():
    """d >= 3 with a component exactly zero: mpmath takes mpf_pow_int,
    whose exact route (bc*n < 1000) the walker replicates — real-axis
    multibrot walks run natively at moderate precision."""
    with mp.workdps(60):  # ~203 bits * 3 < 1000: exact path
        prec = mp.mp.prec
        z0 = mp.mpc(mp.mpf("-1.2599210498948731647672106072782"),
                    mp.mpf(0))
        ref_zs, ref_n = _py_walk("multibrot", 3, z0, z0, 200, 4.0)
        got = native_walk.walk("multibrot", 3, prec, z0._mpc_, z0._mpc_,
                               200, 4.0)
        assert got is not None
        zs, n = got
        assert n == ref_n
        np.testing.assert_array_equal(ref_zs[: ref_n + 1], zs[: n + 1])


def test_walk_zpow_axis_high_prec_falls_back():
    """Past bc*n >= 1000 mpf_pow_int switches to its directed-rounding
    ladder (not replicated) — the walker must decline (the caller then
    stops with a clear error)."""
    with mp.workdps(150):  # ~500 bits * 3 >= 1000: ladder path
        prec = mp.mp.prec
        tail = mp.mpf(1) / mp.mpf(10) ** 140
        z0 = mp.mpc(mp.mpf("-1.5") + tail, mp.mpf(0))
        assert native_walk.walk("multibrot", 3, prec, z0._mpc_,
                                z0._mpc_, 100,
                                4.0) is None


def test_direct_bit_identical_to_mpmath():
    """_direct_resolve semantics: exact mpf escape comparison, z frozen at
    its first beyond-limit value, escaping step not counted."""
    rng = random.Random(11)
    for algo, power in (("mandelbrot", 2), ("burningship", 2),
                        ("tricorn", 2), ("multibrot", 3)):
        with mp.workdps(45):
            prec = mp.mp.prec
            for _ in range(4):
                z0 = _deep_point(rng, 45)
                ref = _py_direct(algo, power, z0, z0, 300, 4.0)
                got = native_walk.direct(algo, power, prec, z0._mpc_,
                                         z0._mpc_, 300,
                                         4.0)
                assert got is not None
                assert got == ref


def test_reference_orbit_uses_native_walker_bit_stable():
    """End-to-end: reference_orbit's packed table at a high-precision depth
    (inputs built from exact Fractions, walked natively) is identical to
    the table the mpmath loop produces from the same exact coordinates, so
    cached orbits and every downstream bit-equality contract hold."""
    from fractions import Fraction

    from fractal_tpu.config import Scene, exact_pos
    from fractal_tpu.ops import perturb as pt

    sc = Scene(width=32, height=24, iterations=600,
               pos_str=("-0.74364388703715871", "0.13182590420531198"),
               scale=(1e15, 1e15))
    w, h = sc.width, sc.height
    ref_px = (w // 2, h // 2)
    pt._ORBIT_CACHE.clear()
    pt._C_ORBIT_CACHE.clear()
    nat = pt.reference_orbit(sc, ref_px, w, h)
    pt._ORBIT_CACHE.clear()
    pt._C_ORBIT_CACHE.clear()

    (Ar, Cr), (Ai, Ci) = pt._affine_fractions(w, h, exact_pos(sc), sc.scale)
    c0r, c0i = Ar * ref_px[0] + Cr, Ai * ref_px[1] + Ci
    spacing = sc.pixel_spacing / sc.supersample
    with mp.workdps(pt._walk_digits(spacing)):
        z0 = mp.mpc(mp.mpf(c0r.numerator) / c0r.denominator,
                    mp.mpf(c0i.numerator) / c0i.denominator)
        zs, n = _py_walk("mandelbrot", 2, z0, z0, sc.iterations,
                         float(sc.limit) ** 2)
    assert nat.n_steps == n
    z32 = zs[: n + 1].astype(np.float32)
    np.testing.assert_array_equal(nat.packed[:n, 0:2], z32[:n])
    np.testing.assert_array_equal(nat.packed[:n, 2:4], z32[1:n + 1])
    assert isinstance(c0r, Fraction)
