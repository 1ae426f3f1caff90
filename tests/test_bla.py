"""BLA (bilinear approximation) tests — ops/bla.py + the macro-step loop.

Correctness contract: a valid table entry (A, B, r) applied to any |δz| < r
reproduces 2^k full nonlinear steps to ~EPS relative error, and the
BLA-accelerated render must agree with the plain perturbation loop on
well-conditioned pixels exactly (counts are integers; sub-EPS phase error
cannot flip a well-conditioned escape test).
"""

import numpy as np

import jax
import jax.numpy as jnp

from fractal_tpu.config import Scene
from fractal_tpu.ops import perturb as pt
from fractal_tpu.ops.bla import EPS, build_table


def _orbit_f64(c, n):
    zs = np.empty((n + 1, 2))
    zr, zi = c.real, c.imag
    zs[0] = (zr, zi)
    for i in range(1, n + 1):
        zr, zi = zr * zr - zi * zi + c.real, 2 * zr * zi + c.imag
        zs[i] = (zr, zi)
    return zs


def test_table_composition_matches_step_products():
    c = complex(-0.158, 1.033)  # period-3-ish interior: bounded orbit
    n = 256
    zs = _orbit_f64(c, n)
    t = build_table(zs.astype(np.float32), n, n, dc_max=1e-12, min_level=2)
    # level-2 entry j must equal the composition of 4 level-0 maps
    for j in (0, 3, 17):
        A = complex(1, 0)
        B = complex(0, 0)
        for i in range(4 * j, 4 * j + 4):
            A0 = 2 * complex(zs[i, 0], zs[i, 1])
            A, B = A0 * A, A0 * B + 1
        row = t.packed[t.offsets[0] + j]
        got_A = complex(row[0], row[1])
        got_B = complex(row[2], row[3])
        assert abs(got_A - A) <= 1e-5 * abs(A) + 1e-30
        assert abs(got_B - B) <= 1e-5 * abs(B) + 1e-30


def test_skip_matches_full_steps_within_radius():
    c = complex(-0.158, 1.033)
    n = 256
    zs = _orbit_f64(c, n)
    t = build_table(zs.astype(np.float32), n, n, dc_max=0.0, min_level=3)
    lev = 1  # level 4: 16 steps
    row = t.packed[t.offsets[lev] + 0]
    A = complex(row[0], row[1])
    r2 = row[4]
    assert r2 > 0
    dz = complex(np.sqrt(r2) * 0.5, 0.0)
    # full nonlinear recurrence, dc = 0
    w = dz
    for i in range(16):
        w = 2 * complex(zs[i, 0], zs[i, 1]) * w + w * w
    approx = A * dz
    assert abs(approx - w) <= 64 * EPS * abs(w)


def _counts_plain(scene, h, w):
    ref_px = pt.choose_reference(scene, w, h)
    orbit = pt.reference_orbit(scene, ref_px, w, h)
    P = pt._pert_params(scene, ref_px, w, h)
    _, _, cnt, gl = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=scene.iterations, height=h, width=w)
    return np.asarray(cnt), np.asarray(gl), ref_px, orbit, P


def test_bla_render_matches_plain_loop_needle():
    scene = Scene(width=64, height=48, iterations=300,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16))
    h, w = 48, 64
    cnt0, gl0, ref_px, orbit, P = _counts_plain(scene, h, w)
    bla = pt._bla_for(scene, orbit, ref_px, w, h)
    _, _, cnt1, gl1 = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=300, height=h, width=w,
        bla_packed=jnp.asarray(bla.packed), bla_offsets=bla.offsets)
    cnt1, gl1 = np.asarray(cnt1), np.asarray(gl1)
    np.testing.assert_array_equal(cnt1, cnt0)
    np.testing.assert_array_equal(gl1, gl0)


def test_bla_render_interior_view():
    """All-interior deep view: BLA skips nearly the whole budget and must
    still report every pixel unescaped with cnt == iterations."""
    scene = Scene(width=32, height=24, iterations=2000,
                  pos=(-0.74364388703715871, 0.13182590420531198),
                  scale=(1e15, 1e15))
    h, w = 24, 32
    cnt0, gl0, ref_px, orbit, P = _counts_plain(scene, h, w)
    bla = pt._bla_for(scene, orbit, ref_px, w, h)
    _, _, cnt1, gl1 = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=2000, height=h, width=w,
        bla_packed=jnp.asarray(bla.packed), bla_offsets=bla.offsets)
    cnt1 = np.asarray(cnt1)
    # plain and BLA agree except possibly in the ill-conditioned band
    agree = (cnt1 == cnt0) | (cnt0 > 500)
    assert agree.mean() > 0.995, (cnt0[~agree], cnt1[~agree])
    # interior classification identical
    np.testing.assert_array_equal(cnt1 == 2000, cnt0 == 2000)


def test_bla_small_iterations_no_levels():
    """iterations < the smallest stored skip: table is a dead placeholder
    and the loop must behave exactly like the plain one."""
    scene = Scene(width=32, height=24, iterations=40,
                  pos=(-2.0, 0.0), scale=(1e16, 1e16))
    h, w = 24, 32
    cnt0, gl0, ref_px, orbit, P = _counts_plain(scene, h, w)
    bla = pt._bla_for(scene, orbit, ref_px, w, h)
    _, _, cnt1, _ = pt.perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=40, height=h, width=w,
        bla_packed=jnp.asarray(bla.packed), bla_offsets=bla.offsets)
    np.testing.assert_array_equal(np.asarray(cnt1), cnt0)


# A deep minibrot-adjacent center (found by iterative max-count recentering
# to 1e41; the orbit contracts near the minibrot cycle, so deep BLA merge
# levels stay valid — the regime the extreme-depth table exists for).
MINIBROT_1E40_X = "-157996253097964571301972830522288002021514947629178379711098185808257073039470695158211500112900838145522465809142611009023639565445383101084883134484682610353514940624481200762246007439/212462249541855969823564443888867658718504667147683695179167999373230694241283933429894861838275817718252008213801240896439140775510819546312539219637043200000000000000000000000000000000"
MINIBROT_1E40_Y = "28008028155349122668929932079246027544335248782475580605078491147016246379854728339564574920280759962068701281864864148011241416251870231103204751712607560043470776143225258105876903281/212462249541855969823564443888867658718504667147683695179167999373230694241283933429894861838275817718252008213801240896439140775510819546312539219637043200000000000000000000000000000000"


def test_fe_table_deep_levels_and_render_counts_preserved():
    """Extreme-depth BLA: at a contracting (minibrot)
    1e40x view the extended-exponent table must carry valid DEEP merge
    levels, and the BLA-accelerated fe render must preserve counts and
    glitch flags bit-exactly vs the plain fe loop."""
    from fractal_tpu.ops import perturb as pt
    from fractal_tpu.ops.bla import build_table_fe

    sc = Scene(width=48, height=32, iterations=512,
               pos_str=(MINIBROT_1E40_X, MINIBROT_1E40_Y),
               scale=(1e40, 1e40), inside=False)
    assert pt._is_extreme(sc)
    w, h = sc.width, sc.height
    ref, orbit = pt.resolve_reference(sc, w, h)
    assert orbit.n_steps >= 512
    P = pt._pert_params_fe(sc, ref, w, h)
    ns = jnp.int32(orbit.n_steps)
    packed = jnp.asarray(orbit.packed)
    assert pt._fe_bla_useful(sc, orbit, ref, w, h)
    bla_packed, bla_offsets = pt._bla_dev_for(sc, orbit, ref, w, h, fe=True)
    tbl = np.asarray(bla_packed)
    offs = list(bla_offsets) + [tbl.shape[0]]
    valid = [int((tbl[offs[i]:offs[i + 1], 6] > 0).sum())
             for i in range(len(bla_offsets))]
    assert valid[-1] >= 1, valid  # the deepest level has a valid merge
    plain = pt.perturb_whole_jnp(packed, P, ns, iterations=512, height=h,
                                 width=w, chunk=pt.PERT_CHUNK_CPU,
                                 extreme=True)
    bla = pt.perturb_whole_jnp(packed, P, ns, iterations=512, height=h,
                               width=w, chunk=pt.PERT_CHUNK_CPU,
                               extreme=True, bla_packed=bla_packed,
                               bla_offsets=bla_offsets)
    np.testing.assert_array_equal(np.asarray(plain[2]), np.asarray(bla[2]))
    np.testing.assert_array_equal(np.asarray(plain[3]), np.asarray(bla[3]))


def test_fe_bla_useless_on_needle_views():
    """On the maximally-expanding needle orbit (|2Z| ~ 4 per step) no merge
    radius survives at ANY depth — the gate must keep the BLA macro loop
    off (its skip-scan overhead would only cost)."""
    from fractal_tpu.ops import perturb as pt

    sc = Scene(width=24, height=16, iterations=300,
               pos_str=("-1.99999999999999999999999999999999999999999999"
                        "1", "0.0"),
               scale=(1e44, 1e44))
    w, h = sc.width, sc.height
    ref, orbit = pt.resolve_reference(sc, w, h)
    assert not pt._fe_bla_useful(sc, orbit, ref, w, h)


def test_build_table_fe_matches_f64_composition():
    """The (mantissa, exponent) merge arithmetic must reproduce the f64
    table's A/B values where both are representable (moderate orbit, no
    over/underflow)."""
    from fractal_tpu.ops.bla import build_table, build_table_fe

    c = complex(-0.158, 1.033)
    n = 256
    zs = _orbit_f64(c, n)
    t64 = build_table(zs.astype(np.float32), n, n, dc_max=1e-12, min_level=2)
    tfe = build_table_fe(zs.astype(np.float32), n, n, dc_max=1e-12,
                         min_level=2)
    assert tfe.offsets == t64.offsets
    for lev in range(len(t64.offsets)):
        off = t64.offsets[lev]
        end = (t64.offsets[lev + 1] if lev + 1 < len(t64.offsets)
               else t64.packed.shape[0])
        for j in range(off, min(end, off + 8)):
            r64 = t64.packed[j]
            rfe = tfe.packed[j]
            Ar = np.ldexp(np.float64(rfe[0]), int(rfe[2]))
            Ai = np.ldexp(np.float64(rfe[1]), int(rfe[2]))
            if abs(r64[0]) < 3e38 and r64[4] > 0:  # unclamped + valid
                np.testing.assert_allclose([Ar, Ai], r64[:2], rtol=1e-6)
                r2 = np.ldexp(np.float64(rfe[6]), int(rfe[7]))
                np.testing.assert_allclose(r2, r64[4], rtol=1e-5)
