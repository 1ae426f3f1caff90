"""Escape-time kernel — the hot path of every f32/f64/ds32 render.

Re-design of the reference's per-pixel scalar loop (``recursive``,
calc/src/lib.rs:245-257) for the GPU.  One ``pallas_call`` through Pallas'
Triton route tiles the image into small 2-D blocks of pixels; each program:

  1. reconstructs its block's complex coordinates from ``broadcasted_iota``
     plus four scalars (c = x·A + C — the viewport transform
     calc/src/lib.rs:181-197 refactored into one multiply-add whose
     constants are computed exactly on the host, see ``viewport_affine``);
  2. iterates the whole block in lock-step with a freeze-on-escape mask
     (the data-parallel answer to the reference's per-pixel early return);
  3. leaves its chunked ``lax.while_loop`` once every pixel of the block has
     escaped or exhausted the budget — blocks far outside the set cost a
     handful of chunks while interior blocks burn the full budget.

z, |z|² and the count stay in registers for the whole iteration; device
memory sees only the 16 parameters and the three outputs.  XLA cannot
express the per-block exit: its whole-image twin (``iterate_whole_jnp``)
stops only when every pixel of the image is done and carries its state
through device memory on every chunk.

Three number representations share the scaffold:
  * ``f32``  — plain float32 (shallow zooms, scale·height ≲ 5e4);
  * ``f64``  — the same expressions at float64, which the GPU has in
    hardware (the reference's own semantics);
  * ``ds32`` — double-single float32 pairs (ops/dd.py), ~2⁻⁴⁸ relative
    precision, an explicit tier.

Grid edges: the outputs are allocated padded up to whole blocks and sliced
after the call; the padding pixels compute values nobody reads.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from fractal_tpu.ops import dd, route
from fractal_tpu.models.rules import get_rule

# Block shape of the escape-time kernel: Triton wants powers of two, and a
# block's state lives in registers (at most 255 per thread), so blocks are
# small — 16×32 pixels over 4 warps is 4 pixels a thread.  Small blocks
# also make the per-block exit track each neighbourhood's escape time.
TILE_H = 16
TILE_W = 32
NUM_WARPS = 4
# Iterations between all-done checks (statically unrolled in the kernel).
CHUNK = 16

# Periodicity (interior cycle) detection radius — squared.  Trade-off: the
# bigger it is, the sooner slowly-converging interior orbits are caught,
# but an exterior orbit passing within eps of periodic must not be able to
# escape within any realistic remaining budget (drift doubles per ~period).
# ds32 and f64: 1e-9 absolute — ~5 decades above the ds32 noise floor
# (~4e-15·|z|; f64's is lower still) so slowly-converging cycles are caught
# early; an exterior orbit that comes this close to periodic needs ≫10⁴ more
# iterations to escape, so within realistic budgets the classification
# matches exact iteration (the rare flips are creepers straddling the
# budget).
PERIOD_EPS_SQ_DS32 = 1e-18
PERIOD_EPS_SQ_F32 = 1e-12


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Host-side exact viewport constants
# ---------------------------------------------------------------------------


def viewport_affine(width: int, height: int, pos, scale,
                    dtype=np.float32) -> Tuple:
    """Refactor the reference transform  c = ((u/h) − off)/s + p  into
    c = u·A + C with A = 1/(h·s), C = p − off/s, computed in exact rational
    arithmetic on the host then split to double-word pairs of ``dtype``.

    Exactness matters: at 1e12× zoom the pixel spacing is below f64 epsilon
    relative to C, so A and C are built with Fractions and only *then*
    rounded — each constant is accurate to the full double-word precision.
    Returns ((A_re, C_re), (A_im, C_im)) as dd pairs.
    """
    out = []
    for axis, (p, s) in enumerate(zip(pos, scale)):
        off = Fraction(width, height * 2) if axis == 0 else Fraction(1, 2)
        a = Fraction(1) / (Fraction(height) * Fraction(float(s)))
        pf = p if isinstance(p, Fraction) else Fraction(float(p))
        c = pf - off / Fraction(float(s))
        out.append((_split_fraction(a, dtype), _split_fraction(c, dtype)))
    return tuple(out)


def _split_fraction(v: Fraction, dtype=np.float32) -> Tuple:
    hi = dtype(float(v))
    lo = dtype(float(v - Fraction(float(hi))))
    return hi, lo


# ---------------------------------------------------------------------------
# Number-representation adapters (shared kernel scaffold)
# ---------------------------------------------------------------------------


class _F32Rep:
    """One plain float per coordinate — f32, or f64 with f64 params."""

    @staticmethod
    def make_c(xx, yy, P):
        # P layout: [Ar_hi, Ar_lo, Cr_hi, Cr_lo, Ai_hi, Ai_lo, Ci_hi, Ci_lo]
        cr = xx * (P[0] + P[1]) + (P[2] + P[3])
        ci = yy * (P[4] + P[5]) + (P[6] + P[7])
        return cr, ci

    @staticmethod
    def to_z(c):
        return c

    @staticmethod
    def const(c_re, c_im, like):
        return (jnp.full_like(like[0], c_re), jnp.full_like(like[0], c_im))

    @staticmethod
    def step(rule, z, c):
        zr, zi = rule(z[0], z[1], c[0], c[1])
        return (zr, zi)

    @staticmethod
    def dist(z):
        return z[0] * z[0] + z[1] * z[1]

    @staticmethod
    def select(mask, a, b):
        return tuple(jnp.where(mask, x, y) for x, y in zip(a, b))

    @staticmethod
    def diff_dist(a, b):
        dr = a[0] - b[0]
        di = a[1] - b[1]
        return dr * dr + di * di

    @staticmethod
    def collapse(z):
        return z[0], z[1]


class _DS32Rep:
    """Double-single float32 pairs: z = ((zr_hi, zr_lo), (zi_hi, zi_lo))."""

    @staticmethod
    def make_c(xx, yy, P):
        Ar, Cr = (P[0], P[1]), (P[2], P[3])
        Ai, Ci = (P[4], P[5]), (P[6], P[7])
        cr = dd.add(dd.mul_f(Ar, xx), Cr)
        ci = dd.add(dd.mul_f(Ai, yy), Ci)
        return cr, ci

    @staticmethod
    def to_z(c):
        return c

    @staticmethod
    def const(c_re, c_im, like):
        zr_hi = like[0][0]
        f = lambda v: jnp.full_like(zr_hi, v)
        return ((f(c_re[0]), f(c_re[1])), (f(c_im[0]), f(c_im[1])))

    @staticmethod
    def dist(z):
        # Escape test only needs the hi words (threshold is ≥ 2, relative
        # error of hi-only sum ~2⁻²⁴ — never flips a test that matters).
        return z[0][0] * z[0][0] + z[1][0] * z[1][0]

    @staticmethod
    def select(mask, a, b):
        return tuple(
            tuple(jnp.where(mask, x, y) for x, y in zip(pa, pb))
            for pa, pb in zip(a, b)
        )

    @staticmethod
    def diff_dist(a, b):
        # full hi+lo difference: resolves below the ds32 noise floor
        dr = (a[0][0] - b[0][0]) + (a[0][1] - b[0][1])
        di = (a[1][0] - b[1][0]) + (a[1][1] - b[1][1])
        return dr * dr + di * di

    @staticmethod
    def collapse(z):
        return z[0][0] + z[0][1], z[1][0] + z[1][1]

    # -- dd iteration rules -------------------------------------------------

    @staticmethod
    def step(rule_name_power, z, c):
        name, power = rule_name_power
        zr, zi = z
        cr, ci = c
        if name in ("mandelbrot", "julia", "multibrot") and power == 2:
            nzr, nzi = dd.quad_step(zr, zi, cr, ci)
        elif name == "burningship":
            ar = dd.where(zr[0] < 0, dd.neg(zr), zr)
            ai = dd.where(zi[0] < 0, dd.neg(zi), zi)
            nzr, nzi = dd.quad_step(ar, ai, cr, ci)
        elif name == "tricorn":
            nzr, nzi = dd.quad_step(zr, zi, cr, ci, cross_sign=-1.0)
        elif name in ("mandelbrot", "julia", "multibrot"):
            wr, wi = zr, zi
            for _ in range(power - 1):
                nwr = dd.sub(dd.mul(wr, zr), dd.mul(wi, zi))
                nwi = dd.add(dd.mul(wr, zi), dd.mul(wi, zr))
                wr, wi = nwr, nwi
            nzr = dd.add(wr, cr)
            nzi = dd.add(wi, ci)
        else:
            raise ValueError(f"no ds32 rule for {name!r}")
        return nzr, nzi


# ---------------------------------------------------------------------------
# Kernel builder
# ---------------------------------------------------------------------------


def _any(mask):
    """``jnp.any`` as a max over int32: the Triton lowering has no
    ``reduce_or`` rule, and this form lowers on every route."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _iterate_tile(rep, rule, is_ds: bool, julia: bool, iterations: int,
                  chunk: int, xx, yy, P, periodicity: bool = False,
                  unroll: bool = True, eps_sq: float = PERIOD_EPS_SQ_F32):
    """Shared iteration scaffold: viewport → masked lock-step loop with
    chunked early exit.  Runs identically inside the Pallas kernel (xx/yy =
    block-local iota + block origin, chunk statically unrolled) and as the
    whole-image XLA twin (``unroll=False``: a rolled inner loop, since
    XLA's CPU backend compiles deeply unrolled bodies very slowly).

    ``periodicity=True`` adds Brent-style cycle detection: a snapshot of z
    is taken at power-of-two steps; a pixel whose orbit returns within
    ``eps_sq`` of the snapshot is interior — it can never escape within any
    realistic budget — and is frozen with cnt = iterations immediately
    instead of burning the rest of the budget.  Interior-heavy deep views
    get ~budget/detection-time speedups.  Only enabled when the caller
    knows the final z phase is irrelevant (scene.inside == False: interior
    renders black, calc/src/lib.rs:232-233); with inside shading the
    reference's secondary×|z_final|² depends on the exact phase at step
    `iterations`.
    """
    limit_sq = P[8]
    n_chunks = _cdiv(max(iterations, 1), chunk)
    shape = xx.shape

    c = rep.make_c(xx, yy, P[:8])
    z0 = rep.to_z(c)
    if julia:
        # c is constant; z starts at the pixel coordinate
        # (calc/src/lib.rs:208-212).
        if is_ds:
            c = rep.const((P[10], P[11]), (P[12], P[13]), z0)
        else:
            c = rep.const(P[10] + P[11], P[12] + P[13], z0)

    cnt0 = jnp.zeros(shape, jnp.int32)

    # The escape flag is NOT carried through the loop: it is re-derived
    # each step from the frozen state — a pixel is done iff its z froze
    # beyond the limit or its budget ran out.  z freezes at the escaped
    # value, so dist(z) > limit² is exactly "has escaped".  (Degenerate
    # case |z₀| > limit — a viewport wider than the 2¹⁶ escape radius —
    # freezes at cnt 0 without one update; the reference would take one
    # step first.  Unreachable with sane scales; documented divergence.)
    # The frozen-state distance is carried through the loop (recomputing
    # rep.dist(z) per step costs more than the one select to maintain it).
    def _active(d, cnt):
        return (d <= limit_sq) & (cnt < iterations)

    def one_step(n, state):
        z, snap, d, cnt = state
        active = _active(d, cnt)
        nz = rep.step(rule, z, c)
        nd = rep.dist(nz)
        esc_now = active & (nd > limit_sq)
        z = rep.select(active, nz, z)
        d = jnp.where(active, nd, d)
        cnt = cnt + (active & ~esc_now)
        if periodicity:
            per_now = active & ~esc_now & (rep.diff_dist(nz, snap) < eps_sq)
            cnt = jnp.where(per_now, iterations, cnt)
            # Brent schedule: snapshot at n = 1, 2, 4, 8, ... (n>=1)
            take = (n >= 1) & ((n & (n - 1)) == 0)
            snap = rep.select(jnp.broadcast_to(take & active, shape), z, snap)
        return z, snap, d, cnt

    def chunk_body(carry):
        state, k = carry
        n0 = k * chunk
        if unroll:
            for i in range(chunk):
                state = one_step(n0 + i, state)
        else:
            state = jax.lax.fori_loop(
                0, chunk, lambda i, s: one_step(n0 + i, s), state)
        return state, k + 1

    def chunk_cond(carry):
        (z, snap, d, cnt), k = carry
        return (k < n_chunks) & _any(_active(d, cnt))

    snap0 = z0 if periodicity else ()
    d0 = rep.dist(z0)
    (z, snap, d, cnt), _ = jax.lax.while_loop(
        chunk_cond, chunk_body, ((z0, snap0, d0, cnt0), jnp.int32(0))
    )
    zr, zi = rep.collapse(z)
    return zr, zi, cnt


def _rep_rule(algo: str, power: int, precision: str):
    """(rep, rule, is_ds, eps_sq, dtype) for a precision tier.

    _DS32Rep is dtype-polymorphic (ops/dd.py works on f32 and f64 words):
    "dd64" is the same double-word scaffold over f64 pairs (~2^-106), run
    by the whole-image twin.  "f64" is _F32Rep's expressions at f64."""
    is_ds = precision in ("ds32", "dd64")
    rep = _DS32Rep if is_ds else _F32Rep
    rule = (algo, power) if is_ds else get_rule(algo, power)
    # the periodicity radius sits above each representation's noise floor
    eps_sq = PERIOD_EPS_SQ_F32 if precision == "f32" else PERIOD_EPS_SQ_DS32
    dtype = jnp.float64 if precision in ("f64", "dd64") else jnp.float32
    return rep, rule, is_ds, eps_sq, dtype


def _build_kernel(algo: str, power: int, julia: bool, iterations: int,
                  precision: str, tile_h: int, tile_w: int, chunk: int,
                  periodicity: bool):
    rep, rule, is_ds, eps_sq, dt = _rep_rule(algo, power, precision)

    def kernel(params_ref, zr_ref, zi_ref, cnt_ref):
        # Pixel indices < 2^24 are exact in f32 (and in f64).
        y0 = pl.program_id(0) * tile_h
        x0 = pl.program_id(1) * tile_w
        yy = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0) + y0).astype(dt)
        xx = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1) + x0).astype(dt)
        P = [params_ref[i] for i in range(16)]
        # Row interleave (multi-device spatial DP): local row r maps to
        # global row r·stride + offset.  Integer-valued floats < 2^24 —
        # exact, so the sharded render is bit-identical to single-device.
        yy = yy * P[14] + P[15]
        zr, zi, cnt = _iterate_tile(
            rep, rule, is_ds, julia, iterations, chunk, xx, yy, P,
            periodicity=periodicity, eps_sq=eps_sq,
        )
        zr_ref[...] = zr
        zi_ref[...] = zi
        cnt_ref[...] = cnt

    return kernel


def iterate_whole_jnp(params, *, algo: str, power: int, iterations: int,
                      precision: str, height: int, width: int,
                      chunk: int = CHUNK, periodicity: bool = False):
    """Whole-image XLA twin of the kernel — identical math (same rep, same
    viewport affine), no Pallas: the production path off the GPU, the
    dd64 path everywhere, and the kernel's oracle in tests."""
    rep, rule, is_ds, eps_sq, dt = _rep_rule(algo, power, precision)
    yy = jax.lax.broadcasted_iota(dt, (height, width), 0)
    xx = jax.lax.broadcasted_iota(dt, (height, width), 1)
    P = [params[i] for i in range(16)]
    yy = yy * P[14] + P[15]  # global-row map for sharded stripes (see kernel)
    return _iterate_tile(
        rep, rule, is_ds, algo == "julia", iterations, chunk, xx, yy, P,
        periodicity=periodicity, unroll=False, eps_sq=eps_sq,
    )


def iterate_params(
    params,
    *,
    algo: str,
    power: int,
    iterations: int,
    precision: str,
    height: int,
    width: int,
    impl: str,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    chunk: int = CHUNK,
    periodicity: bool = False,
):
    """Traceable escape-time iteration of a (height, width) grid: everything
    scene-shaped is static, the 16 viewport/limit/julia scalars ride in
    ``params`` (built host-side by ``scene_params``).  Safe to call inside
    an outer jit.  Returns (zr, zi, cnt).

    ``impl`` (see ops/route.py): ``"triton"`` compiles the kernel for the
    GPU, ``"interpret"`` runs the same kernel through the Pallas
    interpreter (tests), ``"xla"`` runs the whole-image twin.  dd64 always
    runs the twin."""
    if impl not in route.IMPLS:
        raise ValueError(f"unknown implementation {impl!r}")
    if impl == route.XLA or precision == "dd64":
        return iterate_whole_jnp(
            params, algo=algo, power=power, iterations=iterations,
            precision=precision, height=height, width=width, chunk=chunk,
            periodicity=periodicity,
        )
    dt = jnp.float64 if precision == "f64" else jnp.float32
    kernel = _build_kernel(
        algo, power, algo == "julia", iterations, precision, tile_h, tile_w,
        chunk, periodicity,
    )
    # outputs padded to whole blocks (Triton stores are unmasked)
    gh, gw = _cdiv(height, tile_h), _cdiv(width, tile_w)
    hp, wp = gh * tile_h, gw * tile_w
    block = pl.BlockSpec((tile_h, tile_w), lambda i, j: (i, j))
    zr, zi, cnt = pl.pallas_call(
        kernel,
        grid=(gh, gw),
        in_specs=[pl.BlockSpec((16,), lambda i, j: (0,))],
        out_specs=(block, block, block),
        out_shape=(jax.ShapeDtypeStruct((hp, wp), dt),
                   jax.ShapeDtypeStruct((hp, wp), dt),
                   jax.ShapeDtypeStruct((hp, wp), jnp.int32)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=impl == route.INTERPRET,
        name="escape_time",
    )(params.astype(dt))
    return zr[:height, :width], zi[:height, :width], cnt[:height, :width]


def scene_params(scene, height: int = None, width: int = None,
                 dtype=jnp.float32) -> jnp.ndarray:
    """Host-side (concrete Scene) → the [16] scalar block the kernel
    consumes.  Layout:
      [0:8]   viewport affine dd pairs (A_re, C_re, A_im, C_im)
      [8]     limit²  (escape threshold on squared distance, calc:246-251)
      [9]     spare
      [10:14] julia c as dd pairs (re_hi, re_lo, im_hi, im_lo)
      [14:16] global-row map (stride, offset): device-local row r is global
              row r·stride + offset — identity (1, 0) for single-device,
              (n_devices, device_index) for row-interleaved sharding.
    """
    ss = scene.supersample
    height = height if height is not None else scene.height * ss
    width = width if width is not None else scene.width * ss
    from fractal_tpu.config import exact_pos

    np_dt = np.float64 if dtype == jnp.float64 else np.float32
    (Ar, Cr), (Ai, Ci) = viewport_affine(width, height, exact_pos(scene),
                                         scene.scale, np_dt)
    julia = scene.algo == "julia"
    jr = dd.split_str(repr(float(scene.julia_set[0])), dtype) if julia else (0.0, 0.0)
    ji = dd.split_str(repr(float(scene.julia_set[1])), dtype) if julia else (0.0, 0.0)
    limit_sq = np_dt(float(scene.limit)) ** 2
    return jnp.asarray(
        [Ar[0], Ar[1], Cr[0], Cr[1], Ai[0], Ai[1], Ci[0], Ci[1],
         limit_sq, 0.0, jr[0], jr[1], ji[0], ji[1], 1.0, 0.0],
        dtype,
    )
