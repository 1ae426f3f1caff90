"""Perturbation rendering — the deep-zoom decomposition (SURVEY.md §2 C10).

The reference's GPU port stalled on precision (reference README.md:20-22:
f32 breaks past ~1e4× zoom, and f64 runs out near 1e13×).  Perturbation
is the established fix: compute ONE reference orbit ``Z_{n+1} = Z_n² + c0``
in high precision on the host, then iterate only the per-pixel *delta*
``δz`` on the device in plain f32:

    δz' = 2·Z_n·δz + δz² + δc          (Mandelbrot; Julia drops the +δc)
    z    = Z_{n+1} + δz'               (escape test on the full value)

δc = (u − u₀)·A is tiny (pixel offsets × pixel spacing), so f32 holds it
to ~1e-38 — good for zooms past 1e30, far beyond the f64 wall.  Per-step
cost is ~14 f32 flops: this is both the precision *and* the speed path for
deep zooms.

Glitch handling: pixels whose δz dynamics lose precision (the Pauldelbrot
criterion: |z| ≪ |Z|) or that outlive the reference orbit are flagged and
re-rendered exactly with the ds32 kernel as a sparse 1-D fallback pass —
typically a handful of pixels near minibrots.

Reference-point selection: the view center if its orbit survives the full
budget; otherwise the max-iteration-count pixel of a coarse ds32 probe
render.  The orbit itself is computed from the *exact rational* pixel
coordinate (Fraction arithmetic), in f64 for zooms ≲1e13 and by the native
arbitrary-precision walker (ops/native_walk.py) above.
"""

from __future__ import annotations

import functools
import math
import time
from fractions import Fraction
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from fractal_tpu.config import exact_pos
from fractal_tpu.models.rules import POWER_ALGOS, eff_power, perturb_supported
from fractal_tpu.ops import route
from fractal_tpu.ops.escape_pallas import (
    CHUNK,
    _cdiv,
    _iterate_tile,
    _rep_rule,
    scene_params,
)

_BLA_FE_DEBUG = False  # trace-time macro-step tracing (tests only)
GLITCH_TOL_SQ = 1e-6  # Pauldelbrot: glitched when |z|² < τ²·|Z|², τ=1e-3

# Per-render observability: the most recent render's
# glitch-pixel count and the residual count of pixels no reference resolved.
# The cold-frame host resolve finishes every residual exactly (no
# best-effort path), so n_residual is 0 there by construction; the
# device-resident warm path can still report a transient nonzero (it then
# escalates to the host resolve).  Consumed by --profile and the viewer
# status line; reset at each perturbation render.
RENDER_STATS = {"n_glitch": 0, "n_residual": 0, "tier": ""}

# Early-exit check interval of the δ-orbit XLA twin: its while loop
# round-trips the (6-array) state through device memory once per chunk, so
# on an accelerator the chunk is deep; the CPU backend keeps a shallow
# unroll (XLA:LLVM compiles deep unrolls very slowly).
PERT_CHUNK = 64
PERT_CHUNK_CPU = 16
# orbit tables are padded past the budget by the largest chunk ANY path
# uses, so every chunked loader's clamped block read stays in bounds
ORBIT_PAD = max(CHUNK, PERT_CHUNK)

# Zooms this deep need more than f64 for the host reference orbit
# (pixel spacing < ~1e-13 ⇒ orbit must resolve finer structure).
F64_ORBIT_SPACING_LIMIT = 1e-13

# Below this spacing the per-pixel δ quantities leave f32's exponent range
# (subnormals flush near 1e-38; keep margin for the affine gain and early
# δz² products) and the δ-orbit switches to the floatexp tile
# (ops/floatexp.py): f32-grade mantissas with 32-bit exponents — zoom
# depth is then bounded only by the f64 host affine (≈1e300).
EXTREME_SPACING_LIMIT = 1e-30


def _is_extreme(scene) -> bool:
    return scene.pixel_spacing / scene.supersample < EXTREME_SPACING_LIMIT


# ---------------------------------------------------------------------------
# Host side: exact viewport rationals + high-precision reference orbit
# ---------------------------------------------------------------------------


def _affine_fractions(width: int, height: int, pos, scale):
    """The viewport transform c = u·A + C as exact rationals per axis
    (same refactoring as escape_pallas.viewport_affine, kept in Fraction
    form so the reference pixel's coordinate is exact at any depth)."""
    out = []
    for axis, (p, s) in enumerate(zip(pos, scale)):
        off = Fraction(width, height * 2) if axis == 0 else Fraction(1, 2)
        a = Fraction(1) / (Fraction(height) * Fraction(float(s)))
        pf = p if isinstance(p, Fraction) else Fraction(float(p))
        c = pf - off / Fraction(float(s))
        out.append((a, c))
    return out  # [(A_re, C_re), (A_im, C_im)]


class RefOrbit(NamedTuple):
    packed: np.ndarray   # f32 (rows, 8): [Zr_n, Zi_n, Zr_n+1, Zi_n+1, τ²|Z_n+1|², 0,0,0]
    n_steps: int         # number of usable δ-steps (orbit escaped after this)
    ref_px: Tuple[int, int]  # (u0, v0) integer pixel of the reference


_ORBIT_CACHE: dict = {}
_ORBIT_CACHE_MAX = 8


def _cache_get(cache: dict, key):
    """LRU get: a hit moves to the newest slot.  (Plain dict.get left the
    caches FIFO — a banded deep render's per-band secondary-orbit inserts
    would evict the PRIMARY orbit and every later band repaid the full
    high-precision host walk.)"""
    hit = cache.get(key)
    if hit is not None:
        cache[key] = cache.pop(key)
    return hit


def _cache_put(cache: dict, key, val, cap: int = _ORBIT_CACHE_MAX):
    if key in cache:
        cache.pop(key)
    elif len(cache) >= cap:
        cache.pop(next(iter(cache)))  # evict least-recently-used
    cache[key] = val


def _orbit_key(scene, ref_px, width, height):
    return (scene.algo, scene.power, width, height, scene.iterations,
            scene.pos, scene.pos_str, scene.scale, scene.julia_set,
            float(scene.limit), scene.supersample, ref_px)


def _host_step(algo: str, power: int):
    """Host-side one-step rule for the reference walk (models/rules.py
    semantics on python/mpmath complex scalars — `type(z)` keeps the
    mpmath/complex arithmetic of the caller)."""
    if algo == "burningship":
        def step(z, c):  # (|Re z| + i|Im z|)² + c (rules.py:35-39)
            a, b = abs(z.real), abs(z.imag)
            return type(z)(a * a - b * b + c.real, 2 * a * b + c.imag)
        return step
    if algo == "tricorn":
        def step(z, c):  # conj(z)² + c (rules.py:42-46)
            return type(z)(z.real * z.real - z.imag * z.imag + c.real,
                           -2 * z.real * z.imag + c.imag)
        return step
    d = eff_power(algo, power)
    return lambda z, c: z ** d + c


def _walk_digits(spacing: float) -> int:
    """Decimal digits of the high-precision walks: the pixel spacing's
    decade plus 20 guard digits."""
    return int(-math.log10(max(spacing, 1e-300))) + 20


def _walk_c(scene, z0, prec: int):
    """The walk's additive constant as raw mpf: the julia parameter (an
    f64, converted exactly), or the starting point itself."""
    if scene.algo != "julia":
        return z0
    from fractal_tpu.ops.native_walk import mpf_from_fraction

    return tuple(mpf_from_fraction(Fraction(float(v)), prec)
                 for v in scene.julia_set[:2])


_WALK_DECLINED = ("the native orbit walker does not replicate this {} walk "
                  "at {} bits (an integer power of a complex value whose "
                  "components differ by thousands of binary orders)")


def reference_orbit(scene, ref_px: Tuple[int, int], width: int,
                    height: int) -> RefOrbit:
    """Iterate the reference pixel's orbit on the host.

    f64 when the pixel spacing allows, the native arbitrary-precision
    walker (mpmath's arithmetic, ops/native_walk.py) beyond.  Returns the
    packed
    per-step table the device kernel consumes (padded to iterations+CHUNK
    rows so array shape is static across frames).  Results are memoized
    (small LRU): interactive re-renders and bench repeats of the same view
    must not pay the high-precision host walk each frame."""
    key = _orbit_key(scene, ref_px, width, height)
    hit = _cache_get(_ORBIT_CACHE, key)
    if hit is not None:
        return hit
    iters = scene.iterations
    (Ar, Cr), (Ai, Ci) = _affine_fractions(width, height, exact_pos(scene), scene.scale)
    u0, v0 = ref_px
    c0r_f = Ar * u0 + Cr
    c0i_f = Ai * v0 + Ci
    limit_sq = float(scene.limit) ** 2

    spacing = scene.pixel_spacing / scene.supersample
    step = _host_step(scene.algo, scene.power)
    if spacing > F64_ORBIT_SPACING_LIMIT:
        zs = np.empty((iters + 1, 2), np.float64)
        c0r, c0i = float(c0r_f), float(c0i_f)
        if scene.algo == "julia":
            cr, ci = float(scene.julia_set[0]), float(scene.julia_set[1])
        else:
            cr, ci = c0r, c0i
        z = complex(c0r, c0i)  # z starts at the pixel coord (calc:208-212)
        c = complex(cr, ci)
        n = 0
        zs[0] = (z.real, z.imag)
        while n < iters:
            z = step(z, c)
            n += 1
            zs[n] = (z.real, z.imag)
            if z.real * z.real + z.imag * z.imag > limit_sq:
                break
    else:
        from fractal_tpu.ops import native_walk

        prec = native_walk.dps_to_prec(_walk_digits(spacing))
        z0 = (native_walk.mpf_from_fraction(c0r_f, prec),
              native_walk.mpf_from_fraction(c0i_f, prec))
        c = _walk_c(scene, z0, prec)
        res = native_walk.walk(scene.algo,
                               eff_power(scene.algo, scene.power),
                               prec, z0, c, iters, limit_sq)
        if res is None:
            raise ValueError(_WALK_DECLINED.format(scene.algo, prec))
        zs, n = res

    n_steps = n  # δ-steps usable: steps 0..n-1 consume Z_n and Z_{n+1}
    # static shape: the loop index may overrun by < chunk, and block loads
    # clamp to rows - chunk, so pad by the largest chunk any backend uses.
    rows = iters + ORBIT_PAD
    packed = np.zeros((rows, 8), np.float32)
    z32 = zs[: n + 1].astype(np.float32)
    packed[:n, 0] = z32[:n, 0]
    packed[:n, 1] = z32[:n, 1]
    packed[:n, 2] = z32[1 : n + 1, 0]
    packed[:n, 3] = z32[1 : n + 1, 1]
    packed[:n, 4] = GLITCH_TOL_SQ * (z32[1 : n + 1, 0] ** 2
                                     + z32[1 : n + 1, 1] ** 2)
    orbit = RefOrbit(packed, n_steps, (u0, v0))
    _cache_put(_ORBIT_CACHE, key, orbit)
    # Cross-view reuse index: the orbit is a property of the exact starting
    # point (and budget/limit), not of the viewport — record it under its c
    # so pans/zooms over the same region skip the high-precision walk
    # entirely (see resolve_reference).
    ckey = (scene.algo, scene.power,
            scene.julia_set if scene.algo == "julia" else None,
            float(scene.limit), c0r_f, c0i_f)
    _cache_put(_C_ORBIT_CACHE, ckey, (orbit, iters))
    return orbit


_REF_CACHE: dict = {}
_C_ORBIT_CACHE: dict = {}  # exact-c keyed orbits for cross-view reuse


def reuse_reference(scene, width: int, height: int):
    """((u, v) float pixel coords, orbit) reusing a cached orbit whose exact
    starting c lies inside the CURRENT view with a sufficient budget, or
    None.  This is the interactive deep-zoom fast path: a pan or zoom over
    the same region keeps the previous reference (its orbit is unchanged —
    only the viewport moved), skipping both the high-precision host walk
    (seconds at deep zooms) and the device probe.  Fractional reference
    coordinates are exact for the δc math: δc = (x−u0)·A holds for any
    real u0, and the kernels never index by the reference pixel."""
    (Ar, Cr), (Ai, Ci) = _affine_fractions(width, height, exact_pos(scene),
                                           scene.scale)
    want = (scene.algo, scene.power,
            scene.julia_set if scene.algo == "julia" else None,
            float(scene.limit))
    best = None  # (distance², key, (u, v))
    for ckey in _C_ORBIT_CACHE.keys():
        algo, power, jl, lim, c0r_f, c0i_f = ckey
        if (algo, power, jl, lim) != want:
            continue
        orbit, iters = _C_ORBIT_CACHE[ckey]
        # full-budget references only: a short (escaped) orbit would send
        # every long-running pixel to the glitch fallback
        if iters < scene.iterations or orbit.n_steps < scene.iterations:
            continue
        u = (c0r_f - Cr) / Ar
        v = (c0i_f - Ci) / Ai
        if 0 <= u <= width - 1 and 0 <= v <= height - 1:
            # prefer the most CENTRAL in-view orbit, not the newest: a
            # central reference minimizes the view's |δc| spread (the
            # primary-reference quality metric), and the choice stays
            # deterministic by geometry rather than by cache history
            # (e.g. a multiref secondary walked by a previous frame must
            # not displace the view-center orbit for later frames).  The
            # center is choose_reference's (w//2, h//2) convention, so an
            # orbit walked AT the canonical reference pixel scores an
            # exact 0 and always wins over near-center secondaries.
            d2 = (float(u) - width // 2) ** 2 \
                + (float(v) - height // 2) ** 2
            if best is None or d2 < best[0]:
                best = (d2, ckey, (float(u), float(v)))
    if best is not None:
        _, ckey, uv = best
        orbit, _ = _C_ORBIT_CACHE[ckey]
        _C_ORBIT_CACHE[ckey] = _C_ORBIT_CACHE.pop(ckey)  # refresh LRU
        return uv, _sliced_orbit(orbit, scene.iterations)
    return None


def resolve_reference(scene, width: int, height: int):
    """(ref_px, orbit) for a view: exact-view memo first (bit-stable for
    repeated frames), then cross-view orbit reuse, then the fresh
    choose_reference probe + host walk."""
    cu, cv = width // 2, height // 2
    if _cache_get(_REF_CACHE, _orbit_key(scene, (cu, cv), width,
                                         height)) is not None:
        ref = choose_reference(scene, width, height)
        return ref, reference_orbit(scene, ref, width, height)
    ru = reuse_reference(scene, width, height)
    if ru is not None:
        return ru
    ref = choose_reference(scene, width, height)
    return ref, reference_orbit(scene, ref, width, height)


@functools.partial(jax.jit, static_argnames=("algo", "power", "iterations",
                                             "height", "width"))
def _probe_cnt_jit(params, *, algo, power, iterations, height, width):
    from fractal_tpu.ops.escape_pallas import iterate_whole_jnp

    return iterate_whole_jnp(params, algo=algo, power=power,
                             iterations=iterations, precision="ds32",
                             height=height, width=width)[2]


def choose_reference(scene, width: int, height: int) -> Tuple[int, int]:
    """Reference pixel: the view center, unless its orbit escapes before the
    budget — then the max-count pixel of a coarse ds32 probe render mapped
    back to full resolution.  Memoized per view (the probe is a device
    dispatch; interactive re-renders must not pay it per frame)."""
    cu, cv = width // 2, height // 2
    key = _orbit_key(scene, (cu, cv), width, height)
    hit = _cache_get(_REF_CACHE, key)
    if hit is not None:
        return hit
    probe_orbit = reference_orbit(scene, (cu, cv), width, height)
    if probe_orbit.n_steps >= scene.iterations:
        _REF_CACHE[key] = (cu, cv)
        return (cu, cv)

    pw = max(2, min(96, width))
    ph = max(2, min(96, height))
    params = scene_params(scene, ph, pw)
    cnt = _probe_cnt_jit(params, algo=scene.algo, power=scene.power,
                         iterations=scene.iterations, height=ph, width=pw)
    cnt = np.asarray(cnt)
    # Among max-count probe pixels pick the medoid (closest to their own
    # centroid): a plain argmax lands on the first (edge-most) pixel of the
    # interior region, whose full-res neighbor may escape much earlier.
    best = cnt == cnt.max()
    ys, xs = np.nonzero(best)
    cy, cx = ys.mean(), xs.mean()
    i = int(np.argmin((ys - cy) ** 2 + (xs - cx) ** 2))
    pv, pu = int(ys[i]), int(xs[i])
    # Map the probe pixel to full resolution through the exact affines of
    # both grids (the probe's aspect offset differs when ratios differ).
    (Arp, Crp), (Aip, Cip) = _affine_fractions(pw, ph, exact_pos(scene), scene.scale)
    (Ar, Cr), (Ai, Ci) = _affine_fractions(width, height, exact_pos(scene), scene.scale)
    u = int(round(float(((Arp * int(pu) + Crp) - Cr) / Ar)))
    v = int(round(float(((Aip * int(pv) + Cip) - Ci) / Ai)))
    ref = (min(max(u, 0), width - 1), min(max(v, 0), height - 1))
    _cache_put(_REF_CACHE, key, ref)
    return ref


# ---------------------------------------------------------------------------
# Device side: the δ-orbit iteration (shared jnp / Pallas scaffold)
# ---------------------------------------------------------------------------


def _perturb_tile(xx, yy, P, n_steps, iterations: int,
                  chunk: int, load_block, power: int = 2,
                  algo: str = "mandelbrot"):
    """Iterate δz for one tile (or the whole image).

    ``load_block(n0) -> (chunk, 8) orbit rows`` loads one chunk's orbit
    rows; the steps of the chunk use static per-row extracts.
    P (f32): [Ar, Ai, u0, v0, limit², dc_gain, row_stride, row_offset]
    (dc_gain 0 for julia — δc enters only through δz₀; stride/offset map
    device-local rows to global rows for interleaved sharding, identity
    (1, 0) single-device).  ``n_steps`` is a traced scalar — orbit length
    varies per frame without recompiling.

    Returns (zr, zi, cnt, glitch): full final z, reference-semantics count
    (escape step excluded, calc/src/lib.rs:245-257), glitch flag (i32 0/1)
    marking pixels needing the exact fallback.
    """
    f32 = jnp.float32
    Ar, Ai, u0, v0, limit_sq = P[0], P[1], P[2], P[3], P[4]
    dcr = (xx - u0) * Ar
    dci = (yy - v0) * Ai

    # Series-approximation start (trivial series ⇒ n0 = 0, δz₀ = δc exactly)
    dzr0, dzi0, n0 = _series_init(P, dcr, dci)
    block0 = load_block(n0)
    zfr0 = block0[0, 0] + dzr0  # full z_{n0} = Z_{n0} + δz_{n0}
    zfi0 = block0[0, 1] + dzi0
    cnt0 = jnp.zeros(xx.shape, jnp.int32) + n0
    gl0 = jnp.zeros(xx.shape, jnp.int32)

    n_chunks = _cdiv(max(iterations, 1), chunk)

    def _active(zfr, zfi, cnt, gl, n):
        return (
            (zfr * zfr + zfi * zfi <= limit_sq)
            & (cnt == n)
            & (gl == 0)
        )

    def one_step(n, row, state):
        dzr, dzi, zfr, zfi, cnt, gl = state
        live = _active(zfr, zfi, cnt, gl, n) & (n < n_steps)
        Zr, Zi, Zr1, Zi1, gtol = row[0], row[1], row[2], row[3], row[4]
        ndzr, ndzi = _delta_step(algo, power, Zr, Zi, dzr, dzi, dcr, dci,
                                 P[5], P[15] * 0.0 + 1.0)
        nzfr = Zr1 + ndzr
        nzfi = Zi1 + ndzi
        d = nzfr * nzfr + nzfi * nzfi
        esc_now = d > limit_sq
        gl_now = live & (~esc_now) & (d < gtol)
        upd = live
        dzr = jnp.where(upd, ndzr, dzr)
        dzi = jnp.where(upd, ndzi, dzi)
        zfr = jnp.where(upd, nzfr, zfr)
        zfi = jnp.where(upd, nzfi, zfi)
        cnt = cnt + (live & ~esc_now & ~gl_now)
        gl = gl | gl_now.astype(jnp.int32)
        return dzr, dzi, zfr, zfi, cnt, gl

    def chunk_body(carry):
        state, k = carry
        n0 = k * chunk
        block = load_block(n0)  # (chunk, 8); impls clamp the slice start
        for i in range(chunk):  # static unroll: block[i, j] are lane extracts
            row = [block[i, j] for j in range(5)]
            state = one_step(n0 + i, row, state)
        return state, k + 1

    def chunk_cond(carry):
        (dzr, dzi, zfr, zfi, cnt, gl), k = carry
        n = k * chunk
        return (
            (k < n_chunks)
            & (n < n_steps)
            & jnp.any(_active(zfr, zfi, cnt, gl, n) )
        )

    state0 = (dzr0, dzi0, zfr0, zfi0, cnt0, gl0)
    (dzr, dzi, zfr, zfi, cnt, gl), _ = jax.lax.while_loop(
        chunk_cond, chunk_body, (state0, n0 // jnp.int32(chunk))
    )
    # Pixels that outlived the reference orbit (cnt == n_steps < iterations,
    # unescaped) have no more Z rows — they are glitches for the fallback.
    ran_out = (
        (zfr * zfr + zfi * zfi <= limit_sq)
        & (cnt >= n_steps)
        & (n_steps < iterations)
    )
    gl = gl | ran_out.astype(jnp.int32)
    return zfr, zfi, cnt, gl


def _perturb_tile_bla(xx, yy, P, n_steps, iterations: int, chunk: int,
                      load_block, bla_packed, bla_offsets, bla_min_level: int):
    """BLA-accelerated variant of ``_perturb_tile`` (whole-image XLA only).

    The loop advances by *macro steps*: if every live pixel sits inside the
    validity radius of a bilinear table entry at the current (shared) index
    n, the whole image jumps 2^k steps with one complex mul-add; otherwise
    it falls back to a plain chunk.  Escapes/glitches cannot occur inside a
    valid skip (validity keeps |δz| ≪ |Z|, see ops/bla.py), so the
    reference count semantics are preserved exactly.
    """
    f32 = jnp.float32
    Ar, Ai, u0, v0, limit_sq = P[0], P[1], P[2], P[3], P[4]
    dcr = (xx - u0) * Ar
    dci = (yy - v0) * Ai

    # Series-approximation start (trivial series ⇒ n0 = 0, δz₀ = δc exactly)
    dzr0, dzi0, n0 = _series_init(P, dcr, dci)
    block0 = load_block(n0)
    zfr0 = block0[0, 0] + dzr0
    zfi0 = block0[0, 1] + dzi0
    cnt0 = jnp.zeros(xx.shape, jnp.int32) + n0
    gl0 = jnp.zeros(xx.shape, jnp.int32)

    def _active(zfr, zfi, cnt, gl, n):
        return ((zfr * zfr + zfi * zfi <= limit_sq) & (cnt == n) & (gl == 0))

    def one_step(n, row, state):
        dzr, dzi, zfr, zfi, cnt, gl = state
        live = _active(zfr, zfi, cnt, gl, n) & (n < n_steps)
        Zr, Zi, Zr1, Zi1, gtol = row[0], row[1], row[2], row[3], row[4]
        tr = 2.0 * Zr + dzr
        ti = 2.0 * Zi + dzi
        ndzr = tr * dzr - ti * dzi + dcr * P[5]
        ndzi = tr * dzi + ti * dzr + dci * P[5]
        nzfr = Zr1 + ndzr
        nzfi = Zi1 + ndzi
        d = nzfr * nzfr + nzfi * nzfi
        esc_now = d > limit_sq
        gl_now = live & (~esc_now) & (d < gtol)
        dzr = jnp.where(live, ndzr, dzr)
        dzi = jnp.where(live, ndzi, dzi)
        zfr = jnp.where(live, nzfr, zfr)
        zfi = jnp.where(live, nzfi, zfi)
        cnt = cnt + (live & ~esc_now & ~gl_now)
        gl = gl | gl_now.astype(jnp.int32)
        return dzr, dzi, zfr, zfi, cnt, gl

    def macro_body(carry):
        (dzr, dzi, zfr, zfi, cnt, gl), n = carry
        live = _active(zfr, zfi, cnt, gl, n) & (n < n_steps)
        m2 = jnp.max(jnp.where(live, dzr * dzr + dzi * dzi, 0.0))
        # pick the LARGEST valid level (static unrolled scan, few scalars)
        sAr = jnp.float32(0.0); sAi = jnp.float32(0.0)
        sBr = jnp.float32(0.0); sBi = jnp.float32(0.0)
        skip = jnp.int32(0)
        for lev in range(len(bla_offsets) - 1, -1, -1):
            k = lev + bla_min_level
            step = 1 << k
            idx = bla_offsets[lev] + (n >> k)
            row = jax.lax.dynamic_slice(bla_packed, (idx, jnp.int32(0)), (1, 8))
            ok = (
                (skip == 0)
                & ((n & (step - 1)) == 0)
                & (n + step <= n_steps)
                & (m2 < row[0, 4])
            )
            sAr = jnp.where(ok, row[0, 0], sAr)
            sAi = jnp.where(ok, row[0, 1], sAi)
            sBr = jnp.where(ok, row[0, 2], sBr)
            sBi = jnp.where(ok, row[0, 3], sBi)
            skip = jnp.where(ok, jnp.int32(step), skip)

        # Masked skip THEN a plain chunk, unconditionally — lax.cond would
        # split the body into separate computations and double the while-
        # state traffic through device memory.  The masked skip costs
        # ~10 extra vector ops per macro step; when it fires it advances n
        # by up to 2^levels on top of the chunk's 64.
        upd = live & (skip > 0)
        ndzr = sAr * dzr - sAi * dzi + (sBr * dcr - sBi * dci) * P[5]
        ndzi = sAr * dzi + sAi * dzr + (sBr * dci + sBi * dcr) * P[5]
        rowz = load_block(n + skip)  # Z_{n+skip} is col 0/1 of its row
        dzr = jnp.where(upd, ndzr, dzr)
        dzi = jnp.where(upd, ndzi, dzi)
        zfr = jnp.where(upd, rowz[0, 0] + ndzr, zfr)
        zfi = jnp.where(upd, rowz[0, 1] + ndzi, zfi)
        cnt = cnt + jnp.where(upd, skip, 0)
        n = n + skip

        state = (dzr, dzi, zfr, zfi, cnt, gl)
        block = load_block(n)
        for i in range(chunk):
            row = [block[i, j] for j in range(5)]
            state = one_step(n + i, row, state)
        return state, n + jnp.int32(chunk)

    def macro_cond(carry):
        (dzr, dzi, zfr, zfi, cnt, gl), n = carry
        return (
            (n < iterations)
            & (n < n_steps)
            & jnp.any(_active(zfr, zfi, cnt, gl, n))
        )

    state0 = (dzr0, dzi0, zfr0, zfi0, cnt0, gl0)
    (dzr, dzi, zfr, zfi, cnt, gl), _ = jax.lax.while_loop(
        macro_cond, macro_body, (state0, n0)
    )
    ran_out = (
        (zfr * zfr + zfi * zfi <= limit_sq)
        & (cnt >= n_steps)
        & (n_steps < iterations)
    )
    gl = gl | ran_out.astype(jnp.int32)
    return zfr, zfi, cnt, gl


# --- Series approximation (SA): skip the shared iteration prefix ----------
#
# δz_n is a polynomial in δc while the orbit stays coherent:
#     δz_n ≈ A_n·δc + B_n·δc² + C_n·δc³         (K. I. Martin's cubic SA)
# with recurrences A' = 2Z·A + 1, B' = 2Z·B + A², C' = 2Z·C + 2AB.
# All pixels can therefore START at n_skip — one polynomial evaluation
# replaces n_skip iterations of the δ-orbit — where n_skip is the last
# step at which the next-order term D (the truncation-error proxy) is
# below SERIES_TOL of the kept terms for the WORST pixel (|δc| = dc_max).
#
# Scaling: the walk carries A'·dc_max, B'·dc_max², C'·dc_max³ (the actual
# δz-contributions at the view corner), so every quantity stays O(|δz|)
# and f32-representable at any zoom depth; the device evaluates the
# polynomial in u = δc/dc_max, |u| ≤ ~1.
#
# Safety: SERIES_TOL = 1e-7 sits at the f32 rounding floor of the δ-orbit
# the skip feeds (each subsequent f32 step injects ~6e-8 relative noise),
# so the skip is quality-neutral for both the exact tier (glitch detection
# resumes at n_skip; during the skip the f64 series tracks δz *more*
# accurately than the f32 recurrence it replaces) and the p32 tier.  The
# criterion also implies no pixel can escape before n_skip: every |δz| is
# bounded by |A'|+|B'|+|C'| ≪ escape radius while the series is valid.

SERIES_TOL = 1e-7
SERIES_MIN_SKIP = 2 * PERT_CHUNK  # below this the plumbing isn't worth it
# The δ-orbit loops START at the series skip by chunk index (k0 = n_skip //
# chunk), so the skip MUST be a multiple of every chunk any path uses — a
# misaligned skip re-steps δz from a rounded-down chunk base with
# mismatched orbit rows (every pixel's count shifts).  All chunks are
# powers of two, so the max is their least common multiple; the kernel's
# chunk is checked against it (``_delta_call``).
SERIES_ALIGN = max(PERT_CHUNK, PERT_CHUNK_CPU)


def series_skip(z, n_limit: int, dc_max: float, julia: bool,
                tol: float = SERIES_TOL, align: int = 1,
                esc_radius: float = None):
    """Walk the scaled cubic-SA recurrences along reference orbit ``z``
    ((rows, ≥2) [Zr, Zi]); return (n_skip, (A', B', C')) where the scaled
    complex coefficients give δz_{n_skip} = A'u + B'u² + C'u³,
    u = δc/dc_max.  ``align`` restricts candidate skips to multiples of
    the device chunk — the returned coefficients belong to EXACTLY the
    returned step (a skip aligned after the fact would pair coefficients
    with the wrong orbit row).

    ``esc_radius`` enforces the no-early-escape invariant the skip relies
    on: |δz_n| ≤ |A'|+|B'|+|C'| for every pixel (|u| ≤ 1), so while
    |Z_n| + (|A'|+|B'|+|C'|) stays below the escape radius no pixel can
    have escaped during the skipped prefix.  The walk breaks at the first
    step where that bound fails (in practice the truncation test breaks
    first — coefficients at SA-viable depths are ≪ 1 — but the invariant
    is now checked, not assumed)."""
    A, B, C, D = complex(dc_max), 0j, 0j, 0j
    best, best_abc = 0, (A, B, C)
    step_c = 0.0 if julia else dc_max  # julia: δc enters via δz₀ only
    for n in range(n_limit):
        twoZ = 2.0 * complex(z[n, 0], z[n, 1])
        D = twoZ * D + 2.0 * A * C + B * B
        C = twoZ * C + 2.0 * A * B
        B = twoZ * B + A * A
        A = twoZ * A + step_c
        m = max(abs(A), abs(B), abs(C))
        if not math.isfinite(m) or abs(D) > tol * max(m, 1e-300):
            break
        if esc_radius is not None:
            dz_bound = abs(A) + abs(B) + abs(C)
            if math.hypot(float(z[n + 1, 0]),
                          float(z[n + 1, 1])) + dz_bound > esc_radius:
                break
        if (n + 1) % align == 0:
            best, best_abc = n + 1, (A, B, C)
    return best, best_abc


_SERIES_CACHE: dict = {}


def _series_for(scene, orbit, ref_px, width, height, dc_max):
    key = _orbit_key(scene, ref_px, width, height)
    hit = _cache_get(_SERIES_CACHE, key)
    if hit is not None:
        return hit
    # the last term keeps the chunked loaders' clamped block reads exact
    # (load_block starts at min(n, rows - chunk))
    n_limit = min(orbit.n_steps, scene.iterations,
                  orbit.packed.shape[0] - ORBIT_PAD)
    n, abc = series_skip(orbit.packed[:, :2], max(n_limit, 0), dc_max,
                         scene.algo == "julia", align=SERIES_ALIGN,
                         esc_radius=float(scene.limit))
    if n < SERIES_MIN_SKIP:
        n, abc = 0, None
    val = (n, abc)
    _cache_put(_SERIES_CACHE, key, val)
    return val


def _pert_params(scene, ref_px, width: int, height: int, orbit=None):
    """16-slot f32 parameter vector for the δ-orbit kernels.

    [0:8]  — Ar, Ai, u0, v0, limit², dc_gain, row_stride, row_offset
             (dc_gain 0 for julia; stride/offset map device-local rows to
             global rows for interleaved sharding, identity (1, 0)).
    [8:16] — series-approximation slots: n_skip, A'r, A'i, B'r, B'i,
             C'r, C'i, 1/dc_max.  With no orbit (or no worthwhile skip)
             they hold the TRIVIAL series (0, 1,0, 0,0, 0,0, 1): the
             device polynomial then evaluates to exactly δz₀ = δc
             (bit-identical to the pre-SA init), so every consumer runs
             one uniform init path.
    """
    (Ar, Cr), (Ai, Ci) = _affine_fractions(width, height, exact_pos(scene), scene.scale)
    dc_gain = 0.0 if scene.algo == "julia" else 1.0
    sa = [0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    if orbit is not None and scene.power == 2 \
            and scene.algo in ("mandelbrot", "julia"):
        # series coefficients use the quadratic recurrence; multibrot runs
        # with the trivial series (δz₀ = δc)
        dcr_max = max(ref_px[0], width - 1 - ref_px[0]) * abs(float(Ar))
        dci_max = max(ref_px[1], height - 1 - ref_px[1]) * abs(float(Ai))
        dcm = math.hypot(dcr_max, dci_max)
        if dcm > 0.0:
            n_skip, abc = _series_for(scene, orbit, ref_px, width, height,
                                      dcm)
            if n_skip > 0:
                A, B, C = abc
                sa = [float(n_skip), A.real, A.imag, B.real, B.imag,
                      C.real, C.imag, 1.0 / dcm]
    return jnp.asarray(
        [float(Ar), float(Ai), float(ref_px[0]), float(ref_px[1]),
         float(scene.limit) ** 2, dc_gain, 1.0, 0.0] + sa,
        jnp.float32,
    )


def _frexp_fraction(fr):
    """Exact frexp of a Fraction of ANY magnitude: (m, e) with value =
    m·2^e and |m| ∈ [0.5, 1) — float(Fraction) overflows/underflows past
    ~1e±308, this never does."""
    if fr == 0:
        return 0.0, 0
    e = abs(fr.numerator).bit_length() - fr.denominator.bit_length() + 1
    val = fr / (Fraction(2) ** e)
    if abs(val) < Fraction(1, 2):
        val, e = val * 2, e - 1
    elif abs(val) >= 1:
        val, e = val / 2, e + 1
    return float(val), e


def _pert_params_fe(scene, ref_px, width: int, height: int):
    """Parameter vector for the extreme-depth floatexp tile.  Same 16-slot
    f32 layout as ``_pert_params`` where shared (u0/v0/limit²/dc_gain/row
    stride+offset in [2:8]), but the affine gains ride as floatexp pairs:
    [0]=Ar_m, [1]=Ai_m, [8]=Ar_e, [9]=Ai_e (exponents are exact small
    integers in f32).  No SA slots — the series walk is f64-bound."""
    (Ar, _), (Ai, _) = _affine_fractions(width, height, exact_pos(scene),
                                         scene.scale)
    arm, are = _frexp_fraction(Ar)
    aim, aie = _frexp_fraction(Ai)
    dc_gain = 0.0 if scene.algo == "julia" else 1.0
    return jnp.asarray(
        [arm, aim, float(ref_px[0]), float(ref_px[1]),
         float(scene.limit) ** 2, dc_gain, 1.0, 0.0,
         float(are), float(aie), 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        jnp.float32,
    )


def _perturb_tile_fe(xx, yy, P, n_steps, iterations: int, chunk: int,
                     load_block):
    """Extreme-depth δ-orbit tile: the quadratic recurrence in floatexp
    arithmetic (see ops/floatexp.py and EXTREME_SPACING_LIMIT).  Same
    contract as ``_perturb_tile``; quadratic mandelbrot/julia only."""
    from fractal_tpu.ops import floatexp as fx

    f32 = jnp.float32
    u0, v0, limit_sq, gain = P[2], P[3], P[4], P[5]
    Ar = (P[0] * jnp.ones_like(xx), jnp.full(xx.shape, P[8], f32).astype(jnp.int32))
    Ai = (P[1] * jnp.ones_like(xx), jnp.full(xx.shape, P[9], f32).astype(jnp.int32))
    dcr = fx.mul(fx.fe(xx - u0), Ar)
    dci = fx.mul(fx.fe(yy - v0), Ai)
    # julia folds δc into δz₀ only (dc_gain 0 must be a TRUE zero)
    dcr_g = (dcr[0] * gain, jnp.where(gain == 0.0, fx.E_ZERO, dcr[1]))
    dci_g = (dci[0] * gain, jnp.where(gain == 0.0, fx.E_ZERO, dci[1]))

    block0 = load_block(jnp.int32(0))
    dzr0, dzi0 = dcr, dci
    zfr0 = block0[0, 0] + fx.to_float(dzr0)
    zfi0 = block0[0, 1] + fx.to_float(dzi0)
    cnt0 = jnp.zeros(xx.shape, jnp.int32)
    gl0 = jnp.zeros(xx.shape, jnp.int32)

    n_chunks = _cdiv(max(iterations, 1), chunk)

    def _active(zfr, zfi, cnt, gl, n):
        return ((zfr * zfr + zfi * zfi <= limit_sq) & (cnt == n) & (gl == 0))

    def one_step(n, row, state):
        (dzr, dzi, zfr, zfi, cnt, gl) = state
        live = _active(zfr, zfi, cnt, gl, n) & (n < n_steps)
        Zr, Zi, Zr1, Zi1, gtol = row[0], row[1], row[2], row[3], row[4]
        tr = fx.add(fx.fe(2.0 * Zr + jnp.zeros_like(zfr)), dzr)
        ti = fx.add(fx.fe(2.0 * Zi + jnp.zeros_like(zfi)), dzi)
        pr, pi = fx.cmul(tr, ti, dzr, dzi)
        ndzr = fx.add(pr, dcr_g)
        ndzi = fx.add(pi, dci_g)
        nzfr = Zr1 + fx.to_float(ndzr)
        nzfi = Zi1 + fx.to_float(ndzi)
        d = nzfr * nzfr + nzfi * nzfi
        esc_now = d > limit_sq
        gl_now = live & (~esc_now) & (d < gtol)
        dzr = (jnp.where(live, ndzr[0], dzr[0]),
               jnp.where(live, ndzr[1], dzr[1]))
        dzi = (jnp.where(live, ndzi[0], dzi[0]),
               jnp.where(live, ndzi[1], dzi[1]))
        zfr = jnp.where(live, nzfr, zfr)
        zfi = jnp.where(live, nzfi, zfi)
        cnt = cnt + (live & ~esc_now & ~gl_now)
        gl = gl | gl_now.astype(jnp.int32)
        return (dzr, dzi, zfr, zfi, cnt, gl)

    def chunk_body(carry):
        state, k = carry
        n0 = k * chunk
        block = load_block(n0)
        for i in range(chunk):
            row = [block[i, j] for j in range(5)]
            state = one_step(n0 + i, row, state)
        return state, k + 1

    def chunk_cond(carry):
        (dzr, dzi, zfr, zfi, cnt, gl), k = carry
        n = k * chunk
        return ((k < n_chunks) & (n < n_steps)
                & jnp.any(_active(zfr, zfi, cnt, gl, n)))

    state0 = (dzr0, dzi0, zfr0, zfi0, cnt0, gl0)
    (dzr, dzi, zfr, zfi, cnt, gl), _ = jax.lax.while_loop(
        chunk_cond, chunk_body, (state0, jnp.int32(0)))
    ran_out = ((zfr * zfr + zfi * zfi <= limit_sq)
               & (cnt >= n_steps) & (n_steps < iterations))
    gl = gl | ran_out.astype(jnp.int32)
    return zfr, zfi, cnt, gl


def _perturb_tile_bla_fe(xx, yy, P, n_steps, iterations: int, chunk: int,
                         load_block, bla_packed, bla_offsets,
                         bla_min_level: int):
    """Extreme-depth BLA: ``_perturb_tile_bla``'s macro-step loop with the
    floatexp state and an extended-exponent table (``ops/bla.py::
    build_table_fe``).  At ≥~1e30× |δz| stays ~|δc|
    for most of the orbit, so deep merge levels remain valid where
    mid-zoom radii collapse: the whole image jumps 2^k steps with one
    complex fe mul-add while every live |δz|² is below the entry's r².
    Escapes/glitches cannot occur inside a valid skip, so reference count
    semantics are exact (same argument as the f32 BLA)."""
    from fractal_tpu.ops import floatexp as fx

    f32 = jnp.float32
    u0, v0, limit_sq, gain = P[2], P[3], P[4], P[5]
    Ar = (P[0] * jnp.ones_like(xx), jnp.full(xx.shape, P[8], f32).astype(jnp.int32))
    Ai = (P[1] * jnp.ones_like(xx), jnp.full(xx.shape, P[9], f32).astype(jnp.int32))
    dcr = fx.mul(fx.fe(xx - u0), Ar)
    dci = fx.mul(fx.fe(yy - v0), Ai)
    dcr_g = (dcr[0] * gain, jnp.where(gain == 0.0, fx.E_ZERO, dcr[1]))
    dci_g = (dci[0] * gain, jnp.where(gain == 0.0, fx.E_ZERO, dci[1]))

    block0 = load_block(jnp.int32(0))
    dzr0, dzi0 = dcr, dci
    zfr0 = block0[0, 0] + fx.to_float(dzr0)
    zfi0 = block0[0, 1] + fx.to_float(dzi0)
    cnt0 = jnp.zeros(xx.shape, jnp.int32)
    gl0 = jnp.zeros(xx.shape, jnp.int32)

    def _active(zfr, zfi, cnt, gl, n):
        return ((zfr * zfr + zfi * zfi <= limit_sq) & (cnt == n) & (gl == 0))

    def one_step(n, row, state):
        # identical expressions to _perturb_tile_fe.one_step
        (dzr, dzi, zfr, zfi, cnt, gl) = state
        live = _active(zfr, zfi, cnt, gl, n) & (n < n_steps)
        Zr, Zi, Zr1, Zi1, gtol = row[0], row[1], row[2], row[3], row[4]
        tr = fx.add(fx.fe(2.0 * Zr + jnp.zeros_like(zfr)), dzr)
        ti = fx.add(fx.fe(2.0 * Zi + jnp.zeros_like(zfi)), dzi)
        pr, pi = fx.cmul(tr, ti, dzr, dzi)
        ndzr = fx.add(pr, dcr_g)
        ndzi = fx.add(pi, dci_g)
        nzfr = Zr1 + fx.to_float(ndzr)
        nzfi = Zi1 + fx.to_float(ndzi)
        d = nzfr * nzfr + nzfi * nzfi
        esc_now = d > limit_sq
        gl_now = live & (~esc_now) & (d < gtol)
        dzr = (jnp.where(live, ndzr[0], dzr[0]),
               jnp.where(live, ndzr[1], dzr[1]))
        dzi = (jnp.where(live, ndzi[0], dzi[0]),
               jnp.where(live, ndzi[1], dzi[1]))
        zfr = jnp.where(live, nzfr, zfr)
        zfi = jnp.where(live, nzfi, zfi)
        cnt = cnt + (live & ~esc_now & ~gl_now)
        gl = gl | gl_now.astype(jnp.int32)
        return (dzr, dzi, zfr, zfi, cnt, gl)

    INT_MIN = jnp.int32(-(1 << 30))
    shape = xx.shape

    def try_skip(dzr, dzi, zfr, zfi, cnt, gl, n):
        """One greedy skip attempt: largest valid aligned level at n."""
        live = _active(zfr, zfi, cnt, gl, n) & (n < n_steps)
        # max |δz|² over live pixels, exponent-aware: |δz|² as an fe pair
        # whose magnitude order is lexicographic (e, m) after renorm
        m2 = fx.add(fx.mul(dzr, dzr), fx.mul(dzi, dzi))
        has = live & (m2[0] > 0.0)
        maxe = jnp.max(jnp.where(has, m2[1], INT_MIN))
        maxm = jnp.max(jnp.where(has & (m2[1] == maxe), m2[0], 0.0))
        sArm = jnp.float32(0.0); sAim = jnp.float32(0.0)
        sAe = jnp.int32(0)
        sBrm = jnp.float32(0.0); sBim = jnp.float32(0.0)
        sBe = jnp.int32(0)
        skip = jnp.int32(0)
        for lev in range(len(bla_offsets) - 1, -1, -1):
            k = lev + bla_min_level
            step = 1 << k
            idx = bla_offsets[lev] + (n >> k)
            row = jax.lax.dynamic_slice(bla_packed, (idx, jnp.int32(0)),
                                        (1, 8))
            r2m = row[0, 6]
            r2e = row[0, 7].astype(jnp.int32)
            ok = (
                (skip == 0)
                & ((n & (step - 1)) == 0)
                & (n + step <= n_steps)
                & (r2m > 0.0)
                & ((maxe < r2e) | ((maxe == r2e) & (maxm < r2m)))
            )
            sArm = jnp.where(ok, row[0, 0], sArm)
            sAim = jnp.where(ok, row[0, 1], sAim)
            sAe = jnp.where(ok, row[0, 2].astype(jnp.int32), sAe)
            sBrm = jnp.where(ok, row[0, 3], sBrm)
            sBim = jnp.where(ok, row[0, 4], sBim)
            sBe = jnp.where(ok, row[0, 5].astype(jnp.int32), sBe)
            skip = jnp.where(ok, jnp.int32(step), skip)

        upd = live & (skip > 0)
        Apair_r = (sArm * jnp.ones(shape, f32),
                   sAe * jnp.ones(shape, jnp.int32))
        Apair_i = (sAim * jnp.ones(shape, f32),
                   sAe * jnp.ones(shape, jnp.int32))
        Bpair_r = (sBrm * jnp.ones(shape, f32),
                   sBe * jnp.ones(shape, jnp.int32))
        Bpair_i = (sBim * jnp.ones(shape, f32),
                   sBe * jnp.ones(shape, jnp.int32))
        skr, ski = fx.cmul(Apair_r, Apair_i, dzr, dzi)
        tbr, tbi = fx.cmul(Bpair_r, Bpair_i, dcr, dci)
        # δc term gain-folded (julia: true zero, like dcr_g)
        tbr = (tbr[0] * gain, jnp.where(gain == 0.0, fx.E_ZERO, tbr[1]))
        tbi = (tbi[0] * gain, jnp.where(gain == 0.0, fx.E_ZERO, tbi[1]))
        ndzr = fx.add(skr, tbr)
        ndzi = fx.add(ski, tbi)
        rowz = load_block(n + skip)
        dzr = (jnp.where(upd, ndzr[0], dzr[0]),
               jnp.where(upd, ndzr[1], dzr[1]))
        dzi = (jnp.where(upd, ndzi[0], dzi[0]),
               jnp.where(upd, ndzi[1], dzi[1]))
        zfr = jnp.where(upd, rowz[0, 0] + fx.to_float(ndzr), zfr)
        zfi = jnp.where(upd, rowz[0, 1] + fx.to_float(ndzi), zfi)
        cnt = cnt + jnp.where(upd, skip, 0)
        return dzr, dzi, zfr, zfi, cnt, gl, n + skip

    # Greedy ruler descent: after a level-k skip lands at n' = n + 2^k, the
    # next-smaller aligned levels cascade (2048 → 512 → 256 → …), so up to
    # SKIP_SCANS skip attempts run per macro body, each re-checking max|δz|²
    # against its own entry's radius.  A single scan per body degrades to a
    # chunk-crawl between alignment points (the trailing chunk breaks
    # alignment, and the deep view can run slower than without BLA).
    SKIP_SCANS = 4

    def macro_body(carry):
        (dzr, dzi, zfr, zfi, cnt, gl), n = carry
        n_in = n
        for _ in range(SKIP_SCANS):
            dzr, dzi, zfr, zfi, cnt, gl, n = try_skip(
                dzr, dzi, zfr, zfi, cnt, gl, n)
        if _BLA_FE_DEBUG:
            jax.debug.print("macro n_in={a} n_after_skips={b}", a=n_in, b=n)
        state = (dzr, dzi, zfr, zfi, cnt, gl)
        block = load_block(n)
        for i in range(chunk):
            row = [block[i, j] for j in range(5)]
            state = one_step(n + i, row, state)
        return state, n + jnp.int32(chunk)

    def macro_cond(carry):
        (dzr, dzi, zfr, zfi, cnt, gl), n = carry
        return ((n < iterations) & (n < n_steps)
                & jnp.any(_active(zfr, zfi, cnt, gl, n)))

    state0 = (dzr0, dzi0, zfr0, zfi0, cnt0, gl0)
    (dzr, dzi, zfr, zfi, cnt, gl), _ = jax.lax.while_loop(
        macro_cond, macro_body, (state0, jnp.int32(0)))
    ran_out = ((zfr * zfr + zfi * zfi <= limit_sq)
               & (cnt >= n_steps) & (n_steps < iterations))
    gl = gl | ran_out.astype(jnp.int32)
    return zfr, zfi, cnt, gl


def _series_init(P, dcr, dci):
    """Per-pixel series start: (δz_r, δz_i, n_skip) from P's SA slots.
    Complex Horner: δz = ((C'u + B')u + A')·u, u = δc·P[15]."""
    ur = dcr * P[15]
    ui = dci * P[15]
    tr = P[13] * ur - P[14] * ui + P[11]
    ti = P[13] * ui + P[14] * ur + P[12]
    sr = tr * ur - ti * ui + P[9]
    si = tr * ui + ti * ur + P[10]
    dzr = sr * ur - si * ui
    dzi = sr * ui + si * ur
    return dzr, dzi, P[8].astype(jnp.int32)


BLA_MIN_LEVEL = 6  # smallest stored skip = 64 = PERT_CHUNK, so skips always
#                    beat plain chunks and stay chunk-aligned


@functools.partial(jax.jit, static_argnames=("iterations", "height", "width",
                                             "chunk", "bla_offsets", "power",
                                             "algo", "extreme"))
def perturb_whole_jnp(orbit, P, n_steps, *, iterations: int, height: int,
                      width: int, chunk: int = PERT_CHUNK_CPU,
                      bla_packed=None, bla_offsets=None, power: int = 2,
                      algo: str = "mandelbrot", extreme: bool = False):
    """Whole-image XLA program for the δ-orbit iteration (the twin of
    ``perturb_kernel``): the production path off the GPU, the extreme-depth
    (floatexp) and BLA paths everywhere, and the kernel's oracle in
    tests."""
    f32 = jnp.float32
    yy = jax.lax.broadcasted_iota(f32, (height, width), 0)
    xx = jax.lax.broadcasted_iota(f32, (height, width), 1)
    yy = yy * P[6] + P[7]  # global-row map (sharded stripes); exact int f32s

    rows = orbit.shape[0]

    def load_block(n0):
        start = jnp.minimum(n0, jnp.int32(rows - chunk))
        return jax.lax.dynamic_slice(orbit, (start, jnp.int32(0)), (chunk, 8))

    if extreme:
        assert power == 2 and algo in ("mandelbrot", "julia"), \
            "the extreme-depth floatexp tile is quadratic-only"
        # shallow unroll: the ~100-op floatexp step body hits XLA:CPU's
        # slow-compile pathology at the plain tile's chunk depths
        fe_chunk = min(chunk, 4)

        def load_block_fe(n0):
            start = jnp.minimum(n0, jnp.int32(rows - fe_chunk))
            return jax.lax.dynamic_slice(orbit, (start, jnp.int32(0)),
                                         (fe_chunk, 8))

        if bla_packed is not None:
            # extended-exponent BLA table (ops/bla.py::build_table_fe)
            return _perturb_tile_bla_fe(xx, yy, P, n_steps, iterations,
                                        fe_chunk, load_block_fe,
                                        bla_packed, bla_offsets,
                                        BLA_MIN_LEVEL)
        return _perturb_tile_fe(xx, yy, P, n_steps, iterations, fe_chunk,
                                load_block_fe)
    if bla_packed is not None:
        assert power == 2 and algo in ("mandelbrot", "julia"), \
            "BLA tables linearize the quadratic z²+c recurrence only"
        return _perturb_tile_bla(xx, yy, P, n_steps, iterations, chunk,
                                 load_block, bla_packed, bla_offsets,
                                 BLA_MIN_LEVEL)
    return _perturb_tile(xx, yy, P, n_steps, iterations, chunk, load_block,
                         power=power, algo=algo)


# ---------------------------------------------------------------------------
# The δ-orbit kernel (Pallas, Triton route)
# ---------------------------------------------------------------------------

# Block shape and early-exit granularity of the δ-orbit kernel.  The whole
# block shares Z_n, so each step's orbit values are scalar loads of one
# row of the packed table — broadcasts that every thread of the block
# reads from the same cached line.  δz, z, |z|² and the count stay in
# registers for the whole iteration.
PERT_TILE_H = 16
PERT_TILE_W = 32
PERT_POINTS_BLOCK = 512  # points mode: 1-D blocks of flagged pixels
PERT_KERNEL_CHUNK = 32   # statically unrolled steps between exit checks


def _delta_step(algo: str, power: int, Zr, Zi, dzr, dzi, dcr, dci, gain,
                pin):
    """One δ-orbit step (δz_n → δz_{n+1}) against Z_n = (Zr, Zi): the
    recurrence of every perturbation-capable rule, shared by the XLA twin
    (``_perturb_tile``) and the kernel so both evaluate the same
    expressions in the same order.  ``gain`` scales δc (0 for julia: δc
    enters only through δz₀); ``pin`` is a traced 1.0 (see the burning-ship
    branch)."""
    if algo == "burningship":
        # (|Re z|+i|Im z|)²+c: the squares erase the abs in the REAL
        # part (a²−b² = |a|²−|b|²), so δ'_r is the plain quadratic
        # form; the imaginary part needs |ab| − |AB| = diffabs(AB, x)
        # with x = A·δb + B·δa + δa·δb — exact in both branches (the
        # crossing case |X| < |x| only arises when X is itself tiny,
        # where fl(A·B) keeps full relative accuracy).
        #
        # Every product feeding an add is multiplied by a TRACED 1.0
        # (``pin``, exact by IEEE, so results are unchanged on every
        # backend): compilers contract mul+add chains into FMAs
        # differently at different unroll depths around the select tree,
        # which made the twin chunk-dependent on chaotic pixels (24% of
        # counts at a 1e14 boundary view).  With the pin, any FMA formed
        # is fma(t, 1.0, c) == rn(t + c) — bit-identical to the
        # uncontracted lowering.  Mandelbrot/tricorn/multibrot lower
        # chunk-stably as-is and keep their unpinned (faster) forms.
        ndzr = ((2.0 * Zr + dzr) * dzr) * pin \
            - ((2.0 * Zi + dzi) * dzi) * pin + (dcr * gain) * pin
        X = Zr * Zi
        x = (Zr * dzi) * pin + (Zi * dzr) * pin + (dzr * dzi) * pin
        # Branch on X >= -x, not on rn(X + x) >= 0: negation and
        # compare are exact (no rounding, hence no contraction site).
        nx = -x
        ndzi = (2.0 * jnp.where(
            X >= 0.0,
            jnp.where(X >= nx, x, -(2.0 * X + x)),
            jnp.where(X <= nx, -x, 2.0 * X + x),
        )) * pin + (dci * gain) * pin
    elif algo == "tricorn":
        # conj(z)²+c: δ'_r quadratic; δ'_i = −2(Aδb + Bδa + δaδb) + δc
        ndzr = (2.0 * Zr + dzr) * dzr - (2.0 * Zi + dzi) * dzi \
            + dcr * gain
        ndzi = -2.0 * (Zr * dzi + Zi * dzr + dzr * dzi) + dci * gain
    elif power == 2:
        # δz' = 2Z·δz + δz² + δc (Julia: δc folded into δz₀, gain 0)
        tr = 2.0 * Zr + dzr
        ti = 2.0 * Zi + dzi
        ndzr = tr * dzr - ti * dzi + dcr * gain
        ndzi = tr * dzi + ti * dzr + dci * gain
    else:
        # z^d + c (multibrot): (Z+δ)^d − Z^d = Σ_{k=1..d} C(d,k)
        # Z^{d-k} δ^k — evaluated as a Horner scheme in δ with per-step
        # scalar coefficients C(d,j)·Z^{d-j} built from the row's Z.
        zp = [(Zr, Zi)]  # Z^1 .. Z^{d-1}
        for _ in range(power - 2):
            ar, ai = zp[-1]
            zp.append((ar * Zr - ai * Zi, ar * Zi + ai * Zr))
        accr = jnp.ones_like(dzr)   # coefficient of δ^d is 1
        acci = jnp.zeros_like(dzi)
        for j in range(power - 1, 0, -1):
            cjr, cji = zp[power - 1 - j]
            cj = float(math.comb(power, j))
            tr = accr * dzr - acci * dzi + cj * cjr
            ti = accr * dzi + acci * dzr + cj * cji
            accr, acci = tr, ti
        ndzr = accr * dzr - acci * dzi + dcr * gain
        ndzi = accr * dzi + acci * dzr + dci * gain
    return ndzr, ndzi


def _build_delta_kernel(iterations: int, chunk: int, glitch: bool,
                        points: bool, dist_only: bool, power: int,
                        algo: str, tile_h: int, tile_w: int):
    """δ-orbit kernel over one block of pixels.

      * δc comes from the block's iota and the affine in P (grid mode) or
        as an input block (``points``: the glitch fallback's arbitrary
        pixel lists);
      * the live mask derives from the carried frozen |z|² alone: escaped
        (d > limit²) and glitched (d poisoned to +inf) pixels drop out
        with zero bookkeeping; δz updates unconditionally (values after
        the freeze are never selected);
      * cnt increments on every live step and the epilogue subtracts the
        escape/glitch step once, reproducing the reference count semantics
        (escape step excluded, calc/src/lib.rs:245-257) and the twin's
        outputs;
      * ``dist_only`` (p32 fast tier, no glitch pipeline): the coloring
        epilogue consumes only the frozen |z|² (the smooth term and inside
        shading are functions of dist alone — ops/coloring.py), so the
        zfr/zfi freeze selects and outputs are dropped and the kernel
        emits just (d, cnt) — the same d the full kernel's consumers
        recompute, so colors are bit-identical.
    """
    n_chunks = _cdiv(max(iterations, 1), chunk)

    def kernel(ns_ref, p_ref, orbit_ref, *rest):
        if points:
            dcr_ref, dci_ref, *rest = rest
        P = [p_ref[i] for i in range(16)]
        n_steps = ns_ref[0]
        limit_sq = P[4]
        if points:
            dcr = dcr_ref[...]
            dci = dci_ref[...]
        else:
            f32 = jnp.float32
            y0 = pl.program_id(0) * tile_h
            x0 = pl.program_id(1) * tile_w
            shape = (tile_h, tile_w)
            yy = (jax.lax.broadcasted_iota(jnp.int32, shape, 0) + y0).astype(f32)
            xx = (jax.lax.broadcasted_iota(jnp.int32, shape, 1) + x0).astype(f32)
            yy = yy * P[6] + P[7]  # global-row map (sharded stripes)
            dcr = (xx - P[2]) * P[0]
            dci = (yy - P[3]) * P[1]
        pin = P[15] * 0.0 + 1.0

        # Series-approximation start (see _pert_params: the trivial series
        # makes this δz₀ = δc bit-exactly, so one init path serves all).
        dz0r, dz0i, n0 = _series_init(P, dcr, dci)
        zfr0 = orbit_ref[n0, 0] + dz0r
        zfi0 = orbit_ref[n0, 1] + dz0i
        d0 = zfr0 * zfr0 + zfi0 * zfi0
        cnt0 = jnp.zeros(dcr.shape, jnp.int32) + n0
        inf = jnp.float32(jnp.inf)

        def chunk_body(carry):
            (dzr, dzi, zfr, zfi, d, cnt), k = carry
            for i in range(chunk):
                n = k * chunk + i
                live = (d <= limit_sq) & (n < n_steps)
                ndzr, ndzi = _delta_step(
                    algo, power, orbit_ref[n, 0], orbit_ref[n, 1], dzr, dzi,
                    dcr, dci, P[5], pin)
                nzfr = orbit_ref[n, 2] + ndzr  # Z_{n+1} + δz_{n+1}
                nzfi = orbit_ref[n, 3] + ndzi
                nd = nzfr * nzfr + nzfi * nzfi
                if glitch:
                    # Pauldelbrot: |z|² < τ²·|Z|² ⇒ precision lost; poison
                    # d to +inf so the pixel freezes (the epilogue recovers
                    # the flag from d == inf and un-counts the step)
                    nd = jnp.where(nd < orbit_ref[n, 4], inf, nd)
                if not dist_only:
                    zfr = jnp.where(live, nzfr, zfr)
                    zfi = jnp.where(live, nzfi, zfi)
                d = jnp.where(live, nd, d)
                cnt = cnt + live.astype(jnp.int32)
                dzr, dzi = ndzr, ndzi
            return (dzr, dzi, zfr, zfi, d, cnt), k + 1

        def chunk_cond(carry):
            (dzr, dzi, zfr, zfi, d, cnt), k = carry
            return ((k < n_chunks) & (k * chunk < n_steps)
                    & (jnp.max((d <= limit_sq).astype(jnp.int32)) > 0))

        # dist_only carries zfr/zfi as None (empty pytree slots)
        zf0 = (None, None) if dist_only else (zfr0, zfi0)
        (dzr, dzi, zfr, zfi, d, cnt), _ = jax.lax.while_loop(
            chunk_cond, chunk_body,
            ((dz0r, dz0i, zf0[0], zf0[1], d0, cnt0), n0 // chunk))
        escaped = d > limit_sq
        cnt = jnp.maximum(cnt - escaped.astype(jnp.int32), 0)
        if dist_only:
            d_ref, cnt_ref = rest
            d_ref[...] = d
            cnt_ref[...] = cnt
            return
        zr_ref, zi_ref, cnt_ref, gl_ref = rest
        ran_out = (~escaped) & (cnt >= n_steps) & (n_steps < iterations)
        zr_ref[...] = zfr
        zi_ref[...] = zfi
        cnt_ref[...] = cnt
        gl_ref[...] = ((d == inf) | ran_out).astype(jnp.int32)

    return kernel


def _delta_call(orbit, P, n_steps, dc, *, iterations: int, height: int,
                width: int, glitch: bool, dist_only: bool, power: int,
                algo: str, interpret: bool, chunk: int):
    """pallas_call plumbing for both modes; outputs padded to whole blocks
    (Triton stores are unmasked) and sliced back."""
    points = dc is not None
    if chunk > ORBIT_PAD or SERIES_ALIGN % chunk:
        raise ValueError(f"kernel chunk {chunk} breaks the orbit padding / "
                         f"series alignment invariant")
    kernel = _build_delta_kernel(iterations, chunk, glitch, points,
                                 dist_only, power, algo, PERT_TILE_H,
                                 PERT_TILE_W)
    ns = jnp.asarray(n_steps, jnp.int32).reshape(1)
    rows = orbit.shape[0]
    if points:
        k = dc[0].shape[0]
        blk = min(PERT_POINTS_BLOCK, k)  # k is a power of two ≥ 128
        grid = (k // blk,)
        zero = lambda i: (0,)
        in_specs = [pl.BlockSpec((1,), zero), pl.BlockSpec((16,), zero),
                    pl.BlockSpec((rows, 8), lambda i: (0, 0)),
                    pl.BlockSpec((blk,), lambda i: (i,)),
                    pl.BlockSpec((blk,), lambda i: (i,))]
        out_block = pl.BlockSpec((blk,), lambda i: (i,))
        out_dims = (k,)
    else:
        gh, gw = _cdiv(height, PERT_TILE_H), _cdiv(width, PERT_TILE_W)
        grid = (gh, gw)
        zero = lambda i, j: (0,)
        in_specs = [pl.BlockSpec((1,), zero), pl.BlockSpec((16,), zero),
                    pl.BlockSpec((rows, 8), lambda i, j: (0, 0))]
        out_block = pl.BlockSpec((PERT_TILE_H, PERT_TILE_W),
                                 lambda i, j: (i, j))
        out_dims = (gh * PERT_TILE_H, gw * PERT_TILE_W)
    outf = jax.ShapeDtypeStruct(out_dims, jnp.float32)
    outi = jax.ShapeDtypeStruct(out_dims, jnp.int32)
    out_shape = (outf, outi) if dist_only else (outf, outf, outi, outi)
    outs = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=tuple(out_block for _ in out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="delta_orbit",
    )(ns, P, orbit, *(dc or ()))
    if points:
        return outs
    return tuple(a[:height, :width] for a in outs)


@functools.partial(
    jax.jit, static_argnames=("iterations", "height", "width", "glitch",
                              "dist_only", "power", "algo", "interpret",
                              "chunk"))
def perturb_kernel(orbit, P, n_steps, *, iterations: int, height: int,
                   width: int, glitch: bool = True, dist_only: bool = False,
                   power: int = 2, algo: str = "mandelbrot",
                   interpret: bool = False, chunk: int = PERT_KERNEL_CHUNK):
    """δ-orbit kernel over a (height, width) grid: the GPU path of every
    plain-f32 perturbation render.  ``orbit`` is the packed reference
    table (``RefOrbit.packed``), P the ``_pert_params`` vector.  Returns
    (zr, zi, cnt, glitch) like ``perturb_whole_jnp`` — bit-identical to it
    under the interpreter — or (|z|², cnt) with ``dist_only``
    (``glitch`` must then be False).  ``interpret=True`` runs the same
    kernel through the Pallas interpreter (tests)."""
    if dist_only and glitch:
        raise ValueError("dist_only is the p32 fast-tier form (no glitch "
                         "pipeline)")
    return _delta_call(orbit, P, n_steps, None, iterations=iterations,
                       height=height, width=width, glitch=glitch,
                       dist_only=dist_only, power=power, algo=algo,
                       interpret=interpret, chunk=chunk)


@functools.partial(
    jax.jit, static_argnames=("iterations", "glitch", "power", "algo",
                              "interpret", "chunk"))
def perturb_kernel_points(orbit, P, n_steps, dcr, dci, *, iterations: int,
                          glitch: bool = True, power: int = 2,
                          algo: str = "mandelbrot", interpret: bool = False,
                          chunk: int = PERT_KERNEL_CHUNK):
    """The δ-orbit kernel in points mode: δc arrives as two (k,) arrays
    (k a power of two ≥ 128, one entry per flagged pixel) instead of being
    derived from block iota — the device-resident glitch fallback."""
    return _delta_call(orbit, P, n_steps, (dcr, dci), iterations=iterations,
                       height=0, width=0, glitch=glitch, dist_only=False,
                       power=power, algo=algo, interpret=interpret,
                       chunk=chunk)


# ---------------------------------------------------------------------------
# Glitch fallback: exact ds32 re-render of the flagged pixels (sparse 1-D)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("algo", "power", "iterations", "k")
)
def _fallback_1d(params16, xs, ys, *, algo: str, power: int,
                 iterations: int, k: int):
    rep, rule, is_ds, eps_sq, _ = _rep_rule(algo, power, "ds32")
    P = [params16[i] for i in range(16)]
    return _iterate_tile(
        rep, rule, is_ds, algo == "julia", iterations, CHUNK,
        xs.reshape(1, k), ys.reshape(1, k), P, unroll=False, eps_sq=eps_sq,
    )


# ds32's double-word viewport resolves pixel coordinates to ~2^-48 of the
# view center; below this spacing the ds32 fallback would hand glitched
# pixels a garbage (coordinate-collapsed) value — multi-reference
# perturbation takes over instead.
DS32_FALLBACK_SPACING_LIMIT = 1e-13


@functools.partial(jax.jit, static_argnames=("iterations", "k", "chunk",
                                             "power", "algo", "extreme"))
def _pert_fallback_1d_jit(orbit, P, n_steps, xs, ys, *, iterations: int,
                          k: int, chunk: int = PERT_CHUNK_CPU,
                          power: int = 2, algo: str = "mandelbrot",
                          extreme: bool = False):
    """δ-orbit iteration of an arbitrary 1-D pixel list against a
    (secondary) reference orbit — the re-render pass of multi-reference
    perturbation."""
    rows = orbit.shape[0]

    def load_block(n0):
        start = jnp.minimum(n0, jnp.int32(rows - chunk))
        return jax.lax.dynamic_slice(orbit, (start, jnp.int32(0)), (chunk, 8))

    if extreme:
        fe_chunk = min(chunk, 4)  # shallow unroll: XLA:CPU slow-compile

        def load_block_fe(n0):
            start = jnp.minimum(n0, jnp.int32(rows - fe_chunk))
            return jax.lax.dynamic_slice(orbit, (start, jnp.int32(0)),
                                         (fe_chunk, 8))

        return _perturb_tile_fe(xs.reshape(1, k), ys.reshape(1, k), P,
                                n_steps, iterations, fe_chunk,
                                load_block_fe)
    return _perturb_tile(xs.reshape(1, k), ys.reshape(1, k), P, n_steps,
                         iterations, chunk, load_block, power=power,
                         algo=algo)


_SLICE_CACHE: dict = {}


def _sliced_orbit(orbit: RefOrbit, iterations: int) -> RefOrbit:
    """Clip a (possibly larger-budget) cached orbit to this view's static
    row count so array shapes — and hence compiled programs — stay stable
    across reuse.  n_steps is clipped to the budget too: the clipped table
    still covers every consumable row, and n_steps ≥ iterations disables
    the ran-out flag exactly as the original would.  Memoized per
    (orbit, budget) so the clipped table keeps a stable identity for the
    device-array cache (``_packed_for`` keys by id)."""
    rows = iterations + ORBIT_PAD
    if orbit.packed.shape[0] == rows:
        return orbit
    key = (id(orbit.packed), rows)
    hit = _cache_get(_SLICE_CACHE, key)
    if hit is not None:
        return hit[1]
    if orbit.packed.shape[0] >= rows:
        packed = np.ascontiguousarray(orbit.packed[:rows])
    else:
        # An ESCAPED orbit cached under a smaller budget is shorter than
        # this view's static row count: zero-pad so every pack shares one
        # shape (np.stack in _refs_device_pack requires it, and the padded
        # rows are never consumed — the kernels freeze at n ≥ n_steps).
        packed = np.zeros((rows, 8), np.float32)
        packed[: orbit.packed.shape[0]] = orbit.packed
    sliced = RefOrbit(packed,
                      min(orbit.n_steps, iterations), orbit.ref_px)
    _cache_put(_SLICE_CACHE, key, (orbit.packed, sliced))
    return sliced


def _candidate_refs(scene, width: int, height: int, limit: int = 4):
    """Cached orbits usable as secondary references for this view (newest
    first): same algo/julia/limit, exact starting c inside the view, and a
    complete walk (full budget, or escaped before its own budget).  Used by
    the multiref resolver to try known orbits before paying fresh
    high-precision walks — on an interactive pan the previous view's
    secondaries sit near the same minibrots and usually still resolve."""
    (Ar, Cr), (Ai, Ci) = _affine_fractions(width, height, exact_pos(scene),
                                           scene.scale)
    want = (scene.algo, scene.power,
            scene.julia_set if scene.algo == "julia" else None,
            float(scene.limit))
    out = []
    for ckey in reversed(list(_C_ORBIT_CACHE.keys())):
        algo, power, jl, lim, c0r_f, c0i_f = ckey
        if (algo, power, jl, lim) != want:
            continue
        orbit, iters = _C_ORBIT_CACHE[ckey]
        complete = iters >= scene.iterations or orbit.n_steps < iters
        if not complete:
            continue
        u = (c0r_f - Cr) / Ar
        v = (c0i_f - Ci) / Ai
        if 0 <= u <= width - 1 and 0 <= v <= height - 1:
            out.append(((float(u), float(v)),
                        _sliced_orbit(orbit, scene.iterations)))
            if len(out) >= limit:
                break
    return out


MULTIREF_MAX_ROUNDS = 16
MULTIREF_DRY_ROUNDS = 3

# Residuals that survive every multiref round are ALWAYS finished exactly
# by direct high-precision iteration — there is no best-effort path.  The
# only knob is a WARNING threshold: when the projected wall time (measured
# from the first resolved pixel of the actual set, so it reflects the
# native walker and the view's digit count) exceeds this, the resolver
# says how long it expects to take.
DIRECT_RESOLVE_WARN_S = 30.0


def _direct_resolve(scene, idx, width: int, height: int, row0: int = 0):
    """Resolve pixels by DIRECT high-precision iteration — the same walk
    (and digit budget) as ``reference_orbit``, per pixel at its
    exact-rational c.  O(iterations) host work per pixel: only for the
    residual sets that survive every multiref round (a set whose projected
    wall exceeds DIRECT_RESOLVE_WARN_S warns but is still finished
    exactly).  Count and final-z semantics mirror the δ-orbit twins: the
    escaping step is not counted, z freezes at its first beyond-limit
    value."""
    from fractal_tpu.ops import native_walk

    (Ar, Cr), (Ai, Ci) = _affine_fractions(width, height, exact_pos(scene),
                                           scene.scale)
    limit_sq = float(scene.limit) ** 2
    spacing = scene.pixel_spacing / scene.supersample
    prec = native_walk.dps_to_prec(_walk_digits(spacing))
    n_px = idx.size
    out_zr = np.empty(n_px, np.float32)
    out_zi = np.empty(n_px, np.float32)
    out_cnt = np.empty(n_px, np.int32)
    d = eff_power(scene.algo, scene.power)
    t_start = time.perf_counter()
    for j in range(n_px):
        if j == 1:
            est = (time.perf_counter() - t_start) * n_px
            if est > DIRECT_RESOLVE_WARN_S:
                import warnings

                warnings.warn(
                    f"direct resolve of {n_px} residual pixel(s) at "
                    f"{scene.iterations} iterations projects to "
                    f"~{est:.0f} s of host walking (every pixel is "
                    f"finished exactly; no best-effort values)",
                    stacklevel=2)
        x = int(idx[j] % width)
        y = int(idx[j] // width) + row0
        z = (native_walk.mpf_from_fraction(Ar * x + Cr, prec),
             native_walk.mpf_from_fraction(Ai * y + Ci, prec))
        res = native_walk.direct(scene.algo, d, prec, z,
                                 _walk_c(scene, z, prec),
                                 scene.iterations, limit_sq)
        if res is None:
            raise ValueError(_WALK_DECLINED.format(scene.algo, prec))
        out_zr[j], out_zi[j], out_cnt[j] = res
    return out_zr, out_zi, out_cnt


def _multiref_resolve(scene, idx, width: int, height: int,
                      max_refs: int = MULTIREF_MAX_ROUNDS,
                      refs_out: list = None, row0: int = 0):
    """Re-render the flagged pixel list with successive secondary reference
    orbits (classic multi-reference perturbation: each round picks the
    medoid of the still-glitched pixels as the next reference, whose own
    neighborhood then iterates glitch-free).  Cached orbits inside the view
    are tried FIRST (``_candidate_refs``): on a pan, the previous view's
    references usually still resolve, skipping the high-precision walks
    that dominate interactive latency.  Returns (zr, zi, cnt) f32/i32
    arrays in ``idx`` order; pixels still flagged after ``max_refs`` medoid
    rounds are ALWAYS finished EXACTLY by direct high-precision iteration
    (``_direct_resolve``) — a set whose projected wall time is large warns
    but never keeps best-effort values.

    ``refs_out`` (optional list) collects ``(ref_px, orbit)`` pairs for the
    references that resolved pixels, so the caller can cache them and run
    later frames of the same view through the device-resident fallback.

    ``idx``/``row0``: flat indices into a (rows, width) slab whose first row
    is global row ``row0`` of the (height, width) grid — banded renders
    (fractal_tpu.tiled) resolve their glitches in global coordinates while
    keeping ``height`` the FULL grid height (the viewport affine's
    normalizer).

    Returns ``(zr, zi, cnt, n_residual)`` — always 0 since r5: pixels
    still glitched after every round are finished exactly by
    ``_direct_resolve`` regardless of set size, so no
    pixel is ever best-effort.  The return stays for the callers'
    ``RENDER_STATS`` plumbing."""
    n = idx.size
    out_zr = np.zeros(n, np.float32)
    out_zi = np.zeros(n, np.float32)
    out_cnt = np.zeros(n, np.int32)
    remaining = np.arange(n)
    candidates = _candidate_refs(scene, width, height)
    medoid_rounds = 0
    dry = 0  # consecutive zero-progress walked rounds
    tried: set = set()  # failed medoids: never re-pick for the same resolve
    while remaining.size and medoid_rounds < max_refs \
            and dry < MULTIREF_DRY_ROUNDS:
        xs = (idx[remaining] % width).astype(np.float32)
        ys = (idx[remaining] // width + row0).astype(np.float32)
        if candidates:
            ref, orbit = candidates.pop(0)
            walked = False
        else:
            d2 = (xs - xs.mean()) ** 2 + (ys - ys.mean()) ** 2
            ref = None
            for mi in np.argsort(d2, kind="stable"):
                cand = (int(xs[mi]), int(ys[mi]))
                if cand not in tried:
                    ref = cand
                    break
            if ref is None:
                break  # every remaining pixel already failed as a reference
            tried.add(ref)
            orbit = reference_orbit(scene, ref, width, height)
            medoid_rounds += 1
            walked = True
        P = (_pert_params_fe(scene, ref, width, height)
             if _is_extreme(scene) else
             _pert_params(scene, ref, width, height))
        k = 1 << max(7, (remaining.size - 1).bit_length())
        xs_p = np.full(k, float(width), np.float32)   # pad off-image: escapes
        ys_p = np.full(k, float(height), np.float32)
        xs_p[: remaining.size] = xs
        ys_p[: remaining.size] = ys
        zr1, zi1, cnt1, gl1 = _pert_fallback_1d_jit(
            jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
            jnp.asarray(xs_p), jnp.asarray(ys_p),
            iterations=scene.iterations, k=k, power=scene.power,
            algo=scene.algo, extreme=_is_extreme(scene),
        )
        zr1 = np.asarray(zr1).ravel()[: remaining.size]
        zi1 = np.asarray(zi1).ravel()[: remaining.size]
        cnt1 = np.asarray(cnt1).ravel()[: remaining.size]
        gl1 = np.asarray(gl1).ravel()[: remaining.size]
        resolved_any = bool((gl1 == 0).any())
        if walked:
            dry = 0 if resolved_any else dry + 1
        if not (walked or resolved_any):
            continue  # useless cached candidate: no writes, try the next
        if refs_out is not None and resolved_any:
            # only orbits that actually de-glitched pixels are worth packing
            # into the warm-frame device program (a no-op walked medoid
            # would burn a kernel pass per frame for nothing)
            refs_out.append((ref, orbit))
        out_zr[remaining] = zr1
        out_zi[remaining] = zi1
        out_cnt[remaining] = cnt1
        remaining = remaining[gl1 != 0]
    if remaining.size:
        # finish EVERY residual EXACTLY by direct high-precision iteration
        # (no best-effort path — see DIRECT_RESOLVE_WARN_S above; a huge
        # set warns with its projected wall time but still resolves)
        dzr, dzi, dcnt = _direct_resolve(scene, idx[remaining], width,
                                         height, row0=row0)
        out_zr[remaining] = dzr
        out_zi[remaining] = dzi
        out_cnt[remaining] = dcnt
        remaining = remaining[:0]
    return out_zr, out_zi, out_cnt, int(remaining.size)


_MULTIREF_CACHE: dict = {}

# Dense per-view glitch-resolution cache (see render_perturb): value is
# () for a measured-glitch-free view, else (mask, zrF, ziF, cntF) device
# arrays.  Dense f32 triples are ~48 MB at 9 Mpix, so the cap is small —
# it only needs to hold the interactively-current view(s).
_FIX_CACHE: dict = {}
_FIX_CACHE_MAX = 2


@jax.jit
def _fix_color_jit(scene, zr, zi, cnt, mask, zrF, ziF, cntF):
    """Fused warm-frame glitch fix + color: replace the glitched pixels
    with their cached resolved values, then color — one elementwise pass,
    no compaction/scatter (see render_perturb's fix-cache comment)."""
    from fractal_tpu.render import _color_and_downsample

    zr = jnp.where(mask, zrF, zr)
    zi = jnp.where(mask, ziF, zi)
    cnt = jnp.where(mask, cntF, cnt)
    return _color_and_downsample(scene, zr, zi, cnt)


@functools.partial(jax.jit, static_argnames=("iterations", "kpad", "n_refs",
                                             "height", "width", "chunk",
                                             "impl", "power", "algo",
                                             "extreme"))
def _multiref_fallback_color_jit(scene, zr, zi, cnt, gl, orbits, Ps, n_stepss,
                                 *, iterations: int, kpad: int, n_refs: int,
                                 height: int, width: int,
                                 chunk: int = PERT_CHUNK_CPU,
                                 impl: str = route.XLA, power: int = 2,
                                 algo: str = "mandelbrot",
                                 extreme: bool = False):
    """Device-resident multi-reference glitch resolution for warm frames.

    The cold frame discovers the secondary reference pixels on the host
    (``_multiref_resolve``); once their orbits are cached, every later frame
    of the same view resolves its glitches in ONE device program: find the
    flagged pixels (static-size nonzero), δ-iterate them against each cached
    secondary orbit in turn (first de-glitching ref wins), scatter back,
    color.  No big arrays cross to the host."""
    from fractal_tpu.render import _color_and_downsample

    idx = jnp.nonzero(gl.ravel(), size=kpad, fill_value=height * width)[0]
    in_img = idx < height * width
    xs = jnp.where(in_img, (idx % width), width).astype(jnp.float32)
    ys = jnp.where(in_img, (idx // width), height).astype(jnp.float32)

    fzr = jnp.zeros((kpad,), jnp.float32)
    fzi = jnp.zeros((kpad,), jnp.float32)
    fcnt = jnp.zeros((kpad,), jnp.int32)
    pending = jnp.ones((kpad,), jnp.bool_)
    unresolved = jnp.ones((kpad,), jnp.bool_)
    rows = orbits.shape[1]

    for r in range(n_refs):
        if impl != route.XLA and not extreme:
            # δc per flagged pixel for the points-mode kernel (kpad is a
            # power of two ≥ 128)
            dcr = (xs - Ps[r, 2]) * Ps[r, 0]
            dci = (ys - Ps[r, 3]) * Ps[r, 1]
            rzr, rzi, rcnt, rgl = perturb_kernel_points(
                orbits[r], Ps[r], n_stepss[r], dcr, dci,
                iterations=iterations, glitch=True, power=power, algo=algo,
                interpret=impl == route.INTERPRET)
        else:
            orbit = orbits[r]

            def load_block(n0, orbit=orbit):
                start = jnp.minimum(n0, jnp.int32(rows - chunk))
                return jax.lax.dynamic_slice(orbit, (start, jnp.int32(0)),
                                             (chunk, 8))

            Pr = [Ps[r, i] for i in range(16)]
            if extreme:
                fe_chunk = min(chunk, 4)

                def load_block_fe(n0, orbit=orbit):
                    start = jnp.minimum(n0, jnp.int32(rows - fe_chunk))
                    return jax.lax.dynamic_slice(
                        orbit, (start, jnp.int32(0)), (fe_chunk, 8))

                rzr, rzi, rcnt, rgl = _perturb_tile_fe(
                    xs.reshape(1, kpad), ys.reshape(1, kpad), Pr,
                    n_stepss[r], iterations, fe_chunk, load_block_fe)
            else:
                rzr, rzi, rcnt, rgl = _perturb_tile(
                    xs.reshape(1, kpad), ys.reshape(1, kpad), Pr,
                    n_stepss[r], iterations, chunk, load_block,
                    power=power, algo=algo)
        ok = rgl.ravel() == 0
        take = pending & (ok | (r == n_refs - 1))
        fzr = jnp.where(take, rzr.ravel(), fzr)
        fzi = jnp.where(take, rzi.ravel(), fzi)
        fcnt = jnp.where(take, rcnt.ravel(), fcnt)
        unresolved = unresolved & ~(pending & ok)
        pending = pending & ~take

    # pixels no reference de-glitched (the forced last-ref take is
    # best-effort, not a resolution) — callers use this residual to decide
    # whether a host-driven medoid walk is still needed
    n_residual = jnp.sum((unresolved & in_img).astype(jnp.int32))
    shape = (height, width)
    zr = zr.ravel().at[idx].set(fzr, mode="drop").reshape(shape)
    zi = zi.ravel().at[idx].set(fzi, mode="drop").reshape(shape)
    cnt = cnt.ravel().at[idx].set(fcnt, mode="drop").reshape(shape)
    return _color_and_downsample(scene, zr, zi, cnt), zr, zi, cnt, n_residual


@functools.partial(jax.jit, static_argnames=("height", "width"))
def _scatter_fixed(zr, zi, cnt, idx, fzr, fzi, fcnt, *, height, width):
    shape = (height, width)
    zr = zr.ravel().at[idx].set(fzr, mode="drop").reshape(shape)
    zi = zi.ravel().at[idx].set(fzi, mode="drop").reshape(shape)
    cnt = cnt.ravel().at[idx].set(fcnt, mode="drop").reshape(shape)
    return zr, zi, cnt


def _apply_fallback(scene, zr, zi, cnt, gl, width: int, height: int,
                    row0: int = 0, full_height: int = None):
    """Resolve glitched pixels of a (height, width) slab exactly.

    ``row0``/``full_height``: when the slab is a horizontal band of a
    bigger render (fractal_tpu.tiled), the fallback's pixel coordinates
    must be GLOBAL — ``full_height`` is the whole grid's height (the
    viewport affine normalizer) and ``row0`` the band's first global row.
    Defaults reproduce the whole-image case."""
    full_height = height if full_height is None else full_height
    # One scalar device reduction first: the common case is zero glitches,
    # and pulling the full (zr, zi, cnt, gl) set to the host would move
    # ~50 MB at 1080p for nothing.
    if int(jnp.sum(gl, dtype=jnp.int32)) == 0:
        return zr, zi, cnt, 0
    # only the (u8-compressed) mask crosses to the host; the big arrays stay
    # device-resident and are patched with a scatter
    idx = np.flatnonzero(np.asarray(gl.astype(jnp.uint8)))
    if idx.size == 0:
        return zr, zi, cnt, 0
    spacing = scene.pixel_spacing / scene.supersample
    if spacing > DS32_FALLBACK_SPACING_LIMIT:
        k = 1 << max(7, (idx.size - 1).bit_length())  # pow-2 buckets, min 128
        xs = np.zeros(k, np.float32)
        ys = np.zeros(k, np.float32)
        xs[: idx.size] = (idx % width).astype(np.float32)
        ys[: idx.size] = (idx // width + row0).astype(np.float32)
        params16 = scene_params(scene, full_height, width)
        fzr, fzi, fcnt = _fallback_1d(
            params16, jnp.asarray(xs), jnp.asarray(ys),
            algo=scene.algo, power=scene.power, iterations=scene.iterations,
            k=k,
        )
        fzr = fzr.ravel()[: idx.size]
        fzi = fzi.ravel()[: idx.size]
        fcnt = fcnt.ravel()[: idx.size]
    else:
        hzr, hzi, hcnt, nres = _multiref_resolve(scene, idx, width,
                                                 full_height, row0=row0)
        RENDER_STATS["n_residual"] = nres
        fzr, fzi, fcnt = (jnp.asarray(hzr), jnp.asarray(hzi),
                          jnp.asarray(hcnt))
    zr, zi, cnt = _scatter_fixed(
        zr, zi, cnt, jnp.asarray(idx.astype(np.int32)), fzr, fzi, fcnt,
        height=height, width=width,
    )
    return zr, zi, cnt, int(idx.size)


# ---------------------------------------------------------------------------
# Public: full perturbation render
# ---------------------------------------------------------------------------


def iterate_perturb(scene, height: int, width: int, use_pallas: bool):
    """(zr, zi, cnt) for a scene via perturbation + exact glitch fallback."""
    ref_px = choose_reference(scene, width, height)
    orbit = reference_orbit(scene, ref_px, width, height)
    P = (_pert_params_fe(scene, ref_px, width, height) if _is_extreme(scene)
         else _pert_params(scene, ref_px, width, height, orbit=orbit))
    # use_pallas here means "on an accelerator": it only decides the twin's
    # chunk depth.
    chunk = PERT_CHUNK if use_pallas else PERT_CHUNK_CPU
    zr, zi, cnt, gl = perturb_whole_jnp(
        jnp.asarray(orbit.packed), P, jnp.int32(orbit.n_steps),
        iterations=scene.iterations, height=height, width=width, chunk=chunk,
        power=eff_power(scene.algo, scene.power),
        algo=scene.algo, extreme=_is_extreme(scene),
    )
    zr, zi, cnt, n_glitch = _apply_fallback(
        scene, zr, zi, cnt, gl, width, height
    )
    return zr, zi, cnt, n_glitch


# Spatial early-exit granularity: the δ-orbit loop is lock-step across its
# whole array, so exterior regions would burn until the worst pixel of the
# IMAGE finishes.  Rendering in horizontal bands inside one lax.map program
# restores band-level early exit (and caps live state memory) at zero extra
# dispatches.
PERT_BAND_ROWS = 256


@functools.partial(jax.jit, static_argnames=("height", "width", "chunk",
                                             "bla_offsets", "power",
                                             "algo", "extreme"))
def _render_perturb_jit(scene, orbit, P, n_steps, *, height: int, width: int,
                        chunk: int, bla_packed=None, bla_offsets=None,
                        power: int = 2, algo: str = "mandelbrot",
                        extreme: bool = False):
    """One fused device program: banded δ-orbit iteration → coloring →
    glitch count, so the happy path (no glitches) is exactly one program
    and one scalar fetch."""
    from fractal_tpu.render import _color_and_downsample

    ss = scene.supersample
    band = min(height, max(ss, (PERT_BAND_ROWS // ss) * ss))
    n_bands = _cdiv(height, band)
    hp = n_bands * band

    def one_band(start):
        p_local = P.at[7].set(start.astype(jnp.float32))
        return perturb_whole_jnp(
            orbit, p_local, n_steps,
            iterations=scene.iterations, height=band, width=width,
            chunk=chunk, bla_packed=bla_packed, bla_offsets=bla_offsets,
            power=power, algo=algo, extreme=extreme,
        )

    starts = jnp.arange(n_bands, dtype=jnp.int32) * band
    zr, zi, cnt, gl = jax.lax.map(one_band, starts)
    zr = zr.reshape(hp, width)[:height]
    zi = zi.reshape(hp, width)[:height]
    cnt = cnt.reshape(hp, width)[:height]
    gl = gl.reshape(hp, width)[:height]
    img = _color_and_downsample(scene, zr, zi, cnt)
    return img, jnp.sum(gl, dtype=jnp.int32), zr, zi, cnt, gl


@functools.partial(jax.jit, static_argnames=("kpad", "height", "width"))
def _fallback_and_color_jit(scene, params16, zr, zi, cnt, gl, *, kpad: int,
                            height: int, width: int):
    """Device-resident glitch fallback: find the flagged pixels with a
    static-size nonzero, re-iterate them exactly in ds32 as a 1-D batch,
    scatter the results back, and color — zero host transfers of the big
    arrays."""
    from fractal_tpu.render import _color_and_downsample

    idx = jnp.nonzero(gl.ravel(), size=kpad, fill_value=height * width)[0]
    xs = (idx % width).astype(jnp.float32)
    ys = (idx // width).astype(jnp.float32)
    fzr, fzi, fcnt = _fallback_1d(
        params16, xs, ys, algo=scene.algo, power=scene.power,
        iterations=scene.iterations, k=kpad,
    )
    shape = (height, width)
    zr = zr.ravel().at[idx].set(fzr.ravel(), mode="drop").reshape(shape)
    zi = zi.ravel().at[idx].set(fzi.ravel(), mode="drop").reshape(shape)
    cnt = cnt.ravel().at[idx].set(fcnt.ravel(), mode="drop").reshape(shape)
    return _color_and_downsample(scene, zr, zi, cnt)


_BLA_CACHE: dict = {}


def _bla_for(scene, orbit, ref_px, width: int, height: int,
             fe: bool = False):
    """Build (cached) the BLA merge tree for this orbit/view.  ``fe``
    selects the extended-exponent table for the extreme-depth tier."""
    from fractal_tpu.ops.bla import build_table, build_table_fe

    key = _orbit_key(scene, ref_px, width, height) + (fe,)
    hit = _cache_get(_BLA_CACHE, key)
    if hit is not None:
        return hit
    (Ar, _), (Ai, _) = _affine_fractions(width, height, exact_pos(scene), scene.scale)
    u0, v0 = ref_px
    if fe:
        # f64 holds |δc| down to ~1e-300 (the host-affine depth bound);
        # below, dc_max flushes to 0 and the table radii with it (BLA off)
        dcr_max = float(max(u0, width - 1 - u0) * abs(Ar))
        dci_max = float(max(v0, height - 1 - v0) * abs(Ai))
        dc_max = math.hypot(dcr_max, dci_max)
        table = build_table_fe(orbit.packed[:, :2], orbit.n_steps,
                               scene.iterations, dc_max,
                               min_level=BLA_MIN_LEVEL)
    else:
        dcr_max = max(u0, width - 1 - u0) * abs(float(Ar))
        dci_max = max(v0, height - 1 - v0) * abs(float(Ai))
        dc_max = math.hypot(dcr_max, dci_max)
        table = build_table(orbit.packed[:, :2], orbit.n_steps,
                            scene.iterations, dc_max,
                            min_level=BLA_MIN_LEVEL)
    _cache_put(_BLA_CACHE, key, table)
    return table


_PACKED_CACHE: dict = {}


def _packed_for(scene, orbit, ref_px, width, height, fast: bool):
    """Cached device-resident orbit table, keyed by the ORBIT's identity
    (not the view): a pan reuses the same orbit (resolve_reference) and
    bands share it, so neither re-uploads the table.  The cached value pins
    ``orbit.packed`` so the id stays unique while the entry lives.  The
    fast tier stores a gtol-zeroed copy (the Pauldelbrot test never
    fires)."""
    key = (id(orbit.packed), fast)
    hit = _cache_get(_PACKED_CACHE, key)
    if hit is not None:
        return hit[1]
    packed = orbit.packed
    if fast:
        packed = packed.copy()
        packed[:, 4] = 0.0  # gtol 0 ⇒ the glitch test never fires
    dev = jnp.asarray(packed)
    _cache_put(_PACKED_CACHE, key, (orbit.packed, dev))
    return dev


_BLA_DEV_CACHE: dict = {}


def _bla_dev_for(scene, orbit, ref_px, width, height, fe: bool = False):
    """(device bla table, offsets) — cached jnp conversion of ``_bla_for``."""
    key = _orbit_key(scene, ref_px, width, height) + (fe,)
    hit = _cache_get(_BLA_DEV_CACHE, key)
    if hit is not None:
        return hit
    table = _bla_for(scene, orbit, ref_px, width, height, fe=fe)
    dev = (jnp.asarray(table.packed), table.offsets)
    _cache_put(_BLA_DEV_CACHE, key, dev)
    return dev


def _perturb_setup(scene, fast: bool, force_kernel=None):
    """Common prologue for the whole-image, banded and sharded perturbation
    renders: validates the algo, resolves the reference pixel/orbit/params
    once (all cached per view), and returns the device inputs.

    Returns (h, w, impl, ref_px, orbit, P, ns, dev) where ``impl`` is the
    δ-orbit implementation (ops/route.py; ``force_kernel`` as in
    ``route.forced_kernel_impl``) and ``dev`` the device-resident
    (packed orbit, bla_packed, bla_offsets) triple — the BLA table only
    where the twin runs it.  Extreme depth (floatexp) always runs the
    twin."""
    quad = scene.power == 2 and scene.algo in ("mandelbrot", "julia")
    if not perturb_supported(scene.algo, scene.power):
        raise ValueError(
            f"perturbation supports the z^d+c family (mandelbrot/julia/"
            f"multibrot, d >= 2), burning ship, and tricorn — not "
            f"{scene.algo} (power {scene.power}); use ds32/dd64")
    extreme = _is_extreme(scene)
    if extreme and not quad:
        raise ValueError(
            f"zooms past ~1e30× (floatexp δ-orbits) support quadratic "
            f"mandelbrot/julia only, not {scene.algo}")
    ss = scene.supersample
    h, w = scene.height * ss, scene.width * ss
    impl = route.XLA if extreme else route.forced_kernel_impl(force_kernel)
    ref_px, orbit = resolve_reference(scene, w, h)
    P = (_pert_params_fe(scene, ref_px, w, h) if extreme
         else _pert_params(scene, ref_px, w, h, orbit=orbit))
    ns = jnp.int32(orbit.n_steps)
    packed = _packed_for(scene, orbit, ref_px, w, h, fast)
    bla_packed, bla_offsets = None, None
    if impl == route.XLA and quad and not extreme:
        bla_packed, bla_offsets = _bla_dev_for(scene, orbit, ref_px, w, h)
    elif quad and extreme and _fe_bla_useful(scene, orbit, ref_px, w, h):
        # extended-exponent table (build_table_fe): engaged only when
        # deep merge levels survive — the skip-scan overhead loses on
        # expanding (needle-type) orbits where no level is ever valid.
        # BLA linearizes the QUADRATIC recurrence only — a bilinear skip
        # corrupts counts for the fold/conjugate/binomial forms.
        bla_packed, bla_offsets = _bla_dev_for(scene, orbit, ref_px, w, h,
                                               fe=True)
    return h, w, impl, ref_px, orbit, P, ns, (packed, bla_packed,
                                               bla_offsets)


# minimum table level (above BLA_MIN_LEVEL) with a valid entry for the fe
# BLA path to be engaged: skips of < 256 steps don't amortize the per-scan
# overhead of the extreme macro loop
FE_BLA_MIN_USEFUL_LEVEL = 2


def _fe_bla_useful(scene, orbit, ref_px, width, height) -> bool:
    """Whether the extreme-depth BLA table for this view has valid entries
    at a depth worth the macro-loop overhead (contracting/minibrot-
    adjacent orbits: yes; maximally-expanding needle orbits: never)."""
    table = _bla_for(scene, orbit, ref_px, width, height, fe=True)
    if table.levels <= FE_BLA_MIN_USEFUL_LEVEL:
        return False
    start = table.offsets[FE_BLA_MIN_USEFUL_LEVEL]
    return bool((table.packed[start:, 6] > 0.0).any())


@functools.partial(jax.jit, static_argnames=("height", "width", "power",
                                             "algo", "interpret"))
def _render_perturb_kernel_jit(scene, orbit, P, n_steps, *, height: int,
                               width: int, power: int = 2,
                               algo: str = "mandelbrot",
                               interpret: bool = False):
    """One fused program: δ-orbit kernel → coloring → glitch count."""
    from fractal_tpu.render import _color_and_downsample

    zr, zi, cnt, gl = perturb_kernel(
        orbit, P, n_steps, iterations=scene.iterations, height=height,
        width=width, glitch=True, power=power, algo=algo,
        interpret=interpret,
    )
    img = _color_and_downsample(scene, zr, zi, cnt)
    return img, jnp.sum(gl, dtype=jnp.int32), zr, zi, cnt, gl


@functools.partial(jax.jit, static_argnames=("height", "width", "power",
                                             "algo", "interpret"))
def _render_perturb_kernel_fast_jit(scene, orbit, P, n_steps, *,
                                    height: int, width: int,
                                    power: int = 2,
                                    algo: str = "mandelbrot",
                                    interpret: bool = False):
    """p32 fast tier as one fused program: the dist-only δ-orbit kernel
    (no zfr/zfi freeze selects or outputs — coloring needs only |z|², see
    ``_build_delta_kernel``) → coloring.  Bit-identical image to the full
    kernel + ``_color_and_downsample`` (pinned in tests)."""
    from fractal_tpu.render import _color_and_downsample_dist

    d, cnt = perturb_kernel(
        orbit, P, n_steps, iterations=scene.iterations, height=height,
        width=width, glitch=False, dist_only=True, power=power, algo=algo,
        interpret=interpret,
    )
    return _color_and_downsample_dist(scene, d, cnt)


def render_perturb(scene, fast: bool = False):
    """Full perturbation render → (H, W, 3) uint8 device array.

    ``fast=True`` is the documented p32 tier: glitch detection and the
    exact fallback are disabled — classification (interior/escaped) stays
    >99.9 % correct at mid-depth zooms, while long-running boundary pixels
    carry f32 trajectory noise (±few counts of chaotic-filament texture).
    """
    ss = scene.supersample
    h, w, impl, ref_px, orbit, P, ns, dev = _perturb_setup(scene, fast)
    RENDER_STATS.update(
        n_glitch=None if fast else 0, n_residual=0,
        tier=("p32" if fast else
              "floatexp" if _is_extreme(scene) else "perturb"),
        route="")
    packed, bla_packed, bla_offsets = dev
    pw = eff_power(scene.algo, scene.power)
    if impl != route.XLA:
        RENDER_STATS["route"] = "kernel"
        interpret = impl == route.INTERPRET
        if fast:
            return _render_perturb_kernel_fast_jit(
                scene, packed, P, ns, height=h, width=w, power=pw,
                algo=scene.algo, interpret=interpret)
        img, n_gl, zr, zi, cnt, gl = _render_perturb_kernel_jit(
            scene, packed, P, ns, height=h, width=w, power=pw,
            algo=scene.algo, interpret=interpret)
    else:
        RENDER_STATS["route"] = "xla-twin" + (
            "-fe" if _is_extreme(scene) else "") + (
            "-bla" if bla_packed is not None else "")
        img, n_gl, zr, zi, cnt, gl = _render_perturb_jit(
            scene, packed, P, ns,
            height=h, width=w, chunk=_twin_chunk(),
            bla_packed=bla_packed, bla_offsets=bla_offsets,
            power=pw, algo=scene.algo, extreme=_is_extreme(scene),
        )
        if fast:
            return img
    # Warm-frame fix cache: the resolved values of a view's glitched pixels
    # are a deterministic function of the view (like the orbit/BLA/SA
    # caches), so the cold frame's resolution is cached DENSE and every
    # later frame replaces its glitched pixels with one fused mask-select +
    # color pass.  This removes the warm resolve's jnp.nonzero over the
    # full image, its scatters, the per-reference δ-orbit re-runs, and the
    # n_gl host sync.
    fkey = _orbit_key(scene, ("fix",) + tuple(ref_px), w, h)
    fixed = _cache_get(_FIX_CACHE, fkey)
    if fixed is not None:
        if fixed == ():  # view measured glitch-free on the cold frame
            return img
        mask, zrF, ziF, cntF, n_cold = fixed
        RENDER_STATS["n_glitch"] = n_cold
        return _fix_color_jit(scene, zr, zi, cnt, mask, zrF, ziF, cntF)
    n = int(n_gl)
    RENDER_STATS["n_glitch"] = n
    if n == 0:
        _cache_put(_FIX_CACHE, fkey, (), cap=_FIX_CACHE_MAX)
        return img
    spacing = scene.pixel_spacing / ss
    if spacing > DS32_FALLBACK_SPACING_LIMIT:
        # ds32 resolves these pixels exactly: fully device-resident pass
        kpad = 1 << max(7, (n - 1).bit_length())  # pow-2 buckets, min 128
        params16 = scene_params(scene, h, w)
        return _fallback_and_color_jit(scene, params16, zr, zi, cnt, gl,
                                       kpad=kpad, height=h, width=w)
    # Deeper than ds32's wall: multi-reference perturbation.  The first
    # frame of a view discovers the secondary reference pixels on the host
    # (medoid rounds, incl. the glitch-mask fetch); their orbits are cached
    # so every later frame resolves device-resident in one program.
    view_key = _orbit_key(scene, ("multiref",), w, h)
    cached = _cache_get(_MULTIREF_CACHE, view_key)
    kpad = 1 << max(7, (n - 1).bit_length())
    if cached is None:
        # Pan fast path: before the host-driven resolve (mask fetch +
        # sequential device rounds, each a dispatch round trip), try the
        # cached in-view candidate orbits in ONE device program.  Only a
        # scalar residual count crosses to the host; if every glitched
        # pixel resolved (the common pan case), this replaces the whole
        # host loop.
        cands = _candidate_refs(scene, w, h)
        if cands:
            cached = _refs_device_pack(scene, cands, w, h)
            img2, zr2, zi2, cnt2, nres = _multiref_fallback_color_jit(
                scene, zr, zi, cnt, gl, cached[0], cached[1], cached[2],
                iterations=scene.iterations, kpad=kpad,
                n_refs=int(cached[0].shape[0]), height=h, width=w,
                chunk=_twin_chunk(), impl=impl, power=pw, algo=scene.algo,
                extreme=_is_extreme(scene),
            )
            RENDER_STATS["n_residual"] = int(nres)
            if int(nres) == 0:
                _cache_put(_MULTIREF_CACHE, view_key, cached)
                _cache_put(_FIX_CACHE, fkey, (gl != 0, zr2, zi2, cnt2, n),
                           cap=_FIX_CACHE_MAX)
                return img2
            cached = None  # candidates insufficient: full host resolve
        refs: list = []
        idx = np.flatnonzero(np.asarray(gl.astype(jnp.uint8)))
        hzr, hzi, hcnt, nres = _multiref_resolve(scene, idx, w, h,
                                                 refs_out=refs)
        RENDER_STATS["n_residual"] = nres
        zr, zi, cnt = _scatter_fixed(
            zr, zi, cnt, jnp.asarray(idx.astype(np.int32)),
            jnp.asarray(hzr), jnp.asarray(hzi), jnp.asarray(hcnt),
            height=h, width=w,
        )
        _cache_put(_FIX_CACHE, fkey, (gl != 0, zr, zi, cnt, n),
                   cap=_FIX_CACHE_MAX)
        if refs:
            # refs carries (ref_px, orbit) pairs — candidate orbits reused
            # from other views must not be re-walked (their exact c is not
            # representable from the float pixel coordinate)
            _cache_put(_MULTIREF_CACHE, view_key,
                       _refs_device_pack(scene, refs, w, h))
        return _color_jit(scene, zr, zi, cnt)
    orbits, Ps, n_stepss = cached
    img2, zr2, zi2, cnt2, nres_dev = _multiref_fallback_color_jit(
        scene, zr, zi, cnt, gl, orbits, Ps, n_stepss,
        iterations=scene.iterations, kpad=kpad, n_refs=orbits.shape[0],
        height=h, width=w, chunk=_twin_chunk(), impl=impl, power=pw,
        algo=scene.algo, extreme=_is_extreme(scene),
    )
    _cache_put(_FIX_CACHE, fkey, (gl != 0, zr2, zi2, cnt2, n),
               cap=_FIX_CACHE_MAX)
    # device scalar, not int(): warm frames must not pay an extra host sync
    # for observability — consumers (viewer status, --profile) int() it
    RENDER_STATS["n_residual"] = nres_dev
    return img2


def _refs_device_pack(scene, refs, w, h):
    """(orbits, Ps, n_stepss) device pack for the multiref program from
    (ref_px, orbit) pairs."""
    orbs = [_sliced_orbit(o, scene.iterations) for _, o in refs]
    pp = (_pert_params_fe if _is_extreme(scene) else _pert_params)
    return (
        jnp.asarray(np.stack([o.packed for o in orbs])),
        jnp.stack([pp(scene, r, w, h) for r, _ in refs]),
        jnp.asarray(np.array([o.n_steps for o in orbs], np.int32)),
    )


def _twin_chunk() -> int:
    """The δ-orbit twin's chunk on this platform (see PERT_CHUNK)."""
    return (PERT_CHUNK if route.kernel_impl() == route.TRITON
            else PERT_CHUNK_CPU)


@jax.jit
def _color_jit(scene, zr, zi, cnt):
    from fractal_tpu.render import _color_and_downsample

    return _color_and_downsample(scene, zr, zi, cnt)


@jax.jit
def _color_dist_jit(scene, dist, cnt):
    from fractal_tpu.render import _color_and_downsample_dist

    return _color_and_downsample_dist(scene, dist, cnt)


# ---------------------------------------------------------------------------
# Banded perturbation (persistence-capable; fractal_tpu.tiled)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("rows", "width", "glitch",
                                             "power", "algo", "dist_only",
                                             "interpret"))
def _perturb_band_kernel_jit(scene, orbit, P, n_steps, start, *, rows: int,
                             width: int, glitch: bool, power: int = 2,
                             algo: str = "mandelbrot",
                             dist_only: bool = False,
                             interpret: bool = False):
    p_local = P.at[7].set(start.astype(jnp.float32))
    return perturb_kernel(
        orbit, p_local, n_steps, iterations=scene.iterations, height=rows,
        width=width, glitch=glitch, power=power, algo=algo,
        dist_only=dist_only, interpret=interpret,
    )


@functools.partial(jax.jit, static_argnames=("rows", "width", "chunk",
                                             "bla_offsets", "power",
                                             "algo", "extreme"))
def _perturb_band_jnp_jit(scene, orbit, P, n_steps, start, *, rows: int,
                          width: int, chunk: int, bla_packed=None,
                          bla_offsets=None, power: int = 2,
                          algo: str = "mandelbrot", extreme: bool = False):
    p_local = P.at[7].set(start.astype(jnp.float32))
    return perturb_whole_jnp(
        orbit, p_local, n_steps, iterations=scene.iterations, height=rows,
        width=width, chunk=chunk, bla_packed=bla_packed,
        bla_offsets=bla_offsets, power=power, algo=algo, extreme=extreme,
    )


def render_perturb_band(scene, start_row: int, rows: int,
                        fast: bool = False):
    """Colored u8 band [start_row, start_row+rows) of the supersampled grid
    of a perturbation-depth render — the persistence-capable banding used
    by ``fractal_tpu.tiled`` (the reference renders one-shot with no resume
    at all, SURVEY.md §5).

    All bands share the view's single reference orbit/BLA caches; the
    kernel addresses global rows through the exact (stride=1,
    offset=start_row) row map, and each band resolves its own glitches in
    GLOBAL pixel coordinates (``_apply_fallback`` row0/full_height), so the
    assembled image equals the one-shot render — bit-identical when
    multi-reference resolution is not needed, and exactly-resolved either
    way (band-local secondary references may differ from the one-shot
    run's, but every resolved pixel is glitch-free against *its*
    reference)."""
    h, w, impl, ref_px, orbit, P, ns, dev = _perturb_setup(scene, fast)
    packed, bla_packed, bla_offsets = dev
    start = jnp.float32(start_row)
    pw = eff_power(scene.algo, scene.power)
    if impl != route.XLA:
        interpret = impl == route.INTERPRET
        if fast:
            # p32 band: the dist-only kernel form, same as the one-shot
            # fast tier and the sharded bands (bit-identical image; the
            # coloring epilogue consumes |z|² alone)
            dist, cnt = _perturb_band_kernel_jit(
                scene, packed, P, ns, start, rows=rows, width=w,
                glitch=False, power=pw, algo=scene.algo, dist_only=True,
                interpret=interpret,
            )
            return _color_dist_jit(scene, dist, cnt)
        zr, zi, cnt, gl = _perturb_band_kernel_jit(
            scene, packed, P, ns, start, rows=rows, width=w, glitch=True,
            power=pw, algo=scene.algo, interpret=interpret,
        )
    else:
        zr, zi, cnt, gl = _perturb_band_jnp_jit(
            scene, packed, P, ns, start, rows=rows, width=w,
            chunk=_twin_chunk(), bla_packed=bla_packed,
            bla_offsets=bla_offsets, power=pw, algo=scene.algo,
            extreme=_is_extreme(scene),
        )
    if not fast:
        zr, zi, cnt, _ = _apply_fallback(scene, zr, zi, cnt, gl, w, rows,
                                         row0=start_row, full_height=h)
    return _color_jit(scene, zr, zi, cnt)
