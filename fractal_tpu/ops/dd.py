"""Double-word ("double-single" / "double-double") arithmetic.

The reference's GPU (SPIR-V, f32) port "stalled due to precision issues"
(reference README.md:20-22) and pointed at fixed-point multi-precision as
the fix.  This module is that fix for machines whose fast arithmetic is
f32, and the dd64 tier beyond f64: every value is an unevaluated sum ``hi + lo`` of
two machine floats, giving ~2× the mantissa bits (f32 pairs ≈ 48-bit
mantissa, f64 pairs ≈ 106-bit) while all operations remain plain
mul/adds — so the same code runs inside Pallas kernels, under vmap, and on
the CPU backend.

Algorithms are the classic error-free transformations (Dekker 1971,
Knuth TAOCP vol. 2; presented in the QD library of Hida, Li & Bailey 2000):

  * ``two_sum``      — 6-flop branch-free exact addition
  * ``fast_two_sum`` — 3-flop variant valid when |a| >= |b|
  * ``two_prod``     — exact product via Dekker's split

Compilers may contract a mul+add into a fused multiply-add, which changes
the rounding an error-free transformation relies on; the ds32 tier's
accuracy on the GPU is therefore checked against the f64 oracle on the
card.  All functions take/return (hi, lo) pairs of arrays and are
dtype-polymorphic (f32 pairs = "ds32", f64 pairs = "dd64").

Used by: ops/escape_dd.py (deep-zoom escape kernel), ops/perturb.py
(reference-orbit deltas), tests/test_dd.py (vs mpmath-style float oracles).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

DD = Tuple[jax.Array, jax.Array]  # (hi, lo), value = hi + lo


def _split_const(dtype) -> float:
    # Dekker splitter: 2^ceil(p/2) + 1 where p = mantissa bits.
    if jnp.dtype(dtype) == jnp.float64:
        return 134217729.0  # 2^27 + 1
    return 4097.0  # 2^12 + 1 for f32 (p=24)


def _fma(a, b, c):
    """a*b + c with the product split exactly (Dekker) — JAX has no fused
    multiply-add primitive, so the error-free product costs a few flops
    more (two roundings in the final sum, the product itself exact)."""
    p, e = _two_prod_dekker(a, b)
    return (p + c) + e


def _two_prod_dekker(a, b):
    s = _split_const(jnp.result_type(a))
    aa = a * s
    a_hi = aa - (aa - a)
    a_lo = a - a_hi
    bb = b * s
    b_hi = bb - (bb - b)
    b_lo = b - b_hi
    p = a * b
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """Exact a + b = s + e, branch-free (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact a + b = s + e, requires |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Exact a * b = p + e."""
    p = a * b
    e = _fma(a, b, -p)
    return p, e


# ---------------------------------------------------------------------------
# Double-word arithmetic (value = hi + lo, |lo| <= ulp(hi)/2)
# ---------------------------------------------------------------------------


def dd(hi, lo=None) -> DD:
    """Construct a double-word value from one float (lo = 0) or a pair."""
    hi = jnp.asarray(hi)
    if lo is None:
        lo = jnp.zeros_like(hi)
    return hi, jnp.asarray(lo)


def from_f64(x, dtype=jnp.float32) -> DD:
    """Split a host-side f64 (scalar or array) into an f32 double-single
    pair without precision loss beyond 2^-48: hi = f32(x), lo = f32(x - hi).

    This is the host→device boundary for deep-zoom parameters (pos, scale):
    computed in Python f64 (or via `split_str` for beyond-f64), shipped to
    the kernel as two f32s.
    """
    import numpy as np

    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32) if dtype == jnp.float32 else x
    lo = (x - hi.astype(np.float64)).astype(dtype)
    return jnp.asarray(hi, dtype), jnp.asarray(lo, dtype)


def split_str(s: str, dtype=jnp.float32, parts: int = 2):
    """Split a decimal-string coordinate into `parts` floats hi+lo(+...)
    exactly (uses Python arbitrary-precision Fraction; no mpmath needed).
    Returns a tuple of numpy scalars; parts=2 gives a dd pair."""
    import numpy as np
    from fractions import Fraction

    v = Fraction(s)
    out = []
    np_dt = np.float32 if dtype == jnp.float32 else np.float64
    for _ in range(parts):
        f = np_dt(float(v))
        out.append(f)
        v = v - Fraction(float(f))
    return tuple(out)


def add(x: DD, y: DD) -> DD:
    """Double-word + double-word (accurate variant, ~20 flops)."""
    xh, xl = x
    yh, yl = y
    sh, sl = two_sum(xh, yh)
    th, tl = two_sum(xl, yl)
    c = sl + th
    vh, vl = fast_two_sum(sh, c)
    w = tl + vl
    return fast_two_sum(vh, w)


def add_f(x: DD, y) -> DD:
    """Double-word + single float."""
    xh, xl = x
    sh, sl = two_sum(xh, y)
    v = xl + sl
    return fast_two_sum(sh, v)


def sub(x: DD, y: DD) -> DD:
    yh, yl = y
    return add(x, (-yh, -yl))


def neg(x: DD) -> DD:
    return -x[0], -x[1]


def mul(x: DD, y: DD) -> DD:
    """Double-word × double-word (~9 flops with FMA)."""
    xh, xl = x
    yh, yl = y
    ph, pl = two_prod(xh, yh)
    t = xl * yl
    t = _fma(xh, yl, t)
    t = _fma(xl, yh, t)
    return fast_two_sum(ph, pl + t)


def mul_f(x: DD, y) -> DD:
    """Double-word × single float."""
    xh, xl = x
    ph, pl = two_prod(xh, y)
    return fast_two_sum(ph, _fma(xl, y, pl))


def sqr(x: DD) -> DD:
    """Double-word square (cheaper than mul: one two_prod + 1 fma)."""
    xh, xl = x
    ph, pl = two_prod(xh, xh)
    t = _fma(xh + xh, xl, pl)
    return fast_two_sum(ph, t)


def mul_pow2(x: DD, k: float) -> DD:
    """Multiply by an exact power of two (error-free)."""
    return x[0] * k, x[1] * k


def to_float(x: DD):
    """Collapse to the nearest single-word float."""
    return x[0] + x[1]


# ---------------------------------------------------------------------------
# Fused quadratic escape step (the hot path)
# ---------------------------------------------------------------------------


def _split(a):
    """Dekker/Veltkamp split: a = h + l with h holding the top half of the
    mantissa, both halves multiplying exactly in one word.  4 flops.

    (A 2-op bitmask truncation split was tried and measured: it leaves the
    low half with p/2 bits instead of Veltkamp's p/2−1 — the round-to-
    nearest in ``a·s`` absorbs a half-ulp into h — and that one extra bit
    breaks the exactness of the Dekker error recurrences by ~2⁻³⁴.)"""
    s = a * _split_const(jnp.result_type(a))
    h = s - (s - a)
    return h, a - h


def quad_step(zr: DD, zi: DD, cr: DD, ci: DD, *, cross_sign: float = 1.0) -> DD:
    """One fused double-word step of  z ← z² + c  (cross_sign=-1 gives the
    tricorn's conjugate-square).

    Equivalent to ``add(sub(sqr(zr), sqr(zi)), cr)`` /
    ``add(mul_pow2(mul(zr, zi), 2), ci)`` but ~2.5× cheaper (~75 vs ~200
    flops without hardware FMA): the Dekker splits of zr_hi / zi_hi are
    computed once and shared by all three exact products, and the 3-term
    double-word sums use the one-two_sum "sloppy" accumulation (absolute
    error ~2⁻⁴⁸ of the largest term — same order as the accurate chain,
    which is also absolutely bounded; both are far inside the ds32 design
    target).  Used by the ds32 escape kernels; validated against the
    composed dd ops in tests/test_dd.py.
    """
    xh, xl = zr
    yh, yl = zi
    a1, a2 = _split(xh)
    b1, b2 = _split(yh)

    # exact hi-word products
    p1 = xh * xh
    e1 = ((a1 * a1 - p1) + (a1 + a1) * a2) + a2 * a2
    p2 = yh * yh
    e2 = ((b1 * b1 - p2) + (b1 + b1) * b2) + b2 * b2
    p3 = xh * yh
    e3 = ((a1 * b1 - p3) + (a1 * b2 + a2 * b1)) + a2 * b2

    # full double-word products (dropping the lo·lo terms, < 2^-48 level)
    l1 = e1 + (xh + xh) * xl          # x² = (p1, l1)
    l2 = e2 + (yh + yh) * yl          # y² = (p2, l2)
    l3 = e3 + (xh * yl + xl * yh)     # x·y = (p3, l3)

    # re: p1 - p2 + cr   (one exact two_sum per pair, lo terms folded)
    s, e = two_sum(p1, -p2)
    s2, e2s = two_sum(s, cr[0])
    lo = ((l1 - l2) + e) + (cr[1] + e2s)
    nzr = fast_two_sum(s2, lo)

    # im: 2·x·y + ci  (×2 is exact; cross_sign folds the tricorn conjugate)
    ph = (cross_sign * 2.0) * p3
    pl = (cross_sign * 2.0) * l3
    s3, e3s = two_sum(ph, ci[0])
    nzi = fast_two_sum(s3, pl + (ci[1] + e3s))
    return nzr, nzi


def lt(x: DD, y: DD):
    xh, xl = x
    yh, yl = y
    return (xh < yh) | ((xh == yh) & (xl < yl))


def gt(x: DD, y: DD):
    return lt(y, x)


def where(mask, x: DD, y: DD) -> DD:
    return jnp.where(mask, x[0], y[0]), jnp.where(mask, x[1], y[1])
