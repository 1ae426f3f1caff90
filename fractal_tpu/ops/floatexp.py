"""Extended-exponent ("floatexp") arithmetic for extreme-depth δ-orbits.

Past ~1e30× zoom the per-pixel δ quantities leave f32's exponent range
(δc ~ 1/zoom; subnormals flush to zero), which is exactly where the
reference's f64 — and every plain-float renderer — dies (reference
README.md:20-22 stalled ~1e6×; our f32 δ-orbits reach ~1e30×).  The
classic fix (Kalles Fraktaler's ``floatexp``) stores each value as a
normalized f32 mantissa plus a wide integer exponent and renormalizes
after every op: precision stays f32-grade (which perturbation needs —
the REFERENCE carries the magnitude), while the range becomes ±2^±2³⁰.

Values are (m, e) pairs of same-shape arrays: value = m·2^e with
m ∈ ±[0.5, 1) (jnp.frexp normalization) and e int32.  Zero is encoded as
(0.0, E_ZERO) so exponent alignment can never flush a live operand
against a true zero.

All ops are branch-free elementwise jnp (frexp/ldexp lower to exponent
bit manipulation) — they fuse into the surrounding XLA program like any
other elementwise work, at ~5-8 primitive ops per floatexp op.
"""

from __future__ import annotations

import jax.numpy as jnp

# exponent of a true zero: far below any live value, so alignment always
# rounds it away instead of the live operand.  A plain Python int — a
# module-level jnp constant would be captured into every consumer jaxpr
# as a device buffer (and trip the C++ jit fastpath's buffer accounting).
E_ZERO = -(1 << 30)


def fe(x):
    """Plain float array → (m, e)."""
    m, e = jnp.frexp(x)
    return m, jnp.where(m == 0.0, E_ZERO, e.astype(jnp.int32))


def fe_const(m: float, e: int):
    """Host-normalized scalar → (m, e) jnp scalars (use _frexp_fraction
    for exact Fractions beyond f64 range)."""
    return jnp.float32(m), jnp.int32(e if m != 0.0 else E_ZERO)


def to_float(a):
    """(m, e) → plain f32; values below ~2⁻¹²⁶ flush to 0 (by then they
    are far below any consumer's resolution), above 2¹²⁷ saturate to inf."""
    return jnp.ldexp(a[0], jnp.clip(a[1], -200, 200))


def mul(a, b):
    m = a[0] * b[0]  # ∈ ±[0.25, 1): at most one renorm step
    m2, de = jnp.frexp(m)
    return m2, jnp.where(m2 == 0.0, E_ZERO,
                         a[1] + b[1] + de.astype(jnp.int32))


def add(a, b):
    e = jnp.maximum(a[1], b[1])
    # the smaller operand shifts down; > ~150-bit gaps flush — correct
    # rounding (the result keeps the larger operand's 24-bit mantissa)
    m = (jnp.ldexp(a[0], jnp.maximum(a[1] - e, -200))
         + jnp.ldexp(b[0], jnp.maximum(b[1] - e, -200)))
    m2, de = jnp.frexp(m)
    return m2, jnp.where(m2 == 0.0, E_ZERO, e + de.astype(jnp.int32))


def neg(a):
    return -a[0], a[1]


def cmul(ar, ai, br, bi):
    """Complex multiply on (m, e) component pairs."""
    rr = add(mul(ar, br), neg(mul(ai, bi)))
    ri = add(mul(ar, bi), mul(ai, br))
    return rr, ri
