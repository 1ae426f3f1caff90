"""Escape-time iteration rules.

The reference hardcodes one rule, z <- z² + c, in ``Imaginary::square`` +
``recursive`` (calc/src/lib.rs:87-92, 245-257).  Here the rule is a pluggable
step function so one kernel serves Mandelbrot, Julia, Multibrot z^d + c,
Burning Ship, and Tricorn (BASELINE.md "generic iteration-rule kernel").

A rule is ``step(zr, zi, cr, ci) -> (zr', zi')`` operating on arrays of any
real dtype (f32/f64) — written against real pairs, not jnp complex, so the
exact same arithmetic works inside Pallas kernels and for the double-single
("ds") value representation (ops/dd.py) by substituting the arithmetic ops.

All rules are expressed with mul/add/sub only (plus abs/neg), so they lower
to pure elementwise work on any backend.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp

# step(zr, zi, cr, ci) -> (zr', zi')
Rule = Callable[..., Tuple]


def _square_step(zr, zi, cr, ci):
    """z² + c — Imaginary::square semantics (calc/src/lib.rs:87-92):
    re' = re² − im², im' = 2·re·im."""
    zr2 = zr * zr
    zi2 = zi * zi
    return zr2 - zi2 + cr, 2.0 * (zr * zi) + ci


def _burning_ship_step(zr, zi, cr, ci):
    """(|Re z| + i·|Im z|)² + c."""
    ar = jnp.abs(zr)
    ai = jnp.abs(zi)
    return ar * ar - ai * ai + cr, 2.0 * (ar * ai) + ci


def _tricorn_step(zr, zi, cr, ci):
    """conj(z)² + c."""
    zr2 = zr * zr
    zi2 = zi * zi
    return zr2 - zi2 + cr, -2.0 * (zr * zi) + ci


def make_multibrot_step(power: int) -> Rule:
    """z^d + c for integer d >= 2 via repeated complex multiplication
    (square-and-multiply), keeping everything as fused mul/adds."""
    if power < 2:
        raise ValueError("multibrot power must be >= 2")

    def step(zr, zi, cr, ci):
        # square-and-multiply: w = z^power
        wr, wi = zr, zi
        # compute z^power by binary exponentiation over (power - 1) extra mults
        e = power - 1
        br, bi = zr, zi  # current base z^(2^k)
        first = True
        wr = jnp.ones_like(zr)
        wi = jnp.zeros_like(zi)
        n = power
        while n > 0:
            if n & 1:
                if first:
                    wr, wi = br, bi
                    first = False
                else:
                    wr, wi = wr * br - wi * bi, wr * bi + wi * br
            n >>= 1
            if n:
                br, bi = br * br - bi * bi, 2.0 * (br * bi)
        return wr + cr, wi + ci

    return step


RULES = {
    "mandelbrot": _square_step,
    "julia": _square_step,
    "burningship": _burning_ship_step,
    "tricorn": _tricorn_step,
}

#: Algos whose step is z^d + c with d = scene.power: multibrot by
#: definition, plus the --power framework extension on mandelbrot/julia
#: (mandelbrot power d ≡ multibrot d; julia power d has no other spelling).
POWER_ALGOS = ("mandelbrot", "julia", "multibrot")


def eff_power(algo: str, power: int) -> int:
    """Effective exponent d of the z^d term: ``power`` for the z^d + c
    family, 2 for the fixed quadratic folds (burning ship, tricorn)."""
    return power if algo in POWER_ALGOS else 2


def perturb_supported(algo: str, power: int) -> bool:
    """True when a δ-orbit recurrence exists for (algo, power): the
    z^d + c family for any integer d ≥ 2, plus burning ship and tricorn."""
    return (algo in ("burningship", "tricorn")
            or (algo in POWER_ALGOS and power >= 2))


def get_rule(algo: str, power: int = 2) -> Rule:
    if algo in POWER_ALGOS:
        if power == 2:
            return RULES.get(algo, _square_step)
        return make_multibrot_step(power)
    try:
        return RULES[algo]
    except KeyError:
        raise ValueError(f"no escape-time rule for algo {algo!r}") from None
