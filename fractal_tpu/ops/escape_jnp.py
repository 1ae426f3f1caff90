"""Escape-time iteration — pure-jnp/XLA path.

Data-parallel re-design of the reference's per-pixel scalar loop
(``recursive``, calc/src/lib.rs:245-257): instead of per-pixel early return,
the whole image iterates in lock-step with a per-lane *active mask* and
freeze-on-escape ``jnp.where`` selects; a chunked ``lax.while_loop`` gives
whole-array early exit once every lane has either escaped or used its
iteration budget.  Everything is elementwise mul/add → pure vector work that
XLA fuses into one loop body.

Exact count semantics (matching calc/src/lib.rs:245-257):
  * iteration i computes z_next = rule(z) + c; if |z_next|² > limit² the lane
    escapes with count = i and z_final = z_next (the *escaped* value);
  * a lane that never escapes ends with count = iterations and z_final = the
    last in-bounds value.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fractal_tpu.models.rules import Rule

# Iterations per early-exit check.  The any-active reduction costs one pass
# over the mask; 32 iterations of ~14 flops amortize it well.
DEFAULT_CHUNK = 32


def iterate(
    start_r,
    start_i,
    cr,
    ci,
    iterations: int,
    limit,
    rule: Rule,
    chunk: int = DEFAULT_CHUNK,
):
    """Run up to ``iterations`` steps of z <- rule(z) + c per lane.

    Args:
      start_r/start_i: initial z (reference: the pixel coordinate, both for
        Mandelbrot where c==start and Julia where c is constant —
        calc/src/lib.rs:208-212).
      cr/ci: the additive constant c (arrays broadcastable to start shape).
      iterations: static iteration budget.
      limit: escape radius; test is |z|² > limit² (calc:246-251).
      rule: step function from models.rules.

    Returns:
      (zr, zi, count:int32) with the exact reference semantics above.
    """
    dtype = jnp.result_type(start_r)
    limit_sq = jnp.asarray(limit, dtype) ** 2

    zr0 = jnp.broadcast_to(jnp.asarray(start_r, dtype), jnp.shape(start_r))
    shape = zr0.shape
    cr = jnp.broadcast_to(jnp.asarray(cr, dtype), shape)
    ci = jnp.broadcast_to(jnp.asarray(ci, dtype), shape)
    zi0 = jnp.broadcast_to(jnp.asarray(start_i, dtype), shape)

    cnt0 = jnp.zeros(shape, jnp.int32)
    esc0 = jnp.zeros(shape, jnp.bool_)

    def one_step(state):
        zr, zi, cnt, esc = state
        active = ~esc & (cnt < iterations)
        nzr, nzi = rule(zr, zi, cr, ci)
        d = nzr * nzr + nzi * nzi
        esc_now = active & (d > limit_sq)
        zr = jnp.where(active, nzr, zr)
        zi = jnp.where(active, nzi, zi)
        cnt = cnt + (active & ~esc_now)
        esc = esc | esc_now
        return zr, zi, cnt, esc

    if iterations == 0:
        return zr0, zi0, cnt0

    n_chunks = -(-iterations // chunk)

    def chunk_body(carry):
        state, k = carry
        state = jax.lax.fori_loop(
            0, chunk, lambda _, s: one_step(s), state, unroll=True
        )
        return state, k + 1

    def chunk_cond(carry):
        (zr, zi, cnt, esc), k = carry
        any_active = jnp.any(~esc & (cnt < iterations))
        return (k < n_chunks) & any_active

    (zr, zi, cnt, esc), _ = jax.lax.while_loop(
        chunk_cond, chunk_body, ((zr0, zi0, cnt0, esc0), jnp.int32(0))
    )
    return zr, zi, cnt
