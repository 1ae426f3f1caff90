"""Barnsley fern — batched chaos game (IFS) as one device program.

Reference semantics (src/lib.rs:418-463 ``fern`` + 392-408 ``subtract_pixel``
+ 271-319 replicate-and-reduce):

  * start point (pos.re·W, pos.im·H) (src/lib.rs:421-422);
  * empirical geometry: effective_scale_x = 65·scale.re·H·0.006,
    effective_scale_y = 37·scale.im·H·0.006, x-offset W/2, y formula
    ``H − ((y + (pos.im − 5.0) − 0.5)·esy + H/2)`` (src/lib.rs:425-437);
  * affine branches with Wikipedia coefficients chosen by a uniform draw at
    thresholds .01/.86/.93 (src/lib.rs:442-461);
  * each *hit* multiplies the pixel by the per-channel darkening factor
    f_c = 1 / (((1/(v_c/255)) − 1)·weight + 1), truncating to u8 every time
    (src/lib.rs:399-406);
  * the N-thread version renders N independent ferns with iterations/N each
    and combines them with per-pixel saturating adds (src/lib.rs:271-319).

Data-parallel re-design: the walk is inherently sequential per walker, so —
exactly like the reference scales by replication — we run K independent
walkers (vectorized) for iterations/K steps each, accumulate a hit-count
histogram with scatter-add, and apply the darkening as a closed-form
post-pass: because every pixel starts at the same background value and the
per-hit map p → trunc(p·f) is a fixed scalar map, the value after n hits is a
precomputed decay curve indexed by n (exact, including the per-hit u8
truncation).  The curve reaches its fixed point in < 256 steps since u8 is
monotonically decreasing under f < 1.

Unlike the reference's unseeded ``SmallRng::from_entropy()``
(src/lib.rs:428), the walk uses counter-based ``jax.random`` keys — a fixed
``Scene.seed`` reproduces bit-identical ferns.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from fractal_tpu.config import Scene

# Affine maps (a, b, c, d, e, f): x' = a·x + b·y + e ; y' = c·x + d·y + f
# Thresholds on the uniform draw r: branch 0 if r < .01, 1 if < .86,
# 2 if < .93, else 3 (src/lib.rs:445-461, Wikipedia coefficients).
_FERN_COEFFS = np.array(
    [
        [0.00, 0.00, 0.00, 0.16, 0.0, 0.00],
        [0.85, 0.04, -0.04, 0.85, 0.0, 1.60],
        [0.20, -0.26, 0.23, 0.22, 0.0, 1.60],
        [-0.15, 0.28, 0.26, 0.24, 0.0, 0.44],
    ],
    dtype=np.float32,
)

# More walkers amortize per-step scan/RNG overhead until the scatter-add
# saturates (a sweep on the first accelerator picked this value; not yet
# re-swept on the GPU).
DEFAULT_WALKERS = 65536

# Steps whose plot indices are accumulated into ONE scatter-add per scan
# body: fewer, larger scatters, bit-identical histogram (integer adds
# commute; the walk stream is untouched).  Chosen by a sweep on the first
# accelerator (S=25 measured the same as S=5, so the smaller working set
# won); not yet re-swept on the GPU.
SCATTER_BATCH = 5


def _burn_in(scene: Scene, width: int, height: int) -> int:
    """Steps walked but not plotted while walkers settle onto the attractor.

    The reference's single walker plots its transient (a ~50-point streak in
    10M points — invisible), but K parallel walkers all start at the same
    (pos.re·W, pos.im·H) and would amplify it K-fold into a solid artifact.
    The slowest IFS contraction is 0.85/step, so burn until the start
    distance shrinks below a tenth of a pixel, plus a safety margin."""
    d = max(abs(scene.pos[0]) * width, abs(scene.pos[1]) * height, 1.0)
    return 16 + int(math.log(10.0 * d) / math.log(1.0 / 0.85))


def darkening_curve(background, primary, weight: float) -> np.ndarray:
    """Pixel value after n hits, for n = 0..cycle, shape (L, 3) uint8.

    Exact n-fold composition of the reference's per-hit darkening
    (src/lib.rs:399-406).  The darkened channels are fed back through the
    swapped ``RGB::new(r, b, g)`` constructor (calc/src/lib.rs:129), so one
    hit writes, in true (r, g, b) field order:

        r ← trunc(r · f(v.r));  g ← trunc(b · f(v.b));  b ← trunc(g · f(v.g))

    i.e. new = u8(swap_gb(p · factors)) — the g/b channels alternate across
    hits.  The sequence always lands on a 2-cycle (a fixed point is a
    2-cycle with equal entries): the two-step map is monotone nonincreasing
    per channel under truncation.  The returned curve ends exactly one full
    2-cycle from the end — entry n for n ≥ L is curve[L-2 + (n-(L-2)) % 2]
    (see ``apply_darkening``).
    """
    v = np.array(primary, dtype=np.float64)
    factors = np.empty(3)
    for c in range(3):
        if v[c] <= 0.0:
            factors[c] = 0.0  # 1/(v/255) → ∞ in Rust f64 ⇒ multiply by 0
        else:
            factors[c] = 1.0 / (((1.0 / (v[c] / 255.0)) - 1.0) * weight + 1.0)

    def step(p):
        q = p.astype(np.float64) * factors
        q = np.where(np.isnan(q), 0.0, q)
        q = np.clip(np.trunc(q), 0.0, 255.0)
        return q[[0, 2, 1]].astype(np.uint8)  # RGB::new's g/b swap

    curve = [np.array([int(b) for b in background], dtype=np.uint8)]
    for _ in range(1024):
        q = step(curve[-1])
        if len(curve) >= 2 and np.all(q == curve[-2]):
            break  # 2-cycle closed (covers the fixed point: q == both tails)
        curve.append(q)
    if len(curve) < 2 or not np.all(step(curve[-1]) == curve[-2]):
        curve.append(step(curve[-1]))  # ensure the last two entries cycle
    return np.stack(curve)  # (L, 3)


def lut_index(hits, length: int):
    """Map hit counts to darkening-curve rows, extending past the end with
    the curve's terminal 2-cycle (parity of n)."""
    tail = length - 2 + jnp.remainder(hits - (length - 2), 2)
    return jnp.where(hits < length, hits, tail)


@functools.partial(
    jax.jit, static_argnames=("width", "height", "walkers", "steps",
                              "replicas", "burn_in", "rng_walkers")
)
def _fern_hits(
    scene: Scene,
    width: int,
    height: int,
    walkers: int,
    steps: int,
    replicas: int,
    seed,
    burn_in: int = 64,
    rng_walkers: int = 0,
    lo=0,
):
    """Run the chaos game; return per-replica hit-count grids
    (replicas, H, W) int32.

    ``rng_walkers`` (walker-sharded exact mode, sharding.py): draw the
    per-step uniforms for the FULL ``rng_walkers``-wide single-device
    walker set but simulate only the ``walkers``-wide slice starting at
    ``lo`` — the slice's histogram contributions are bit-identical to the
    same walkers in the single-device run (the key chain never depends on
    the walker axis), so integer psums of the slices reproduce the
    single-device histogram exactly.  Slice walkers whose global index is
    past ``rng_walkers`` are padding: they walk but never plot."""
    f32 = jnp.float32
    w_f = jnp.asarray(float(width), f32)
    h_f = jnp.asarray(float(height), f32)
    pos_re = jnp.asarray(scene.pos[0], f32)
    pos_im = jnp.asarray(scene.pos[1], f32)
    esx = 65.0 * jnp.asarray(scene.scale[0], f32) * h_f * 0.006
    esy = 37.0 * jnp.asarray(scene.scale[1], f32) * h_f * 0.006

    k = walkers
    x0 = jnp.full((k,), pos_re * w_f, f32)
    y0 = jnp.full((k,), pos_im * h_f, f32)
    key0 = jax.random.PRNGKey(seed)

    lo = jnp.asarray(lo, jnp.int32)

    def walk_step(x, y, key):
        key, sub = jax.random.split(key)
        if rng_walkers:
            # Exact-slice mode: the full-width draw IS the single-device
            # stream; pad to n·k so the last slice never clamps back onto
            # a neighbour's walkers (double-count), then slice.
            r_full = jax.random.uniform(sub, (rng_walkers,), f32)
            pad = (-rng_walkers) % k
            if pad:
                r_full = jnp.concatenate(
                    [r_full, jnp.zeros((pad,), f32)])
            r = jax.lax.dynamic_slice(r_full, (lo,), (k,))
        else:
            r = jax.random.uniform(sub, (k,), f32)

        # Branch coefficients via a 3-deep select chain instead of a
        # (k, 6) jnp.take gather: the selects are pure elementwise ops.
        # The selected constants are the same f32 values, so the walk is
        # bit-identical to the gather form.
        def pick(j):
            c = _FERN_COEFFS  # host constants — folded at trace time
            v = jnp.full((k,), float(c[0, j]), f32)
            v = jnp.where(r >= 0.01, float(c[1, j]), v)
            v = jnp.where(r >= 0.86, float(c[2, j]), v)
            v = jnp.where(r >= 0.93, float(c[3, j]), v)
            return v

        ca, cb, cc, cd, ce, cf_ = (pick(j) for j in range(6))
        nx = ca * x + cb * y + ce
        ny = cc * x + cd * y + cf_
        return nx, ny, key

    def plot_indices(x, y):
        # Pixel mapping (src/lib.rs:433-437) with Rust `as usize` cast
        # semantics: truncate toward zero, saturate negatives to 0.
        px_f = (x - pos_re) * esx + w_f / 2.0
        py_f = h_f - ((y + (pos_im - 5.0) - 0.5) * esy + h_f / 2.0)
        px = jnp.maximum(jnp.trunc(px_f), 0.0).astype(jnp.int32)
        py = jnp.maximum(jnp.trunc(py_f), 0.0).astype(jnp.int32)
        valid = (px < width) & (py < height)
        if rng_walkers:
            # padding walkers (global index past the real walker set) walk
            # but never plot
            valid &= (lo + jnp.arange(k, dtype=jnp.int32)) < rng_walkers
        flat = py * width + px
        return jnp.where(valid, flat, width * height)  # OOB index → dropped

    def batched_body(batch):
        # SCATTER_BATCH steps' indices feed ONE (batch·k,) scatter-add —
        # measured 1.47× over per-step scatters (see SCATTER_BATCH).  The
        # walk/plot interleaving is unchanged (plot BEFORE the update,
        # src/lib.rs:432-441) and integer adds commute, so the histogram
        # is bit-identical to the per-step form.
        def body(carry, _):
            x, y, key, hist = carry
            idxs = []
            for _i in range(batch):
                idxs.append(plot_indices(x, y))
                x, y, key = walk_step(x, y, key)
            idx = idxs[0] if batch == 1 else jnp.concatenate(idxs)
            hist = hist.at[idx].add(1, mode="drop")
            return (x, y, key, hist), None

        return body

    def burn_body(carry, _):
        x, y, key, hist = carry
        x, y, key = walk_step(x, y, key)
        return (x, y, key, hist), None

    def one_replica(rep_idx):
        key = jax.random.fold_in(key0, rep_idx)
        hist = jnp.zeros((width * height,), jnp.int32)
        carry = (x0, y0, key, hist)
        carry, _ = jax.lax.scan(burn_body, carry, None, length=burn_in)
        nb, rem = divmod(steps, SCATTER_BATCH)
        if nb:
            carry, _ = jax.lax.scan(batched_body(SCATTER_BATCH), carry,
                                    None, length=nb)
        if rem:
            carry, _ = jax.lax.scan(batched_body(1), carry, None, length=rem)
        return carry[3].reshape(height, width)

    return jax.vmap(one_replica)(jnp.arange(replicas))


def apply_darkening(hits, curve: np.ndarray):
    """hits (…, H, W) int32 → image (…, H, W, 3) uint8 via the decay curve,
    alternating over the terminal 2-cycle for counts past the curve end."""
    lut = jnp.asarray(curve)  # (L, 3)
    return jnp.take(lut, lut_index(hits, lut.shape[0]), axis=0)


def saturating_sum_u8(imgs):
    """Per-pixel saturating add across the leading axis — the reference's
    ``combine_images`` all-reduce (src/lib.rs:272-318)."""
    total = jnp.sum(imgs.astype(jnp.uint16), axis=0)
    return jnp.minimum(total, 255).astype(jnp.uint8)


def render_fern(scene: Scene, walkers: int = DEFAULT_WALKERS):
    """Full fern render: chaos game → hit histogram → darkening curve →
    (optional) replica saturating-sum.  ``supersample=k`` plots onto a k×
    grid and box-downsamples the darkened image (framework extension; the
    reference has no AA)."""
    replicas = max(1, scene.fern_replicas)
    total = max(1, scene.iterations)
    per_replica = max(1, total // replicas)
    k = int(min(walkers, per_replica))
    steps = max(1, per_replica // k)
    ss = scene.supersample
    w, h = scene.width * ss, scene.height * ss

    hits = _fern_hits(
        scene, w, h, k, steps, replicas, scene.seed,
        burn_in=_burn_in(scene, w, h),
    )
    curve = darkening_curve(
        scene.secondary_color.as_tuple(),
        scene.primary_color.as_tuple(),
        float(scene.color_weight),
    )
    if replicas == 1:
        img = apply_darkening(hits[0], curve)
    else:
        img = saturating_sum_u8(apply_darkening(hits, curve))  # (R,H,W,3)→
    if ss > 1:
        from fractal_tpu.ops.coloring import downsample_box
        import jax.numpy as _jnp

        img = downsample_box(img.astype(_jnp.float32), ss)
    return img
