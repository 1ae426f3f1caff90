"""Multi-device rendering: shard_map over a 1-D device mesh.

Data-parallel equivalents of the reference's two parallel strategies
(SURVEY.md §2 C7/C9):

* **Escape-time spatial DP** — the reference fans image *rows* out over
  rayon threads (src/lib.rs:253-270).  Here rows are **round-robin
  interleaved** over a 1-D device mesh: device d computes global rows
  d, d+N, d+2N, …  Interleaving (vs contiguous blocks) is the load
  balancer: escape-time cost varies wildly across the image (interior
  pixels burn the full budget, exterior escape in a few steps), and
  adjacent rows cost alike, so striding equalizes per-device work the
  same way rayon's work-stealing equalized per-thread work.  Each device
  computes its own stripe's coordinates from its mesh position — zero
  communication; the only "collective" is the output layout epilogue.

* **Fern ensemble DP** — the reference renders N full replicas with
  iterations/N each and pairwise-reduces with saturating adds
  (src/lib.rs:271-319).  Its reduce is literally an all-reduce: here each
  device walks its own seeded replica set and a single ``jax.lax.psum``
  over the mesh combines hit-count grids.

The mesh follows the algorithm alone (every device reaches every other at
the same rate), and works identically on several GPUs and on the CPU
backend with ``--xla_force_host_platform_device_count=N`` (how the tests
exercise it).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from fractal_tpu.config import Scene
from fractal_tpu.models.rules import eff_power
from fractal_tpu.ops import coloring, route
from fractal_tpu.ops.escape_pallas import iterate_params, scene_params

AXIS = "rows"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


def mesh_for_devices(devices: int) -> Optional[Mesh]:
    """The ``--devices N`` mesh: None for 1 (the default single-device
    path), all available devices for 0, a clear error past the device
    count.  Shared by every frontend surface (__main__, viewer)."""
    if devices < 0:
        raise ValueError(f"--devices {devices}: must be >= 0 (0 = all)")
    if devices == 1:
        return None
    avail = len(jax.devices())
    n = avail if devices == 0 else devices
    if n > avail:
        raise ValueError(f"--devices {n}: only {avail} device(s) available")
    return make_mesh(n)


def _pad_rows(h: int, n: int) -> int:
    return -(-h // n) * n


# ---------------------------------------------------------------------------
# Escape-time: row-interleaved spatial DP
# ---------------------------------------------------------------------------


def _render_escape_sharded_jit(scene: Scene, params, precision: str,
                               impl: str, mesh: Mesh):
    """The whole image IS the h-row band at offset 0 (scene_params'
    identity (1, 0) row map): one code path for stills and bands."""
    return _render_band_sharded_jit(scene, params, precision, impl, mesh,
                                    rows=scene.height * scene.supersample)


SHARDED_PRECISIONS = ("f32", "f64", "ds32")


def render_escape_sharded(scene: Scene, mesh: Optional[Mesh] = None,
                          precision: Optional[str] = None,
                          backend: str = "auto"):
    """Render an escape-time scene across a device mesh.  Returns the
    (height, width, 3) uint8 image (replicated on the host).

    Every device runs the params program of its stripe (``iterate_params``:
    the escape-time kernel where it compiles, the twin elsewhere); the
    gathered image equals the single-device params-program render
    bit-for-bit.  ``backend`` follows render.py::escape_impl — the CLI's
    --backend reaches meshes too."""
    from fractal_tpu.render import escape_impl, params_dtype, resolve_precision

    mesh = mesh if mesh is not None else make_mesh()
    precision = precision or resolve_precision(scene)
    if precision in ("perturb", "p32"):
        # p32 keeps its single-device semantics on a mesh (fast tier:
        # glitch detection and the exact fallback off)
        return render_perturb_sharded(
            scene, mesh, fast=precision == "p32",
            use_pallas=False if backend == "jnp" else None)
    if precision not in SHARDED_PRECISIONS:
        # No silent downgrade: dd64 has no sharded program; deeper
        # requests must pick an explicit path.
        raise ValueError(
            f"sharded rendering supports f32/f64/ds32/perturb, not "
            f"{precision!r}; use precision='f64' or 'perturb' for deeper "
            f"zooms")
    params = scene_params(scene, dtype=params_dtype(precision))
    return _render_escape_sharded_jit(scene, params, precision,
                                      escape_impl(precision, backend), mesh)


@functools.partial(
    jax.jit, static_argnames=("precision", "impl", "mesh", "rows")
)
def _render_band_sharded_jit(scene: Scene, params, precision: str,
                             impl: str, mesh: Mesh, rows: int):
    """One horizontal band of the supersampled grid, its rows interleaved
    across the mesh: device d owns global rows {start + r·n + d} — the
    band's global start (params[15], set by the caller exactly like the
    single-device band path, render.py::_render_band_jit) composes with
    the interleave stride through the same exact integer row map, so
    banded + sharded stays bit-identical to the one-shot render."""
    n = mesh.shape[AXIS]
    ss = scene.supersample
    w = scene.width * ss
    rp = _pad_rows(rows, n)
    rows_local = rp // n

    def local_stripe(params):
        d = jax.lax.axis_index(AXIS).astype(params.dtype)
        p_local = (params.at[14].set(n)
                   .at[15].set(params[15] + d))
        zr, zi, cnt = iterate_params(
            p_local,
            algo=scene.algo,
            power=scene.power,
            iterations=scene.iterations,
            precision=precision,
            height=rows_local,
            width=w,
            impl=impl,
            periodicity=not scene.inside,
        )
        img = coloring.color_escape_result(
            zr, zi, cnt,
            iterations=scene.iterations,
            stable_limit=scene.stable_limit,
            exposure=scene.exposure,
            primary_color=scene.primary_color.as_tuple(),
            secondary_color=scene.secondary_color.as_tuple(),
            inside=scene.inside,
            smooth=scene.smooth,
            as_float=True,
        )
        return img

    stripes = shard_map(
        local_stripe,
        mesh=mesh,
        in_specs=P(),
        out_specs=P(AXIS),
        check_vma=False,
    )(params)
    img = (
        stripes.reshape(n, rows_local, w, 3)
        .transpose(1, 0, 2, 3)
        .reshape(rp, w, 3)[:rows]
    )
    return coloring.downsample_box(img, ss)


# ---------------------------------------------------------------------------
# Perturbation: same row-interleaved spatial DP, orbit table replicated
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("iterations", "h", "w",
                                             "impl", "mesh", "power",
                                             "algo", "extreme",
                                             "bla_offsets", "glitch",
                                             "dist_only"))
def _perturb_sharded_jit(orbit, P, ns, iterations: int, h: int, w: int,
                         impl: str, mesh: Mesh, power: int = 2,
                         algo: str = "mandelbrot", extreme: bool = False,
                         bla_packed=None, bla_offsets=None,
                         glitch: bool = True, dist_only: bool = False):
    """Row-interleaved δ-orbit stripes: the orbit table is replicated per
    device; each device's stripe addresses global rows through the exact
    integer row map P[6:8] and runs the δ-orbit kernel (``impl`` not
    "xla") or the twin, so the gathered result is bit-identical to the
    single-device render of the same implementation.  Returns
    (zr, zi, cnt, gl), or (dist, cnt) for the kernel's ``dist_only`` form
    (p32)."""
    from fractal_tpu.ops.perturb import (
        _twin_chunk, perturb_kernel, perturb_whole_jnp,
    )

    n = mesh.shape[AXIS]
    hp = _pad_rows(h, n)
    rows_local = hp // n

    def local_stripe(orbit, P, ns, *bla):
        d = jax.lax.axis_index(AXIS).astype(jnp.float32)
        p_local = P.at[6].set(jnp.float32(n)).at[7].set(P[7] + d)
        if impl == route.XLA:
            return perturb_whole_jnp(
                orbit, p_local, ns[0], iterations=iterations,
                height=rows_local, width=w, chunk=_twin_chunk(),
                power=power, algo=algo, extreme=extreme,
                bla_packed=bla[0] if bla else None, bla_offsets=bla_offsets)
        return perturb_kernel(
            orbit, p_local, ns[0], iterations=iterations,
            height=rows_local, width=w, glitch=glitch, dist_only=dist_only,
            power=power, algo=algo, interpret=impl == route.INTERPRET)

    args = (orbit, P, ns)
    if bla_packed is not None:
        args = args + (bla_packed,)
    outs = shard_map(
        local_stripe, mesh=mesh,
        in_specs=(P_spec(),) * len(args),
        out_specs=(P_spec(AXIS),) * (2 if dist_only else 4),
        check_vma=False,
    )(*args)

    def deint(a):
        return (a.reshape(n, rows_local, w)
                .transpose(1, 0, 2).reshape(hp, w)[:h])

    return tuple(deint(a) for a in outs)


def P_spec(*axes):
    from jax.sharding import PartitionSpec

    return PartitionSpec(*axes)


def render_perturb_sharded(scene: Scene, mesh: Optional[Mesh] = None,
                           fast: bool = False,
                           use_pallas: Optional[bool] = None):
    """Deep-zoom perturbation across the mesh: one host reference orbit,
    replicated to every device; each device iterates its own interleaved
    row stripe of f32 δ-orbits; the exact glitch fallback and the coloring
    epilogue run once on the gathered result.

    ``fast=True`` is the p32 tier with IDENTICAL semantics to the
    single-device fast path (glitch detection and the exact fallback are
    skipped).  ``use_pallas`` overrides the platform's choice
    (ops/route.py: tests force the δ-orbit kernel through the Pallas
    interpreter on CPU meshes)."""
    return _render_perturb_sharded_impl(scene, mesh, fast, use_pallas)


def render_perturb_band_sharded(scene: Scene, start_row: int, rows: int,
                                fast: bool = False,
                                mesh: Optional[Mesh] = None,
                                use_pallas: Optional[bool] = None):
    """Mesh twin of ``ops.perturb.render_perturb_band`` (fractal_tpu.tiled):
    the band's global start row rides P[7] and composes with the interleave
    stride (P[6]=N, offset=start+d), all exact integer f32s, so banded +
    sharded perturbation renders match the single-device bands bit-for-bit
    (glitches still resolve in GLOBAL pixel coordinates)."""
    return _render_perturb_sharded_impl(scene, mesh, fast, use_pallas,
                                        start_row=start_row, rows=rows)


def _render_perturb_sharded_impl(scene: Scene, mesh, fast, use_pallas,
                                 start_row: int = 0,
                                 rows: Optional[int] = None):
    from fractal_tpu.ops.perturb import (
        RENDER_STATS, _apply_fallback, _color_dist_jit, _color_jit,
        _is_extreme, _perturb_setup,
    )

    mesh = mesh if mesh is not None else make_mesh()
    h, w, impl, ref_px, orbit, P, _, dev = _perturb_setup(
        scene, fast, force_kernel=use_pallas)
    packed, bla_packed, bla_offsets = dev
    band = rows is not None
    h_out = rows if band else h
    if band:
        P = P.at[7].set(jnp.float32(start_row))
    ns = jnp.asarray([orbit.n_steps], jnp.int32)
    # Same depth observability as the single-device path (__main__ --profile
    # and the viewer status line read these after every render)
    RENDER_STATS.update(
        n_glitch=None if fast else 0, n_residual=0,
        tier=("p32" if fast else
              "floatexp" if _is_extreme(scene) else "perturb"),
        route=("sharded-kernel" if impl != route.XLA else
               "sharded-xla-twin" + ("-fe" if _is_extreme(scene) else "")
               + ("-bla" if bla_packed is not None else "")))
    kernel_fast = fast and impl != route.XLA
    outs = _perturb_sharded_jit(
        packed, P, ns, scene.iterations, h_out, w, impl, mesh,
        power=eff_power(scene.algo, scene.power), algo=scene.algo,
        extreme=_is_extreme(scene), bla_packed=bla_packed,
        bla_offsets=bla_offsets, glitch=not fast, dist_only=kernel_fast,
    )
    if kernel_fast:
        # p32: the dist-only kernel form (no zfr/zfi selects/outputs;
        # coloring consumes |z|² alone) — same values, fewer ops/step.
        # Coloring runs as the same jitted program as single-device renders
        # use: run op by op, GPU rounding differs on a few pixels.
        return _color_dist_jit(scene, *outs)
    zr, zi, cnt, gl = outs
    if not fast:
        zr, zi, cnt, n_gl = _apply_fallback(
            scene, zr, zi, cnt, gl, w, h_out,
            row0=start_row, full_height=h)
        RENDER_STATS["n_glitch"] = int(n_gl)
    return _color_jit(scene, zr, zi, cnt)


# ---------------------------------------------------------------------------
# Fern: ensemble DP with a psum all-reduce
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("walkers", "steps", "mesh", "compat_replicas", "burn_in"),
)
def _render_fern_sharded_jit(scene: Scene, walkers: int, steps: int,
                             mesh: Mesh, compat_replicas: bool, curve,
                             burn_in: int = 64):
    from fractal_tpu.models.fern import _fern_hits, lut_index

    n = mesh.shape[AXIS]

    def local_replica(curve):
        d = jax.lax.axis_index(AXIS)
        # Per-device replica: distinct fold of the scene seed, exactly like
        # fern.py's one_replica — device index plays the replica index.
        hits = _fern_hits(
            scene, scene.width, scene.height, walkers, steps, 1,
            scene.seed + d * 7919, burn_in=burn_in,
        )[0]
        if compat_replicas:
            # Reference N-thread mode (src/lib.rs:271-319): darken each
            # replica independently, then saturating-add.  Saturating chain
            # of non-negatives ≡ clamp(total), so psum + min is exact.
            img = jnp.take(curve, lut_index(hits, curve.shape[0]), axis=0)
            total = jax.lax.psum(img.astype(jnp.int32), AXIS)
            return jnp.minimum(total, 255).astype(jnp.uint8)
        # Native mode: one global fern — all-reduce the hit grids, darken once.
        hits = jax.lax.psum(hits, AXIS)
        return jnp.take(curve, lut_index(hits, curve.shape[0]), axis=0)

    return shard_map(
        local_replica,
        mesh=mesh,
        in_specs=P(),
        out_specs=P(),
        check_vma=False,
    )(curve)


@functools.partial(
    jax.jit,
    static_argnames=("k_total", "k_dev", "steps", "replicas", "mesh",
                     "burn_in", "ss"),
)
def _render_fern_sharded_exact_jit(scene: Scene, k_total: int, k_dev: int,
                                   steps: int, replicas: int, mesh: Mesh,
                                   curve, burn_in: int, ss: int):
    """Walker-sharded exact mode: device d simulates the single-device
    walker slice [d·k_dev, (d+1)·k_dev) against the SAME per-step uniform
    stream (drawn full-width, sliced — the key chain never depends on the
    walker axis), so the int32 histogram psum reproduces the single-device
    histogram bit-for-bit and the darkening post-pass is byte-identical to
    render_fern."""
    from fractal_tpu.models.fern import (
        _fern_hits, apply_darkening, saturating_sum_u8,
    )

    w, h = scene.width * ss, scene.height * ss

    def local_slice(curve):
        d = jax.lax.axis_index(AXIS)
        hits = _fern_hits(
            scene, w, h, k_dev, steps, replicas, scene.seed,
            burn_in=burn_in, rng_walkers=k_total, lo=d * k_dev,
        )
        hits = jax.lax.psum(hits, AXIS)  # exact: integer partial sums
        if replicas == 1:
            img = apply_darkening(hits[0], curve)
        else:
            img = saturating_sum_u8(apply_darkening(hits, curve))
        if ss > 1:
            from fractal_tpu.ops.coloring import downsample_box

            img = downsample_box(img.astype(jnp.float32), ss)
        return img

    return shard_map(
        local_slice,
        mesh=mesh,
        in_specs=P(),
        out_specs=P(),
        check_vma=False,
    )(curve)


def render_fern_sharded(scene: Scene, mesh: Optional[Mesh] = None,
                        walkers: int = None, compat_replicas: bool = False,
                        exact: bool = True):
    """Fern across a device mesh, one psum combine (the reference's
    combine_images all-reduce, src/lib.rs:303-318, as a single
    collective).  Three modes:

    * ``exact`` (default): walkers of the single-device run are sliced
      across devices against the same RNG stream — bit-identical to
      ``render_fern`` at any mesh size.  The per-step uniforms are drawn
      full-width on every device (the walk, scatter and histogram all
      shard; only the RNG replicate).
    * ``exact=False`` (ensemble): each device walks an independent seeded
      replica with iterations/N points and the hit grids psum into one
      global fern — everything shards including the RNG; same statistics,
      not the single-device point stream.
    * ``compat_replicas``: the reference's N-thread semantics — darken
      each replica independently, saturating-add (src/lib.rs:271-319).

    The walker count defaults to the single-device sweep's optimum
    (models/fern.py DEFAULT_WALKERS), clamped to the point budget."""
    from fractal_tpu.models.fern import DEFAULT_WALKERS, darkening_curve

    if walkers is None:
        walkers = DEFAULT_WALKERS

    mesh = mesh if mesh is not None else make_mesh()
    n = mesh.shape[AXIS]
    from fractal_tpu.models.fern import _burn_in

    if exact and not compat_replicas:
        ss = scene.supersample
        replicas = max(1, scene.fern_replicas)
        total = max(1, scene.iterations)
        per_replica = max(1, total // replicas)
        k_total = int(min(walkers, per_replica))
        steps = max(1, per_replica // k_total)
        k_dev = -(-k_total // n)
        curve = jnp.asarray(darkening_curve(
            scene.secondary_color.as_tuple(),
            scene.primary_color.as_tuple(),
            float(scene.color_weight),
        ))
        return _render_fern_sharded_exact_jit(
            scene, k_total, k_dev, steps, replicas, mesh, curve,
            burn_in=_burn_in(scene, scene.width * ss, scene.height * ss),
            ss=ss,
        )

    per_dev = max(1, scene.iterations // n)
    k = int(min(walkers, per_dev))
    steps = max(1, per_dev // k)

    curve = jnp.asarray(darkening_curve(
        scene.secondary_color.as_tuple(),
        scene.primary_color.as_tuple(),
        float(scene.color_weight),
    ))
    return _render_fern_sharded_jit(
        scene, k, steps, mesh, compat_replicas, curve,
        burn_in=_burn_in(scene, scene.width, scene.height))
