"""Batched animation rendering — frame sweeps as ONE device program.

The reference renders stills only; animations mean re-invoking the binary
per frame (process startup + full re-render each time).  Here a sweep over
any *traced* scene parameter (julia c, pos, scale, exposure — the dynamic
pytree leaves of Scene) compiles once and runs all frames inside a single
``lax.map`` dispatch: no per-frame launch overhead.

``lax.map`` (sequential) rather than ``vmap``: frames are rendered to u8
as they finish, so device memory holds one frame's iteration state plus
the (frames, H, W, 3) u8 output — a 256-frame 1080p sweep needs ~1.6 GB,
not the ~40 GB a vmapped iteration state would.

Precision: sweeps run the same auto ladder as stills (f32 → f64) — there is
no silent downgrade; a parameter sweep on an explicit ds32/dd64 tier renders
each frame with the params program, with the per-frame exact viewport
constants stacked host-side.  Deep *zoom* sweeps (scale ramps past f64)
go through ``render_zoom_sweep``: one reference orbit, computed at the
deepest frame, is shared by every frame (the center pixel's c is the same
at every zoom level), and frames iterate f32 δ-orbits against it — the
p32 fast tier's quality envelope (see PERF.md), documented rather than
silent.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from fractal_tpu.config import Scene
from fractal_tpu.models.rules import eff_power, perturb_supported
from fractal_tpu.ops import route
from fractal_tpu.render import (
    _render_escape_jit,
    _render_escape_pallas_jit,
    escape_impl,
    params_dtype,
    resolve_precision,
)


def _frame_fn(treedef, precision: str):
    def one_frame(leaves):
        sc = jax.tree_util.tree_unflatten(treedef, leaves)
        return _render_escape_jit(sc, precision)

    return one_frame


def _frame_fn_params(treedef, precision: str, impl: str):
    def one_frame(args):
        leaves, params = args
        sc = jax.tree_util.tree_unflatten(treedef, leaves)
        return _render_escape_pallas_jit(sc, params, precision, impl)

    return one_frame


@functools.partial(jax.jit, static_argnames=("precision", "treedef"))
def _sweep_jit(scene: Scene, leaves_batched, treedef, precision: str):
    """Render one frame per entry of the batched dynamic leaves."""
    return jax.lax.map(_frame_fn(treedef, precision), leaves_batched)


@functools.partial(jax.jit, static_argnames=("precision", "treedef",
                                             "impl"))
def _sweep_params_jit(scene: Scene, leaves_batched, params_batched, treedef,
                      precision: str, impl: str):
    """Params-program sweep: per-frame exact viewport params ride alongside
    the traced leaves; each frame runs the same program as a still render
    (the escape-time kernel or its twin) — no precision downgrade."""
    return jax.lax.map(_frame_fn_params(treedef, precision, impl),
                       (leaves_batched, params_batched))


def _pad_frame_axis(tree, n_frames: int, n_dev: int):
    """Pad every leaf's leading (frame) axis to a multiple of the mesh size
    by repeating the last frame — padding frames render (identical work per
    device) and are sliced off after the gather."""
    pad = (-n_frames) % n_dev
    if not pad:
        return tree
    return jax.tree_util.tree_map(
        lambda x: jnp.concatenate(
            [x, jnp.repeat(x[-1:], pad, axis=0)]), tree)


def _run_frames_sharded(mesh, one_frame, batched, n_frames: int,
                        replicated=()):
    """Frame-parallel DP: shard the frame axis across the mesh, each device
    lax.maps its local slice (one frame's iteration state resident at a
    time — the same memory envelope as the single-device sweep, n-way
    parallel).  Every frame runs the identical per-frame program, so the
    gathered sweep is bit-identical to the unsharded one."""
    from jax import shard_map
    from jax.sharding import PartitionSpec

    from fractal_tpu.parallel.sharding import AXIS

    n = mesh.shape[AXIS]
    batched = _pad_frame_axis(batched, n_frames, n)

    def local(batched, replicated):
        return jax.lax.map(lambda a: one_frame(a, *replicated), batched)

    out = shard_map(
        local, mesh=mesh,
        in_specs=(PartitionSpec(AXIS), PartitionSpec()),
        out_specs=PartitionSpec(AXIS),
        check_vma=False,
    )(batched, replicated)
    return jax.tree_util.tree_map(lambda x: x[:n_frames], out)


def _batch_leaves(scenes, treedef, dtype):
    batched = []
    for s in scenes:
        leaves, td = jax.tree_util.tree_flatten(s)
        if td != treedef:
            raise ValueError(
                "sweep frames must share static scene structure "
                "(algo/dims/iterations/flags); only traced parameters may vary")
        batched.append(leaves)
    # stack on the HOST, one device transfer per leaf — per-frame jnp ops
    # would pay a dispatch frames×leaves times.
    # Extreme-depth scale leaves overflow the f32 cast to inf; that leaf is
    # never consumed device-side (the fe params carry the affine), so the
    # overflow is expected, not a lost value.
    np_dt = np.float64 if dtype == jnp.float64 else np.float32
    with np.errstate(over="ignore"):
        return [
            jnp.asarray(np.stack([np.asarray(f[i], np_dt) for f in batched]))
            for i in range(len(batched[0]))
        ]


def render_sweep(scenes: Sequence[Scene], device_resident: bool = False,
                 mesh=None):
    """Render a sequence of scenes that differ only in traced (dynamic)
    parameters — julia_set, pos, scale, exposure, colors, limits — as one
    compiled program.  Returns (frames, H, W, 3) uint8 (host numpy, or the
    device array with ``device_resident=True``).

    All scenes must share static structure (algo, dims, iterations, …);
    a mismatch raises before any device work.  Each frame renders at the
    precision the auto ladder resolves for it, through the same program as
    a still render of that tier.  Sweeps whose depth needs perturbation must go
    through ``render_zoom_sweep`` (per-frame reference orbits are the
    per-frame cost the batched sweep avoids); a ValueError says so.

    ``mesh``: frame-parallel DP — the frame axis shards across the device
    mesh, each device lax.maps its slice (same per-frame program, same
    memory envelope), so the sweep is bit-identical to the unsharded one
    and ~N× faster wall-clock.
    """
    if not scenes:
        raise ValueError("empty sweep")
    first = scenes[0]
    _, treedef = jax.tree_util.tree_flatten(first)
    # resolve against the deepest frame so one frame past a threshold
    # upgrades the whole sweep (uniform quality across frames)
    deepest = max(scenes, key=lambda s: max(abs(s.scale[0]), abs(s.scale[1])))
    precision = resolve_precision(deepest)
    if precision in ("perturb", "p32"):
        raise ValueError(
            "sweep reaches perturbation depth; use render_zoom_sweep "
            "(shared-orbit deep-zoom sweep) instead")
    dtype = params_dtype(precision)
    leaves_batched = _batch_leaves(scenes, treedef, dtype)
    impl = escape_impl(precision)
    if precision in ("ds32", "dd64") or impl != route.XLA:
        # the params program (still renders of these tiers run it too)
        from fractal_tpu.ops.escape_pallas import scene_params

        params_batched = jnp.stack(
            [scene_params(s, dtype=dtype) for s in scenes])
        if mesh is not None:
            out = _run_frames_sharded(
                mesh, lambda a: _frame_fn_params(treedef, precision,
                                                 impl)(a),
                (leaves_batched, params_batched), len(scenes))
        else:
            out = _sweep_params_jit(first, leaves_batched, params_batched,
                                    treedef, precision, impl)
    elif mesh is not None:
        out = _run_frames_sharded(
            mesh, lambda a: _frame_fn(treedef, precision)(a),
            leaves_batched, len(scenes))
    else:
        out = _sweep_jit(first, leaves_batched, treedef, precision)
    if device_resident:
        return out
    return np.asarray(jax.device_get(out))


def _zoom_frame_fn(scene: Scene, treedef, *, height: int, width: int,
                   impl: str, glitch: bool, power: int, algo: str,
                   extreme: bool):
    """Per-frame zoom-sweep program, shared by the single-device lax.map
    and the frame-sharded mesh twin (the orbit rides as a replicated extra
    so the mesh version can shard only the frame axis)."""
    from fractal_tpu.ops.perturb import (
        _twin_chunk,
        perturb_kernel,
        perturb_whole_jnp,
    )
    from fractal_tpu.render import _color_and_downsample

    def one_frame(args, orbit_packed, n_steps):
        leaves, P = args
        sc = jax.tree_util.tree_unflatten(treedef, leaves)
        if extreme or impl == route.XLA:
            # floatexp δ-orbits (P in the _pert_params_fe layout) always run
            # the XLA twin; plain-f32 frames do off the GPU
            zr, zi, cnt, gl = perturb_whole_jnp(
                orbit_packed, P, n_steps, iterations=scene.iterations,
                height=height, width=width,
                chunk=_twin_chunk(),
                power=power, algo=algo, extreme=extreme)
        else:
            zr, zi, cnt, gl = perturb_kernel(
                orbit_packed, P, n_steps, iterations=scene.iterations,
                height=height, width=width, glitch=glitch, power=power,
                algo=algo, interpret=impl == route.INTERPRET)
        # per-frame flagged-pixel count: the exact sweep re-renders only
        # the frames where it is non-zero (zero extra cost per frame)
        return (_color_and_downsample(sc, zr, zi, cnt),
                jnp.sum(gl, dtype=jnp.int32))

    return one_frame


@functools.partial(jax.jit, static_argnames=("height", "width", "impl",
                                             "treedef", "glitch", "power",
                                             "algo", "extreme"))
def _zoom_sweep_jit(scene: Scene, leaves_batched, params_batched,
                    orbit_packed, n_steps, treedef, *, height: int,
                    width: int, impl: str, glitch: bool = False,
                    power: int = 2, algo: str = "mandelbrot",
                    extreme: bool = False):
    one_frame = _zoom_frame_fn(
        scene, treedef, height=height, width=width, impl=impl,
        glitch=glitch, power=power, algo=algo, extreme=extreme)
    return jax.lax.map(
        lambda a: one_frame(a, orbit_packed, n_steps),
        (leaves_batched, params_batched))


def render_zoom_sweep(scene: Scene, scales: Sequence[float],
                      device_resident: bool = False, exact: bool = False,
                      mesh=None):
    """Deep-zoom video: render ``scene`` at each zoom level in ``scales``
    (classic use: log-spaced 1e2 → 1e12) as ONE device program.

    The reference orbit is computed once at the DEEPEST frame — the view
    center's c is identical at every zoom level, so the same orbit serves
    all frames; only the per-frame viewport constants (δc gain) change.
    Every perturbation algo is supported (quadratic mandelbrot/julia,
    multibrot z^d+c, burning ship, tricorn — r3), and sweeps whose deepest
    frame passes the f32-δc wall (~1e30×) run the whole sweep through the
    floatexp program (quadratic only, like stills — the fe parameter
    layout's (mantissa, exponent) affine gains are exact at any depth,
    where the plain f32 viewport gain would underflow).  By default frames run
    the p32 quality envelope (f32 δ-orbits, no glitch fallback — see
    PERF.md); at shallow zoom f32 is exact-grade anyway, and past 1e6×
    the classification stays >99.9 % with boundary texture noise.  Fast
    sweeps also ride the per-frame series approximation (quadratic only):
    deep frames skip their common prefix exactly as stills do.

    ``exact=True`` closes the sweep/still quality gap:
    the batched pass runs glitch detection, and every frame that flags
    pixels is replaced by its still render (``render_perturb`` — full
    glitch fallback through the shared orbit/fix caches), so each output
    frame equals the still render of that zoom level.  Cost: one extra
    still render per glitched frame (typically only the deepest few).
    """
    from fractal_tpu.ops.perturb import _pert_params, reference_orbit

    if not perturb_supported(scene.algo, scene.power):
        raise ValueError(
            f"zoom sweeps support the z^d+c family (mandelbrot/julia/"
            f"multibrot, d >= 2), burning ship, and tricorn — not "
            f"{scene.algo} (power {scene.power})")
    from fractal_tpu.ops.perturb import _is_extreme

    deepest_probe = scene.replace(scale=(max(abs(float(s)) for s in scales),) * 2)
    extreme = _is_extreme(deepest_probe)
    if extreme and not (scene.power == 2
                        and scene.algo in ("mandelbrot", "julia")):
        raise ValueError(
            "zoom sweeps past ~1e30x (floatexp δ-orbits) support quadratic "
            f"mandelbrot/julia only, not {scene.algo} "
            f"(power {scene.power})")
    ss = scene.supersample
    h, w = scene.height * ss, scene.width * ss
    smax = max(float(s) for s in scales)
    deepest = scene.replace(scale=(smax, smax))
    # center reference: the zoom target must be interior-ish (a deep zoom
    # target always is — you zoom onto structure, the center orbit survives);
    # if it escapes early the deep frames would outlive the orbit.
    ref = (w // 2, h // 2)
    orbit = reference_orbit(deepest, ref, w, h)
    if orbit.n_steps < scene.iterations:
        raise ValueError(
            f"zoom-sweep center escapes after {orbit.n_steps} iterations "
            f"(< {scene.iterations}); pick a center on/inside the set "
            "(e.g. a minibrot) for a deep-zoom video")
    impl = route.kernel_impl()
    frames = [scene.replace(scale=(float(s), float(s))) for s in scales]
    _, treedef = jax.tree_util.tree_flatten(scene)
    leaves_batched = _batch_leaves(frames, treedef, jnp.float32)
    # fast-tier sweeps engage the per-frame series approximation (each
    # frame's scale gets its own n_skip/coefficients in its P row —
    # quadratic only, _pert_params gates internally); exact sweeps stay
    # SA-free so clean frames keep the bit-for-still contract (the still's
    # SA is computed against ITS chosen reference, not the sweep center)
    sa_orbit = None if exact else orbit
    if extreme:
        # the WHOLE sweep runs the floatexp program (uniform tier — one
        # frame past the wall upgrades every frame, like the precision
        # ladder): the fe parameter layout carries the affine gains as
        # (mantissa, exponent) pairs, which the batched f32 P rows
        # represent exactly at any depth.  No SA slots — the fe tile has
        # no series-approximation path.
        from fractal_tpu.ops.perturb import _pert_params_fe

        params_batched = jnp.stack(
            [_pert_params_fe(f, ref, w, h) for f in frames])
    else:
        params_batched = jnp.stack(
            [_pert_params(f, ref, w, h, orbit=sa_orbit) for f in frames])
    if mesh is not None:
        # Frame-parallel DP: the frame axis shards across the mesh, the
        # shared orbit replicates (it's identical for every
        # frame), each device lax.maps its slice — bit-identical to the
        # unsharded sweep (same per-frame program).
        one_frame = _zoom_frame_fn(
            scene, treedef, height=h, width=w, impl=impl, glitch=exact,
            power=eff_power(scene.algo, scene.power), algo=scene.algo,
            extreme=extreme)
        out, glc = _run_frames_sharded(
            mesh, one_frame, (leaves_batched, params_batched), len(frames),
            replicated=(jnp.asarray(orbit.packed),
                        jnp.int32(orbit.n_steps)))
    else:
        out, glc = _zoom_sweep_jit(
            scene, leaves_batched, params_batched,
            jnp.asarray(orbit.packed), jnp.int32(orbit.n_steps), treedef,
            height=h, width=w, impl=impl, glitch=exact,
            power=eff_power(scene.algo, scene.power),
            algo=scene.algo, extreme=extreme)
    if exact:
        from fractal_tpu.ops.perturb import render_perturb

        for i in np.flatnonzero(np.asarray(glc)):
            still = render_perturb(frames[int(i)], fast=False)
            out = out.at[int(i)].set(still)
    if device_resident:
        return out
    return np.asarray(jax.device_get(out))


def julia_c_path(t: np.ndarray) -> np.ndarray:
    """A classic closed c-path: circle of radius .7885 (the 'Julia morph')."""
    return np.stack([0.7885 * np.cos(2 * np.pi * t),
                     0.7885 * np.sin(2 * np.pi * t)], axis=-1)


def julia_sweep(frames: int = 256, width: int = 1920, height: int = 1080,
                iterations: int = 300, **scene_kw) -> np.ndarray:
    """The BASELINE.json config: an N-frame Julia animation at 1080p over a
    c-parameter path, batched into one program."""
    t = np.linspace(0.0, 1.0, frames, endpoint=False)
    cs = julia_c_path(t)
    scenes = [
        Scene(algo="julia", width=width, height=height,
              iterations=iterations, julia_set=(float(cr), float(ci)),
              pos=(0.0, 0.0), scale=(0.4, 0.4), **scene_kw)
        for cr, ci in cs
    ]
    return render_sweep(scenes)
