"""Render driver — the L2 orchestration layer (reference ``get_image``,
src/lib.rs:253-321, re-designed for an accelerator).

Where the reference fans rows out over rayon threads, here the whole image is
one jitted XLA program (or one Pallas kernel): the "thread fan-out" is the
kernel's grid of pixel blocks plus, for multi-device runs, shard_map tiling
over the device mesh (fractal_tpu.parallel).

Pipeline: viewport transform → escape iteration → coloring epilogue →
(optional) supersample downsample.  The fern goes through the chaos-game
path in models/fern.py.

Precision policy ("auto"): picks the cheapest representation that still
resolves one pixel, by pixel spacing 1/(height·scale):
  * f32     spacing > ~2e-5   (f32 has 24-bit mantissa; |c| ~ O(1))
  * f64     down to ~1e-13    (the reference's own semantics)
  * perturb below (mandelbrot/julia): f32 delta orbits against a
    high-precision reference orbit — the deep-zoom decomposition the
    reference's GPU branch was missing (reference README.md:20-22).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fractal_tpu.config import Scene
from fractal_tpu.models.rules import get_rule, perturb_supported
from fractal_tpu.ops import coloring, route, viewport
from fractal_tpu.ops.escape_jnp import iterate

F32_SPACING_LIMIT = 2e-5   # conservative: ~2^7 ulps of headroom at |c|~1
F64_SPACING_LIMIT = 1e-13
# f64 resolves pixels down to ~1e-13 spacing; past that only perturbation
# works (f32 δ-orbits hold to ~1e-38 absolute).  Within f64's range we stay
# on f64, the reference's own semantics; perturbation is the
# beyond-reference extension.
PERTURB_SPACING_LIMIT = 1e-13


def _ensure_x64():
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)


def resolve_precision(scene: Scene) -> str:
    """Resolve 'auto' to a concrete precision for this scene (static):
    f32 for shallow views, perturbation past f64's reach, f64 between —
    the reference's own semantics, in hardware on the CPU and the GPU.
    ds32 and dd64 are explicit tiers only.
    """
    if scene.precision != "auto":
        if scene.precision in ("f64", "dd64"):
            _ensure_x64()
        return scene.precision
    spacing = scene.pixel_spacing / scene.supersample
    if spacing > F32_SPACING_LIMIT:
        return "f32"
    if (perturb_supported(scene.algo, scene.power)
            and spacing <= PERTURB_SPACING_LIMIT):
        return "perturb"
    _ensure_x64()
    return "f64"


def _grid_dtype(precision: str):
    if precision in ("f64", "dd64"):
        _ensure_x64()
        return jnp.float64
    return jnp.float32


# ---------------------------------------------------------------------------
# Escape-time path
# ---------------------------------------------------------------------------


def _color_and_downsample_dist(scene: Scene, dist, cnt):
    """``_color_and_downsample`` from the squared final distance (the p32
    dist-only kernel's output) — bit-identical to the zr/zi form."""
    img_f = coloring.color_escape_result_dist(
        dist,
        cnt,
        iterations=scene.iterations,
        stable_limit=scene.stable_limit,
        exposure=scene.exposure,
        primary_color=scene.primary_color.as_tuple(),
        secondary_color=scene.secondary_color.as_tuple(),
        inside=scene.inside,
        smooth=scene.smooth,
        as_float=True,
    )
    return coloring.downsample_box(img_f, scene.supersample)


def _color_and_downsample(scene: Scene, zr, zi, cnt):
    img_f = coloring.color_escape_result(
        zr,
        zi,
        cnt,
        iterations=scene.iterations,
        stable_limit=scene.stable_limit,
        exposure=scene.exposure,
        primary_color=scene.primary_color.as_tuple(),
        secondary_color=scene.secondary_color.as_tuple(),
        inside=scene.inside,
        smooth=scene.smooth,
        as_float=True,
    )
    return coloring.downsample_box(img_f, scene.supersample)


def _escape_jnp_band(scene: Scene, precision: str, start: int, rows: int):
    """Shared body of the whole-image jnp program and its banded form:
    pixel_grid's transform is elementwise over integer-valued row indices,
    so a band is bit-identical to the same slice of the one-shot render."""
    ss = scene.supersample
    h, w = scene.height * ss, scene.width * ss
    # Supersampling subdivides each pixel: the viewport transform divides by
    # height, so using the scaled height keeps the same view window.
    dtype = _grid_dtype(precision)

    cr, ci = viewport.pixel_grid(w, h, scene.pos, scene.scale, dtype=dtype,
                                 row0=start, rows=rows)
    rule = get_rule(scene.algo, scene.power)
    if scene.algo == "julia":
        c_r = jnp.asarray(scene.julia_set[0], dtype)
        c_i = jnp.asarray(scene.julia_set[1], dtype)
        zr, zi, cnt = iterate(cr, ci, c_r, c_i, scene.iterations, scene.limit, rule)
    else:
        # Mandelbrot-family: z starts at the pixel coordinate and c == z0
        # (calc/src/lib.rs:208-212 — note: NOT the z0=0 convention).
        zr, zi, cnt = iterate(cr, ci, cr, ci, scene.iterations, scene.limit, rule)
    return _color_and_downsample(scene, zr, zi, cnt)


@functools.partial(jax.jit, static_argnames=("precision",))
def _render_escape_jit(scene: Scene, precision: str):
    ss = scene.supersample
    return _escape_jnp_band(scene, precision, 0, scene.height * ss)


@functools.partial(jax.jit, static_argnames=("precision", "rows"))
def _render_band_jnp_jit(scene: Scene, precision: str, start,
                         rows: int):
    """One band through the jnp program — used by fractal_tpu.tiled for
    the tiers whose ONE-SHOT render rides the jnp program (f64 always;
    f32 on CPU), so banded == one-shot bit-exactly there too.  ``start``
    is traced (integer-valued, exact in the grid dtype), so every
    same-size band shares one compiled program."""
    return _escape_jnp_band(scene, precision, start, rows)


@functools.partial(jax.jit, static_argnames=("precision", "impl"))
def _render_escape_pallas_jit(scene: Scene, params, precision: str,
                              impl: str):
    """The params program: ``iterate_params`` (the escape-time kernel or
    its twin, per ``impl``) → coloring."""
    from fractal_tpu.ops.escape_pallas import iterate_params

    ss = scene.supersample
    h, w = scene.height * ss, scene.width * ss
    zr, zi, cnt = iterate_params(
        params,
        algo=scene.algo,
        power=scene.power,
        iterations=scene.iterations,
        height=h,
        width=w,
        precision=precision,
        impl=impl,
        # Interior cycle detection is exact only when interior pixels render
        # black (no dependence on the final z phase) — see _iterate_tile.
        periodicity=not scene.inside,
    )
    return _color_and_downsample(scene, zr, zi, cnt)


@functools.partial(jax.jit,
                   static_argnames=("precision", "impl", "rows"))
def _render_band_jit(scene: Scene, params, precision: str, impl: str,
                     rows: int):
    """One horizontal band of the supersampled grid (see fractal_tpu.tiled):
    `params[15]` carries the global start row, so this is the same program
    as the full render addressed through the exact global-row map."""
    from fractal_tpu.ops.escape_pallas import iterate_params

    w = scene.width * scene.supersample
    zr, zi, cnt = iterate_params(
        params,
        algo=scene.algo,
        power=scene.power,
        iterations=scene.iterations,
        height=rows,
        width=w,
        precision=precision,
        impl=impl,
        periodicity=not scene.inside,
    )
    return _color_and_downsample(scene, zr, zi, cnt)


def params_dtype(precision: str):
    """Word type of the ``scene_params`` block a precision tier reads."""
    if precision in ("f64", "dd64"):
        _ensure_x64()
        return jnp.float64
    return jnp.float32


def escape_impl(precision: str, backend: str = "auto") -> str:
    """Which program renders an escape-time tier (ops/route.py names).

    "auto" runs the escape-time kernel where it compiles (f32, f64 and
    ds32 on the GPU) and the XLA programs elsewhere.  "pallas" asks for
    the kernel — on a platform without it that is the twin, the same
    arithmetic.  "jnp" asks for the XLA programs."""
    if backend == "jnp" or precision == "dd64":
        return route.XLA
    return route.kernel_impl()


def _render_escape(scene: Scene, backend: str = "auto"):
    precision = resolve_precision(scene)
    if precision in ("perturb", "p32"):
        if not perturb_supported(scene.algo, scene.power):
            raise ValueError(
                f"perturbation supports the z^d+c family (mandelbrot/"
                f"julia/multibrot, d >= 2), burning ship, and tricorn — "
                f"not {scene.algo} (power {scene.power}); use ds32/dd64")
        from fractal_tpu.ops.perturb import render_perturb

        # p32 — the explicit fast tier: f32 δ-orbits against the exact
        # reference orbit, no glitch fallback.  Interior/escaped
        # classification >99.9 % correct at mid-depth; boundary counts carry
        # f32 trajectory noise.  Never auto-selected: "auto" keeps the
        # f64/perturb ladder (no silent precision change).
        return render_perturb(scene, fast=precision == "p32")
    impl = escape_impl(precision, backend)
    if (impl == route.XLA and precision in ("f32", "f64")
            and backend != "pallas"):
        # the whole-image jnp program (reference viewport expressions)
        return _render_escape_jit(scene, precision)
    from fractal_tpu.ops.escape_pallas import scene_params

    # Exact host-side viewport constants — needs concrete pos/scale, so
    # this runs outside jit; everything traced happens in the jit above.
    params = scene_params(scene, dtype=params_dtype(precision))
    return _render_escape_pallas_jit(scene, params, precision, impl)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def render_u8(scene: Scene, backend: str = "auto"):
    """Render a scene to a device array of shape (height, width, 3) uint8."""
    if scene.algo == "fern":
        from fractal_tpu.models.fern import render_fern

        return render_fern(scene)
    return _render_escape(scene, backend=backend)


def render(scene: Scene, backend: str = "auto") -> np.ndarray:
    """Render to a host numpy array (H, W, 3) uint8 — the ``get_image``
    equivalent (src/lib.rs:253)."""
    return np.asarray(jax.device_get(render_u8(scene, backend=backend)))
