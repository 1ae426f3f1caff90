"""Banded rendering with checkpoint/resume — for huge ("100MP+") renders.

The reference renders one-shot and has no resume (SURVEY.md §5); for
multi-minute posters a crash costs everything.  Here the image is rendered
in horizontal bands, each addressed through an exact global-row map —
the params program's integer (stride, offset) row map wherever the
one-shot render runs the params program, the jnp program's elementwise
``pixel_grid(row0=...)`` band where it runs the jnp program (f64 off the
GPU) — so the banded result is bit-identical to the one-shot render at
every tier, with one caveat: f32 off the GPU, where the one-shot render
rides the jnp program and XLA:CPU's shape-dependent fusion rounding can
flip ~0.05 % of chaotic boundary escape tests between differently-shaped
programs (see ``_band_u8``; on the GPU both run the kernel and match
exactly).  Completed bands are written to a checkpoint
directory as they finish; a rerun skips them and assembles the rest.

Escape-time scenes only (the fern's chaos game is a global scatter — no
spatial decomposition to band).  Perturbation-depth scenes band too when
persistence is requested: one reference orbit is shared across bands and
each band resolves its glitches in global coordinates
(ops/perturb.render_perturb_band); without ``ckpt_dir`` they keep the
faster one-shot program (which already bands internally for early exit).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import jax
import numpy as np

from fractal_tpu.config import Scene


def _band_u8(scene: Scene, start_row: int, rows: int, precision: str,
             impl: str):
    """Render global rows [start_row, start_row+rows) of the supersampled
    grid, colored and downsampled — shapes static per band size.

    Program choice mirrors the one-shot render (render.py::_render_escape):
    f64 off the GPU rides the jnp program (bit-identical bands); every
    other tier rides the params program (the kernel on the GPU, the twin
    elsewhere), bit-identical too.  f32 off the GPU keeps the params
    program: the one-shot f32 render rides the jnp program instead, and
    XLA:CPU's whole-program fusion rounds the escape loop shape-dependently
    (FMA contraction), so band programs of any family can flip ~0.05 % of
    chaotic boundary escape tests vs the one-shot shape — measured, and
    not fixable short of pinning every mul+add in the hot rules."""
    from fractal_tpu.ops import route
    from fractal_tpu.ops.escape_pallas import scene_params
    from fractal_tpu.render import (
        _render_band_jit, _render_band_jnp_jit, params_dtype,
    )

    if precision == "f64" and impl == route.XLA:
        return _render_band_jnp_jit(scene, precision, start_row, rows)
    params = scene_params(scene, dtype=params_dtype(precision))
    params = params.at[15].set(float(start_row))
    return _render_band_jit(scene, params, precision, impl, rows)


def render_tiled(scene: Scene, band_rows: int = 512,
                 ckpt_dir: Optional[str] = None,
                 progress: Optional[Callable[[str], None]] = None,
                 mesh=None) -> np.ndarray:
    """Render `scene` in row bands with optional checkpoint/resume.

    Returns the assembled (height, width, 3) uint8 host image.  With
    `ckpt_dir`, finished bands are persisted as ``band_<i>.npy`` plus a
    manifest; a rerun with the same scene resumes after the last completed
    band.  A manifest whose scene hash differs aborts (stale directory).

    ``mesh``: each band's rows additionally interleave across the device
    mesh (the band's global start composes with the interleave stride
    through the exact integer row map) — banded + sharded renders stay
    bit-identical to the UNBANDED sharded render at every tier, including
    perturbation depth (shared orbit replicated per device, glitches
    resolved in global coordinates).  They also match the single-device
    banded render wherever the mesh and single-device one-shot programs
    agree (everywhere on the GPU; on CPU the f32/f64 mesh rides the params
    program while single-device f32/f64 rides the jnp program, mirroring
    their one-shot counterparts — same split as unbanded renders).
    """
    from fractal_tpu.render import resolve_precision

    if scene.algo == "fern":
        raise ValueError("banded rendering applies to escape-time scenes; "
                         "the fern chaos game is a global scatter")
    precision = resolve_precision(scene)
    perturb = precision in ("perturb", "p32")
    if perturb and ckpt_dir is None:
        # Without persistence the one-shot program is strictly better (it
        # already bands internally for spatial early exit, with no per-band
        # dispatch/fetch): --bands alone falls through to it, loudly —
        # keeping a requested mesh (it must not silently drop to 1 device).
        if progress:
            progress("perturbation path: internal banding, --bands ignored")
        if mesh is not None:
            from fractal_tpu.parallel.sharding import render_perturb_sharded

            return np.asarray(jax.device_get(render_perturb_sharded(
                scene, mesh, fast=precision == "p32")))
        from fractal_tpu.render import render_u8

        return np.asarray(jax.device_get(render_u8(scene)))

    ss = scene.supersample
    h = scene.height * ss
    band_rows = max(ss, (band_rows // ss) * ss)  # keep downsample aligned
    n_bands = -(-h // band_rows)
    from fractal_tpu.render import escape_impl

    impl = escape_impl(precision)

    if perturb and mesh is not None:
        from fractal_tpu.parallel.sharding import render_perturb_band_sharded

        def band_u8(start, rows):
            return render_perturb_band_sharded(scene, start, rows,
                                               fast=precision == "p32",
                                               mesh=mesh)
    elif perturb:
        from fractal_tpu.ops.perturb import render_perturb_band

        def band_u8(start, rows):
            return render_perturb_band(scene, start, rows,
                                       fast=precision == "p32")
    elif mesh is not None:
        from fractal_tpu.ops.escape_pallas import scene_params
        from fractal_tpu.parallel.sharding import (
            SHARDED_PRECISIONS, _render_band_sharded_jit,
        )
        from fractal_tpu.render import params_dtype

        if precision not in SHARDED_PRECISIONS:
            # Same no-silent-downgrade contract as the unbanded mesh path
            # (render_escape_sharded): dd64 has no sharded program.
            raise ValueError(
                f"sharded rendering supports f32/f64/ds32/perturb, not "
                f"{precision!r}; use precision='f64' or 'perturb' for "
                f"deeper zooms")

        def band_u8(start, rows):
            params = scene_params(scene, dtype=params_dtype(precision))
            params = params.at[15].set(float(start))
            return _render_band_sharded_jit(scene, params, precision,
                                            impl, mesh, rows)
    else:
        def band_u8(start, rows):
            return _band_u8(scene, start, rows, precision, impl)

    scene_key = repr(sorted(
        (k, str(v)) for k, v in scene.__dict__.items()
    )) + f"|{precision}|{band_rows}"
    manifest_path = os.path.join(ckpt_dir, "manifest.json") if ckpt_dir else None
    done = set()
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(manifest_path):
            m = json.load(open(manifest_path))
            if m.get("scene_key") != scene_key:
                raise ValueError(
                    f"checkpoint dir {ckpt_dir} holds a different render "
                    "(scene/precision/band mismatch); use a fresh directory")
            done = set(m.get("done", []))

    bands = []
    for b in range(n_bands):
        start = b * band_rows
        rows = min(band_rows, h - start)
        band_path = (os.path.join(ckpt_dir, f"band_{b}.npy")
                     if ckpt_dir else None)
        if b in done and band_path and os.path.exists(band_path):
            band = np.load(band_path)
        else:
            band = np.asarray(jax.device_get(band_u8(start, rows)))
            if ckpt_dir:
                np.save(band_path, band)
                done.add(b)
                json.dump({"scene_key": scene_key, "done": sorted(done)},
                          open(manifest_path, "w"))
            if progress:
                progress(f"band {b + 1}/{n_bands} ({rows} rows)")
        bands.append(band)
    return np.concatenate(bands, axis=0)
