"""fractal_tpu — a fractal rendering framework for accelerators (JAX).

A from-scratch JAX / XLA / Pallas re-design of the capabilities of the
reference renderer (Icelk/fractal-renderer): escape-time fractals
(Mandelbrot, Julia, Multibrot, Burning Ship, Tricorn), the Barnsley fern
chaos game, smooth coloring, AVIF/PNG output, an interactive viewer, and
deep-zoom precision paths (double-single / double-double / perturbation)
that go past the f64 wall which stalled the reference's GPU port
(reference README.md:20-22).

Layering (cf. SURVEY.md §1):
  models/    fractal families — iteration rules + the fern (L1 equivalent)
  ops/       compute kernels: jnp + Pallas escape kernels, dd arithmetic,
             viewport transform, coloring epilogue (L1/L2)
  parallel/  device-mesh sharding: shard_map tiling, psum reduces (L2)
  io/        image encoding (PNG/AVIF), --open launcher (L3)
  cli.py     command-line frontend with reference-parity flags (L4)
  viewer.py  interactive viewer with latest-wins coalescing (L4)
"""

from fractal_tpu.config import Scene, RGB, scene_defaults
from fractal_tpu.render import render, render_u8

__version__ = "0.1.0"

__all__ = ["Scene", "RGB", "scene_defaults", "render", "render_u8", "__version__"]
