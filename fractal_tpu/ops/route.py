"""The one platform decision: which implementation runs the hot loops.

The hand-written Pallas kernels (the escape-time kernel in
``ops/escape_pallas.py`` and the δ-orbit kernel in ``ops/perturb.py``) are
compiled through Pallas' Triton route, which exists only for NVIDIA GPUs.
Every other platform runs the XLA twins: whole-image programs with the same
arithmetic.  Tests run the kernels themselves through the Pallas
interpreter by asking for ``"interpret"`` explicitly; production code never
does.
"""

from __future__ import annotations

from typing import Optional

import jax

# Implementation names, passed as a static argument down to the kernels.
XLA = "xla"              # the whole-image XLA twin
TRITON = "triton"        # the Pallas kernel compiled for the GPU
INTERPRET = "interpret"  # the same Pallas kernel run by the interpreter

IMPLS = (XLA, TRITON, INTERPRET)


def kernel_impl(platform: Optional[str] = None) -> str:
    """``TRITON`` on the ``gpu`` platform, ``XLA`` everywhere else.

    ``platform`` defaults to ``jax.default_backend()``."""
    platform = jax.default_backend() if platform is None else platform
    return TRITON if platform == "gpu" else XLA


def forced_kernel_impl(force: Optional[bool]) -> str:
    """The implementation for a caller's explicit choice: ``None`` follows
    the platform; ``True`` asks for the kernel (compiled where it can be,
    interpreted elsewhere — tests use this); ``False`` asks for the twin."""
    if force is None:
        return kernel_impl()
    if not force:
        return XLA
    return TRITON if kernel_impl() == TRITON else INTERPRET
