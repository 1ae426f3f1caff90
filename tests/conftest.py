"""Test configuration: force the CPU backend with 8 virtual devices so
sharding tests run without several devices (SURVEY.md §4), and enable x64
for bit-parity tests against the f64 scalar reference implementation.

Tests of code that runs only on a GPU carry the ``gpu`` marker and skip
elsewhere; ``python chip_smoke.py`` runs their full-size counterparts on
the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Set in-process as well as through JAX_PLATFORMS, so a plain `pytest`
# run is held to the CPU too.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (the Triton kernels compile only "
                   "there); skips elsewhere")
