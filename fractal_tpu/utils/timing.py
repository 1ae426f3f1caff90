"""Per-phase wall-time profiling and optional jax.profiler tracing.

The reference has no tracing at all (SURVEY.md §5: println! only); the
framework provides a --profile flag printing a kernel / device→host / encode
phase breakdown, plus ``trace()`` for full jax.profiler traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Tuple


class Phases:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.entries: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.entries.append((name, time.perf_counter() - t0))

    def report(self) -> None:
        if not self.enabled or not self.entries:
            return
        total = sum(dt for _, dt in self.entries)
        print("--- profile ---")
        for name, dt in self.entries:
            print(f"{name:>16s}: {dt * 1e3:9.2f} ms")
        print(f"{'total':>16s}: {total * 1e3:9.2f} ms")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace viewable in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync(x):
    """Force completion of device work.

    A device→host copy waits for the computation and its transfer, so
    timings through ``sync``/``device_get`` include the fetch.
    """
    import jax

    return jax.device_get(x)
