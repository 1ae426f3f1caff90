"""Worker process for the real multi-host (DCN) test.

Launched by tests/test_multihost.py as one of two OS processes.  Each
process owns 2 virtual CPU devices (XLA_FLAGS set by the parent before
python starts), joins the cluster over a local Gloo coordinator, and runs
the package's sharded renders on the GLOBAL 4-device mesh — the fern psum
and the escape stripes genuinely cross the process boundary.

Prints exactly one JSON line on success; any exception exits non-zero.
"""

import hashlib
import json
import sys

# Pin the CPU in-process as well as through the environment (same recipe
# as tests/conftest.py).
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main() -> None:
    coordinator, process_id = sys.argv[1], int(sys.argv[2])

    from fractal_tpu.parallel import multihost

    multihost.initialize(coordinator_address=coordinator,
                         num_processes=2, process_id=process_id,
                         initialization_timeout=60)
    assert multihost.is_multihost(), multihost.status()
    assert jax.process_count() == 2
    assert len(jax.local_devices()) == 2
    assert len(jax.devices()) == 4

    import jax.numpy as jnp
    import numpy as np

    from fractal_tpu.config import Scene, scene_defaults
    from fractal_tpu.parallel.sharding import (
        make_mesh,
        render_escape_sharded,
        render_fern_sharded,
    )

    mesh = make_mesh()  # all 4 devices, spanning both processes

    # Fern: the lax.psum all-reduce runs over DCN (Gloo) between the two
    # processes.  out_specs=P() -> replicated -> fully addressable here.
    fern = scene_defaults("fern").replace(width=48, height=48,
                                          iterations=40_000, seed=7)
    fern_img = np.asarray(render_fern_sharded(fern, mesh))
    fern_sha = hashlib.sha256(fern_img.tobytes()).hexdigest()

    # Escape: each device renders its interleaved row stripe; the output is
    # a global array (not fully addressable per process), so compare via a
    # replicated device-side checksum.
    esc = Scene(width=64, height=44, iterations=96,
                pos=(-0.6, 0.0), scale=(0.4, 0.4), precision="ds32")
    img = render_escape_sharded(esc, mesh, precision="ds32")
    esc_sum = int(jax.jit(lambda x: jnp.sum(x.astype(jnp.int64)))(img))

    # local_row_range must tile the image exactly across the 2 hosts.
    lo, hi = multihost.local_row_range(esc.height)
    assert 0 <= lo <= hi <= esc.height

    print(json.dumps({
        "process_id": process_id,
        "status": multihost.status(),
        "process_count": jax.process_count(),
        "global_devices": len(jax.devices()),
        "fern_sha": fern_sha,
        "escape_sum": esc_sum,
        "row_range": [lo, hi],
    }), flush=True)


if __name__ == "__main__":
    main()
