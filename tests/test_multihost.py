"""Real multi-host (DCN) test: two OS processes, one Gloo coordinator.

r1 shipped `parallel/multihost.py` as a shim whose only exercised behavior
was the single-process no-op.  This test launches an
actual 2-process cluster on the CPU backend (2 virtual devices per process
→ a 4-device global mesh), so the fern ``lax.psum`` and the escape-stripe
``shard_map`` genuinely run collectives across the process boundary, and
asserts the results are bit-identical to the same renders in a single
process — the package's sharding contract extended over DCN.

The reference is single-process shared-memory (SURVEY.md §5 "distributed
backend"); this is the multi-host story it lacks.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fractal_tpu.config import Scene, scene_defaults
from fractal_tpu.parallel.sharding import (
    make_mesh,
    render_escape_sharded,
    render_fern_sharded,
)
from fractal_tpu.render import render_u8

WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster_results():
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    # Set before python starts, so it precedes the worker's jax import.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(WORKER)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(WORKER))),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out")
        assert p.returncode == 0, (
            f"worker failed rc={p.returncode}\n"
            f"stdout: {out.decode()[-2000:]}\nstderr: {err.decode()[-2000:]}")
        outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    return outs


def test_two_process_cluster_forms(cluster_results):
    a, b = sorted(cluster_results, key=lambda r: r["process_id"])
    assert (a["process_id"], b["process_id"]) == (0, 1)
    for r in (a, b):
        assert r["status"] == "joined"
        assert r["process_count"] == 2
        assert r["global_devices"] == 4


def test_fern_psum_crosses_processes_bit_identical(cluster_results):
    """The 4-device fern psum over DCN equals the 4-device single-process
    run bit-for-bit (the replica seeds depend only on device index)."""
    fern = scene_defaults("fern").replace(width=48, height=48,
                                          iterations=40_000, seed=7)
    local = np.asarray(render_fern_sharded(fern, make_mesh(4)))
    want = hashlib.sha256(local.tobytes()).hexdigest()
    for r in cluster_results:
        assert r["fern_sha"] == want


def test_escape_stripes_across_processes_match_single_device(cluster_results):
    """Replicated device-side checksum of the multi-host sharded escape
    render equals the single-device render's (the stripes' exact global-row
    map is process-layout-independent)."""
    esc = Scene(width=64, height=44, iterations=96,
                pos=(-0.6, 0.0), scale=(0.4, 0.4), precision="ds32")
    single = int(np.asarray(render_u8(esc)).astype(np.int64).sum())
    sharded_local = render_escape_sharded(esc, make_mesh(4), precision="ds32")
    local = int(jax.jit(lambda x: jnp.sum(x.astype(jnp.int64)))(sharded_local))
    assert local == single  # local 4-device contract...
    for r in cluster_results:
        assert r["escape_sum"] == single  # ...and over two real processes


def test_row_ranges_tile_the_image(cluster_results):
    ranges = sorted(r["row_range"] for r in cluster_results)
    assert ranges[0][0] == 0
    assert ranges[0][1] == ranges[1][0]
    assert ranges[1][1] == 44
