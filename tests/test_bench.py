"""The bench harness line stays parseable and compact.

``python bench.py`` prints exactly ONE JSON line, read from a bounded tail
of stdout, so the fully-populated line must stay ≤ ``bench.LINE_BUDGET``
(1,800 B) with worst-case-width values in every config slot.  It measures
the GPU only (tests/test_kernels.py checks that it refuses the CPU).
"""

import json

import bench


def test_json_line_fits_driver_capture():
    """The fully-populated line — every config slot present, every numeric
    field at worst-case realistic width, the device named — must stay
    within LINE_BUDGET so a 2,000-byte tail capture can never clip it.
    Uses the real assembly path."""
    cfg = {}
    for name in list(bench.baseline_configs()) + list(
            bench.longtail_configs()):
        cfg[name] = {"ms": 99999.9, "mps": 99999.9, "cold": 999999,
                     "warm": 99999, "prec": "perturb", "nres": 999999}
    cfg["jsweep256"] = {"s": 999.99, "fps": 9999.9,
                        "s_minmax": [999.99, 9999.99], "cold": 9999999}
    result = bench.assemble_result(
        p50=9.9999994, times=[9.99999] * 8, t_cold=999.9994, t_warm=99.9994,
        p50_exact=99.99994, t_cold_exact=999.9994, configs=cfg,
        device=("gpu", "NVIDIA H100 80GB HBM3", 4))
    line = json.dumps(result, separators=(",", ":"))
    assert len(line) <= bench.LINE_BUDGET, (
        f"driver JSON line is {len(line)} B fully populated — over the "
        f"{bench.LINE_BUDGET} B budget; shrink keys/values in bench.py")
    # and the emit() guard uses the same serialization
    parsed = json.loads(line)
    assert parsed["details"]["cfg"]["mp100"]["ms"] == 99999.9
    assert (parsed["details"]["backend"], parsed["details"]["kind"],
            parsed["details"]["count"]) == ("gpu", "NVIDIA H100 80GB HBM3", 4)


def test_tracked_deep_scenes_zero_residual():
    """The deep bench scenes (scaled to test size) must report
    RENDER_STATS['n_residual'] == 0 after a full exact render — no tracked
    config ships best-effort pixels."""
    from fractal_tpu.ops.perturb import RENDER_STATS, render_perturb

    scenes = {**bench.baseline_configs(), **bench.longtail_configs()}
    for name in ("dz1e12", "p1e15"):
        sc = scenes[name].replace(width=64, height=48, iterations=600)
        render_perturb(sc)
        assert int(RENDER_STATS.get("n_residual") or 0) == 0, name


def test_config_inventory_stable():
    """The tracked config set: every BASELINE.json config + the long tail
    + the 100 MP device row must be present by (short) name."""
    names = set(bench.baseline_configs()) | set(bench.longtail_configs())
    assert {"julia_1080p", "m4k_ss2", "mb3_2k", "dz1e12", "bship_2k",
            "fern_100m", "fern_10m", "p1e15", "fe1e44", "bla1e40",
            "fe1e44_11k", "mp100"} <= names
