"""Entry-point contract: dryrun_multichip runs the multi-device step on
the devices the default backend has, re-runs itself on virtual CPU
devices only when that backend IS the CPU, and never swaps a real
backend with too few devices for a virtual one.
"""

import sys

import pytest


@pytest.fixture
def graft(monkeypatch):
    sys.path.insert(0, ".")
    import __graft_entry__ as g

    monkeypatch.delenv("_FRACTAL_DRYRUN_CHILD", raising=False)
    return g


def test_dryrun_runs_in_process_when_cpu_pinned(graft, capsys):
    # conftest already provisioned 8 virtual CPU devices in this process
    graft.dryrun_multichip(8)
    out = capsys.readouterr().out
    assert "work-balance" in out
    assert "max/mean=" in out


def test_dryrun_respawns_cpu_with_too_few_devices(graft, monkeypatch):
    respawned = []
    monkeypatch.setattr(graft, "_respawn_virtual_cpu",
                        lambda n: respawned.append(n))
    graft.dryrun_multichip(64)  # more than the 8 this process has
    assert respawned == [64]


def test_dryrun_refuses_real_backend_with_too_few_devices(graft,
                                                          monkeypatch):
    monkeypatch.setattr(graft.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(graft, "_respawn_virtual_cpu", lambda n: (
        pytest.fail("a GPU backend must not be swapped for virtual CPUs")))
    with pytest.raises(RuntimeError, match="only 8 device"):
        graft.dryrun_multichip(64)
