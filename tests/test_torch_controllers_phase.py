"""The card script's ``controllers`` phase, rehearsed on the CPU at a small
size: the port's APIServer, its ControllerManager (every default
controller, leader-elected) and a fleet of the port's hollow kubelets
each in a spawned process, and the connected runner here on
``device="cpu"``. The four steps (saturate, scale and roll, two kubelets
out of service and their nodes NotReady, delete) reach their end states
and every gate of the phase holds; the manager evicts the failed nodes'
pods and exits 0, only the failed nodes are tainted, and the fleet runs
no pod at the end."""

from __future__ import annotations

import chip_smoke

SMALL = (("big", 1, 20), ("medium", 2, 6), ("small", 6, 2))


def test_chip_smoke_controllers_phase_runs_on_the_cpu():
    out = chip_smoke.controllers_phase(device="cpu", n_nodes=10,
                                       deployments=SMALL, n_failed=2,
                                       step_timeout_s=120.0)
    assert set(out["steps_s"]) == {"saturate", "scale_update",
                                   "node_failure", "delete"}
    # each step's CPU seconds by process, the apiserver's measured
    assert set(out["steps_cpu_s"]) == set(out["steps_s"])
    for split in out["steps_cpu_s"].values():
        assert set(split) == {"apiserver", "manager", "fleet", "scheduler"}
    assert out["steps_cpu_s"]["saturate"]["apiserver"] > 0
    assert out["pods"] == 44 and out["saturate_binds"] >= 44
    assert out["manager_exit_code"] == 0
    assert out["manager"]["evictions"] >= out["pods_on_failed_nodes"] > 0
    assert out["launches"] == {"count_pn": 0}
    assert len(out["manager_controllers"]) >= 29
    assert len(out["tainted_nodes"]) == 2
    assert out["fleet"]["running_pods"] == 0
    assert out["fleet"]["fleet"]["nodes"] == 8
