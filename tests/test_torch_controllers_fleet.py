"""The card script's ``controllers`` phase at its fleet size, rehearsed on
the CPU: 100 hollow kubelets of the port (``kubernetes_tpu_torch/kubelet/
kubemark.py``) run the nodes, as on the card, with fewer pods. Five
kubelets go out of service in the node-failure step: their nodes get the
not-ready taint and lose their pods, while the heartbeats and lease
renewals of the other 95 keep every one of them untainted through the
phase."""

from __future__ import annotations

import chip_smoke

PODS = (("big", 1, 100), ("medium", 2, 30), ("small", 10, 4))


def test_chip_smoke_controllers_phase_on_a_hollow_fleet_of_100():
    out = chip_smoke.controllers_phase(device="cpu", n_nodes=100,
                                       deployments=PODS, n_failed=5,
                                       step_timeout_s=150.0)
    assert out["nodes"] == 100 and out["pods"] == 200
    failed = sorted(out["tainted_nodes"])
    assert len(failed) == 5
    assert all("node.kubernetes.io/not-ready" in out["tainted_nodes"][n]
               for n in failed)
    assert out["pods_on_failed_nodes"] > 0
    assert out["manager"]["evictions"] >= out["pods_on_failed_nodes"]
    assert out["manager_exit_code"] == 0
    fleet = out["fleet"]
    assert fleet["running_pods"] == 0 and fleet["fleet"]["nodes"] == 95
    for kind in ("heartbeat", "lease", "status"):
        assert out["fleet_flushes"][kind]["flushes"] > 0
        assert out["fleet_flushes"][kind]["errors"] == 0
    assert out["launches"] == {"count_pn": 0}
