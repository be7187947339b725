"""The port's kubelet (``kubernetes_tpu_torch/kubelet/``) against the JAX
package's, on the CPU.

Every case of ``tests/test_kubelet.py`` (the fake runtime, PLEG, pod
workers, a kubelet running bound pods, heartbeats, restarts, a whole
cluster from Deployment and Job to Running) and
``tests/test_kubelet_managers.py`` (probes, QoS, admission, the CPU and
volume managers), the kubelet cases of ``tests/test_connected_pipeline.py``
(pod workers' retries, a static pod's mirror) and of
``tests/test_autoscaler.py`` (a hollow node's template taints, a gang
scaled up from zero on hollow kubelets and scaled down again) runs on both
packages through ``tests/torch_store_parity.py``: both pass, and their
records are equal.

Kubelets heartbeat and write pod status on threads of their own, so these
modules are ``RECONCILED``: their records compare the stores once they are
quiet, with resourceVersions and stamps masked. The autoscaler case polls
``ClusterAutoscaler.run_once`` until the runner has bound the gang, and
the static-pod case reads the mirror until the kubelet has recreated it:
what each poll reads depends on how far the other thread got, so those
modules are ``POLLED``, and their records keep the case's writes.
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity

NAMES = ("test_kubelet", "test_kubelet_managers")
# the kubelet's cases in modules that test more than the kubelet
PICKED = {
    "test_connected_pipeline": (
        "test_pod_workers_record_and_retry_sync_errors",
        "test_pod_workers_latest_update_wins_during_backoff",
        "test_static_pod_mirror_resync_survives_lost_delete_event"),
    "test_autoscaler": ("test_hollow_node_registers_template_taints",
                        "test_gang_scale_up_and_idle_scale_down_e2e"),
}
CASES = ([(name, *c) for name in NAMES for c in parity.cases(name)]
         + [(name, *c) for name, picked in PICKED.items()
            for c in parity.cases(name) if c[1] in picked])


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("name,fname,params", [c[:1] + c[2:] for c in CASES],
                         ids=[f"{c[0]}::{c[1]}" for c in CASES])
def test_reference_case_on_both_packages(name, fname, params, tmp_path,
                                         shared):
    ref, port = parity.both(name, fname, params, tmp_path, shared)
    assert port == ref


def test_kubelet_cases_are_selected():
    assert [sum(c[0] == n for c in CASES)
            for n in (*NAMES, *PICKED)] == [9, 9, 3, 2]
