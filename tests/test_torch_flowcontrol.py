"""API Priority and Fairness in the port (``store/flowcontrol.py``) against
the JAX package's, on the CPU.

- Every APF case of ``tests/test_admission_apf.py`` (classification,
  overflow, queueing, the 429 over HTTP, ``shuffle_shard``, the greedy and
  polite flows, the queueset's 429) runs on both packages through
  ``tests/torch_store_parity.py``: both pass, and their records (requests
  and answers, the servers' stores and flow stats) are equal.
- ``shuffle_shard``'s hands on a seeded grid of flows, deck and hand sizes,
  and ``classify`` on a seeded grid of verbs, paths and agents under the
  default schemas: equal, tolerance 0.
- One seeded, single-threaded sequence of acquires and releases over a
  level with a few queues: the same grants, the same 429s, the same stats.
- The port's dispatch count by level and flow (``dispatched_by_flow``, an
  addition of the port the scheduler's gate reads): requests given a seat,
  exempt ones included, a rejected one not.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch_store_parity as parity
from kubernetes_tpu.store import flowcontrol as ref_fc
from kubernetes_tpu_torch.store import flowcontrol as port_fc

NAME = "test_admission_apf"
APF = ("test_flow_", "test_apf_", "test_shuffle_", "test_greedy_",
       "test_queueset_")
CASES = [c for c in parity.cases(NAME) if c[1].startswith(APF)]


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def test_apf_cases_are_selected():
    assert len(CASES) == 7


def test_shuffle_shard_hands_equal():
    rng = np.random.RandomState(0)
    for _ in range(300):
        flow = f"flow-{rng.randint(10_000)}"
        n = int(rng.choice([1, 4, 16, 64, 128]))
        hand = int(rng.randint(1, 12))
        salt = str(rng.choice(["", "global-default", "system"]))
        assert (port_fc.shuffle_shard(flow, n, hand, salt)
                == ref_fc.shuffle_shard(flow, n, hand, salt))


def test_classification_equal():
    rng = np.random.RandomState(1)
    verbs = ["get", "list", "watch", "create", "update", "delete", "patch"]
    paths = ["/healthz", "/readyz", "/metrics", "/api/v1/pods",
             "/api/v1/namespaces/default/pods/p/binding",
             "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases",
             "/apis/apps/v1/deployments", "/api/v1/nodes/n1/status"]
    agents = ["", "kube-scheduler", "kubelet/hollow", "kube-controller-manager",
              "ktpu", "curl/8"]
    ref, port = ref_fc.FlowController(), port_fc.FlowController()
    for _ in range(200):
        v, p, a = (str(rng.choice(verbs)), str(rng.choice(paths)),
                   str(rng.choice(agents)))
        assert port.classify(v, p, a).name == ref.classify(v, p, a).name


def _sequence(fc_mod, seed: int) -> list:
    """Seeded acquires (timeout 0: a queued request withdraws at once) and
    releases over one level -> what each step did, and the stats."""
    level = fc_mod.PriorityLevel("t", concurrency=2, queue_length=2,
                                 n_queues=4, hand_size=2)
    fc = fc_mod.FlowController(levels=[level, fc_mod.PriorityLevel(
        "global-default", concurrency=1)])
    rng = np.random.RandomState(seed)
    held, out = 0, []
    for _ in range(60):
        if held and rng.rand() < 0.4:
            fc.release(level)
            held -= 1
            out.append(("release", fc.stats()))
            continue
        flow = f"f{rng.randint(5)}"
        try:
            fc.acquire(level, timeout=0.0, flow=flow)
            held += 1
            out.append(("granted", flow))
        except fc_mod.RejectedError as e:
            out.append(("rejected", flow, e.retry_after))
    out.append(("end", fc.stats(), fc.rejected_total))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_admission_sequence_equal(seed):
    assert _sequence(port_fc, seed) == _sequence(ref_fc, seed)


def test_dispatched_by_flow_counts_seats():
    level = port_fc.PriorityLevel("t", concurrency=1, queue_length=0)
    fc = port_fc.FlowController()
    fc.levels["t"] = level
    exempt = fc.classify("get", "/healthz")
    fc.acquire(exempt, flow="probe")
    fc.acquire(level, flow="a")
    with pytest.raises(port_fc.RejectedError):
        fc.acquire(level, flow="b")  # seat taken, no queue
    fc.release(level)
    fc.acquire(level, flow="b")
    fc.release(level)
    assert fc.dispatched_by_flow() == {"exempt": {"probe": 1},
                                       "t": {"a": 1, "b": 1}}
    assert fc.rejected_total == 1
