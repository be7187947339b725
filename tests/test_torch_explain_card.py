"""The port's explainer and extenders on the CUDA card against the CPU.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_explain_card.py``).
Every test needs the card and skips without one:

- ``explain_step``'s verdicts and ``valid`` bit-equal on the card and the
  CPU on ``chip_smoke.explain_parity_phase``'s three small clusters, and on
  a 1024-node MixedHeterogeneous cluster (its soft spread reaches
  ``count_pn`` on the card);
- the explainer thread on the card judges in mode ``tensor`` and gives
  the CPU's explanation;
- the Scheduler with an HTTP extender places the same pods on the card
  and the CPU (``chip_smoke.extender_parity_phase``), and
  ``TPUExtenderServer`` on the card answers as on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import chip_smoke


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_explain_parity_phase_on_card():
    _card()
    out = chip_smoke.explain_parity_phase(devices=("cuda", "cpu"))
    assert set(out) == {"relational_mix", "constraint_mix", "saturated"}


@pytest.mark.gpu
def test_explain_step_reaches_count_pn_on_card():
    _card()
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.ops import kernels
    node_dicts, bound, batches = chip_smoke.workload(
        n_nodes=1024, n_bound=512, n_requests=1, batch=64)
    ct, pb, meta, _ = chip_smoke._explain_encode(
        [Node.from_dict(d) for d in node_dicts],
        [Pod.from_dict(d) for d in bound],
        [Pod.from_dict(d) for d in batches[0]])
    kernels.reset_launches()
    card = chip_smoke._explain_verdicts(ct, pb, meta, "cuda")
    assert kernels.LAUNCHES["count_pn"] >= 1
    cpu = chip_smoke._explain_verdicts(ct, pb, meta, "cpu")
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_explainer_thread_on_card():
    _card()
    from kubernetes_tpu_torch.config.types import SchedulerConfiguration
    from kubernetes_tpu_torch.sched.cache import SchedulerCache
    from kubernetes_tpu_torch.sched.explainer import SchedulingExplainer
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
    got = {}
    for device in ("cuda", "cpu"):
        cache = SchedulerCache()
        for i in range(3):
            # n0 too small, n1 and n2 big enough but tainted
            w = make_node(f"n{i}").capacity({"cpu": "2" if i else "1",
                                             "pods": "10"})
            if i:
                w.taint("dedicated", "ml", "NoSchedule")
            cache.add_node(w.obj())
        cfg = SchedulerConfiguration()
        ex = SchedulingExplainer(cfg, lambda: None, device=device)
        pod = make_pod("p0").req({"cpu": "1500m"}).obj()
        assert ex.submit(cache, cfg.profiles[0], "single", [pod])
        ex.drain()
        ex.close()
        exp = dict(ex.explain_of(pod.key))
        exp.pop("ts")
        got[device] = exp
    assert got["cuda"] == got["cpu"]
    assert got["cuda"]["mode"] == "tensor"
    assert got["cuda"]["filters"] == {"TaintToleration": 2,
                                      "NodeResourcesFit": 1}


@pytest.mark.gpu
def test_extender_parity_phase_on_card():
    _card()
    out = chip_smoke.extender_parity_phase(devices=("cuda", "cpu"))
    assert out["placed"] == out["pods"]


@pytest.mark.gpu
def test_extender_server_on_card_equals_cpu():
    _card()
    from kubernetes_tpu_torch.api.types import Node
    from kubernetes_tpu_torch.sched.extender_server import TPUExtenderServer
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    nodes, pods = mixed_heterogeneous(pods=4, nodes=256, seed=1)
    servers = [TPUExtenderServer(device=d).start() for d in ("cuda", "cpu")]
    try:
        for s in servers:
            s.set_cluster([Node.from_dict(n.to_dict()) for n in nodes], [])
        for p in pods:
            payload = {"pod": p.to_dict(),
                       "nodenames": [n.metadata.name for n in nodes]}
            f = [chip_smoke._post_json(f"{s.url}/filter", payload)[0]
                 for s in servers]
            assert f[0] == f[1] and "error" not in f[0]
            pr = [chip_smoke._post_json(f"{s.url}/prioritize", payload)[0]
                  for s in servers]
            assert [h["host"] for h in pr[0]] == [h["host"] for h in pr[1]]
            # the 0..10 scores within 1: a float32 score at a rounding
            # step may round either way on the two devices
            assert max(abs(a["score"] - b["score"])
                       for a, b in zip(*pr)) <= 1, json.dumps(pr)[:200]
    finally:
        for s in servers:
            s.stop()
