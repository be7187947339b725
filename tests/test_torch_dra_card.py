"""DRA device claims on the CUDA card against the CPU.

This file imports no JAX, so the card's machine runs it
(``python -m pytest --noconftest -m gpu tests/test_torch_dra_card.py``).
Every test needs the card and skips without one:

- ``chip_smoke.dra_parity_phase`` on ``cuda`` and ``cpu``: gang_drain over
  the claim workload (``testing/workloads.dra_mix``) bit-equal, the
  Scheduler's drain path with its churn equal (binder logs, ctx_stats,
  the folded context with its ``dra:`` column), serial rounds on each
  device equal to the oracle's placements;
- the filter masks of the claim workload (device nodes, devices in use,
  the allocated pin, the unready claim) on the card equal the CPU's.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import chip_smoke
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
from kubernetes_tpu_torch.models.schedule_step import evaluate
from kubernetes_tpu_torch.sched.dra import DraCatalog
from kubernetes_tpu_torch.testing import workloads


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_dra_parity_on_card_equals_cpu_and_oracle():
    _card()
    out = chip_smoke.dra_parity_phase(devices=("cuda", "cpu"))
    assert out["scheduler"]["placed"] >= 100
    assert out["serial"]["legs"] == ["oracle", "serial_cpu", "serial_cuda"]
    assert "dra:" + workloads.DRA_CLASS in out["gang_drain"]["resources"]


@pytest.mark.gpu
def test_claim_masks_on_card_equal_cpu():
    _card()
    w = workloads.dra_mix(nodes=32, pods=96, seed=5)
    enc = SnapshotEncoder()
    enc.set_dra(DraCatalog.from_lists(copy.deepcopy(w["claims"]),
                                      copy.deepcopy(w["classes"]),
                                      copy.deepcopy(w["slices"])))
    pending = [Pod.from_dict(copy.deepcopy(d)) for d in w["pending"]]
    ct, meta = enc.encode_cluster(
        [Node.from_dict(copy.deepcopy(d)) for d in w["nodes"]],
        [Pod.from_dict(copy.deepcopy(d)) for d in w["bound"]],
        pending_pods=pending)
    pb = enc.encode_pods(pending, meta)
    got = {d: evaluate(ct.to(d), pb.to(d), topo_keys=meta.topo_keys)
           .feasible.cpu().numpy() for d in ("cuda", "cpu")}
    np.testing.assert_array_equal(got["cuda"], got["cpu"])
    names = [p.metadata.name for p in pending]
    # the unready pod fits nowhere; the pinned one only on its claim's node
    assert not got["cuda"][names.index("unready")].any()
    assert got["cuda"][names.index("pinned")].sum() <= 1
