"""``chip_smoke.py``'s ``chaos`` phase gates (ChaosChurnQueued), on the CPU.

- ``chaos_unreached`` names the fault classes whose op the run did not
  reach at their site; ``chaos_unfired`` the classes whose op it reached
  and that did not fire. Only the second fails the phase.
- ``chaos_failures`` passes a clean run and fails on each gate alone: a
  lost pod (measured or of a recovery wave), a reached class that did not
  fire, an unrecovered site, a breaker not back at ``single`` after a
  restore, no drain on the card after the restore, a violation, a
  divergence, a loop that died.
"""

from __future__ import annotations

import copy

import pytest

import chip_smoke
from kubernetes_tpu_torch.chaos import Fault, FaultSchedule

FAULTS = [Fault("api.bind", "error", 3, 2, 503),
          Fault("api.bind", "conflict", 9, 1),
          Fault("device.drain", "runtime", 1, 2),
          Fault("watch.nodes", "drop", 1, 1, 9)]


def _schedule(ops: dict) -> FaultSchedule:
    """A schedule whose sites ran ``ops`` operations each, through the
    injection side, every fire followed by a healthy op."""
    schedule = FaultSchedule(copy.deepcopy(FAULTS), seed=5)
    for site, n in ops.items():
        for _ in range(n):
            if schedule.should_fire(site) is None:
                schedule.note_ok(site)
    return schedule


class _Unfired:
    """A schedule in which api.bind's counter passed op 3 with no fire (a
    seam that counted its op without consulting the schedule)."""

    faults = FAULTS

    def peek(self, site):
        return {"api.bind": 5, "device.drain": 4}.get(site, 0)

    def report(self):
        return {"classes": {"device.drain:runtime": {"fires": 2}},
                "unrecovered_sites": []}


def test_unreached_and_unfired_split_by_the_op_reached():
    s = _schedule({"api.bind": 6, "device.drain": 4, "watch.nodes": 1})
    assert chip_smoke.chaos_unreached(s) == ["api.bind:conflict",
                                             "watch.nodes:drop"]
    assert chip_smoke.chaos_unfired(s) == []
    assert chip_smoke.chaos_unfired(_Unfired()) == ["api.bind:error"]


def test_every_class_reached_fires():
    s = _schedule({"api.bind": 12, "device.drain": 4, "watch.nodes": 3})
    assert chip_smoke.chaos_unreached(s) == []
    assert chip_smoke.chaos_unfired(s) == []
    assert s.report()["unrecovered_sites"] == []


def _summary(schedule) -> dict:
    wave = {"pods": 513, "bound": 513, "restores_before": 1, "drains": 2,
            "drain_failures": 0, "launches": {"count_pn": 32}}
    return {"pods": 2000, "bound": 2000,
            "audit": {"violations": 0, "byInvariant": {}},
            "sentinel": {"divergences": 0},
            "chaos": {"waves": [dict(wave, drains=1, drain_failures=1),
                                wave],
                      "recovery": schedule.report(),
                      "breaker": {"mode": "single", "trips": 1,
                                  "restores": 1},
                      "stages": {"restored": True, "drained": True,
                                 "recovered": True},
                      "loop_error": None}}


def test_clean_run_passes():
    s = _schedule({"api.bind": 6, "device.drain": 4})
    assert chip_smoke.chaos_failures(_summary(s), s) == []


@pytest.mark.parametrize("edit,words", [
    (lambda d: d.update(bound=1999), "lost pods: 1 measured"),
    (lambda d: d["chaos"]["waves"][-1].update(bound=512),
     "1 of the recovery waves"),
    (lambda d: d["chaos"]["recovery"].update(unrecovered_sites=["api.bind"]),
     "unrecovered sites"),
    (lambda d: d["chaos"]["breaker"].update(mode="oracle"), "want single"),
    (lambda d: d["chaos"]["breaker"].update(restores=0), "want single"),
    (lambda d: d["chaos"]["stages"].update(drained=False),
     "no drain on the card"),
    (lambda d: d["chaos"]["waves"][-1].update(drain_failures=1),
     "no drain on the card"),
    (lambda d: d["chaos"]["waves"][-1].update(launches={"count_pn": 0}),
     "no drain on the card"),
    (lambda d: d["chaos"].update(waves=[]), "no drain on the card"),
    (lambda d: d["audit"].update(violations=1), "invariant violations"),
    (lambda d: d["sentinel"].update(divergences=1), "sentinel divergences"),
    (lambda d: d["chaos"].update(loop_error="KernelError()"),
     "the loop died"),
])
def test_each_gate_fails_alone(edit, words):
    s = _schedule({"api.bind": 6, "device.drain": 4})
    summary = _summary(s)
    edit(summary)
    out = chip_smoke.chaos_failures(summary, s)
    assert len(out) == 1 and words in out[0], out


def test_a_reached_class_that_did_not_fire_fails():
    s = _Unfired()
    out = chip_smoke.chaos_failures(_summary(s), s)
    assert len(out) == 1 and "api.bind:error" in out[0], out


@pytest.fixture()
def cpu_card(monkeypatch):
    """The card's helpers the phase calls, on the CPU: no synchronize, no
    graph pool, no ``count_pn`` launch to count (its plain version runs
    there); the phase's own gate list is returned, not raised."""
    import torch
    from kubernetes_tpu_torch.models import graphs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(graphs, "pool_bytes", lambda *a, **k: 0)
    check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda cond, msg: (
        None if "never launched" in msg or msg.startswith("chaos.churn: [")
        else check(cond, msg)))


def test_churn_runs_on_the_cpu(cpu_card):
    """ChaosChurnQueued at 200 pods on 100 nodes: every pod bound under
    the faults, the breaker tripped once and restored, the recovery waves
    ran until a drain passed the burst, and the one gate left is the
    launch of count_pn, which the CPU does not count."""
    out = chip_smoke.chaos_churn(device="cpu", pods=200, nodes=100)
    assert out["cell"] == chip_smoke.CHAOS_CELL
    assert out["bound"] == 200 and out["oracle_pods"] == 0
    assert out["breaker_state"]["mode"] == "single"
    assert out["breaker_state"]["restores"] >= 1
    assert out["stages"] == {**out["stages"], "restored": True,
                             "drained": True, "recovered": True}
    last = out["waves"][-1]
    assert last["drains"] >= 1 and last["drain_failures"] == 0
    assert last["bound"] == last["pods"]
    assert out["recovery"]["unrecovered_sites"] == []
    assert set(out["unreached"]).isdisjoint(out["recovery"]["classes"])
    assert len(out["failures"]) == 1, out["failures"]
    assert "'launches': {'count_pn': 0}" in out["failures"][0]
