"""``chip_smoke.py``'s ``explainab`` phase (ROADMAP Queue A item 5b), on
the CPU.

- ``explainab_failures``, the phase's gates, is the reference's failures
  list (``benchmarks/connected.py:552-561``) without its throughput floor:
  a leg that ran without the explainer, or with the flight recorder off,
  fails; an off leg that ran with either (an invalid A/B) fails; a missing
  ratio fails; a leg with an unbound pod, a violation, a divergence, a
  loop error, a ``device_explain`` error or an oracle pod fails. A ratio
  below the reference's 0.95 does not: it is a ratio of two host-time
  windows, reported only.
- The phase runs whole on the CPU at a small size (200 pods on 100 nodes):
  both legs bind every pod under the churn loop, the off leg without the
  explainer and the flight recorder, the on leg with both; the flight
  recorder's setting is restored. ``count_pn`` has no launch on the CPU
  (its plain version runs there), so that one check is left to the card.
"""

from __future__ import annotations

import copy

import pytest
import torch

import chip_smoke


def _leg(on: bool) -> dict:
    return {"pods": 2000, "bound": 2000, "explainer_constructed": on,
            "flight_enabled": on, "audit": {"violations": 0},
            "sentinel": {"divergences": 0}, "loop_errors": 0,
            "device_explain_errors": 0, "oracle_pods": 0}


def _result(ratio=0.97) -> dict:
    return {"legs": {"off": _leg(False), "on": _leg(True)},
            "throughput_on": 97.0, "throughput_off": 100.0,
            "throughput_ratio": ratio}


def test_clean_ab_passes():
    assert chip_smoke.explainab_failures(_result()) == []


@pytest.mark.parametrize("ratio", [0.5, 0.94, 1.3])
def test_ratio_is_reported_not_gated(ratio):
    assert chip_smoke.explainab_failures(_result(ratio)) == []


def test_missing_ratio_fails():
    out = chip_smoke.explainab_failures(_result(None))
    assert len(out) == 1 and "ratio unavailable" in out[0]


@pytest.mark.parametrize("leg,key,value,words", [
    ("on", "explainer_constructed", False, "without the explainer"),
    ("on", "flight_enabled", False, "flight recorder disabled"),
    ("off", "explainer_constructed", True, "A/B invalid"),
    ("off", "flight_enabled", True, "A/B invalid"),
    ("on", "bound", 1999, "1999 of 2000"),
    ("off", "loop_errors", 2, "loop errors 2"),
    ("on", "device_explain_errors", 1, "device_explain errors 1"),
    ("off", "oracle_pods", 3, "oracle pods 3"),
])
def test_each_gate_fails(leg, key, value, words):
    result = _result()
    result["legs"][leg][key] = value
    out = chip_smoke.explainab_failures(result)
    assert len(out) == 1 and words in out[0], out


@pytest.mark.parametrize("leg,path", [("on", ("audit", "violations")),
                                      ("off", ("sentinel", "divergences"))])
def test_violations_and_divergences_fail(leg, path):
    result = copy.deepcopy(_result())
    result["legs"][leg][path[0]][path[1]] = 1
    assert len(chip_smoke.explainab_failures(result)) == 1


def test_missing_leg_fails():
    result = _result()
    del result["legs"]["on"]
    assert chip_smoke.explainab_failures(result)


@pytest.fixture()
def cpu_card(monkeypatch):
    """The card's helpers the phases call, on the CPU: no synchronize, no
    graph pool, and no ``count_pn`` launch to count."""
    from kubernetes_tpu_torch.models import graphs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(graphs, "pool_bytes", lambda *a, **k: 0)
    check = chip_smoke.check
    monkeypatch.setattr(chip_smoke, "check", lambda cond, msg: (
        None if "never launched" in msg else check(cond, msg)))


def test_phase_runs_on_the_cpu(cpu_card):
    from kubernetes_tpu_torch.utils.tracing import FLIGHT
    flight0 = FLIGHT.enabled
    out = chip_smoke.explainab_phase(device="cpu", pods=200, nodes=100)
    assert out["failures"] == []
    assert FLIGHT.enabled == flight0
    on, off = out["legs"]["on"], out["legs"]["off"]
    assert on["bound"] == off["bound"] == 200
    assert on["explainer_constructed"] and not off["explainer_constructed"]
    assert on["flight_enabled"] and not off["flight_enabled"]
    assert on["churn"]["ops"] >= chip_smoke.CHURN_MIN_OPS
    assert isinstance(out["throughput_ratio"], float)
