"""``ktpu`` against a hollow kubelet: every case of
``tests/test_kubectl_breadth.py`` on both packages, on the CPU.

The pod ``log``, ``exec`` and ``portforward`` subresources through the
apiserver to a served ``HollowNode``, ``attach``, the kubelet's metrics
endpoint, static pods and their mirrors, rollout, traces, ``top``,
labels, ``wait`` and the scale subresource run through
``tests/torch_store_parity.py``: both pass, and their records (the
requests the case made, the stores once quiet) are equal. The kubelet
heartbeats on a thread of its own, so the module is ``RECONCILED``, and
its first heartbeat tick creates the node's Lease 2 s after it started
on either package, so whether a store holds that Lease is how long the
case ran: the records drop it (``LEASE_BY_CHANCE``, C14).
"""

from __future__ import annotations

import time

import pytest

import torch_store_parity as parity

NAME = "test_kubectl_breadth"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def test_kubectl_breadth_cases_are_selected():
    assert len(CASES) == 13


def test_a_case_past_the_first_heartbeat_tick_keeps_an_equal_record(
        tmp_path, shared, monkeypatch):
    """C14: the traces case failed a loaded run and passed alone. Its port
    leg, made to outlast the kubelet's first heartbeat tick (as a loaded
    host's exports of a worker's full tracer ring did), stores the node's
    Lease where the reference's quick leg does not; the records, which
    drop that Lease, stay equal."""
    from kubernetes_tpu_torch.utils import tracing
    dump = tracing.dump_stacks
    monkeypatch.setattr(tracing, "dump_stacks",
                        lambda: time.sleep(2.5) or dump())
    held = []
    kept = parity._kept

    def watch(obj):
        if obj.get("kind") == "Lease":
            held.append(parity._LEASE_CHANCE.is_set())
        return kept(obj)

    monkeypatch.setattr(parity, "_kept", watch)
    ref, port = parity.both(NAME, "test_debug_traces_and_stacks", {},
                            tmp_path, shared)
    assert held and all(held)
    assert port == ref
