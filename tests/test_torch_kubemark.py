"""The port's kubemark (``kubernetes_tpu_torch/kubelet/kubemark.py``)
against the JAX package's, on the CPU.

Every case of ``tests/test_bulk_fanin.py`` (17 tests, 20 cases: the bulk heartbeat, lease and
status endpoints, the sharded batchers, their healing and backoff, a
HollowCluster's fan-in, the node lifecycle controller over batched
leases, the runner's liveness-only skip) and the hollow-fleet smoke of
``tests/test_kubemark.py`` runs on both packages through
``tests/torch_store_parity.py``: both pass, and their records are equal.
A fleet's batchers flush on timers of their own, in an order that is
chance, so these modules are ``RECONCILED``: their records compare the
converged stores, resourceVersions and stamps masked.

Left out: ``test_kubemark.py``'s ``slow`` fleet case, which drives the JAX
package's own harness (``benchmarks/kubemark.py``) on either package; the
port's fleet runs beside its runner in ``chip_smoke.controllers_phase``
(``tests/test_torch_controllers_phase.py`` rehearses it here).
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity

NAMES = ("test_bulk_fanin", "test_kubemark")
# runs ``benchmarks/kubemark.py``, which imports the JAX package
NOT_PORTED = ("test_kubemark_fleet_with_connected_scheduler",)
CASES = [(name, *c) for name in NAMES for c in parity.cases(name)
         if c[1] not in NOT_PORTED]


def _id(case) -> str:
    # a parametrized case's values are lambdas: number them instead
    name, cid, fname, params = case
    same = [c for c in CASES if c[2] == fname]
    return f"{name}::{fname}" + (f"[{same.index(case)}]" if params else "")


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("name,fname,params", [c[:1] + c[2:] for c in CASES],
                         ids=[_id(c) for c in CASES])
def test_reference_case_on_both_packages(name, fname, params, tmp_path,
                                         shared):
    ref, port = parity.both(name, fname, params, tmp_path, shared)
    assert port == ref


def test_kubemark_cases_are_selected():
    assert [sum(c[0] == n for c in CASES) for n in NAMES] == [20, 1]
