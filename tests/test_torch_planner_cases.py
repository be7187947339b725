"""The reference's autoscaler and descheduler cases that the port's other
tests do not hold, on both packages, on the CPU.

Each runs through ``tests/torch_store_parity.py``: both pass, and their
records are equal. ``test_autoscaler`` is ``RECONCILED`` and ``POLLED``
there (its HPA case runs a controller on a thread of its own); the
port's ``Descheduler`` and its planning functions are bound to the CPU
(``ON_CPU``), and the port's ``ktpu`` defaults to ``--device cpu`` for
``deschedule run``. The rest of the two files' cases are held by
``tests/test_torch_autoscaler.py``, ``tests/test_torch_descheduler.py``,
``tests/test_torch_kubelet.py`` and ``tests/test_torch_cli.py``.
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity

SELECTED = {
    "test_autoscaler": (
        "test_hpa_stabilization_with_fake_clock", "test_load_node_group_yaml",
        "test_queue_unschedulable_pods_snapshot",
        "test_scale_down_pdb_blocks_eviction",
        "test_scale_down_pdb_budget_charges_across_evictions",
        "test_cache_exports_generation_and_full_encode_gauges",
        "test_ktpu_autoscale_status"),
    "test_descheduler": (
        "test_configuration_from_yaml", "test_pdb_blocks_eviction",
        "test_pdb_budget_charges_across_sets",
        "test_gang_that_fits_needs_no_evictions",
        "test_gang_defrag_respects_eviction_budget",
        "test_gang_consolidation_skips_protected_nodes",
        "test_gang_consolidation_never_evicts_placed_gang_members",
        "test_ktpu_deschedule_run_and_status"),
}
CASES = [(name, cid, fname, params) for name, fnames in SELECTED.items()
         for cid, fname, params in parity.cases(name) if fname in fnames]


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.fixture()
def ktpu_on_cpu(monkeypatch):
    """The port's ``ktpu`` with ``--device cpu`` as its default."""
    from kubernetes_tpu_torch.cli import ktpu
    build = ktpu.build_parser

    def build_parser():
        ap = build()
        ap.set_defaults(device="cpu")
        return ap

    monkeypatch.setattr(ktpu, "build_parser", build_parser)


@pytest.mark.parametrize("name,fname,params", [(c[0], *c[2:]) for c in CASES],
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_reference_case_on_both_packages(name, fname, params, tmp_path,
                                         shared, ktpu_on_cpu):
    ref, port = parity.both(name, fname, params, tmp_path, shared)
    assert port == ref


def test_planner_cases_are_selected():
    assert sorted(c[2] for c in CASES) == sorted(
        f for fnames in SELECTED.values() for f in fnames)
