"""The port's scenario time machine (``kubernetes_tpu_torch/scenario/``)
against the JAX package's, on the CPU.

Every case of ``tests/test_scenario.py`` runs on both packages through
``tests/torch_store_parity.py``: both pass, and their records are equal.
They cover the trace format (canonical bytes, refusals), the six builtin
generators (each pure in its seed), the committed golden fixture, the WAL
and audit-bundle recorders, and the driver: replays through an apiserver
and a connected scheduler, its time warp, its error counting and the
``ktpu status`` Scenario line. Besides, each builtin's bytes are the
reference's.
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity
from kubernetes_tpu.scenario import generate as ref_generate
from kubernetes_tpu_torch.scenario import generate

NAME = "test_scenario"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def test_scenario_cases_are_selected():
    assert len(CASES) == 26


@pytest.mark.parametrize("name", sorted(ref_generate.BUILTINS))
def test_builtin_bytes_are_the_references(name):
    for seed in (0, 3):
        assert (generate.builtin_trace(name, seed=seed).to_lines()
                == ref_generate.builtin_trace(name, seed=seed).to_lines())
