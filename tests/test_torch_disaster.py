"""The port's apiserver kill/restart harness (``chaos/apiserver.py``)
against the JAX package's, on the CPU.

Every case of ``tests/test_disaster.py`` runs on both packages through
``tests/torch_store_parity.py``: both pass, and their records are equal.
They cover the readiness gate while the WAL replays, the HTTP client's
capped retries through a dead window, 410/TooOld and the informers'
relist across a restart, a connected scheduler riding the restart, the
node lifecycle controller's disruption modes, and ``ktpu status``'s
Durability and Disruption lines.
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity

NAME = "test_disaster"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def test_disaster_cases_are_selected():
    assert len(CASES) == 12
