"""``ktpu`` against a hollow kubelet: every case of
``tests/test_kubectl_breadth.py`` on both packages, on the CPU.

The pod ``log``, ``exec`` and ``portforward`` subresources through the
apiserver to a served ``HollowNode``, ``attach``, the kubelet's metrics
endpoint, static pods and their mirrors, rollout, traces, ``top``,
labels, ``wait`` and the scale subresource run through
``tests/torch_store_parity.py``: both pass, and their records (the
requests the case made, the stores once quiet) are equal. The kubelet
heartbeats on a thread of its own, so the module is ``RECONCILED``.
"""

from __future__ import annotations

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
