"""The port's container runtime seam, device, memory and topology managers,
CNI and CSI (``kubernetes_tpu_torch/kubelet/``) against the JAX package's,
on the CPU.

Every case of ``tests/test_cri_managers.py`` (CRI over gRPC, the kubelet
over a remote runtime, the Device, Memory and Topology managers) and
``tests/test_cni_csi.py`` (a CNI plugin by exec, CSI over gRPC, the volume
manager driving it) runs on both packages through
``tests/torch_store_parity.py``: both pass, and their records are equal.
The port imports msgpack and grpc where it packs a message or serves,
so its ``cri`` and ``csi`` modules import without them
(``tests/test_torch_imports.py``); these cases need both, as the
reference's do.
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity

NAMES = ("test_cri_managers", "test_cni_csi")
CASES = [(name, *c) for name in NAMES for c in parity.cases(name)]


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("name,fname,params", [c[:1] + c[2:] for c in CASES],
                         ids=[f"{c[0]}::{c[1]}" for c in CASES])
def test_reference_case_on_both_packages(name, fname, params, tmp_path,
                                         shared):
    ref, port = parity.both(name, fname, params, tmp_path, shared)
    assert port == ref


def test_runtime_cases_are_selected():
    assert [sum(c[0] == n for c in CASES) for n in NAMES] == [11, 6]
