"""The port's storage, identity and certificate controllers against the
JAX package's, on the CPU.

Every case of ``tests/test_attachdetach_nodeipam.py`` (attach/detach,
node IPAM, ephemeral volumes, the service load balancer, routes),
``tests/test_protection_csr.py`` (PVC and PV protection, CSR approving and
cleaning) and ``tests/test_certificates.py`` (CSR signing and ``ktpu
certificate approve``) runs on both packages through
``tests/torch_store_parity.py``: both pass, and their records (the stores
and the requests, key material masked) are equal. The certificate cases
skip, as the reference's do, where ``cryptography`` is not installed.
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity
from kubernetes_tpu_torch.controllers.certificates import HAVE_CRYPTOGRAPHY

NAMES = ("test_attachdetach_nodeipam", "test_protection_csr",
         "test_certificates")
CASES = [(name, *c) for name in NAMES for c in parity.cases(name)]
# the reference's module-level mark: X.509 issuance needs cryptography
NEEDS_X509 = pytest.mark.skipif(
    not HAVE_CRYPTOGRAPHY, reason="optional dependency 'cryptography' "
    "not installed (signer disabled)")


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize(
    "name,fname,params",
    [pytest.param(*(c[:1] + c[2:]), marks=[NEEDS_X509]
                  if c[0] == "test_certificates" else [])
     for c in CASES],
    ids=[f"{c[0]}::{c[1]}" for c in CASES])
def test_reference_case_on_both_packages(name, fname, params, tmp_path,
                                         shared):
    ref, port = parity.both(name, fname, params, tmp_path, shared)
    assert port == ref


def test_storage_cases_are_selected():
    assert [sum(c[0] == n for c in CASES) for n in NAMES] == [10, 5, 5]
