"""The port's kube-proxy against the JAX package's, on the CPU.

Every case of ``tests/test_proxy.py`` (11) runs on both packages through
``tests/torch_store_parity.py``: both pass, and their records (the store
of the case's ``DirectClient`` where it is a fixture) are equal. Then the
three renderers (iptables-restore, nft, ipvsadm-restore) of each package
write the same text for the same Services and Endpoints, and their
parsed decision tables agree.
"""

from __future__ import annotations

import pytest

import torch_store_parity as parity

NAME = "test_proxy"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def test_proxy_cases_are_selected():
    assert len(CASES) == 11


def _objects():
    """Services (one with ClientIP affinity and a nodePort, one headless,
    one without endpoints) and their Endpoints."""
    svcs = [{"kind": "Service", "metadata": {"name": f"s{i}"},
             "spec": {"clusterIP": f"10.96.3.{i}",
                      "ports": [{"port": 80 + i, "protocol": "TCP"}]}}
            for i in range(4)]
    svcs[1]["spec"]["sessionAffinity"] = "ClientIP"
    svcs[2]["spec"]["ports"][0]["nodePort"] = 30082
    svcs.append({"kind": "Service", "metadata": {"name": "headless"},
                 "spec": {"clusterIP": "None", "ports": [{"port": 53}]}})
    eps = [{"kind": "Endpoints", "metadata": {"name": f"s{i}"},
            "subsets": [{"addresses": [{"ip": f"10.88.3.{10 * i + j}"}
                                       for j in range(i)],
                         "ports": [{"port": 9000 + i}]}]}
           for i in range(4)]
    return svcs, eps


def _renders(pkg: str) -> dict:
    import importlib
    cs = importlib.import_module(f"{pkg}.client.clientset")
    store = importlib.import_module(f"{pkg}.store.store")
    proxier = importlib.import_module(f"{pkg}.proxy.proxier")
    nft = importlib.import_module(f"{pkg}.proxy.nftables")
    ipvs = importlib.import_module(f"{pkg}.proxy.ipvs")
    svcs, eps = _objects()
    out = {}
    for name, cls, render, parse in (
            ("iptables", proxier.Proxier, "sync_proxy_rules_text",
             proxier.RestoredRules),
            ("nftables", nft.NftablesProxier, "sync_nft_text",
             nft.RestoredNftRules),
            ("ipvs", ipvs.IpvsProxier, "sync_ipvs_text",
             ipvs.RestoredIpvsRules)):
        client = cs.DirectClient(store.ObjectStore())
        for s in svcs:
            client.resource("services", "default").create(s)
        for e in eps:
            client.resource("endpoints", "default").create(e)
        p = cls(client).start()
        try:
            text = getattr(p, render)()
        finally:
            p.stop()
        table = parse(text)
        out[name] = (text, {i: sorted(table.backends(f"10.96.3.{i}", 80 + i))
                            for i in range(4)})
    return out


def test_renders_equal_reference_and_backends_agree():
    ref, port = (_renders(pkg) for pkg in parity.PACKAGES)
    assert port == ref
    tables = [t for _text, t in port.values()]
    assert tables[0] == tables[1] == tables[2]
    assert tables[0][0] == [] and len(tables[0][3]) == 3
