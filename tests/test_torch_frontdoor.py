"""The front door in the port (``store/frontdoor.py`` and the apiserver's
read-replica plane) against the JAX package's, on the CPU.

- Every case of ``tests/test_frontdoor.py`` (replica reads with the lag
  header, the 421 and its leader hint, a spread client chasing the leader,
  one resourceVersion vocabulary across replicas, the lag-gated
  ``/readyz``, ``/frontdoor/status``, the published ConfigMap and ``ktpu
  status``'s line, a replica lost and a compacted one relisted) runs on
  both packages through ``tests/torch_store_parity.py``, each package over
  its own three-node cluster shared by the cases as the reference's module
  fixture is: both pass, and their records (requests and answers, the
  leader's store) are equal. Which node wins an election, the replay lags
  and the watch counts are chance, and masked. Before each GET, every
  replica has replayed what its leader holds: a replica's answer is then
  that of the leader, and its replay timing is not what is compared.
- What the port's ``/frontdoor/status`` adds, for the card's front-door
  gates: the reads each server served, the writes it answered 421, and on
  every node the writers' wait for their quorum.
- ``serve``: the cluster in a spawned process answers on every endpoint,
  with one leader, until told to stop.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import urllib.error
import urllib.request

import pytest

import torch_store_parity as parity
from kubernetes_tpu_torch.client.clientset import HTTPClient
from kubernetes_tpu_torch.store import frontdoor as port_frontdoor

NAME = "test_frontdoor"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def _status(url: str) -> dict:
    with urllib.request.urlopen(url + "/frontdoor/status",
                                timeout=10.0) as resp:
        return json.loads(resp.read())


def _post(url: str, obj: dict) -> int:
    req = urllib.request.Request(
        url + "/api/v1/namespaces/default/configmaps",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10.0) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_frontdoor_status_counts_reads_421s_and_commit_waits():
    fd = port_frontdoor.FrontDoorCluster(3).start()
    try:
        leader, replica = fd.leader_api.url, fd.replica_apis[0].url
        cm = {"kind": "ConfigMap", "metadata": {"name": "c"}}
        assert _post(leader, cm) == 201
        assert _post(replica, dict(cm, metadata={"name": "d"})) == 421
        HTTPClient(replica).resource("configmaps", "default").list()
        st = {url: _status(url) for url in fd.endpoints}
        assert st[replica]["notLeader"] == 1
        assert st[replica]["reads"] >= 1
        assert st[leader]["notLeader"] == 0
        assert st[leader]["commitWait"]["count"] >= 1
        assert all("commitWait" in s for s in st.values())
    finally:
        fd.stop()


def test_serve_runs_the_cluster_in_a_process():
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=port_frontdoor.serve, args=(child,),
                       daemon=True)
    proc.start()
    try:
        assert parent.poll(120.0)
        info = parent.recv()
        assert len(info["endpoints"]) == 3
        roles = sorted(_status(url)["role"] for url in info["endpoints"])
        assert roles == ["leader", "replica", "replica"]
        assert _status(info["leader"])["role"] == "leader"
    finally:
        parent.send("stop")
        proc.join(30.0)
    assert proc.exitcode == 0
