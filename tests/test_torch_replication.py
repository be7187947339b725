"""The replicated store in the port (``store/replication.py``) against the
JAX package's, on the CPU.

- Every case of ``tests/test_replication.py`` runs on both packages through
  ``tests/torch_store_parity.py``: both pass, and the contents of the
  furthest-ahead node's store are equal. Raft is compared by what it ends
  with, not by its timing: every wait is on a condition, with the
  reference's bounds.
- Two deliberate differences (ROADMAP "Deliberate differences"), each shown
  on both packages:
  - log matching by term: a leader cut off after applying a write that no
    follower acknowledged, a new leader writing over the same
    resourceVersions, then the old leader rejoining. The port's old leader
    ends equal to the new one; the JAX package's keeps the phantom object
    and lacks the new leader's write at that resourceVersion;
  - a one-node group commits: a create on a ``ReplicatedStore`` over a
    node with no peers returns on the port and raises ``QuorumLost`` on the
    JAX package.
"""

from __future__ import annotations

import socket
import time

import pytest

import torch_store_parity as parity
from kubernetes_tpu.store import replication as ref_replication
from kubernetes_tpu.store import store as ref_store
from kubernetes_tpu_torch.store import replication as port_replication
from kubernetes_tpu_torch.store import store as port_store

NAME = "test_replication"
CASES = parity.cases(NAME)
SIDES = {"ref": (ref_replication, ref_store),
         "port": (port_replication, port_store)}


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


def _wait(fn, timeout=30.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _group(side: str, n: int = 3) -> list:
    replication, store = SIDES[side]
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return [replication.RaftNode(
        f"n{i}", store.ObjectStore(),
        {f"n{j}": f"http://127.0.0.1:{ports[j]}" for j in range(n) if j != i},
        port=ports[i]) for i in range(n)]


def _leader(nodes, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        leaders = [nd for nd in nodes if nd.is_leader()]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.05)
    raise AssertionError("no single leader")


def _put(side: str, nodes, name: str):
    """Create ``name`` through whichever of ``nodes`` leads, again after
    a leadership move -> the leader that committed it."""
    replication, store = SIDES[side]
    while True:
        leader = _leader(nodes)
        try:
            replication.ReplicatedStore(leader, commit_timeout=10.0).create(
                "ConfigMap", _cm(name))
            return leader
        except replication.NotLeader:
            continue
        except store.AlreadyExists:
            return leader


def _names(node) -> dict:
    return {o["metadata"]["name"]: int(o["metadata"]["resourceVersion"])
            for o in node.store.list("ConfigMap")[0]}


def _cm(name):
    return {"kind": "ConfigMap", "metadata": {"name": name, "namespace": "d"},
            "data": {"v": name}}


def _cut_off(nodes, old) -> None:
    """Drop every message to and from ``old``."""
    old._post = lambda url, path, obj: None
    for nd in nodes:
        if nd is not old:
            orig = type(nd)._post
            nd._post = (lambda url, path, obj, _orig=orig:
                        None if url == old.url else _orig(url, path, obj))


def _rejoin(nodes) -> None:
    for nd in nodes:
        nd.__dict__.pop("_post", None)


def _phantom_run(side: str) -> dict:
    replication, _store = SIDES[side]
    nodes = _group(side)
    try:
        while True:  # until one leader holds the term from base to the cut
            old = _put(side, nodes, "base")
            _wait(lambda: all("base" in _names(nd) for nd in nodes),
                  what="base on every node")
            _cut_off(nodes, old)
            if old.is_leader():
                break
            _rejoin(nodes)
            for nd in nodes:  # start over from an empty group
                nd.stop()
            nodes = _group(side)
        with pytest.raises(replication.QuorumLost):
            replication.ReplicatedStore(old, commit_timeout=0.5).create(
                "ConfigMap", _cm("phantom"))
        rest = [nd for nd in nodes if nd is not old]
        _put(side, rest, "new1")
        new = _put(side, rest, "new2")
        _rejoin(nodes)
        _wait(lambda: not old.is_leader()
              and _names(old).get("new2") == _names(new)["new2"],
              what="the old leader to follow the new one")
        return {"old": _names(old), "new": _names(new)}
    finally:
        for nd in nodes:
            nd.stop()


def test_rejoining_leader_drops_its_uncommitted_suffix():
    port = _phantom_run("port")
    assert port["old"] == port["new"]
    assert "phantom" not in port["old"]
    ref = _phantom_run("ref")
    # the reference keeps the phantom at the rv where the new term wrote
    assert ref["old"]["phantom"] == ref["new"]["new1"]
    assert "new1" not in ref["old"]
    # both new leaders hold the same objects at the same rvs
    assert port["new"] == ref["new"]


def _single_node_create(side: str):
    replication, store = SIDES[side]
    node = replication.RaftNode("solo", store.ObjectStore(), {})
    try:
        _leader([node])
        rs = replication.ReplicatedStore(node, commit_timeout=1.0)
        try:
            out = rs.create("ConfigMap", _cm("one"))
        except replication.QuorumLost:
            return "QuorumLost"
        return out["metadata"]["name"], node.status()["commit_rv"]
    finally:
        node.stop()


def test_single_node_group_commits():
    assert _single_node_create("port") == ("one", 1)
    assert _single_node_create("ref") == "QuorumLost"
