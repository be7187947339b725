"""Server-side apply in the port (``store/apply.py``, PATCH on the
apiserver, both clients' ``apply``, ``ktpu apply --server-side``) against
the JAX package's, on the CPU.

- Every case of ``tests/test_server_side_apply.py`` runs on both packages
  through ``tests/torch_store_parity.py``: both pass, and their records
  (status codes and reasons, stored objects with their managedFields) are
  equal.
- Seeded sequences of applies by three field managers, forced or not,
  over ConfigMaps and Nodes with dotted keys: the same merged objects and
  managedFields (their timestamps masked), the same conflicts.
- ``field_set``, ``to_fields_v1`` and ``from_fields_v1`` on seeded
  objects: equal, and the round trip holds.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

import torch_store_parity as parity
from kubernetes_tpu.store import apply as ref_apply
from kubernetes_tpu_torch.store import apply as port_apply

NAME = "test_server_side_apply"
CASES = parity.cases(NAME)


@pytest.fixture(scope="module")
def shared():
    yield from parity.shared_fixtures()


@pytest.mark.parametrize("fname,params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_case_on_both_packages(fname, params, tmp_path, shared):
    ref, port = parity.both(NAME, fname, params, tmp_path, shared)
    assert port == ref


KEYS = ["a", "b", "config.yaml", "topology.kubernetes.io/zone", "x.y.z"]


def _random_config(rng, kind: str) -> dict:
    obj = {"kind": kind, "metadata": {"name": "obj"}}
    if rng.rand() < 0.7:
        obj["data"] = {k: str(rng.choice(["1", "2"]))
                       for k in rng.choice(KEYS, int(rng.randint(0, 4)),
                                           replace=False)}
    if rng.rand() < 0.5:
        obj["metadata"]["labels"] = {
            k: str(rng.choice(["u", "v"]))
            for k in rng.choice(KEYS, int(rng.randint(1, 3)), replace=False)}
    if rng.rand() < 0.3:
        obj["spec"] = {"list": [int(v) for v in rng.randint(0, 3, 2)],
                       "nested": {"k": str(rng.choice(["p", "q"]))}}
    return obj


def _apply_sequence(mod, seed: int) -> list:
    rng = np.random.RandomState(seed)
    kind = str(rng.choice(["ConfigMap", "Node"]))
    live, out = None, []
    for _ in range(25):
        desired = _random_config(rng, kind)
        manager = str(rng.choice(["mgr-a", "mgr-b", "kubectl"]))
        force = bool(rng.rand() < 0.3)
        try:
            live = mod.server_side_apply(copy.deepcopy(live),
                                         copy.deepcopy(desired), manager,
                                         force=force)
            out.append(("ok", parity.mask(live)))
        except mod.ApplyConflict as e:
            out.append(("conflict", e.conflicts, str(e)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_apply_sequences_equal(seed):
    port = _apply_sequence(port_apply, seed)
    assert port == _apply_sequence(ref_apply, seed)


def test_field_sets_equal_and_round_trip():
    rng = np.random.RandomState(7)
    for _ in range(100):
        obj = _random_config(rng, "ConfigMap")
        paths = port_apply.field_set(obj)
        assert paths == ref_apply.field_set(obj)
        trie = port_apply.to_fields_v1(paths)
        assert trie == ref_apply.to_fields_v1(paths)
        assert port_apply.from_fields_v1(trie) == paths
        assert ([port_apply.path_str(p) for p in sorted(paths)]
                == [ref_apply.path_str(p) for p in sorted(paths)])
