"""The device mesh over physical cards: ``parity.mesh`` and the ``mesh``
leg of ``chip_smoke.py``, on four H100s joined by NVLink.

    python3 tests/torch_mesh_probe.py            # four cards, cuda:0..3
    python3 tests/torch_mesh_probe.py --logical  # one card, logical shards
    python3 tests/torch_mesh_probe.py --drain-only   # parity.mesh alone

It imports no JAX (``chip_smoke.py``'s phases are JAX-free). Each line of
its output is one JSON object; the last is ``{"ok": true, ...}``.

- ``parity.mesh``: MixedHeterogeneous at 5000 nodes (the 8192 bucket),
  P=512, B=2, drained single-card and on meshes (1,4) and (2,2) over
  ``cuda:0..3``. Gates: assignments, rounds, fill and folded state
  bit-equal to the single-card drain, and count_pn launched on every
  shard. Reported: each drain's milliseconds, the bytes its collectives
  moved between cards (``PEER_BYTES``) and in all.
- ``mesh``: Connected/10000Pods5000Nodes through the connected runner,
  single-card and with its scheduler on the (1,4) mesh of the four cards
  (``Scheduler.set_mesh``); both legs start their loop once every pod is
  queued. Gates: the mesh active, every pod bound, the same placements.
  Pods/s of both legs is reported, not gated.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((1, 4), (2, 2))
CONNECTED = (1, 4)


def main() -> int:
    import torch
    import chip_smoke as cs
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.parallel.mesh import make_mesh
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    logical = "--logical" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    n = torch.cuda.device_count()
    if not logical and n < 4:
        print(f"torch_mesh_probe: needs 4 cards, has {n}", file=sys.stderr)
        return 2
    cards = ["cuda:0"] * 4 if logical else [f"cuda:{i}" for i in range(4)]
    smi = cs.nvidia_smi_line()
    cs.emit({"phase": "device", "count": n, "logical": logical,
             "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    t0 = time.perf_counter()
    kernels.build()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})

    nodes, pods = mixed_heterogeneous(pods=cs.MESH_P * cs.MESH_B,
                                      nodes=cs.MESH_NODES, seed=cs.SEED)
    enc = SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods)
    pbs = [enc.encode_pods(pods[i:i + cs.MESH_P], meta, min_p=cs.MESH_P)
           for i in range(0, cs.MESH_P * cs.MESH_B, cs.MESH_P)]
    keys = tuple(meta.topo_keys)
    single = cs.mesh_drain(ct, pbs, keys, device="cuda:0")
    legs = {}
    for shape in SHAPES:
        m = make_mesh(cards, pods_axis=shape[0])
        cs.mesh_drain(ct, pbs, keys, mesh=m)   # first touch of each card
        leg = cs.mesh_drain(ct, pbs, keys, mesh=m)
        name = f"{shape[0]}x{shape[1]}"
        cs.check(cs._same(leg["assignments"], single["assignments"])
                 and cs._same(leg["rounds"], single["rounds"])
                 and leg["fill"] == single["fill"]
                 and cs._same(leg["folded"], single["folded"]),
                 f"probe: the {name} mesh's drain differs from one card's")
        for i in range(shape[0]):
            for j in range(shape[1]):
                cs.check(leg["shard_launches"].get(f"count_pn@{i},{j}", 0)
                         > 0, f"probe: count_pn never launched on shard "
                              f"({i},{j}) of {name}")
        legs[name] = {k: leg[k] for k in ("ms", "launches", "shard_launches",
                                          "exchanged_bytes", "peer_bytes")}
        legs[name]["devices"] = [str(d) for d in m.device_list()]
    cs.emit({"phase": "parity.mesh", "nodes": len(nodes), "pods": len(pods),
             "placed": single["fill"], "single_ms": single["ms"],
             "meshes": legs, "bit_equal": True})
    del single, legs
    if "--drain-only" in sys.argv[1:]:
        print(smi, flush=True)
        cs.emit({"ok": True, "drain_only": True})
        return 0

    c_nodes, c_pods = cs.connected_workload()
    one, runner = cs.connected_phase(c_nodes, c_pods, smi=smi,
                                     queued_first=True)
    del runner
    m = make_mesh(cards, pods_axis=CONNECTED[0])
    meshed, runner = cs.connected_phase(c_nodes, c_pods, smi=smi, mesh=m,
                                        queued_first=True)
    del runner
    placed, placed1 = meshed.pop("placements"), one.pop("placements")
    cs.check(meshed["mesh_active"] and meshed["mesh_devices"] == 4,
             f"probe: the mesh was not active ({meshed['mesh']})")
    differ = sorted(k for k in placed1 if placed.get(k) != placed1[k])
    cs.check(not differ and len(placed) == len(c_pods),
             f"probe: the mesh placed {len(differ)} of {len(c_pods)} pods "
             f"elsewhere than one card ({differ[:5]}; ctx "
             f"{meshed['ctx_stats']} / {one['ctx_stats']})")
    keep = ("pods", "bound", "window_s", "pods_per_s", "attempt_p99_s",
            "ctx_stats", "breaker", "launches")
    cs.emit({"phase": "mesh", "shape": list(CONNECTED),
             "mesh": meshed["mesh"], "same_placements": True,
             **{k: meshed[k] for k in keep},
             "single_card": {k: one[k] for k in keep}})
    print(smi, flush=True)
    cs.emit({"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": n}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
