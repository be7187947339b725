"""Gang fragment probe: does a slice gang that reaches the scheduling loop
in fragments ever bind?

Each package's ``SchedulerRunner`` runs its own loop over a
``DirectClient`` store (an empty 4x4x2 grid, batch_size 4, the default
backoff of 1 s doubling to 10 s) while a 4x2x2 gang (16 members) is
created one member every ``--gap`` seconds, as a client creating a gang
pod by pod does. The loop pops what its informer has queued, so the gang
arrives in fragments; each fails its carve on the member count and backs
off.

    env JAX_PLATFORMS=cpu python tests/torch_gang_fragment_probe.py --seconds 60

prints one JSON line per package: members bound, the seconds watched,
the failed carves, and the first pops' (seconds, size).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _objects():
    from kubernetes_tpu.testing.wrappers import make_node, make_pod
    from kubernetes_tpu.topology.slicing import (GANG_LABEL,
                                                 SLICE_SHAPE_LABEL,
                                                 topology_labels)
    nodes = []
    for x in range(4):
        for y in range(4):
            for z in range(2):
                nb = make_node(f"n{x}{y}{z}").capacity(
                    {"cpu": "4", "memory": "8Gi", "pods": "16"})
                for k, v in topology_labels(x, y, z).items():
                    nb = nb.label(k, v)
                nodes.append(nb.obj().to_dict())
    pods = [make_pod(f"g-{m}").req({"cpu": "1"})
            .labels({GANG_LABEL: "g", SLICE_SHAPE_LABEL: "4x2x2"})
            .obj().to_dict() for m in range(16)]
    return nodes, pods


def probe(pkg: str, seconds: float, gap: float) -> dict:
    if pkg == "reference":
        from kubernetes_tpu.client.clientset import DirectClient
        from kubernetes_tpu.config.types import SchedulerConfiguration
        from kubernetes_tpu.sched.runner import SchedulerRunner
        from kubernetes_tpu.store.store import ObjectStore
        kw = {}
    else:
        from kubernetes_tpu_torch.client.clientset import DirectClient
        from kubernetes_tpu_torch.config.types import SchedulerConfiguration
        from kubernetes_tpu_torch.sched.runner import SchedulerRunner
        from kubernetes_tpu_torch.store.store import ObjectStore
        kw = {"device": "cpu"}
    nodes, pods = _objects()
    client = DirectClient(ObjectStore())
    for n in nodes:
        client.nodes().create(n)
    runner = SchedulerRunner(
        client, SchedulerConfiguration(batch_size=4, explainer_enabled=False,
                                       parity_sample_every=0), **kw)
    sched = runner.scheduler
    pops = []
    run_batch = sched._run_batch

    def counted(batch, cap):
        pops.append((round(time.time() - t0, 2), len(batch)))
        return run_batch(batch, cap)

    sched._run_batch = counted
    runner.start()
    t0 = time.time()
    try:
        for p in pods:
            client.pods().create(p)
            time.sleep(gap)
        deadline = t0 + seconds
        while time.time() < deadline:
            if all(p["spec"].get("nodeName")
                   for p in client.pods(None).list()):
                break
            time.sleep(0.1)
        bound = sum(1 for p in client.pods(None).list()
                    if p["spec"].get("nodeName"))
        with sched._carve_lock:
            stats = dict(sched._carve_stats)
        return {"package": pkg, "members": len(pods), "bound": bound,
                "watched_s": round(time.time() - t0, 1),
                "carve_stats": stats, "pops": len(pops),
                "first_pops": pops[:20]}
    finally:
        runner.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--gap", type=float, default=0.05,
                    help="seconds between two members' creates")
    args = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    for pkg in ("reference", "port"):
        print(json.dumps(probe(pkg, args.seconds, args.gap)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
