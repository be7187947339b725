"""The drain with ``_domain_counts``' [N,N] branch against its factored
branch, in one call on the card (ROADMAP B2).

    python3 tests/torch_b2_ab.py [OUT]

Encodes ``chip_smoke.py``'s drain cell (MixedHeterogeneous/10000Pods5000Nodes,
an 8192-node bucket, batches of 1024) once, then runs the captured
``gang_drain`` six times, alternating the branch that
``KTPU_DOMAIN_FACTORED`` forces (dense, factored, factored, dense, dense,
factored). Each leg drops the round graphs first (``graphs.reset``: the
graph key does not hold the branch), captures them in a warm-up drain and
times the next one. Every leg's assignments and rounds must equal the
first's. Prints one JSON line a leg and a summary (pods/s a leg, the
median of each branch); writes them to OUT (default
``build/b2_ab.json``). Needs a CUDA card (about a minute on one H100).
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ORDER = ("0", "1", "1", "0", "0", "1")   # KTPU_DOMAIN_FACTORED a leg


def main(out_path) -> int:
    import numpy as np
    import torch
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models import graphs
    from kubernetes_tpu_torch.models.gang import gang_drain, prepare_drain
    from kubernetes_tpu_torch.ops import kernels
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    kernels.build()
    nodes, pods = cs.drain_workload()
    enc = SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods,
                                  pending_slots=False)
    chunks = [pods[i:i + cs.DRAIN_BATCH]
              for i in range(0, len(pods), cs.DRAIN_BATCH)]
    plan = prepare_drain(ct, [enc.encode_pods(c, meta) for c in chunks])
    legs, first = [], None
    for mode in ORDER:
        os.environ["KTPU_DOMAIN_FACTORED"] = mode
        graphs.reset()
        gang_drain(topo_keys=meta.topo_keys, prepared=plan)   # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        assignments, rounds, _req = gang_drain(topo_keys=meta.topo_keys,
                                               prepared=plan)
        seconds = time.perf_counter() - t0
        placed = int((assignments >= 0).sum())
        if first is None:
            first = (assignments, rounds)
        equal = bool(np.array_equal(assignments, first[0])
                     and np.array_equal(rounds, first[1]))
        leg = {"factored": mode == "1", "seconds": seconds,
               "pods_per_s": placed / seconds, "placed": placed,
               "rounds": [int(r) for r in rounds], "equal_to_first": equal}
        legs.append(leg)
        print(json.dumps(leg), flush=True)
    by = {b: [leg["pods_per_s"] for leg in legs if leg["factored"] == b]
          for b in (False, True)}
    summary = {"card": smi, "nodes_bucket": int(ct.node_valid.shape[0]),
               "legs": legs,
               "median_pods_per_s": {"dense": statistics.median(by[False]),
                                     "factored": statistics.median(by[True])},
               "all_equal": all(leg["equal_to_first"] for leg in legs)}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "legs"}),
          flush=True)
    return 0 if summary["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else os.path.join(ROOT, "build", "b2_ab.json")))
