"""Run ``chip_smoke.py``'s cluster, domain_counts and ktpu phases alone on
the card.

    python3 tests/torch_cluster_probe.py [OUT]

Builds the kernels, then runs ``domain_counts_phase`` (ROADMAP B2's two
branches), ``cluster_phase`` (ClusterUp/20Nodes100Pods: ``ktpu-up init``
and ``join`` children, the Deployment, the proxy renders) and
``ktpu_phase`` (``ktpu lint`` included) one after another, each timed; a
phase that fails is reported and the next one runs. Everything each phase
returned goes to OUT as JSON (default ``build/cluster_probe.json``); the
last lines print the cluster phase's steps and gates and the B2 times.
Needs a CUDA card (a few minutes on one H100).
"""

import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(out_path) -> int:
    from kubernetes_tpu_torch.ops import kernels
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    t = time.perf_counter()
    kernels.build()
    print("build", round(time.perf_counter() - t, 1), flush=True)
    out = {"smi": smi}
    rc = 0
    for name, fn in (("domain_counts", cs.domain_counts_phase),
                     ("cluster", lambda: cs.cluster_phase(smi=smi)),
                     ("ktpu", cs.ktpu_phase)):
        t = time.perf_counter()
        try:
            out[name] = fn()
            print(name, "ok", round(time.perf_counter() - t, 1), flush=True)
        except Exception as e:  # reported; the next phase still runs
            traceback.print_exc()
            out[name] = {"error": repr(e)}
            rc = 1
            print(name, "FAILED", round(time.perf_counter() - t, 1),
                  repr(e)[:2000], flush=True)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1, default=str)
    cluster = out.get("cluster", {})
    print(json.dumps({k: v for k, v in cluster.items()
                      if k.endswith("_s") or k in (
                          "device", "pods_per_node", "backends", "exits",
                          "launches", "failures", "seconds", "error")},
                     default=str))
    print(json.dumps(out.get("domain_counts"), default=str))
    print(json.dumps((out.get("ktpu") or {}).get("commands", {}).get("lint"),
                     default=str))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1
                  else os.path.join(ROOT, "build", "cluster_probe.json")))
