"""Informer relist probe: does the port's pod informer relist where the
reference's does not?

10,000 MixedHeterogeneous pods are created at once (4 concurrent bulk
creates of 2500) against the port's HTTP ``APIServer`` in a spawned
process with 5000 nodes seeded, then bound in bulk (4 concurrent
``bind_many`` calls of 1024), while a ``SchedulerRunner`` (loop stopped)
watches them: the port's with its tracer span on every watch event, the
port's without it, and the reference's. Each variant runs with no other
thread and beside ``--busy`` threads spinning in the interpreter (the
scheduling loop, auditor and sentinel of a connected run share it). The
apiserver's watch queue holds 4096 events: a watcher that falls further
behind is cut off and relists.

    env JAX_PLATFORMS=cpu python tests/torch_relist_probe.py --reps 2

prints one JSON line per trial: relists after the creates and after the
binds, and the seconds until the informer saw every create and bind.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _spin(stop: threading.Event) -> None:
    x = 0
    while not stop.is_set():
        for i in range(2000):
            x += i * i


def _runner(variant: str, url: str):
    if variant == "reference":
        from kubernetes_tpu.client.clientset import HTTPClient
        from kubernetes_tpu.config.types import SchedulerConfiguration
        from kubernetes_tpu.sched.runner import SchedulerRunner
        return SchedulerRunner(HTTPClient(url, wire="json"),
                               SchedulerConfiguration(
                                   explainer_enabled=False,
                                   parity_sample_every=0))
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.config.types import SchedulerConfiguration
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    r = SchedulerRunner(HTTPClient(url, wire="json"),
                        SchedulerConfiguration(explainer_enabled=False,
                                               parity_sample_every=0),
                        device="cpu")
    if variant == "port_nospan":
        r._on_pod = r._handle_pod  # the handler without its span
    return r


def _wait(pred, timeout=300.0) -> None:
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.05)


def trial(variant: str, busy: int, n_nodes: int, n_pods: int) -> dict:
    import multiprocessing as mp
    import chip_smoke as cs
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    server, pipe, url = cs.start_apiserver(mp.get_context("spawn"))
    stop = threading.Event()
    try:
        nodes, pods = mixed_heterogeneous(pods=n_pods, nodes=n_nodes, seed=0)
        nd, pd = cs._wire(nodes), cs._wire(pods)
        seed = HTTPClient(url, timeout=120.0, wire="json")
        seed.nodes().create_many(nd)
        r = _runner(variant, url)
        r.start(wait_sync=120.0, start_loop=False)
        inf = r.factory._informers[("pods", None)]
        relist0 = r._total_relists()
        for _ in range(busy):
            threading.Thread(target=_spin, args=(stop,), daemon=True).start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(lambda o: seed.pods("default").create_many(o),
                          [pd[i:i + 2500] for i in range(0, len(pd), 2500)]))
        _wait(lambda: len(inf.store) >= n_pods)
        seen_s = time.perf_counter() - t0
        relists_create = r._total_relists() - relist0
        names = [d["metadata"]["name"] for d in pd]
        chunks = [[("default", n, nd[i % len(nd)]["metadata"]["name"])
                   for i, n in enumerate(names[j:j + 1024], j)]
                  for j in range(0, len(names), 1024)]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(lambda c: seed.pods("default").bind_many(c),
                          chunks))
        _wait(lambda: sum(1 for o in inf.store.list()
                          if (o.get("spec") or {}).get("nodeName"))
              >= n_pods)
        out = {"variant": variant, "busy_threads": busy,
               "relists_create": relists_create,
               "relists_bind": r._total_relists() - relist0 - relists_create,
               "creates_seen_s": round(seen_s, 3),
               "binds_seen_s": round(time.perf_counter() - t1, 3)}
        stop.set()
        r.stop()
        return out
    finally:
        stop.set()
        cs.stop_process(server, pipe)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--busy", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=10000)
    args = ap.parse_args()
    for _ in range(args.reps):
        for busy in (0, args.busy):
            for variant in ("port_span", "port_nospan", "reference"):
                print(json.dumps(trial(variant, busy, args.nodes,
                                       args.pods)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
