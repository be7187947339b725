#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each:

  device   the card, and its name and power limit from nvidia-smi
  build    nvcc builds every kernel of ``kubernetes_tpu_torch/ops/csrc``
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes of the path's first Schedule (seeded inputs) and, for the
           required (anti-)affinity terms the path does not reach, of a
           5000-node ``required_terms_mix`` cluster; with times: kernel_ms
           (the call as the path makes it, CUDA events around back-to-back
           calls), device_ms (20 calls captured once in a CUDA graph and
           replayed: the kernel without its Python wrapper), plain_ms,
           library_ms and the bound
  parity   a small cluster through the engine on the card and on the CPU
           (the plain versions): the assignments must be equal
  path     the sidecar engine in process: PushSnapshot of a 5000-node
           MixedHeterogeneous cluster with 2000 bound pods, then 8 Schedule
           requests of 256 pending pods, each followed by the PushDelta that
           binds what it placed; the placements are checked
  profile  one more Schedule request of 256 pods on the path's engine under
           torch.profiler (CPU and CUDA): the device operations with the
           most time, and the device's busy share of the request

Then the kernel table line ({"kernels": [...]}, launches counted in the path
phase only), the card's name and power limit, and last
{"ok": true, "device": {...}}. Any failed phase exits non-zero before the
last line. Without a CUDA card the script exits non-zero and prints no
result.

``python3 chip_smoke.py --sweep`` instead times count_pn's launch geometries
(selectors per block, nodes per block, threads) at the kernels phase's
shapes, each checked bit-equal to the plain version, and prints one line
each.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
N_NODES = 5000
N_BOUND = 2000
N_REQUESTS = 8
BATCH = 256          # the scheduler's default batch_size

# H100 SXM published peaks (dense): device memory 3.35 TB/s; 32-bit CUDA-core
# rate 67 T/s, the nearest table entry for the kernel's integer compares.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


class PhaseFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise PhaseFailed(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events around
    back-to-back calls: the host's pace whenever it is slower than the
    device's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=10, warmup=3) -> float:
    """Mean device milliseconds of one ``fn`` call: ``calls`` calls captured
    once in a CUDA graph, the graph replayed ``replays`` times between CUDA
    events. No host work runs between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# ------------------------------------------------------------------ workload

def workload(n_nodes=N_NODES, n_bound=N_BOUND, n_requests=N_REQUESTS,
             batch=BATCH, seed=SEED):
    """-> (node dicts, bound pod dicts, [pending batch dicts]). The bound
    pods sit on the nodes round-robin."""
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    nodes, pods = mixed_heterogeneous(pods=n_bound + n_requests * batch,
                                      nodes=n_nodes, seed=seed)
    node_dicts = [n.to_dict() for n in nodes]
    bound = []
    for i, p in enumerate(pods[:n_bound]):
        d = p.to_dict()
        d["spec"]["nodeName"] = node_dicts[i % n_nodes]["metadata"]["name"]
        bound.append(d)
    pending = [p.to_dict() for p in pods[n_bound:]]
    return node_dicts, bound, [pending[i * batch:(i + 1) * batch]
                               for i in range(n_requests)]


# ------------------------------------------------------------------ kernels

def count_pn_bound(ct, sel, pod_ns, ns_explicit, ns_mask):
    """Least time for count_pn on these inputs: each input byte read once
    (epod rows only where valid), the output written once; the selector
    compares for each valid (existing pod, term) pair."""
    E, K = ct.epod_labels.shape
    P, T, X = sel.key.shape
    V = sel.vals.shape[3]
    N = ct.node_valid.shape[0]
    e_valid = int(ct.epod_valid.sum())
    pt_valid = int(sel.valid.sum())
    nbytes = (E                                   # epod_valid
              + e_valid * (K * 4 + 4 + 4)         # labels, node, ns
              + P * T * X * (4 + 4 + 1)           # key, op, expr_valid
              + P * T * X * V * 4 + P * T         # vals, valid
              + P * 4                             # pod_ns
              + P * T * N * 4)                    # output
    if ns_explicit is not None:
        nbytes += P * T + P * T * ns_mask.shape[2]
    ops = e_valid * pt_valid * (X * (2 * V + 6) + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def _encoded(node_dicts, bound, pending_dicts, ns_labels=None):
    """(ClusterTensors extended by the batch, PodBatch) on the card."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models.gang import extend_cluster
    enc = SnapshotEncoder()
    if ns_labels is not None:
        enc.set_namespaces(ns_labels)
    pending = [Pod.from_dict(d) for d in pending_dicts]
    ct, meta = enc.encode_cluster([Node.from_dict(d) for d in node_dicts],
                                  [Pod.from_dict(d) for d in bound],
                                  pending_pods=pending)
    pb = enc.encode_pods(pending, meta).to("cuda")
    return extend_cluster(ct.to("cuda"), pb), pb


def count_pn_cases(node_dicts, bound, first_batch):
    """{term set: (ct, count_pn arguments)}: the spread and preferred
    affinity terms of the path's first Schedule round, and the required
    affinity and anti-affinity terms of a 5000-node ``required_terms_mix``
    cluster (2000 bound pods, 256 pending; T, X, V > 1, explicit and own
    namespace sets), which the path's cluster never reaches."""
    from kubernetes_tpu_torch.testing.workloads import required_terms_mix
    ct, pb = _encoded(node_dicts, bound, first_batch)
    nodes, rbound, pending, ns_labels = required_terms_mix(
        pods=BATCH, nodes=N_NODES, bound=N_BOUND, seed=SEED)
    rct, rpb = _encoded([n.to_dict() for n in nodes],
                        [p.to_dict() for p in rbound],
                        [p.to_dict() for p in pending], ns_labels)
    return {
        "spread": (ct, (pb.sc_sel, pb.pod_ns, None, None)),
        "preferred_affinity": (ct, (pb.paff_sel, pb.pod_ns,
                                    pb.paff_ns_explicit, pb.paff_ns_mask)),
        "required_affinity": (rct, (rpb.aff_sel, rpb.pod_ns,
                                    rpb.aff_ns_explicit, rpb.aff_ns_mask)),
        "required_anti_affinity": (rct, (rpb.anti_sel, rpb.pod_ns,
                                         rpb.anti_ns_explicit,
                                         rpb.anti_ns_mask)),
    }


def kernels_phase(cases):
    """count_pn against _count_pn_plain on the card for each term set of
    ``count_pn_cases``; -> one table row per (kernel, term set)."""
    import torch
    from kubernetes_tpu_torch.ops import topology
    rows = []
    for terms, (ct, args) in cases.items():
        got = topology.count_pn(ct, *args)
        want = topology._count_pn_plain(ct, *args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err == 0.0, f"count_pn[{terms}] differs from its plain version "
                          f"by {err}")
        check(float(want.sum()) > 0, f"count_pn[{terms}]: nothing to count")
        match = topology._term_match_epods(ct, *args)
        nodes = torch.arange(ct.node_valid.shape[0], device="cuda")
        onehot = (ct.epod_node[:, None] == nodes[None, :]).float()
        with topology._full_fp32():
            library_ms = cuda_ms(lambda: torch.einsum("ept,en->ptn", match,
                                                      onehot))
        bound_ms, bound_by, nbytes, ops = count_pn_bound(ct, *args)
        kernel_ms = cuda_ms(lambda: topology.count_pn(ct, *args))
        device_ms = graph_ms(lambda: topology.count_pn(ct, *args))
        geo = topology.count_pn_geometry(
            int(args[0].key.shape[0] * args[0].key.shape[1]),
            int(ct.node_valid.shape[0]), int(args[0].key.shape[2]),
            int(args[0].vals.shape[3]),
            0 if args[2] is None else int(args[3].shape[2]))
        rows.append({
            "name": f"count_pn[{terms}]", "route": "cuda",
            "source": "kubernetes_tpu_torch/ops/csrc/count_pn.cu",
            "replaces": "kubernetes_tpu/ops/pallas/domain_count.py:171 "
                        "(03c3298; live as kubernetes_tpu/ops/topology.py:96)",
            "shape": {"E": int(ct.epod_labels.shape[0]),
                      "P": int(args[0].key.shape[0]),
                      "T": int(args[0].key.shape[1]),
                      "X": int(args[0].key.shape[2]),
                      "V": int(args[0].vals.shape[3]),
                      "N": int(ct.node_valid.shape[0])},
            "geometry": {"pt_tile": geo.pt_tile,
                         "node_range": geo.node_range,
                         "threads": geo.threads, "blocks": geo.blocks,
                         "smem_bytes": geo.smem_bytes},
            "max_abs_err": err,
            "kernel_ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": cuda_ms(lambda: topology._count_pn_plain(ct, *args)),
            "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share_kernel": bound_ms / kernel_ms,
            "bound_share_device": bound_ms / device_ms,
            "bytes": nbytes, "operations": ops,
        })
    return rows


# (selectors per block, nodes per block, threads per block); every entry
# fits a block's shared memory at the kernels phase's shapes
SWEEP = [(pt_tile, node_range, threads)
         for pt_tile in (1, 2, 4, 8)
         for node_range in (1024, 2048, 4096, 8192)
         for threads in (128, 256, 512)
         if pt_tile * node_range <= 16384]


def sweep_phase(cases):
    """device_ms and kernel_ms of count_pn at each SWEEP geometry (taken as
    it is, not adjusted as ``count_pn_geometry`` would), for each term set,
    each result checked bit-equal to the plain version."""
    import torch
    from kubernetes_tpu_torch.ops import topology
    for terms, (ct, args) in cases.items():
        want = topology._count_pn_plain(ct, *args)
        P, T, X = args[0].key.shape
        dims = (P * T, ct.node_valid.shape[0], X, args[0].vals.shape[3],
                0 if args[2] is None else args[3].shape[2])
        PT, N, X, V, NSB = map(int, dims)
        # floors: PyTorch's fill of an output this size, and the kernel
        # with no existing pod to walk (staging and the stores alone)
        empty = ct.replace(epod_labels=ct.epod_labels[:0],
                           epod_node=ct.epod_node[:0],
                           epod_ns=ct.epod_ns[:0],
                           epod_valid=ct.epod_valid[:0])
        emit({"phase": "sweep", "terms": terms, "floors": True,
              "fill_ms": graph_ms(lambda: torch.zeros(
                  (P, T, N), dtype=torch.float32, device="cuda")),
              "no_pods_ms": graph_ms(lambda: topology.count_pn(empty,
                                                               *args))})
        for pt_tile, node_range, threads in SWEEP:
            geo = topology.CountPnGeometry(
                PT, N, pt_tile, node_range, threads,
                topology._smem_layout(pt_tile, node_range, X, V, NSB))
            key = (pt_tile, node_range, threads)
            run = lambda: topology.count_pn(ct, *args, geometry=geo)  # noqa: E731
            got = run()
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"sweep: count_pn[{terms}] at {key} differs from plain")
            emit({"phase": "sweep", "terms": terms, "pt_tile": geo.pt_tile,
                  "node_range": geo.node_range, "threads": geo.threads,
                  "blocks": geo.blocks, "smem_bytes": geo.smem_bytes,
                  "device_ms": graph_ms(run), "kernel_ms": cuda_ms(run)})


# ------------------------------------------------------------------ parity

def parity_phase():
    """A small cluster through the engine on the card and on the CPU: the
    assignments and rounds must be equal."""
    from kubernetes_tpu_torch.sidecar.server import _Engine
    from kubernetes_tpu_torch.testing.workloads import relational_mix
    nodes, bound, pending, _ = relational_mix(pods=48, nodes=32, seed=SEED)
    req = {"nodes": [n.to_dict() for n in nodes],
           "pods": [p.to_dict() for p in bound], "generation": 1}
    batch = {"pods": [p.to_dict() for p in pending], "generation": 1}
    out = {}
    for device in ("cuda", "cpu"):
        eng = _Engine(device=device)
        check(eng.dispatch("PushSnapshot", req) == {"generation": 1},
              "parity: PushSnapshot refused")
        out[device] = eng.dispatch("Schedule", batch)
        check("error" not in out[device], f"parity on {device}: {out[device]}")
    check(out["cuda"] == out["cpu"],
          "parity: the card's assignments differ from the CPU's")
    placed = sum(1 for a in out["cuda"]["assignments"] if a)
    return {"pods": len(pending), "placed": placed,
            "rounds": out["cuda"]["rounds"]}


# ------------------------------------------------------------------ path

def _parse(node_dicts, pod_dicts):
    from kubernetes_tpu_torch.api.types import Node, Pod
    return ({d["metadata"]["name"]: Node.from_dict(d) for d in node_dicts},
            [Pod.from_dict(d) for d in pod_dicts])


def check_placements(node_dicts, bound, placed_dicts, n_pending):
    """Allocatable cpu/memory/pods hold on every node; no pod without a
    toleration sits on a tainted node; every nodeSelector pod sits on a
    matching node; at least 90% of the pending pods are placed."""
    nodes, pods = _parse(node_dicts, bound + placed_dicts)
    used: dict[str, dict[str, int]] = {}
    for p in pods:
        u = used.setdefault(p.spec.node_name, {})
        for r, q in p.resource_requests().items():
            u[r] = u.get(r, 0) + q
    for name, u in used.items():
        alloc = nodes[name].allocatable_canonical()
        for r in ("cpu", "memory", "pods"):
            check(u.get(r, 0) <= alloc[r],
                  f"node {name} over allocatable {r}: {u.get(r)} > {alloc[r]}")
    for p in pods[len(bound):]:
        node = nodes[p.spec.node_name]
        for t in node.spec.taints:
            if t.effect in ("NoSchedule", "NoExecute"):
                check(any(tol.key == t.key and tol.value == t.value
                          for tol in p.spec.tolerations),
                      f"{p.key} on tainted {p.spec.node_name} untolerated")
        for k, v in p.spec.node_selector.items():
            check(node.metadata.labels.get(k) == v,
                  f"{p.key} on {p.spec.node_name} breaks nodeSelector {k}={v}")
    check(len(placed_dicts) >= 0.9 * n_pending,
          f"only {len(placed_dicts)} of {n_pending} pods placed")


def path_phase(node_dicts, bound, batches, device=None):
    """The sidecar engine's main path, through its request dispatch."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sidecar.server import _Engine
    eng = _Engine(device=device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    resp = eng.dispatch("PushSnapshot", {"nodes": node_dicts, "pods": bound,
                                         "generation": 1})
    check(resp == {"generation": 1}, f"PushSnapshot: {resp}")
    gen = 1
    placed_dicts, requests = [], []
    for i, batch in enumerate(batches):
        t1 = time.perf_counter()
        resp = eng.dispatch("Schedule", {"pods": batch, "generation": gen})
        t2 = time.perf_counter()
        check("assignments" in resp, f"Schedule {i}: {resp}")
        timings = dict(eng.last_timings)
        ops = []
        for d, node in zip(batch, resp["assignments"]):
            if node:
                d = dict(d, spec=dict(d["spec"], nodeName=node))
                placed_dicts.append(d)
                ops.append({"op": "upsert", "pod": d})
        resp_d = eng.dispatch("PushDelta", {"base_generation": gen,
                                            "generation": gen + 1,
                                            "ops": ops})
        gen += 1
        check(resp_d == {"generation": gen}, f"PushDelta {i}: {resp_d}")
        row = {"request": i, "pods": len(batch), "placed": len(ops),
               "rounds": resp["rounds"],
               "encode_ms": timings["encode_ms"],
               "schedule_ms": timings["device_ms"],
               "request_ms": (t2 - t1) * 1e3}
        requests.append(row)
        emit({"phase": "path.request", **row})
    launches = dict(kernels.LAUNCHES)
    wall_s = time.perf_counter() - t0
    check_placements(node_dicts, bound, placed_dicts,
                     sum(len(b) for b in batches))
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the path")
    return {"requests": requests, "launches": launches, "wall_s": wall_s,
            "placed": len(placed_dicts), "engine": eng, "generation": gen}


# ------------------------------------------------------------------ profile

def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy


def trace_summary(events, top=12):
    """Device time in a chrome trace's events: the busy time (the union of
    kernel, copy and fill intervals), the operations with the most total
    time, and each hand kernel's count and total."""
    from kubernetes_tpu_torch.ops import kernels
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name: dict[str, list] = {}
    for e in device:
        entry = by_name.setdefault(e["name"], [0, 0.0])
        entry[0] += 1
        entry[1] += float(e["dur"])
    busy_us = _busy_us([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in device])
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    hand = {k: [(n, us) for name, (n, us) in by_name.items() if k in name]
            for k in kernels.KERNELS}
    return {"device_ops": len(device), "device_busy_ms": busy_us / 1e3,
            "top_device_ops": [{"name": name[:120], "count": n,
                                "total_ms": us / 1e3}
                               for name, (n, us) in ranked],
            "hand_kernels": {k: {"count": sum(n for n, _ in hits),
                                 "total_ms": sum(us for _, us in hits) / 1e3}
                             for k, hits in hand.items()}}


def profile_phase(eng, batch, gen):
    """One Schedule request on ``eng`` under torch.profiler (CPU and CUDA).
    -> the request's host time and its split, the device's busy share of
    the request and of its schedule part, and ``trace_summary`` of the
    trace, which is kept under build/profile/."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "schedule_request.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        resp = eng.dispatch("Schedule", {"pods": batch, "generation": gen})
        torch.cuda.synchronize()
        request_ms = (time.perf_counter() - t0) * 1e3
    check("assignments" in resp, f"profiled Schedule: {resp}")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        summary = trace_summary(json.load(f)["traceEvents"])
    check(summary["device_ops"] > 0,
          "profiled Schedule: the trace holds no device time")
    schedule_ms = eng.last_timings["device_ms"]
    return {"pods": len(batch), "rounds": resp["rounds"],
            "request_ms": request_ms,
            "encode_ms": eng.last_timings["encode_ms"],
            "schedule_ms": schedule_ms,
            "device_busy_share": summary["device_busy_ms"] / request_ms,
            "device_busy_share_of_schedule":
                summary["device_busy_ms"] / schedule_ms,
            **summary, "trace": os.path.relpath(trace_path)}


# ------------------------------------------------------------------ main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubernetes_tpu_torch.ops import kernels

    smi = nvidia_smi_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", **device, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"built": b["built"],
                             "ptxas": [ln for ln in b["ptxas"].splitlines()
                                       if "registers" in ln or "spill" in ln]}
                      for name, b in built.items()}})

    # one batch past the path's requests, for the profiled request (the
    # generator draws pod by pod, so the first batches do not change)
    node_dicts, bound, batches = workload(n_requests=N_REQUESTS + 1)
    batches, profiled_batch = batches[:N_REQUESTS], batches[N_REQUESTS]
    cases = count_pn_cases(node_dicts, bound, batches[0])
    if "--sweep" in sys.argv[1:]:
        sweep_phase(cases)
        print(smi, flush=True)
        emit({"ok": True, "device": device})
        return 0
    rows = kernels_phase(cases)
    del cases
    emit({"phase": "kernels", "rows": rows,
          "launches_while_comparing": dict(kernels.LAUNCHES)})

    emit({"phase": "parity", **parity_phase()})

    path = path_phase(node_dicts, bound, batches)
    rounds = sum(r["rounds"] for r in path["requests"])
    emit({"phase": "path", "nodes": len(node_dicts), "bound": len(bound),
          "requests": len(batches), "placed": path["placed"],
          "rounds": rounds, "launches": path["launches"],
          "launches_per_round": {k: n / rounds
                                 for k, n in path["launches"].items()},
          "wall_s": path["wall_s"]})

    emit({"phase": "profile", **profile_phase(path["engine"], profiled_batch,
                                              path["generation"])})

    # one entry per kernel: count_pn at the spread terms' shape, the one
    # the path launches most (the spread count every round)
    table = []
    for name, n in path["launches"].items():
        row = dict(next(r for r in rows if r["name"].startswith(name + "[")))
        row.update(name=name, launches=n, ms=row.pop("kernel_ms"))
        table.append(row)
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
