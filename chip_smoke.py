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
           (the plain versions): the assignments must be equal; and the
           resident drain with Recreate churn over a small relational_mix
           cluster on both, 9 cycles: placements, rounds, new_fill and the
           folded requested/epod_valid/epod_node equal after every cycle,
           and at least 5 cycles folding behind a fused patch; and the
           port's Scheduler (sched/scheduler.py) over a small relational_mix
           cluster with churn between pops, at pipeline depth 1 and 2:
           binder logs, ctx_stats and the folded context equal; and the
           port's SchedulerRunner over a DirectClient, at depth 1 and 2,
           on a small relational_mix cluster and on a MixedHeterogeneous
           cluster of 32 nodes x 192 pods, the parity sentinel sampling
           every drain: the store's bindings, ctx_stats and the sentinel's
           samples, divergences and breaker mode equal on the card and the
           CPU, at least one sample and 0 divergences on each
  path     the sidecar engine in process: PushSnapshot of a 5000-node
           MixedHeterogeneous cluster with 2000 bound pods, then 8 Schedule
           requests of 256 pending pods, each followed by the PushDelta that
           binds what it placed; the placements are checked
  profile  one more Schedule request of 256 pods on the path's engine under
           torch.profiler (CPU and CUDA): the device operations with the
           most time, and the device's busy share of the request
  drain    MixedHeterogeneous/10000Pods5000Nodes as scheduler_perf's
           run_workload runs it: encode, batches of 1024, prepare_drain,
           a warm-up gang_drain, the measured gang_drain (scheduled, rounds
           per batch, encode/warm-up/measured seconds, pods/s, launches);
           the placements are checked and 90% must be placed
  kernels.drain  count_pn at the drain's shape (PT = 1024·T, E = 10240,
           N = 8192: the last batch's spread and preferred affinity terms)
           against its plain version, with the same times as the kernels
           phase
  resident the connected steady state (testing/resident.py): a
           SchedulerCache of the path's cluster, a context armed with
           8 x 256, then 8 cycles of Recreate churn + one fused drain_step
           of 8 x 256 pending pods (ms, placed, patch compiled, rebuilds,
           fill_host, top); after every cycle the folded requested and
           valid epod slots equal a host recount; 0 rebuilds
  kernels.resident  count_pn at the resident drain's shape (PT = 256·T,
           E = 34816, N = 8192: the folded context and the spread and
           preferred affinity terms of the last cycle's first batch), as
           kernels.drain
  profile.drain  one more resident cycle under torch.profiler: the
           device's busy share of the drain_step and the top operations
  scheduler  the north star through the port's Scheduler: 10,000
           MixedHeterogeneous pods on 5000 nodes, reference defaults
           (8 x 256 a pop, pipeline depth 2, fused fold, staging arena),
           warm_drain, then run_once with Recreate churn before every pop
           until the queue is empty; scheduled, the window from the first
           queue.add to the last binding and pods/s over it, p50/p99 of
           ATTEMPT_DURATION, per-cycle ms, ctx_stats, staging stats; the
           placements are checked, 90% placed, breaker "single", 0 loop
           errors, 0 pods through the oracle, 0 separate patches
  kernels.scheduler  count_pn at the scheduler's resident shape (the
           folded context after the run), as kernels.drain
  profile.scheduler  one more pop of 2048 pods under torch.profiler:
           the device's busy share of the whole cycle, assume and bind
           included
  connected  Connected/10000Pods5000Nodes as benchmarks/connected.py runs
           it: the port's APIServer in a spawned process, 5000 nodes seeded,
           SchedulerRunner(HTTPClient(url, wire="json")) with pops of
           2 x 512, depth 2, fused fold, staging, the parity sentinel every
           4th drain and a fail-fast auditor every 2 s; informers synced,
           warm_drain, 10,000 pods created in concurrent chunks of 2500,
           the loop started, a watcher process counting the bound pods.
           The window from the first create to the last bound event,
           pods/s, ATTEMPT_DURATION p50/p99, E2E_SCHEDULING p99, tracer
           span totals (the loop's, and the pod handler's, the audit
           sweeps' and the sentinel checks' on their own threads), the
           encode cache's hits and misses at pop time,
           ctx_stats, staging, breaker, loop errors, relists, audit sweeps
           and violations, sentinel samples and divergences, launches.
           Gates: 10,000 of 10,000 bound within 300 s, placements checked,
           breaker "single", 0 oracle pods, 0 loop errors, >= 1 audit sweep
           with 0 violations, >= 1 sentinel sample with 0 divergences
  kernels.connected  count_pn at the connected run's folded resident
           shape, as kernels.drain

Each path (path, drain, resident, scheduler, connected) is driven with the
launch counts set to 0 just before it and read just after. Then the kernel table line
({"kernels": [...]}, one row per kernel at the shape of its most launches,
launches summed over the paths, the shapes checked), the card's name and
power limit, and last {"ok": true, "device": {...}}. Any failed phase
exits non-zero before the last line. Without a CUDA card the script exits
non-zero and prints no result.

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


# ------------------------------------------------------------------ drain

DRAIN_PODS = 10000
DRAIN_BATCH = 1024   # scheduler_perf.run_workload's batch


def drain_workload(pods=DRAIN_PODS, nodes=N_NODES, seed=SEED):
    """MixedHeterogeneous/10000Pods5000Nodes as ``run_workload`` builds
    it: no bound pods, every pod measured. -> (nodes, pods)."""
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    return mixed_heterogeneous(pods=pods, nodes=nodes, seed=seed)


def drain_phase(nodes, pods, batch=DRAIN_BATCH, device=None):
    """The non-resident drain as ``benchmarks/scheduler_perf.py``'s
    ``run_workload`` runs it: encode (pending slots off), batches of
    ``batch``, ``prepare_drain`` (counted as encode time), one warm-up
    ``gang_drain``, then the measured one, whose launches are counted.
    The placements are checked like the path's."""
    import numpy as np
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models.gang import gang_drain, prepare_drain
    from kubernetes_tpu_torch.ops import kernels
    enc = SnapshotEncoder()
    t0 = time.perf_counter()
    ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods,
                                  pending_slots=False)
    chunks = [pods[i:i + batch] for i in range(0, len(pods), batch)]
    pbs = [enc.encode_pods(c, meta) for c in chunks]
    plan = prepare_drain(ct, pbs, device=device)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gang_drain(topo_keys=meta.topo_keys, prepared=plan)
    warmup_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    assignments, rounds, requested = gang_drain(topo_keys=meta.topo_keys,
                                                prepared=plan)
    measured_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(np.isfinite(requested).all() and requested.shape == (
        ct.allocatable.shape[0], len(meta.resources)),
        "drain: requested is not [N,R]")
    placed = []
    for b, chunk in enumerate(chunks):
        for pod, a in zip(chunk, assignments[b][:len(chunk)]):
            if a >= 0:
                d = pod.to_dict()
                d["spec"]["nodeName"] = meta.node_names[int(a)]
                placed.append(d)
    check_placements([n.to_dict() for n in nodes], [], placed, len(pods))
    return {"pods": len(pods), "nodes": len(nodes), "batches": len(chunks),
            "batch": batch, "scheduled": len(placed),
            "rounds": [int(r) for r in rounds], "encode_s": encode_s,
            "warmup_s": warmup_s, "measured_s": measured_s,
            "pods_per_s": len(placed) / measured_s, "launches": launches,
            "plan": plan, "assignments": assignments, "meta": meta}


def _term_cases(prefix, ct, pb):
    """{term set: (ct, count_pn arguments)}: the spread and preferred
    affinity terms of ``pb``, the two count_pn calls of a drain round on
    the MixedHeterogeneous workloads."""
    return {
        f"{prefix}_spread": (ct, (pb.sc_sel, pb.pod_ns, None, None)),
        f"{prefix}_preferred_affinity": (ct, (pb.paff_sel, pb.pod_ns,
                                              pb.paff_ns_explicit,
                                              pb.paff_ns_mask)),
    }


def drain_count_cases(drain):
    """count_pn's inputs as the drain's last batch meets them in its first
    round: the spread and preferred affinity terms of that batch over the
    existing-pod tensors with every earlier batch's committed pods valid
    (PT = 1024·T, E = e0 + 10·1024, N = 8192)."""
    import torch
    from kubernetes_tpu_torch.models.gang import _batch
    ct_all, pb_stack, e0 = drain["plan"]
    B, P = pb_stack.pod_valid.shape
    a = torch.as_tensor(drain["assignments"], device=ct_all.epod_node.device)
    node = ct_all.epod_node.clone()
    valid = ct_all.epod_valid.clone()
    node[e0:] = a.reshape(-1)
    valid[e0:e0 + (B - 1) * P] = a[:B - 1].reshape(-1) >= 0
    ct = ct_all.replace(epod_node=node, epod_valid=valid)
    return _term_cases("drain", ct, _batch(pb_stack, B - 1))


def resident_count_cases(drv):
    """count_pn's inputs as the resident drain's first batch meets them in
    its first round: the folded context after the resident cycles (E = e0 +
    B·P = 32768 + 8·256, every fold valid, the extension rows not; N =
    8192) and the spread and preferred affinity terms of the last cycle's
    first batch, padded to the context's shapes (PT = 256·T)."""
    from kubernetes_tpu_torch.models.gang import _batch
    ct = drv.ctx["ct"]
    return _term_cases("resident", ct,
                       _batch(drv.last_stack.to(ct.epod_valid.device), 0))


# ------------------------------------------------------------------ resident

RESIDENT_B = 8       # SchedulerConfiguration.max_drain_batches default
RESIDENT_P = BATCH   # SchedulerConfiguration.batch_size default
RESIDENT_CYCLES = 8


def resident_workload(n_nodes=N_NODES, n_bound=N_BOUND,
                      cycles=RESIDENT_CYCLES, per_cycle=RESIDENT_B * RESIDENT_P,
                      seed=SEED):
    """-> (node dicts, bound pod dicts, [pending pods per cycle]): the path
    phase's cluster, and one drain's worth of pending pods for the arming
    sample, each cycle and the profiled cycle."""
    node_dicts, bound, batches = workload(
        n_nodes=n_nodes, n_bound=n_bound, n_requests=cycles + 2,
        batch=per_cycle, seed=seed)
    return node_dicts, bound, batches


def _churn(cache, i, live_nodes, live_pods):
    """scheduler_perf's Recreate churn (``benchmarks/connected.py``
    ``_churn_loop``): a 2-cpu node and a foreign pod bound to it; past 3
    live, the oldest node and the oldest pod go."""
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
    cache.add_node(make_node(f"churn-n{i}").capacity(
        {"cpu": "2", "memory": "4Gi", "pods": "8"}).obj())
    live_nodes.append(f"churn-n{i}")
    cache.add_pod(make_pod(f"churn-p{i}", "churn").req({"cpu": "100m"})
                  .node(f"churn-n{i}").obj())
    live_pods.append(f"churn/churn-p{i}")
    if len(live_nodes) > 3:
        cache.remove_node(live_nodes.pop(0))
    if len(live_pods) > 3:
        cache.remove_pod(live_pods.pop(0))


def recount(drv):
    """The resident context against a host recount from the cache: on every
    live node's row, ``requested`` equals the summed requests of the
    cache's bound and assumed pods there and the valid epod slots equal
    their number; every valid slot is one the patch state knows."""
    import numpy as np
    ctx, cache = drv.ctx, drv.cache
    cs = ctx["cs"]
    live = {n.metadata.name for n in cache.list_nodes()}
    rows = {name: cs.node_index[name] for name in live}
    want = np.zeros((ctx["ct"].requested.shape[0], len(cs.resources)),
                    np.int64)
    count = np.zeros(want.shape[0], np.int64)
    for p in cache.bound_pods():
        row = rows.get(p.spec.node_name)
        if row is not None:
            want[row] += cache.request_vector(p, cs.resources)
            count[row] += 1
    idx = np.array(sorted(rows.values()))
    requested = ctx["ct"].requested.cpu().numpy()
    valid = ctx["ct"].epod_valid.cpu().numpy()
    node = ctx["ct"].epod_node.cpu().numpy()
    got_count = np.bincount(node[valid], minlength=want.shape[0])
    check(np.array_equal(requested[idx], want[idx]),
          "resident: folded requested differs from the host recount")
    check(np.array_equal(got_count[idx], count[idx]),
          "resident: valid epod slots differ from the host recount")
    check(int(valid.sum()) == len(cs.slot_of),
          "resident: valid epod slots differ from the patch state's")
    return int(count[idx].sum())


def resident_phase(node_dicts, bound, pending, device=None, B=RESIDENT_B,
                   P=RESIDENT_P, cycles=RESIDENT_CYCLES):
    """The connected steady state through testing/resident.py: a
    SchedulerCache of the path's cluster, a context armed with B x P, then
    ``cycles`` cycles of Recreate churn + one fused drain_step of B x P
    pending pods each, every one checked against a host recount. 0
    rebuilds after the arming build, and a compiled patch in every
    cycle. -> (summary, harness, churn state)."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.cache import SchedulerCache
    from kubernetes_tpu_torch.testing.resident import ResidentDrain
    cache = SchedulerCache()
    for d in node_dicts:
        cache.add_node(Node.from_dict(d))
    for d in bound:
        cache.add_pod(Pod.from_dict(d))
    drv = ResidentDrain(cache, batch_size=P, max_drain_batches=B,
                        slot_headroom=(cycles + 1) * B * P + 64,
                        device=device)
    t0 = time.perf_counter()
    drv.arm([Pod.from_dict(d) for d in pending[0]])
    arm_s = time.perf_counter() - t0
    churn = ([], [])
    rows = []
    kernels.reset_launches()
    for i in range(cycles):
        _churn(cache, i, *churn)
        out = drv.cycle([Pod.from_dict(d) for d in pending[i + 1]])
        cs = drv.ctx["cs"]
        row = {"cycle": i, "ms": out.ms, "drain_ms": out.drain_ms,
               "pods": len(pending[i + 1]), "placed": len(out.placed),
               "rounds": out.rounds, "patch": out.patched,
               "rebuilds": drv.stats["rebuilds"], "fill_host": cs.fill_host,
               "top": cs.top, "recounted_pods": recount(drv)}
        emit({"phase": "resident.cycle", **row})
        rows.append(row)
        check(out.patched, f"resident: cycle {i} compiled no patch")
        check(drv.stats["rebuilds"] == 0,
              f"resident: the context rebuilt at cycle {i}: "
              f"{drv.stats['reasons']}")
    launches = dict(kernels.LAUNCHES)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched in the resident "
                     f"cycles")
    placed = sum(r["placed"] for r in rows)
    pods = sum(r["pods"] for r in rows)
    check(placed >= 0.9 * pods, f"resident: only {placed} of {pods} placed")
    return ({"nodes": len(node_dicts), "bound": len(bound), "B": B, "P": P,
             "cycles": cycles, "arm_s": arm_s, "placed": placed,
             "pods": pods, "rebuilds": drv.stats["rebuilds"],
             "folds": drv.stats["folds"], "launches": launches,
             "e0": drv.ctx["e0"]}, drv, churn)


# cycles of drain_parity_phase that must fold behind a fused churn patch
PARITY_PATCHED = 5


def drain_parity_phase(seed=SEED, devices=("cuda", "cpu")):
    """The resident drain with churn on a small relational_mix cluster, on
    the card and on the CPU: each cycle's placements, rounds, new_fill and
    the folded requested/epod_valid/epod_node must be equal. Cycles 0-3
    drain relational_mix's pending pods (the host-port pods among them
    taint the fold, so the next cycle rebuilds); cycles 4-8 drain its
    pods with no host port and no volume, so after one rebuild each of
    them folds behind a fused patch. At least PARITY_PATCHED cycles must
    place pods behind a compiled patch."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.sched.cache import SchedulerCache
    from kubernetes_tpu_torch.testing.resident import ResidentDrain
    from kubernetes_tpu_torch.testing.workloads import relational_mix
    # the generator draws pod by pod: the first 144 pending pods do not
    # depend on the count
    nodes, bound, pending, ns_labels = relational_mix(pods=4 * 32 + 16 + 200,
                                                      nodes=32, seed=seed)
    pending = [Pod.from_dict(p.to_dict()) for p in pending]
    clean = [p for p in pending[4 * 32 + 16:]
             if not p.host_ports() and not p.spec.volumes]
    cycles = ([pending[16 + 32 * i:16 + 32 * (i + 1)] for i in range(4)]
              + [clean[32 * i:32 * (i + 1)] for i in range(5)])
    check(all(len(c) == 32 for c in cycles), "drain parity: too few pods")
    runs = []
    for device in devices:
        cache = SchedulerCache()
        for name, labels in ns_labels.items():
            cache.update_namespace({"metadata": {"name": name,
                                                 "labels": labels}})
        for n in nodes:
            cache.add_node(Node.from_dict(n.to_dict()))
        for p in bound:
            cache.add_pod(Pod.from_dict(p.to_dict()))
        drv = ResidentDrain(cache, batch_size=16, max_drain_batches=2,
                            slot_headroom=len(cycles) * 32 + 64,
                            device=device)
        drv.arm(pending[:32])
        churn, log = ([], []), []
        for i, pods in enumerate(cycles):
            _churn(cache, i, *churn)
            out = drv.cycle(pods)
            ct = drv.ctx["ct"]
            log.append((out.placed, out.rounds, int(drv.ctx["fill_dev"]),
                        out.patched, ct.requested.cpu().tolist(),
                        ct.epod_valid.cpu().tolist(),
                        ct.epod_node.cpu().tolist()))
        runs.append(log)
    check(all(run == runs[0] for run in runs),
          "drain parity: the card's resident drain differs from the CPU's")
    folded = sum(1 for c in runs[0] if c[3] and c[0])
    check(folded >= PARITY_PATCHED,
          f"drain parity: {folded} cycles placed pods behind a fused patch, "
          f"fewer than {PARITY_PATCHED}")
    return {"cycles": len(runs[0]), "placed": [len(c[0]) for c in runs[0]],
            "fill": [c[2] for c in runs[0]],
            "patched": [c[3] for c in runs[0]],
            "patched_folds_compared": folded}


def profile_drain_phase(drv, churn, pods, i):
    """One more resident cycle (churn, fused patch, drain_step of B x P)
    under torch.profiler: the device's busy share of the drain and of the
    cycle, and ``trace_summary`` of the trace (kept under build/profile/)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.api.types import Pod
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "resident_drain.json")
    pods = [Pod.from_dict(d) for d in pods]
    _churn(drv.cache, i, *churn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = drv.cycle(pods)
        torch.cuda.synchronize()
    check(out.patched and not out.rebuilt,
          "profiled resident cycle: no fused patch, or a rebuild")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        summary = trace_summary(json.load(f)["traceEvents"])
    check(summary["device_ops"] > 0,
          "profiled resident cycle: the trace holds no device time")
    return {"pods": len(pods), "placed": len(out.placed),
            "rounds": out.rounds, "cycle_ms": out.ms,
            "drain_ms": out.drain_ms,
            "device_busy_share_of_drain":
                summary["device_busy_ms"] / out.drain_ms,
            "device_busy_share_of_cycle": summary["device_busy_ms"] / out.ms,
            **summary, "trace": os.path.relpath(trace_path)}


# ------------------------------------------------------------------ scheduler

SCHED_PODS = 10000   # the north star: MixedHeterogeneous/10000Pods5000Nodes
SCHED_PROFILED = 2048  # one more pop's worth of pods for profile.scheduler


def sched_config(**overrides):
    """The port's SchedulerConfiguration: the reference defaults (batch_size
    256, max_drain_batches 8, pipeline_depth 2, fused fold and staging on)
    with the explainer off (the port refuses it: a later slice) and, unless
    ``overrides`` names it, the parity sentinel off (as the scheduler phase
    has measured the loop since it was ported)."""
    from kubernetes_tpu_torch.config.types import (SchedulerConfiguration,
                                                   validate)
    cfg = SchedulerConfiguration(**dict(
        dict(explainer_enabled=False, parity_sample_every=0), **overrides))
    validate(cfg)
    return cfg


def no_preemption_gate():
    """PreemptionSimulation off: default preemption is a later slice."""
    from kubernetes_tpu_torch.config.features import FeatureGate
    gate = FeatureGate()
    gate.set("PreemptionSimulation", False)
    return gate


def make_scheduler(cfg, node_objs, bound_objs=(), ns_labels=None,
                   device=None, confirm=True):
    """A port Scheduler over a fresh SchedulerCache and SchedulingQueue,
    PreemptionSimulation off (default preemption is a later slice), and an
    in-process binder that logs (pod key, node, seconds) and, with
    ``confirm``, confirms the binding in the cache as the runner's informer
    would. -> (scheduler, binder log)."""
    import dataclasses
    from kubernetes_tpu_torch.sched.cache import SchedulerCache
    from kubernetes_tpu_torch.sched.queue import SchedulingQueue
    from kubernetes_tpu_torch.sched.scheduler import Scheduler
    cache = SchedulerCache(assume_ttl=3600.0)
    for name, labels in (ns_labels or {}).items():
        cache.update_namespace({"metadata": {"name": name, "labels": labels}})
    for n in node_objs:
        cache.add_node(n)
    for p in bound_objs:
        cache.add_pod(p)
    # backoff beyond the run: a pod that fails stays out of later pops
    queue = SchedulingQueue(backoff_initial=3600.0, backoff_max=3600.0)
    log = []

    def binder(pod, node):
        log.append((pod.key, node, time.perf_counter()))
        if confirm:
            cache.add_pod(dataclasses.replace(
                pod, spec=dataclasses.replace(pod.spec, node_name=node)))
        return True

    sched = Scheduler(cfg, cache, queue, binder,
                      feature_gate=no_preemption_gate(), device=device)
    return sched, log


def sched_parity_phase(seed=SEED, devices=("cuda", "cpu"), depths=(1, 2)):
    """The port's Scheduler over a small relational_mix cluster with churn
    between pops (Recreate churn, a nominee held from the first pop and
    cleared at the fourth), on each device, at each pipeline depth: the
    binder logs (pod -> node), ctx_stats and the folded requested,
    epod_valid and epod_node must be equal on every device. In-flight
    drains resolve only at the depth bound and the pipeline's own drains
    (``_drain_ready`` is held False), so both devices resolve at the same
    points, as in tests/test_torch_sched.py."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.testing.workloads import relational_mix
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    nodes, bound, pending, ns_labels = relational_mix(pods=160, nodes=16,
                                                      bound=12, seed=seed)
    clean = [p for p in pending[16:]
             if not p.host_ports() and not p.spec.volumes]
    pods = [p.to_dict() for p in pending[:16] + clean[:64]]
    nominee = make_pod("nominee", "churn").req({"cpu": "3"}).obj()
    out = {}
    for depth in depths:
        runs = {}
        for device in devices:
            sched, log = make_scheduler(
                sched_config(batch_size=8, max_drain_batches=2,
                             pipeline_depth=depth),
                [Node.from_dict(n.to_dict()) for n in nodes],
                [Pod.from_dict(p.to_dict()) for p in bound], ns_labels,
                device=device, confirm=False)
            sched._drain_ready = lambda pend: False
            try:
                check(sched.warm_drain([Pod.from_dict(d) for d in pods[:16]],
                                       slot_headroom=256),
                      "scheduler parity: the context did not arm")
                for d in pods:
                    sched.queue.add(Pod.from_dict(d))
                churn = ([], [])
                for i in range(10):
                    if i < 6:
                        if i in (0, 3):
                            sched.nominate_external(nominee,
                                                    "node-0" if i == 0 else "")
                        _churn(sched.cache, i, *churn)
                    sched.run_once(wait=0.01)
                sched._resolve_pending()
                sched.wait_for_bindings()
                ctx = sched._drain_ctx
                ct = ctx["ct"]
                runs[device] = {
                    "log": {k: n for k, n, _t in log},
                    "ctx_stats": json.loads(json.dumps(sched.ctx_stats)),
                    "fill_host": ctx["cs"].fill_host, "top": ctx["cs"].top,
                    "fill_bound": ctx["fill_bound"],
                    "requested": ct.requested.cpu().tolist(),
                    "epod_valid": ct.epod_valid.cpu().tolist(),
                    "epod_node": ct.epod_node.cpu().tolist()}
            finally:
                sched.close()
        first = runs[devices[0]]
        for device in devices[1:]:
            for key, value in first.items():
                check(runs[device][key] == value,
                      f"scheduler parity at depth {depth}: {key} on "
                      f"{devices[0]} differs from {device}")
        check(first["fill_bound"] == first["fill_host"],
              f"scheduler parity at depth {depth}: fill_bound "
              f"{first['fill_bound']} != fill_host {first['fill_host']}")
        check(first["ctx_stats"]["folds"] >= 3 and len(first["log"]) >= 40,
              f"scheduler parity at depth {depth}: too little folded "
              f"({first['ctx_stats']}, {len(first['log'])} placed)")
        out[f"depth_{depth}"] = {"placed": len(first["log"]),
                                 "ctx_stats": first["ctx_stats"],
                                 "fill_host": first["fill_host"]}
    return out


def sched_workload(pods=SCHED_PODS + SCHED_PROFILED, nodes=N_NODES,
                   seed=SEED):
    """MixedHeterogeneous/10000Pods5000Nodes and one more pop for the
    profiled cycle. -> (node dicts, [measured pod dicts], [profiled])."""
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    node_objs, pod_objs = mixed_heterogeneous(pods=pods, nodes=nodes,
                                              seed=seed)
    dicts = [p.to_dict() for p in pod_objs]
    return ([n.to_dict() for n in node_objs], dicts[:SCHED_PODS],
            dicts[SCHED_PODS:])


def _cycles(cycle_log):
    """cycle_log entries -> one dict per drain: pods, and the ms from the
    cycle's start to each mark (encode, dispatch, dispatched, resolved)."""
    return [{"pods": n, **{k: v * 1e3 for k, v in marks.items()}}
            for n, _t0, marks in cycle_log]


def scheduler_phase(node_dicts, pod_dicts, device=None, smi=""):
    """The north star through the port's Scheduler: warm_drain on the first
    pop's pods, then every pod into the queue and run_once until the queue
    is empty and the pipeline has resolved, with the Recreate churn applied
    to the cache before every pop. The window runs from the first
    queue.add to the last binding in the binder's log. The placements are
    checked; at least 90% placed; the breaker still "single", no loop
    error, no pod through the oracle, no separate patch dispatch (fused
    fold). The loop's tracer spans over the window are summed by name
    (count, total and longest ms). -> (summary, scheduler, churn
    state)."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.metrics.registry import (ATTEMPT_DURATION,
                                                       LOOP_ERRORS)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.utils.tracing import TRACER
    cfg = sched_config()
    sched, log = make_scheduler(cfg, [Node.from_dict(d) for d in node_dicts],
                                device=device)
    oracle_pods = []
    to_oracle = sched._schedule_oracle

    def counted_oracle(profile, items):
        oracle_pods.append(len(items))
        return to_oracle(profile, items)

    sched._schedule_oracle = counted_oracle
    sched.cycle_log = []
    pods = [Pod.from_dict(d) for d in pod_dicts]
    pop = cfg.batch_size * cfg.max_drain_batches
    t0 = time.perf_counter()
    check(sched.warm_drain(pods[:pop], slot_headroom=len(pods) + 2 * pop),
          "scheduler: warm_drain did not arm the context")
    warm_s = time.perf_counter() - t0
    errors0 = sum(LOOP_ERRORS.items().values())
    ATTEMPT_DURATION.reset()
    TRACER.reset()
    kernels.reset_launches()
    churn = ([], [])
    pops = 0
    t_start = time.perf_counter()
    for p in pods:
        sched.queue.add(p)
    while True:
        _churn(sched.cache, pops, *churn)
        sched.run_once(wait=0.05)
        pops += 1
        if (not sched._pending and not sched._staged
                and sched.queue.stats()["active"] == 0):
            break
        check(pops < 100, "scheduler: the queue did not drain in 100 pops")
    sched._resolve_pending()
    sched.wait_for_bindings(timeout=120.0)
    t_end = max((t for _k, _n, t in log), default=t_start)
    launches = dict(kernels.LAUNCHES)
    errors = sum(LOOP_ERRORS.items().values()) - errors0
    window_s = t_end - t_start
    spans = {}
    for sp in TRACER.spans():
        agg = spans.setdefault(sp.name, {"count": 0, "total_ms": 0.0,
                                         "max_ms": 0.0})
        agg["count"] += 1
        agg["total_ms"] += sp.duration_ms
        agg["max_ms"] = max(agg["max_ms"], sp.duration_ms)
    placed = {k: n for k, n, _t in log}
    check(len(placed) == len(log), "scheduler: a pod was bound twice")
    by_key = {d["metadata"].get("namespace", "default") + "/"
              + d["metadata"]["name"]: d for d in pod_dicts}
    placed_dicts = []
    for key, node in placed.items():
        d = dict(by_key[key])
        d["spec"] = dict(d["spec"], nodeName=node)
        placed_dicts.append(d)
    churn_nodes = [{"metadata": {"name": f"churn-n{i}"},
                    "status": {"allocatable": {"cpu": "2", "memory": "4Gi",
                                               "pods": "8"}}}
                   for i in range(pops)]
    check_placements(node_dicts + churn_nodes, [], placed_dicts, len(pods))
    stats = sched.ctx_stats
    check(sched.breaker.mode == "single",
          f"scheduler: the breaker degraded to {sched.breaker.mode!r}")
    check(errors == 0, f"scheduler: {errors} loop errors")
    check(not oracle_pods, f"scheduler: {sum(oracle_pods)} pods went "
                           "through the numpy oracle")
    check(stats["patches"] == 0,
          f"scheduler: {stats['patches']} separate patch dispatches in "
          "fused mode (the fusion degraded)")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched by the scheduler")
    q = {"result": "scheduled"}
    return ({"pods": len(pods), "nodes": len(node_dicts), "pops": pops,
             "scheduled": len(placed), "warm_drain_s": warm_s,
             "window_s": window_s, "pods_per_s": len(placed) / window_s,
             "attempt_p50_s": ATTEMPT_DURATION.percentile(0.5, q),
             "attempt_p99_s": ATTEMPT_DURATION.percentile(0.99, q),
             "attempts_observed": ATTEMPT_DURATION.count(q),
             "north_star_p99_under_1s":
                 ATTEMPT_DURATION.percentile(0.99, q) < 1.0,
             "cycles": _cycles(sched.cycle_log), "spans": spans,
             "spans_dropped": TRACER.dropped,
             "ctx_stats": stats, "staging": sched.cache.staging_stats(),
             "encode_cache": sched.cache.encode_cache_stats(),
             "breaker": sched.breaker.mode, "loop_errors": errors,
             "oracle_pods": sum(oracle_pods), "launches": launches,
             "card": smi}, sched, churn)


def scheduler_count_cases(sched, pod_dicts, prefix="scheduler"):
    """count_pn's inputs as the scheduler's resident drain meets them: the
    folded context after the run (E = e0 + B·P, N = 8192) and the spread
    and preferred affinity terms of a batch encoded against the context's
    meta and padded to its batch shapes."""
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.models.gang import (_batch, pad_batch_to,
                                                  stack_batches)
    ctx = sched._drain_ctx
    ct = ctx["ct"]
    P = sched.cfg.batch_size
    pb = sched.cache.encode_pods([Pod.from_dict(d) for d in pod_dicts[:P]],
                                 ctx["meta"], min_p=P)
    stack = pad_batch_to(stack_batches([pb] * sched.cfg.max_drain_batches),
                         ctx["pb_shape"])
    check(stack is not None, "scheduler: the batch exceeds the context")
    return _term_cases(prefix, ct,
                       _batch(stack.to(ct.epod_valid.device), 0))


def profile_scheduler_phase(sched, churn, pod_dicts, i):
    """One more pop (churn, then run_once of B x P pods until its bindings
    land) under torch.profiler: the device's busy share of the whole
    cycle, assume and bind included, and ``trace_summary`` of the trace
    (kept under build/profile/)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.api.types import Pod
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "scheduler_cycle.json")
    for d in pod_dicts:
        sched.queue.add(Pod.from_dict(d))
    _churn(sched.cache, i, *churn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bound = sched.run_once(wait=0.05)
        bound += sched._resolve_pending()
        sched.wait_for_bindings(timeout=60.0)
        torch.cuda.synchronize()
        cycle_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        summary = trace_summary(json.load(f)["traceEvents"])
    check(summary["device_ops"] > 0,
          "profiled scheduler cycle: the trace holds no device time")
    return {"pods": len(pod_dicts), "bound": bound, "cycle_ms": cycle_ms,
            "device_busy_share_of_cycle": summary["device_busy_ms"]
            / cycle_ms, **summary, "trace": os.path.relpath(trace_path)}


# ------------------------------------------------------------------ connected

CONNECTED_PODS = 10000   # Connected/10000Pods5000Nodes (bench.py's case)
CONNECTED_BATCH = 512    # benchmarks/connected.py run_connected's defaults
CONNECTED_DRAIN_BATCHES = 2
CONNECTED_CHUNK = 2500   # concurrent bulk creates, as run_connected makes
CONNECTED_TIMEOUT_S = 300.0
CONNECTED_PARITY_EVERY = 4   # the reference's chaos runs sample this densely
CONNECTED_AUDIT_S = 2.0


def connected_workload(pods=CONNECTED_PODS, nodes=N_NODES, seed=SEED):
    """MixedHeterogeneous/10000Pods5000Nodes as wire dicts, without the
    wrappers' process-local uids (the store stamps its own). -> (node
    dicts, pod dicts)."""
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    node_objs, pod_objs = mixed_heterogeneous(pods=pods, nodes=nodes,
                                              seed=seed)
    out = []
    for objs in (node_objs, pod_objs):
        dicts = [o.to_dict() for o in objs]
        for d in dicts:
            d["metadata"].pop("uid", None)
        out.append(dicts)
    return tuple(out)


def watch_bound(url, ns, rv0, n_pods, count, done, dead, ready):
    """Watcher process: count the pods whose nodeName got set (one event
    per binding). Its JSON decode burns its own interpreter, not the
    scheduler's."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    client = HTTPClient(url, timeout=30.0, wire="json")
    seen = set()
    try:
        w = client.pods(ns).watch(since_rv=rv0)
        ready.set()
        for ev in w:
            if (ev.object or {}).get("spec", {}).get("nodeName"):
                seen.add(ev.object["metadata"]["name"])
                count.value = len(seen)
                if len(seen) >= n_pods:
                    done.set()
                    return
    except Exception:
        import traceback
        traceback.print_exc()
    dead.set()


def start_apiserver(ctx):
    """The port's APIServer in its own process (spawned: this process holds
    a CUDA context and must not fork). -> (process, stop pipe, url)."""
    from kubernetes_tpu_torch.store.apiserver import serve
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=serve, args=(child,), daemon=True)
    proc.start()
    check(parent.poll(120.0), "connected: the apiserver did not start")
    return proc, parent, f"http://127.0.0.1:{parent.recv()}"


def stop_process(proc, pipe=None) -> None:
    if pipe is not None:
        try:
            pipe.send("stop")
        except (OSError, EOFError):
            pass
    proc.join(10.0)
    if proc.is_alive():
        proc.terminate()
        proc.join(10.0)


def _span_totals(t0=None):
    """Tracer spans by name: count, total and longest ms, and with ``t0``
    (a time.time()) the seconds from it to the last span's end."""
    from kubernetes_tpu_torch.utils.tracing import TRACER
    spans = {}
    for sp in TRACER.spans():
        agg = spans.setdefault(sp.name, {"count": 0, "total_ms": 0.0,
                                         "max_ms": 0.0, "end": sp.end})
        agg["count"] += 1
        agg["total_ms"] += sp.duration_ms
        agg["max_ms"] = max(agg["max_ms"], sp.duration_ms)
        agg["end"] = max(agg["end"], sp.end)
    for agg in spans.values():
        end = agg.pop("end")
        if t0 is not None:
            agg["last_end_s"] = end - t0
    return spans


def connected_phase(node_dicts, pod_dicts, device=None, smi=""):
    """Connected/10000Pods5000Nodes as ``benchmarks/connected.py``
    run_connected runs it (its ``explain=False`` leg), through the port: an
    APIServer in a spawned process, the nodes seeded with one bulk create,
    ``SchedulerRunner(HTTPClient(url, wire="json"))`` with pops of 2 x 512,
    pipeline depth 2, fused fold and staging, the parity sentinel every
    4th drain and a fail-fast auditor on a clean client every 2 s;
    informers synced with the loop stopped,
    ``warm_drain``, then the pods created in concurrent chunks of 2500 and
    the loop started. A watcher process counts the bound pods. The window
    runs from the first create to the last bound event. Gates: every pod
    bound within the timeout, the placements checked, breaker "single", 0
    pods through the oracle, 0 loop errors, at least one audit sweep with
    0 violations, at least one sentinel sample and 0 divergences. The
    pods through the oracle and the seconds of the other threads (pod
    handler, audit sweeps, sentinel checks) are read from the tracer's
    spans. -> (summary, stopped runner)."""
    import multiprocessing as mp
    from concurrent.futures import ThreadPoolExecutor
    from kubernetes_tpu_torch.audit.auditor import (InvariantAuditor,
                                                    InvariantViolationError)
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.metrics.registry import (ATTEMPT_DURATION,
                                                       E2E_SCHEDULING,
                                                       LOOP_ERRORS)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.utils.tracing import FLIGHT, TRACER
    ctx = mp.get_context("spawn")
    server, server_pipe, url = start_apiserver(ctx)
    watcher = runner = None
    try:
        seed_client = HTTPClient(url, timeout=120.0, wire="json")
        t0 = time.perf_counter()
        seed_client.nodes().create_many(node_dicts)
        seed_s = time.perf_counter() - t0
        cfg = sched_config(batch_size=CONNECTED_BATCH,
                           max_drain_batches=CONNECTED_DRAIN_BATCHES,
                           parity_sample_every=CONNECTED_PARITY_EVERY,
                           audit_interval_s=CONNECTED_AUDIT_S,
                           audit_fail_fast=True)
        runner = SchedulerRunner(HTTPClient(url, wire="json"), cfg,
                                 feature_gate=no_preemption_gate(),
                                 device=device)
        # fail-fast audit over a CLEAN client, as run_connected's
        # _bench_auditor: the scheduler's transport is not the auditor's
        runner.auditor = InvariantAuditor(
            client=HTTPClient(url, timeout=60.0, wire="json"),
            cache=runner.cache, scheduler=runner.scheduler,
            interval_s=CONNECTED_AUDIT_S, fail_fast=True,
            pre_sweep=runner.sweep_stale_nominations,
            post_sweep=runner.publish_status,
            relists=runner._total_relists)
        t0 = time.perf_counter()
        runner.start(wait_sync=120.0, start_loop=False)
        check(runner.has_synced(), "connected: the informers did not sync")
        sync_s = time.perf_counter() - t0
        from kubernetes_tpu_torch.api.types import Pod
        pods = [Pod.from_dict(d) for d in pod_dicts]
        pop = CONNECTED_BATCH * CONNECTED_DRAIN_BATCHES
        t0 = time.perf_counter()
        check(runner.scheduler.warm_drain(pods, slot_headroom=len(pods)
                                          + pop),
              "connected: warm_drain did not arm the context")
        warm_s = time.perf_counter() - t0
        del pods

        _, rv0 = seed_client.pods("default").list_rv()
        count = ctx.Value("i", 0)
        all_bound, watch_dead, ready = ctx.Event(), ctx.Event(), ctx.Event()
        watcher = ctx.Process(target=watch_bound,
                              args=(url, "default", rv0, len(pod_dicts),
                                    count, all_bound, watch_dead, ready),
                              daemon=True)
        watcher.start()
        check(ready.wait(120.0), "connected: the watcher did not start")

        errors0 = sum(LOOP_ERRORS.items().values())
        ATTEMPT_DURATION.reset()
        E2E_SCHEDULING.reset()
        FLIGHT.reset()
        # every pod's timeline kept: E2E_SCHEDULING is derived from them
        FLIGHT.max_pods = max(FLIGHT.max_pods, 2 * len(pod_dicts))
        # the window's spans all kept: one per pod watch event (two events
        # a pod), the loop's and the binds', the sweeps' and the checks'
        TRACER.max_spans = max(TRACER.max_spans, 8 * len(pod_dicts))
        TRACER.reset()
        enc0 = runner.cache.encode_cache_stats()
        kernels.reset_launches()
        jobs = [pod_dicts[i:i + CONNECTED_CHUNK]
                for i in range(0, len(pod_dicts), CONNECTED_CHUNK)]
        t_start, t_start_wall = time.perf_counter(), time.time()
        with ThreadPoolExecutor(max_workers=min(4, len(jobs))) as pool:
            list(pool.map(lambda objs: seed_client.pods("default")
                          .create_many(objs), jobs))
        t_created = time.perf_counter()
        enc_created = runner.cache.encode_cache_stats()
        runner.start_loop()
        deadline = t_start + CONNECTED_TIMEOUT_S
        milestones = {}
        completed = False
        while time.perf_counter() < deadline:
            n = count.value
            for frac in (0.25, 0.5, 0.75):
                if n >= len(pod_dicts) * frac and frac not in milestones:
                    milestones[frac] = time.perf_counter() - t_start
            if all_bound.wait(timeout=0.02):
                completed = True
                break
            check(runner.loop_error is None,
                  f"connected: the scheduling loop died: "
                  f"{runner.loop_error!r}")
            check(not watch_dead.is_set(), "connected: the watcher died")
        window_s = time.perf_counter() - t_start
        check(completed, f"connected: {count.value} of {len(pod_dicts)} "
                         f"pods bound in {CONNECTED_TIMEOUT_S} s")
        q = {"result": "scheduled"}
        launches = dict(kernels.LAUNCHES)
        spans = _span_totals(t_start_wall)
        oracle_pods = sum(sp.attributes["pods"]
                          for sp in TRACER.spans("scheduler/oracle"))
        enc = runner.cache.encode_cache_stats()
        errors = sum(LOOP_ERRORS.items().values()) - errors0
        ctx_stats = json.loads(json.dumps(runner.scheduler.ctx_stats))
        summary = {
            "pods": len(pod_dicts), "nodes": len(node_dicts),
            "bound": count.value, "window_s": window_s,
            "pods_per_s": count.value / window_s,
            "create_s": t_created - t_start, "bound_frac_s": milestones,
            "seed_nodes_s": seed_s, "informer_sync_s": sync_s,
            "warm_drain_s": warm_s,
            "attempt_p50_s": ATTEMPT_DURATION.percentile(0.5, q),
            "attempt_p99_s": ATTEMPT_DURATION.percentile(0.99, q),
            "attempts_observed": ATTEMPT_DURATION.count(q),
            "e2e_p50_s": E2E_SCHEDULING.percentile(0.5),
            "e2e_p99_s": E2E_SCHEDULING.percentile(0.99),
            "e2e_observed": E2E_SCHEDULING.count(),
            "north_star_p99_under_1s":
                ATTEMPT_DURATION.percentile(0.99, q) < 1.0,
            # runner/pod_*, audit/sweep and sentinel/check are the other
            # consumers of the one interpreter, each on its own thread
            "spans": spans, "spans_dropped": TRACER.dropped,
            # pops' encode against the informer-time compile cache: hits
            # are rows compiled on the watch thread; the window's misses
            # were compiled on the scheduling thread
            "encode_cache_window": {k: enc[k] - enc0[k] for k in enc},
            "encode_cache_by_create_end": {k: enc_created[k] - enc0[k]
                                           for k in enc},
            "ctx_stats": ctx_stats,
            "staging": runner.cache.staging_stats(),
            "breaker": runner.scheduler.breaker.mode,
            "breaker_trip_reasons": dict(
                runner.scheduler.breaker.trip_reasons),
            "loop_errors": errors, "oracle_pods": oracle_pods,
            "relists": runner._total_relists(),
            "launches": launches, "card": smi}
        # the settle: the sentinel's verdicts land (bounded), the auditor
        # stops and sweeps twice more (confirm-2 invariants need two looks)
        sentinel = runner.scheduler.sentinel
        sentinel.drain(120.0)
        summary["sentinel_backlog"] = sentinel._q.unfinished_tasks
        runner.auditor.stop()
        for _ in range(2):
            try:
                runner.auditor.run_once()
            except InvariantViolationError:
                pass  # counted below
        audit = runner.auditor.status()
        summary["audit"] = {k: audit[k] for k in ("sweeps", "violations",
                                                  "byInvariant", "failed")}
        summary["sentinel"] = sentinel.stats()
        bindings = {p["metadata"]["name"]: p["spec"].get("nodeName", "")
                    for p in seed_client.pods("default").list()}
    finally:
        if runner is not None:
            runner.stop()  # re-raises a KernelError that ended the loop
        if watcher is not None:
            stop_process(watcher)
        stop_process(server, server_pipe)
    placed = []
    for d in pod_dicts:
        node = bindings.get(d["metadata"]["name"], "")
        if node:
            placed.append(dict(d, spec=dict(d["spec"], nodeName=node)))
    check(len(placed) == len(pod_dicts),
          f"connected: {len(placed)} of {len(pod_dicts)} pods bound in the "
          "store")
    check_placements(node_dicts, [], placed, len(pod_dicts))
    check(summary["breaker"] == "single",
          f"connected: the breaker degraded to {summary['breaker']!r} "
          f"({summary['breaker_trip_reasons']})")
    check(summary["spans_dropped"] == 0,
          f"connected: the tracer dropped {summary['spans_dropped']} spans "
          "of the window")
    check(summary["oracle_pods"] == 0,
          f"connected: {summary['oracle_pods']} pods went through the oracle")
    check(summary["loop_errors"] == 0,
          f"connected: {summary['loop_errors']} loop errors")
    check(summary["audit"]["sweeps"] >= 1, "connected: the auditor never swept")
    check(summary["audit"]["violations"] == 0,
          f"connected: invariant violations {summary['audit']['byInvariant']}")
    check(summary["sentinel"]["samples"]["drain"] >= 1,
          "connected: the sentinel took no sample")
    check(summary["sentinel"]["divergences"] == 0,
          f"connected: parity divergence {summary['sentinel']}")
    check(summary["sentinel_backlog"] == 0,
          "connected: the sentinel's verdicts did not land in 120 s")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched by the connected "
                     "scheduler")
    return summary, runner


def connected_parity_phase(seed=SEED, devices=("cuda", "cpu"), depths=(1, 2)):
    """The port's runner over a DirectClient, on each device, at each
    pipeline depth, on two small clusters: ``relational_mix`` (24 nodes,
    required and preferred pod (anti-)affinity, hard and soft spread) and
    MixedHeterogeneous (32 nodes x 192 pods, soft spread). Informers synced
    with the loop stopped, then run_once until the queue and the pipeline
    are empty, the parity sentinel sampling every drain (its verdicts
    landed after each pop). The store's bindings, ctx_stats, the
    sentinel's samples and divergences and the breaker's mode must be equal
    on every device, with at least one sample and 0 divergences. In-flight
    drains resolve only at the depth bound, as in sched_parity_phase."""
    from kubernetes_tpu_torch.client.clientset import DirectClient
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.store.store import ObjectStore
    from kubernetes_tpu_torch.testing.workloads import (mixed_heterogeneous,
                                                        relational_mix)
    m_nodes, m_pending = mixed_heterogeneous(pods=192, nodes=32, seed=seed)
    clusters = {"relational": relational_mix(pods=64, nodes=24, bound=24,
                                             seed=seed),
                "mixed": (m_nodes, [], m_pending, {})}
    out = {}
    for leg, (nodes, bound, pending, ns_labels) in clusters.items():
        for depth in depths:
            runs = {}
            for device in devices:
                client = DirectClient(ObjectStore())
                for name, labels in sorted(ns_labels.items()):
                    client.resource("namespaces", None).create(
                        {"kind": "Namespace",
                         "metadata": {"name": name, "labels": labels}})
                client.nodes().create_many([n.to_dict() for n in nodes])
                for pods in (bound, pending):
                    by_ns = {}
                    for p in pods:
                        by_ns.setdefault(p.metadata.namespace, []).append(
                            p.to_dict())
                    for ns in sorted(by_ns):
                        client.pods(ns).create_many(by_ns[ns])
                runner = SchedulerRunner(
                    client, sched_config(batch_size=16, max_drain_batches=2,
                                         pipeline_depth=depth,
                                         parity_sample_every=1,
                                         backoff_initial_s=3600.0,
                                         backoff_max_s=3600.0,
                                         assume_ttl_s=3600.0,
                                         audit_interval_s=3600.0),
                    feature_gate=no_preemption_gate(), device=device)
                try:
                    runner.start(start_loop=False)
                    check(runner.has_synced(),
                          "connected parity: the informers did not sync")
                    sched = runner.scheduler
                    sched._drain_ready = lambda pend: False
                    for _ in range(64):
                        sched.run_once(wait=0.01)
                        sched.sentinel.drain(60.0)
                        if (runner.queue.stats()["active"] == 0
                                and not sched._pending):
                            break
                    sched._resolve_pending()
                    sched.wait_for_bindings()
                    sched.sentinel.drain(60.0)
                    runs[device] = {
                        "bindings": {
                            p["metadata"]["namespace"] + "/"
                            + p["metadata"]["name"]:
                                p["spec"].get("nodeName", "")
                            for p in client.pods(None).list()},
                        "ctx_stats": json.loads(json.dumps(sched.ctx_stats)),
                        "samples": dict(sched.sentinel.samples),
                        "divergences": sched.sentinel.divergences,
                        "breaker": sched.breaker.mode}
                finally:
                    runner.stop()  # raises a ParityError that ended it
            first = runs[devices[0]]
            where = f"connected parity ({leg}, depth {depth})"
            for device in devices[1:]:
                for key, value in first.items():
                    check(runs[device][key] == value,
                          f"{where}: {key} on {devices[0]} differs from "
                          f"{device}")
            placed = sum(1 for n in first["bindings"].values() if n)
            check(placed >= len(bound) + len(pending) // 2,
                  f"{where}: only {placed} bound")
            check(first["samples"]["drain"] >= 1,
                  f"{where}: the sentinel took no sample")
            check(first["divergences"] == 0 and first["breaker"] == "single",
                  f"{where}: {first['divergences']} divergences, breaker "
                  f"{first['breaker']!r}")
            out[f"{leg}_depth_{depth}"] = {
                "bound": placed, "ctx_stats": first["ctx_stats"],
                "sentinel_samples": first["samples"],
                "divergences": first["divergences"],
                "breaker": first["breaker"]}
    return out


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

    emit({"phase": "parity", **parity_phase(),
          "drain": drain_parity_phase(), "scheduler": sched_parity_phase(),
          "connected": connected_parity_phase()})

    launches = {}   # kernel -> {path: launches}

    path = path_phase(node_dicts, bound, batches)
    rounds = sum(r["rounds"] for r in path["requests"])
    emit({"phase": "path", "nodes": len(node_dicts), "bound": len(bound),
          "requests": len(batches), "placed": path["placed"],
          "rounds": rounds, "launches": path["launches"],
          "launches_per_round": {k: n / rounds
                                 for k, n in path["launches"].items()},
          "wall_s": path["wall_s"]})
    for name, n in path["launches"].items():
        launches.setdefault(name, {})["path"] = n

    emit({"phase": "profile", **profile_phase(path["engine"], profiled_batch,
                                              path["generation"])})
    del path

    drain = drain_phase(*drain_workload())
    for name, n in drain["launches"].items():
        check(n > 0, f"kernel {name} was never launched in the drain")
        launches.setdefault(name, {})["drain"] = n
    emit({"phase": "drain", **{k: v for k, v in drain.items()
                               if k not in ("plan", "assignments", "meta")}})
    drain_rows = kernels_phase(drain_count_cases(drain))
    del drain
    emit({"phase": "kernels.drain", "rows": drain_rows})

    r_nodes, r_bound, r_pending = resident_workload()
    resident, drv, churn = resident_phase(r_nodes, r_bound, r_pending)
    for name, n in resident["launches"].items():
        launches.setdefault(name, {})["resident"] = n
    emit({"phase": "resident", **resident})
    resident_rows = kernels_phase(resident_count_cases(drv))
    emit({"phase": "kernels.resident", "rows": resident_rows})
    emit({"phase": "profile.drain",
          **profile_drain_phase(drv, churn, r_pending[-1],
                                resident["cycles"])})
    del drv

    s_nodes, s_pods, s_profiled = sched_workload()
    sched_sum, sched, s_churn = scheduler_phase(s_nodes, s_pods, smi=smi)
    for name, n in sched_sum["launches"].items():
        launches.setdefault(name, {})["scheduler"] = n
    emit({"phase": "scheduler", **sched_sum})
    sched_rows = kernels_phase(scheduler_count_cases(sched, s_pods))
    emit({"phase": "kernels.scheduler", "rows": sched_rows})
    emit({"phase": "profile.scheduler",
          **profile_scheduler_phase(sched, s_churn, s_profiled,
                                    sched_sum["pops"])})
    sched.close()
    del sched

    c_nodes, c_pods = connected_workload()
    conn_sum, runner = connected_phase(c_nodes, c_pods, smi=smi)
    for name, n in conn_sum["launches"].items():
        launches.setdefault(name, {})["connected"] = n
    emit({"phase": "connected", **conn_sum})
    conn_rows = kernels_phase(scheduler_count_cases(runner.scheduler, c_pods,
                                                    prefix="connected"))
    emit({"phase": "kernels.connected", "rows": conn_rows})
    del runner

    # one entry per kernel, at the shape of the path with its most launches
    # among those whose rows are taken from the path's own context
    # (resident, scheduler, connected), launches summed over every path;
    # every row of the kernels phases was held bit-equal to the plain
    # version
    rows_by_path = {"resident": resident_rows, "scheduler": sched_rows,
                    "connected": conn_rows}
    table = []
    for name, by_path in launches.items():
        top = max(rows_by_path, key=lambda path: by_path.get(path, 0))
        row = dict(next(r for r in rows_by_path[top]
                        if r["name"].startswith(name + "[")))
        row.update(name=name, launches=sum(by_path.values()),
                   launches_by_path=by_path, ms=row.pop("kernel_ms"),
                   shape_of=top,
                   shapes_checked=[r["name"] for r in
                                   rows + drain_rows + resident_rows
                                   + sched_rows + conn_rows
                                   if r["name"].startswith(name + "[")])
        table.append(row)
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
