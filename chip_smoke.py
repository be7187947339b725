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
  connected  Connected/10000Pods5000Nodes as bench.py runs
           benchmarks/connected.py (explain=True): the port's APIServer in
           a spawned process, 5000 nodes seeded,
           SchedulerRunner(HTTPClient(url, wire="json")) with pops of
           2 x 512, depth 2, fused fold, staging, the explainer on, the
           parity sentinel every 4th drain and a fail-fast auditor every
           2 s; informers synced,
           warm_drain, 10,000 pods created in concurrent chunks of 2500,
           the loop started, a watcher process counting the bound pods.
           The window from the first create to the last bound event,
           pods/s, ATTEMPT_DURATION p50/p99, E2E_SCHEDULING p99, tracer
           span totals (the loop's, and the pod handler's, the audit
           sweeps' and the sentinel checks' on their own threads), the
           encode cache's hits and misses at pop time,
           ctx_stats, staging, breaker, loop errors, relists, audit sweeps
           and violations, sentinel samples and divergences, the
           explainer's stats and explain/* spans, launches.
           Gates: 10,000 of 10,000 bound within 300 s, placements checked,
           breaker "single", 0 oracle pods, 0 loop errors, >= 1 audit sweep
           with 0 violations, >= 1 sentinel sample with 0 divergences
  kernels.connected  count_pn at the connected run's folded resident
           shape, as kernels.drain
  parity.preemption  default preemption on the card and on the CPU, three
           legs, every result equal: _wave_scan's four outputs bit-equal
           (all Qb steps, and stopped after the last preemptor) on a 64-node
           saturated cluster with a PDB and 40 preemptors of four
           priorities, and tensor_static_masks on a 32-node
           MixedHeterogeneous cluster; the Scheduler with
           PreemptionSimulation on over a 12-node saturated cluster, 10
           preemptors among 6 pods that fit nowhere, at depth 1 and 2
           (binder logs, evictions in order, nominations, ctx_stats, the
           sentinel's wave samples, 0 divergences); the runner over a
           DirectClient on 16 saturated nodes and 12 preemptors (the
           store's bindings, what was evicted, the sentinel's samples)
  preemption  Preemption/128x5000 as benchmarks/preemption_bench.py
           run_preemption runs it: 5000 nodes of 8 CPU saturated by 10000
           bound pods of 4 CPU, 128 preemptors of 6 CPU at priority 100; a
           warm-up preempt_wave, then the measured one (masks_s: the static
           masks; wave_s: preempt_wave given them), preemptors/s; checks:
           128 resolved with 256 victims, equal to the CPU's wave, and the
           parity sentinel's verify_wave_results finds no problem. Then
           _wave_scan alone (CUDA events; under torch.profiler its launches
           a preemptor step and the device's busy share), and the exact
           host scan on 8 preemptors, one spawned process each
  connected_preemption  ConnectedPreemption/128x5000 as
           benchmarks/connected.py run_connected_preemption runs it: the
           saturated cluster behind the port's APIServer in a spawned
           process, SchedulerRunner(HTTPClient(url, wire="json")) with pops
           of 256, max_drain_batches 1, PreemptionSimulation on, the
           explainer on, the sentinel on every wave; warm_preempt, then 128
           preemptors created at once and a watcher counting their
           bindings. Gates: 128 of 128 bound, 256 victims evicted, 0 loop
           errors, breaker "single", at least one wave sample and 0
           divergences; at least one preemptor's explanation read back
           from the scheduler-explanations ConfigMap over HTTP, each
           {"NodeResourcesFit": 5000} in mode tensor with the message
           "0/5000 nodes are available: 5000 Insufficient resources.";
           PreemptionThroughput, the window, the preempt/* and explain/*
           spans, the preemptors explained
  parity.explain  explain_step on the card and the CPU over one host
           encoding of relational_mix, constraint_mix (taints, host ports,
           nodeSelectors, an unschedulable node) and a small saturated
           cluster with preemptors: verdicts [F,P,N] and valid bit-equal,
           first-fail verdicts, histograms and messages equal
  parity.extender  the port's Scheduler with one in-script HTTP extender
           (ZoneExtender: a seeded zone veto, per-zone scores) over a
           32-node MixedHeterogeneous cluster, 96 pods in pops of 32, on the
           card and the CPU: placements equal, none on a vetoed node
  explain  explain_step at full width as the explainer's judge runs it:
           the ConnectedPreemption cluster and its 128 preemptors (every
           row {"NodeResourcesFit": 5000}) and the path's MixedHeterogeneous
           cluster with 256 pending pods (8 sampled pods' first-fail
           verdicts equal to the oracle's reasons); encode ms,
           explain_step ms (CUDA events), its launches and the device's
           busy share (torch.profiler), count_pn's launches a call
  kernels.explain  count_pn at the explain calls' own shapes (the
           private encoder's cluster, one case for each launch of a call:
           the MixedHeterogeneous pods' spread terms), as kernels.drain
  extender  (a) the port's Scheduler with the ZoneExtender (filter and
           prioritize, node-cache capable, weight 1) places 512
           MixedHeterogeneous pods on 5000 nodes in pops of 256 through the
           group path: every placement outside the veto and checked, 0 loop
           and 0 attempt errors; pods/s, the scheduler/extenders span.
           (b) TPUExtenderServer on the card over the same cluster answers
           /filter and /prioritize for 4 pods in both wire forms
           (nodenames, full node objects), each response equal to the CPU
           server's (names exactly, 0..10 scores within 1); ms a request
  kernels.extender  count_pn at (a)'s last pop's shape (the second 256
           pods against the nodes with the first 256 bound, extended by the
           batch as gang_schedule extends it), as kernels.drain

  parity.slice  the reference's SliceCarve layout (a 4x4x2 torus, 4 cells
           pinned near-full, 2x2x2 gangs, a 4x4x2 gang that cannot be
           carved, a 2x2x2 gang at priority 100 placed by slice
           preemption) through the port's Scheduler on the card and the
           CPU: binder logs, events, evictions, nominations, the distinct
           explanations, carve counters, topology_status() and the
           sentinel's carve samples equal; and carve_step on the card
           against the numpy twin (the port's oracle carver) on a seeded
           16x16x16 cluster (empty, full and mixed 4x4x4 cubes: holes,
           unschedulable nodes, claimed cells), 2x2x4, 4x4x4, 4x4x8, 8x8x8
           and 8x8x16 with every rotation: fits, cost, node_grid and
           free_grid bit-equal, both selections equal
  slice    SliceCarve/16x16x16: a TPU v4 pod's torus, 4096 nodes (one a
           cell: 240 CPU, 407Gi, 4 google.com/tpu), 205 single-host
           background pods in the x >= 12 slab, the port's APIServer in a
           spawned process, SchedulerRunner(HTTPClient(url, wire="json"))
           (reference defaults, PreemptionSimulation on, the explainer on,
           the sentinel on every carve, a fail-fast auditor every 2 s),
           run_once driven by the phase once a gang is wholly queued. A
           seeded stream of 40 gangs (2x2x4 : 4x4x4 : 4x4x8 : 8x8x8 = 0.4 :
           0.3 : 0.2 : 0.1; members of 8 CPU, 32Gi, 4 TPU; one in four
           with a soft hostname spread), the oldest deleted from 70%
           occupancy on; an 8x8x16 gang that cannot be carved (its
           FailedScheduling event and {"SliceCarve": 4096} explanation);
           2x2x4 gangs until no 4x4x8 origin is free, then a 4x4x8 gang
           at priority 1000 bound by one slice preemption on the box
           select_eviction names. Gangs, carves/s, create-to-bind p50/p99,
           spans, carve_step ms per shape (CUDA events, 10 calls with the
           read-back), its launches and busy share (torch.profiler),
           topology_status(). Gates: every gang contiguous in the API,
           sentinel carve samples >= carves with 0 divergences, 0 audit
           violations, 0 loop errors, count_pn launched
  kernels.slice  count_pn at the slice path's shape (the last spread
           gang's terms, P = 256, over the cluster with it bound), as
           kernels.drain

  parity.planner  the resident planners on the card and the CPU, over
           tests/test_planner.py's fuzz (seeds 0-2): the port's Scheduler
           armed over the fuzz cluster, the scale-up options, scale-down
           plan, eviction plan and gang plan through its ResidentPlanner
           (all hits, no decline) and cold, equal on each device and across
           the devices; tenant_quota_mask on seeded tenants and quotas and
           without_pods (two victims on one node) equal across the devices
  autoscaler  ClusterAutoscalerScaleUp/1000Nodes2000Pending as
           benchmarks/scheduler_perf.py runs it (1000 node-default nodes,
           1000 fill pods bound round-robin, 2000 pod-default pods pending,
           node-group-default and node-group-large, least-waste), the
           warm-up excluded: ScaleUpDecisionSeconds cold (host encode,
           run_filters on the card) and resident (a Scheduler armed over
           the cluster with warm_drain, its ResidentPlanner), the options,
           the chosen group, the planner/* spans, one resident call under
           torch.profiler. Gates: options equal on both paths and to the
           CPU's, 2000 pods placed, each decision within 60 s, every
           resident call a hit
  defrag   DeschedulerDefrag/1000Nodes100Gang as scheduler_perf.py runs it
           (1000 nodes fragmented by one 12-CPU pod each, a gang of 100
           24-CPU pods, drain prefixes capped at 110), the warm-up
           excluded: DefragPlanSeconds, batch_victims, the candidate sets,
           the evictions, one plan under torch.profiler. Gates: 100 gang
           pods seated within 60 s, the plan equal to the CPU's, each gang
           pod alone on a drained node, no victim on a drained node
  planner  PlannerLoop (benchmarks/plannerloop.py) at 5000 nodes and 3 pods
           a node: the port's APIServer in a spawned process, the
           SchedulerRunner with its loop stopped and a fail-fast auditor,
           warm_drain, a ClusterAutoscaler and a dry-run Descheduler driven
           by one BackgroundPlanner; adaptive warm-up, a window of 3
           cycles (the reference's 6, cut so that the script keeps to its
           time), the resident-vs-cold parity legs on one observation, one
           more cycle under torch.profiler. cycle_ms, the planner/* spans
           (observe, encode, dispatch, each planner). Gates: the warm-up
           goes quiet; the window counts 0 steadyCompiles, 0 declines and
           0 scheduler full encodes; every planner's hits advance; the four
           legs equal, scale-up options not empty; 0 invariant violations;
           count_pn never launched

  parity.fleet  fleet mode on the card and the CPU: tests/test_fleet.py's
           randomized parity workloads (seeds 0-2: three tenants, nodes
           interleaved, zone values shared), each device's fleet-batched
           drain equal to its standalone drains and assignments and rounds
           bit-equal across the devices; the fleet preemption wave (nodes
           and victims); a FleetRunner over three DirectClients driven pop
           by pop (bindings on every tenant, ctx_stats, pops)
  fleet.drain  4 tenants x 1250 nodes (the parity generator at full
           width, 512 pods a tenant): one FleetQueue pop split by the
           fleet-mode Scheduler's _tenant_chunks, one gang_drain on the
           card (count_pn's launches counted) bit-equal to the four
           standalone drains
  kernels.fleet  count_pn at the fleet drain's last block with every
           committed pod valid (its spread and anti-affinity terms, P =
           512, N = 8192), as kernels.drain
  fleet    FleetChurn as benchmarks/fleetchurn.py runs it (8 s warm-up,
           12 s window, churn every 0.4 s, tenant 0 at 4x) at 4 tenant
           apiservers x 1250 nodes, 2500 upfront pods a tenant, pops of
           4 x 512, on the port's FleetRunner (see fleet_phase). Gates
           (fleet_failures): upfront 100% bound, 0 invariant violations
           (cross_tenant live), 0 sentinel divergences, 0 CompileCounter
           events and 0 context rebuilds in the window, per tenant churn
           created, completion >= 0.5 and every churn pod bound within
           120 s, no t<id>. name on a tenant, the fleet status ConfigMap
           on every tenant. Each tenant's bind p99 is reported against the
           reference's 10 s SLO (fleet_slo), not gated on

  parity.dra  DRA device claims (sched/dra.py: device classes as dra:<class>
           columns of the resource axis) on the card, on the CPU and
           through the oracle, on testing/workloads.dra_mix (48 nodes, one
           DeviceClass, slices on every other node, template and named
           claims, an unready claim, an allocated claim, three pods
           contending for two devices): gang_drain's assignments, rounds
           and requested bit-equal; the Scheduler's drain path with a
           late node's slice patched in and a new slice's full encode
           (binder logs, ctx_stats, the folded context with its dra:
           column) equal across the devices, no node over its devices;
           serial rounds on each device equal to the oracle's placements
  dra      SchedulingWithResourceClaimTemplate/5000pods_500nodes (upstream
           scheduler_perf's DRA config, structured parameters): 500
           nodes, one ResourceSlice of 10 devices each, one claim
           template a namespace; the APIServer in a spawned process, the
           SchedulerRunner over HTTP (reference defaults, the sentinel
           every 4th drain, a fail-fast auditor every 2 s) and the
           ResourceClaimController in a spawned process; 2500 init pods,
           then 2500 measured pods (pods/s, attempt p50/p99, claim
           events, rebuilds, full encodes and captures of the window),
           then 500 measured pods deleted and 500 new ones bound under
           torch.profiler (the busy share). Gates (dra_phase): every pod
           bound with its claim allocated on its node to it, no node over
           10 allocated devices, no pod bound while its claim was
           missing, the deleted pods' claims released, 0 violations, 0
           divergences, 0 loop errors, breaker "single", 0 oracle pods

  The gang rounds run as captured CUDA graphs on the card
  (kubernetes_tpu_torch/models/graphs.py: K rounds a replay, one host
  read of the progress flag a chunk). The drain, resident, scheduler,
  connected and fleet.drain paths run captured (the main path, whose
  launches fill the kernel table: count_pn's launches inside a graph are
  counted at every replay; each path's line carries its graph counters:
  captures, replays and host reads a batch, keys, pool bytes, K) and
  eager on the card (``capture=False``), in the same call:
  drain.eager  right after kernels.drain: the drain's prepared plan
           again, eager, bit-equal to the captured drain, pods/s
  and, after the fleet phase:
  resident.eager  the first RESIDENT_EAGER_CYCLES resident cycles eager:
           their placements and the folded context bit-equal to the
           captured run's at that cycle, drain ms
  scheduler.eager  the scheduler phase eager
  connected.eager  the connected phase eager, cut to 5000 pods
  (fleet.drain runs its eager and replay-only drains itself, bit-equal)
  parity.graph  at the drain, resident, scheduler, connected and
           fleet.drain shapes: one drain_step (gang_drain for the drain and
           the fleet drain, of their first batch) captured and eager on
           the card, under torch.profiler (the device's busy share of the
           call, the host's launch calls and the kernels a round), bit-equal
           (assignments, rounds, requested, new fill, the folded context);
           and captured and eager with the rounds cut at GRAPH_CPU_ROUNDS,
           and on the CPU so cut at the resident shape only (the CPU takes
           seconds a round at these widths), bit-equal
  warm     three boots of a SchedulerRunner (a 64-node MixedHeterogeneous
           cluster over a DirectClient), each in a child process
           (``--warm-boot DIR``), on one empty temporary aotCacheDir: cold
           (count_pn built, the ladder captures), warm (nothing built, the
           same fingerprint, the canary drain sample with 0 divergences),
           and after one byte of the cached library is flipped (swept and
           counted at boot, built again, never loaded); the ladder's and
           the first drain's seconds of each, the threads left after the
           runner stopped; each child exits as a process does, its exit
           code held at 0; then a changed build flag invalidates the
           cache wholesale

Every phase fails while LOOP_ERRORS{site=device_preempt} is above 0 (a
device preemption failure the scheduler degraded to the host scan) or
LOOP_ERRORS{site=device_explain} is (a failure of the explainer's device
judge, whose pods then got no verdict).

Each path (path, drain, resident, scheduler, connected, preemption,
connected_preemption, explain, extender, slice, autoscaler, defrag,
planner, fleet.drain, fleet, parity.dra, dra) is driven with the launch
counts set to 0 just before it and read just after; the preemption and
planner paths launch no hand kernel (their device work is torch ops),
nor do the fleet and DRA paths (the FleetChurn and claim pods carry no
topology term; fleet.drain launches count_pn), and every path's count is
printed, 0 included. Then
the kernel table line
({"kernels": [...]}, one row per kernel at the shape of its most launches,
launches summed over the paths, the shapes checked), the card's name and
power limit, and last {"ok": true, "device": {...}}. Any failed phase
exits non-zero before the last line. Without a CUDA card the script exits
non-zero and prints no result.

``python3 chip_smoke.py --chunks`` instead times the captured rounds' chunk
K (models/gang.GRAPH_CHUNK: rounds a replay between host reads) at the
drain's and the resident cycle's shapes, eager beside it, one line each
(chunk_sweep_phase).

``python3 chip_smoke.py --sweep`` instead times count_pn's launch geometries
(selectors per block, nodes per block, threads) at the kernels phase's
shapes, each checked bit-equal to the plain version, and prints one line
each.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one phase's line, with the seconds since the script started
    (``at_s``); a phase in which the scheduler degraded a device
    preemption failure to the host scan, or the explainer a failure of its
    device judge to the oracle, fails instead."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _T0}
    if "phase" in obj and "kubernetes_tpu_torch" in sys.modules:
        n = device_preempt_errors()
        check(n == 0, f"phase {obj['phase']}: {n} device preemption "
                      "failure(s) degraded to the host scan "
                      "(LOOP_ERRORS{site=device_preempt})")
        n = device_explain_errors()
        check(n == 0, f"phase {obj['phase']}: {n} explainer device "
                      "judge failure(s) judged by the oracle "
                      "(LOOP_ERRORS{site=device_explain})")
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


def api_launches(events) -> int:
    """The launches the host made in a trace: the runtime's and the
    driver's kernel and graph launch calls (a replayed graph is one)."""
    return sum(1 for e in events if e.get("ph") == "X"
               and e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "Launch" in e.get("name", ""))


@contextlib.contextmanager
def profiled():
    """torch.profiler (CPU and CUDA) over a ``with`` block, started and
    stopped while no thread replays a graph of the gang rounds (under
    ``models/graphs.LOCK``): on the card its stop has hung against the
    scheduler loop's concurrent ``CUDAGraph.replay`` (PERF.md §7)."""
    from torch.profiler import ProfilerActivity, profile
    from kubernetes_tpu_torch.models import graphs
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with graphs.LOCK:
        prof.start()
    try:
        yield prof
    finally:
        with graphs.LOCK:
            prof.stop()


def profile_call(fn, name, top=6):
    """One ``fn()`` under torch.profiler (CPU and CUDA): its wall ms, its
    kernel launches, the device's busy share and ``trace_summary`` (the
    ``top`` operations; trace under build/profile/)."""
    import torch
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"{name}.json")
    torch.cuda.synchronize()
    with profiled() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    summary = trace_summary(events, top=top)
    n_kernels = sum(1 for e in events
                    if e.get("ph") == "X" and e.get("cat") == "kernel")
    check(n_kernels > 0, f"{name}: the trace holds no kernel")
    return {"wall_ms": wall_ms, "launches": n_kernels,
            "api_launches": api_launches(events),
            "device_busy_share": summary["device_busy_ms"] / wall_ms,
            **summary, "trace": os.path.relpath(trace_path)}


def profile_phase(eng, batch, gen):
    """One Schedule request on ``eng`` under torch.profiler (CPU and CUDA).
    -> the request's host time and its split, the device's busy share of
    the request and of its schedule part, and ``trace_summary`` of the
    trace, which is kept under build/profile/."""
    import torch
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "schedule_request.json")
    torch.cuda.synchronize()
    with profiled() as prof:
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
    ``gang_drain`` (it captures the graphs of the rounds), then the
    measured one, whose launches and graph replays are counted. The
    placements are checked like the path's."""
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
    g0 = graph_counters()
    t0 = time.perf_counter()
    assignments, rounds, requested = gang_drain(topo_keys=meta.topo_keys,
                                                prepared=plan)
    measured_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    graphs = graph_report(g0, len(chunks))
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
            "graphs": graphs, "captured": True,
            "plan": plan, "assignments": assignments, "meta": meta,
            "requested": requested, "host": (ct, pbs)}


def drain_eager_phase(drain):
    """The captured drain's prepared plan once more with the rounds eager
    on the card (``capture=False``): one warm-up gang_drain, then the
    measured one, bit-equal to the captured drain's results. -> the
    eager leg's numbers."""
    from kubernetes_tpu_torch.models.gang import gang_drain
    from kubernetes_tpu_torch.ops import kernels
    kw = dict(topo_keys=drain["meta"].topo_keys, prepared=drain["plan"],
              capture=False)
    t0 = time.perf_counter()
    gang_drain(**kw)
    warmup_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    assignments, rounds, requested = gang_drain(**kw)
    measured_s = time.perf_counter() - t0
    check(_same([drain[k] for k in ("assignments", "rounds", "requested")],
                [assignments, [int(r) for r in rounds], requested]),
          "drain: the eager drain differs from the captured one")
    return {"bit_equal": True, "warmup_s": warmup_s,
            "measured_s": measured_s,
            "pods_per_s": drain["scheduled"] / measured_s,
            "launches": dict(kernels.LAUNCHES)}


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
RESIDENT_EAGER_CYCLES = 4   # resident.eager: the first cycles, eager


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
                   P=RESIDENT_P, cycles=RESIDENT_CYCLES, capture=True,
                   tree_at=None):
    """The connected steady state through testing/resident.py: a
    SchedulerCache of the path's cluster, a context armed with B x P (its
    slots sized for RESIDENT_CYCLES, whatever ``cycles``), then ``cycles``
    cycles of Recreate churn + one fused drain_step of B x P pending pods
    each, every one checked against a host recount. 0 rebuilds after the
    arming build, and a compiled patch in every cycle. ``capture=False``:
    the rounds run eagerly on the card. ``tree_at``: the summary's
    ``tree`` holds the context on the host after that many cycles. ->
    (summary, harness, churn state)."""
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
                        slot_headroom=(max(cycles, RESIDENT_CYCLES) + 1)
                        * B * P + 64, device=device)
    drv.capture = capture
    t0 = time.perf_counter()
    drv.arm([Pod.from_dict(d) for d in pending[0]])
    arm_s = time.perf_counter() - t0
    churn = ([], [])
    rows, tree = [], None
    kernels.reset_launches()
    g0 = graph_counters()
    for i in range(cycles):
        _churn(cache, i, *churn)
        out = drv.cycle([Pod.from_dict(d) for d in pending[i + 1]])
        cs = drv.ctx["cs"]
        row = {"cycle": i, "ms": out.ms, "drain_ms": out.drain_ms,
               "pods": len(pending[i + 1]), "placed": len(out.placed),
               "rounds": out.rounds, "patch": out.patched,
               "rebuilds": drv.stats["rebuilds"], "fill_host": cs.fill_host,
               "top": cs.top, "recounted_pods": recount(drv)}
        emit({"phase": "resident.cycle", "captured": capture, **row})
        row["placements"] = out.placed
        rows.append(row)
        check(out.patched, f"resident: cycle {i} compiled no patch")
        check(drv.stats["rebuilds"] == 0,
              f"resident: the context rebuilt at cycle {i}: "
              f"{drv.stats['reasons']}")
        if i + 1 == tree_at:
            tree = _host_tree(drv.ctx["ct"])
    launches = dict(kernels.LAUNCHES)
    graphs = graph_report(g0, cycles * B)
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
             "e0": drv.ctx["e0"], "captured": capture, "graphs": graphs,
             "drain_ms": [r["drain_ms"] for r in rows],
             "placements": [r["placements"] for r in rows], "tree": tree},
            drv, churn)


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
    from kubernetes_tpu_torch.api.types import Pod
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "resident_drain.json")
    pods = [Pod.from_dict(d) for d in pods]
    _churn(drv.cache, i, *churn)
    torch.cuda.synchronize()
    with profiled() as prof:
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
    with, unless ``overrides`` names them, the explainer and the parity
    sentinel off (as the scheduler phase has measured the loop since it
    was ported; the connected cells turn both on, as the reference's
    benches run them)."""
    from kubernetes_tpu_torch.config.types import (SchedulerConfiguration,
                                                   validate)
    cfg = SchedulerConfiguration(**dict(
        dict(explainer_enabled=False, parity_sample_every=0), **overrides))
    validate(cfg)
    return cfg


def no_preemption_gate():
    """PreemptionSimulation off, for the cells where no pod preempts (the
    reference's default is on; the preemption phases keep it)."""
    from kubernetes_tpu_torch.config.features import FeatureGate
    gate = FeatureGate()
    gate.set("PreemptionSimulation", False)
    return gate


def make_scheduler(cfg, node_objs, bound_objs=(), ns_labels=None,
                   device=None, confirm=True, gate=None):
    """A port Scheduler over a fresh SchedulerCache and SchedulingQueue,
    PreemptionSimulation off unless ``gate`` says otherwise (the cells of
    the main path preempt nothing: every pod fits), and an in-process
    binder that logs (pod key, node, seconds) and, with ``confirm``,
    confirms the binding in the cache as the runner's informer would.
    -> (scheduler, binder log)."""
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
                      feature_gate=gate or no_preemption_gate(),
                      device=device)
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


def scheduler_phase(node_dicts, pod_dicts, device=None, smi="",
                    capture=True):
    """The north star through the port's Scheduler: warm_drain on the first
    pop's pods, then every pod into the queue and run_once until the queue
    is empty and the pipeline has resolved, with the Recreate churn applied
    to the cache before every pop. The window runs from the first
    queue.add to the last binding in the binder's log. The placements are
    checked; at least 90% placed; the breaker still "single", no loop
    error, no pod through the oracle, no separate patch dispatch (fused
    fold). The loop's tracer spans over the window are summed by name
    (count, total and longest ms). ``capture=False``: the rounds run
    eagerly on the card. The warm ladder's captures and seconds and the
    window's graph counters are reported. -> (summary, scheduler, churn
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
    sched.capture = capture
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
    g0 = graph_counters()
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
    graphs = graph_report(g0, pops * cfg.max_drain_batches)
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
             "captured": capture, "warm_ladder": sched.warm_stats,
             "graphs": graphs, "card": smi}, sched, churn)


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
    from kubernetes_tpu_torch.api.types import Pod
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "scheduler_cycle.json")
    for d in pod_dicts:
        sched.queue.add(Pod.from_dict(d))
    _churn(sched.cache, i, *churn)
    torch.cuda.synchronize()
    with profiled() as prof:
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
CONNECTED_EAGER = 5000   # connected.eager's pods: the eager run, cut to
                         # five drains of 2 x 512 (the sentinel samples
                         # every 4th)


def connected_workload(pods=CONNECTED_PODS, nodes=N_NODES, seed=SEED):
    """MixedHeterogeneous/10000Pods5000Nodes as wire dicts, without the
    wrappers' process-local uids (the store stamps its own). -> (node
    dicts, pod dicts)."""
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    node_objs, pod_objs = mixed_heterogeneous(pods=pods, nodes=nodes,
                                              seed=seed)
    return _wire(node_objs), _wire(pod_objs)


def _wire(objs):
    """Wire dicts without the wrappers' process-local uids (the store
    stamps its own)."""
    return _wire_dicts([o.to_dict() for o in objs])


def _wire_dicts(dicts):
    for d in dicts:
        d["metadata"].pop("uid", None)
    return dicts


def watch_bound(url, ns, rv0, n_pods, count, done, dead, ready, prefix=""):
    """Watcher process: count the pods whose nodeName got set (one event
    per binding), of those whose name starts with ``prefix``; a deletion
    is not a binding. Its JSON decode burns its own interpreter, not the
    scheduler's."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    client = HTTPClient(url, timeout=30.0, wire="json")
    seen = set()
    try:
        w = client.pods(ns).watch(since_rv=rv0)
        ready.set()
        for ev in w:
            if ev.type == "DELETED" or not (ev.object or {}).get(
                    "metadata", {}).get("name", "").startswith(prefix):
                continue
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


def connected_phase(node_dicts, pod_dicts, device=None, smi="",
                    capture=True):
    """Connected/10000Pods5000Nodes as ``bench.py`` runs
    ``benchmarks/connected.py`` run_connected (``explain=True``, its
    default), through the port: an APIServer in a spawned process, the
    nodes seeded with one bulk create, ``SchedulerRunner(HTTPClient(url,
    wire="json"))`` with pops of 2 x 512, pipeline depth 2, fused fold and
    staging, the explainer and the flight recorder on, the parity sentinel
    every 4th drain and a fail-fast auditor on a clean client every 2 s;
    informers synced with the loop stopped,
    ``warm_drain``, then the pods created in concurrent chunks of 2500 and
    the loop started. A watcher process counts the bound pods. The window
    runs from the first create to the last bound event. Gates: every pod
    bound within the timeout, the placements checked, breaker "single", 0
    pods through the oracle, 0 loop errors, at least one audit sweep with
    0 violations, at least one sentinel sample and 0 divergences, and (in
    ``emit``) 0 ``device_explain`` errors. The pods through the oracle and
    the seconds of the other threads (pod handler, audit sweeps, sentinel
    checks, the explainer's ``explain/*``) are read from the tracer's
    spans; the explainer's ``stats()`` are reported. ``capture=False``:
    the rounds run eagerly on the card. -> (summary, stopped runner)."""
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
                           audit_fail_fast=True, explainer_enabled=True)
        runner = SchedulerRunner(HTTPClient(url, wire="json"), cfg,
                                 feature_gate=no_preemption_gate(),
                                 device=device)
        runner.scheduler.capture = capture
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
        g0 = graph_counters()
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
        pops = sum(1 for sp in TRACER.spans("scheduler/gang_dispatch"))
        graphs = graph_report(g0, pops * CONNECTED_DRAIN_BATCHES)
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
            "launches": launches, "captured": capture,
            "warm_ladder": runner.scheduler.warm_stats, "graphs": graphs,
            "card": smi}
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
        explainer = runner.scheduler.explainer
        explainer.drain(120.0)
        summary["explainer"] = explainer.stats()
        summary["explain_spans"] = {k: v for k, v in _span_totals().items()
                                    if k.startswith("explain/")}
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
    check(summary["explainer"]["errors"] == 0,
          f"connected: explainer errors {summary['explainer']}")
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


# ------------------------------------------------------------------ preemption

PREEMPT_NODES = 5000      # bench.py's BENCH_PREEMPT_NODES / BENCH_CPREEMPT_NODES
PREEMPT_PODS = 128        # bench.py's BENCH_PREEMPT_PODS / BENCH_CPREEMPT_PODS
PREEMPT_HOST_SAMPLE = 8   # benchmarks/preemption_bench.py's host_sample
PREEMPT_BATCH = 256       # run_connected_preemption's SchedulerConfiguration
PREEMPT_TIMEOUT_S = 300.0  # run_connected_preemption's timeout


def preemptors(n, ns="default", prefix="hi"):
    """The preemptors of benchmarks/preemption_bench.py and connected.py:
    6 CPU / 8Gi at priority 100. On a saturated node (two 4-CPU pods on 8
    CPU) each needs both victims."""
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    return [make_pod(f"{prefix}-{k}", ns).req({"cpu": "6", "memory": "8Gi"})
            .priority(100).obj() for k in range(n)]


def preemption_gate():
    """PreemptionSimulation on: the reference's default feature gate."""
    from kubernetes_tpu_torch.config.features import FeatureGate
    gate = FeatureGate()
    gate.set("PreemptionSimulation", True)
    return gate


def device_preempt_errors() -> int:
    """LOOP_ERRORS{site=device_preempt}: device preemption failures the
    scheduler degraded around (to the exact host scan). Every phase fails
    while it is above 0 (``emit``)."""
    from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS
    return int(LOOP_ERRORS.items().get((("site", "device_preempt"),), 0))


def _result_keys(results):
    return [None if r is None else
            (r.node_name, [v.key for v in r.victims], r.num_pdb_violations)
            for r in results]


def host_scan_seconds(args):
    """Worker process: the exact serial scan (``find_candidate``) for one
    preemptor of the preemption cell. -> seconds."""
    n_nodes, k = args
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubernetes_tpu_torch.sched.preemption import find_candidate
    from kubernetes_tpu_torch.testing.workloads import build_saturated
    nodes, bound = build_saturated(n_nodes)
    pod = preemptors(k + 1)[k]
    t0 = time.perf_counter()
    res = find_candidate(nodes, bound, pod)
    seconds = time.perf_counter() - t0
    check(res is not None and len(res.victims) == 2,
          f"preemption: the host scan found {res}")
    return seconds


def profile_wave_scan(staged, steps, name):
    """``_wave_scan`` alone under torch.profiler: its launches a preemptor
    step and the device's busy share of the scan (trace under
    build/profile/)."""
    from kubernetes_tpu_torch.ops.preemption import _wave_scan
    out = profile_call(lambda: _wave_scan(*staged, steps=steps), name,
                       top=8)
    return {"steps": steps, "scan_ms": out.pop("wall_ms"),
            "kernels": out["launches"],
            "launches_per_step": out.pop("launches") / steps, **out}


def preemption_phase(n_nodes=PREEMPT_NODES, n_pre=PREEMPT_PODS,
                     host_sample=PREEMPT_HOST_SAMPLE, device=None):
    """Preemption/128x5000 as ``benchmarks/preemption_bench.py``
    run_preemption runs it at bench.py's sizes, through the port: a
    saturated cluster, one warm-up ``preempt_wave``, then the measured
    wave as the scheduler splits it: the static masks
    (``tensor_static_masks``, a fresh encode of the cluster) and
    ``preempt_wave`` given them (the scan on the card, the host's exact
    verification). Checks: every preemptor resolved with two victims, the
    results equal to the CPU's wave, and the parity sentinel's
    ``verify_wave_results`` finds no problem. Then ``_wave_scan`` alone:
    its time by CUDA events and, under torch.profiler, its launches a
    preemptor step and the device's busy share. Last, the exact host scan
    on ``host_sample`` preemptors, one spawned process each, all at once:
    the rate is ``host_sample`` over the sum of their seconds."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from kubernetes_tpu_torch.audit.sentinel import verify_wave_results
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.preemption import _wave_scan, wave_inputs
    from kubernetes_tpu_torch.sched.preemption import (preempt_wave,
                                                       tensor_static_masks)
    from kubernetes_tpu_torch.testing.workloads import build_saturated
    nodes, bound = build_saturated(n_nodes)
    pre = preemptors(n_pre)
    t0 = time.perf_counter()
    preempt_wave(nodes, bound, pre, device=device)
    warm_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    masks = tensor_static_masks(nodes, pre, bound_pods=bound, device=device)
    t1 = time.perf_counter()
    results = preempt_wave(nodes, bound, pre, static_masks=masks,
                           device=device)
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    resolved = sum(r is not None for r in results)
    victims = sum(len(r.victims) for r in results if r is not None)
    check(resolved == n_pre, f"preemption: {resolved} of {n_pre} resolved")
    check(victims == 2 * n_pre,
          f"preemption: {victims} victims, {2 * n_pre} expected")
    cpu = preempt_wave(nodes, bound, pre, device="cpu")
    check(_result_keys(results) == _result_keys(cpu),
          "preemption: the card's wave differs from the CPU's")
    problems = verify_wave_results(nodes, bound, pre, results)
    check(not problems,
          f"preemption: the oracle refutes the wave: {problems[:3]}")
    staged, _ = wave_inputs(nodes, bound, pre, [], static_masks=masks,
                            device=device)
    scan_ms = cuda_ms(lambda: _wave_scan(*staged, steps=n_pre), iters=3,
                      warmup=1)
    profiled = profile_wave_scan(staged, n_pre, "preemption_wave_scan")
    t3 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=host_sample,
                             mp_context=mp.get_context("spawn")) as pool:
        host_s = list(pool.map(host_scan_seconds,
                               [(n_nodes, k) for k in range(host_sample)]))
    host_wall_s = time.perf_counter() - t3
    return {"nodes": n_nodes, "bound": len(bound), "preemptors": n_pre,
            "resolved": resolved, "victims": victims, "warmup_s": warm_s,
            "masks_s": t1 - t0, "wave_s": t2 - t1, "measure_s": t2 - t0,
            "preemptors_per_s": resolved / (t2 - t0),
            "equal_to_cpu": True, "oracle_problems": len(problems),
            "wave_scan_ms": scan_ms, "wave_scan_profile": profiled,
            "host_scan_s": host_s, "host_scan_wall_s": host_wall_s,
            "host_serial_per_s": host_sample / sum(host_s),
            "launches": launches}


def warm_preempt(runner, n_high):
    """Warm the preemption path's device work before the measured window,
    mutating nothing, as benchmarks/connected.py's _warm_preempt does with
    the port's own calls: the gang step at the failure batch's shapes,
    with and without the nominee overlay, the [Q,N] static masks and the
    wave at the WAVE_BUCKET. -> seconds."""
    from kubernetes_tpu_torch.models.gang import gang_schedule
    from kubernetes_tpu_torch.ops.preemption import dry_run_wave
    from kubernetes_tpu_torch.sched import preemption as pmod
    from kubernetes_tpu_torch.sched.scheduler import DRAIN_NOM_BUCKET
    t0 = time.perf_counter()
    cache, profile = runner.cache, runner.cfg.profiles[0]
    dev = runner.scheduler.device
    warm = preemptors(n_high, ns="warmup", prefix="warm")
    nodes, ct, meta = cache.snapshot(pending_pods=warm)
    bound = cache.bound_pods()
    pb = cache.encode_pods(warm, meta, min_p=runner.cfg.batch_size)
    kw = dict(seed=runner.cfg.seed, fit_strategy=profile.fit_strategy,
              topo_keys=meta.topo_keys, weights=profile.weights(),
              enabled_filters=profile.enabled_filters)
    gang_schedule(ct.to(dev), pb.to(dev), **kw)
    ct_nom = cache.overlay_nominated(ct, meta,
                                     [(meta.node_names[0], 100, warm[0])],
                                     min_m=DRAIN_NOM_BUCKET)
    gang_schedule(ct_nom.to(dev), pb.to(dev), **kw)
    masks = pmod.tensor_static_masks(
        nodes, warm, ct=ct, meta=meta, encode_pods=cache.encode_pods,
        min_p=pmod.WAVE_BUCKET, device=dev)
    dry_run_wave(nodes, bound, warm, [], static_masks=masks,
                 min_q=pmod.WAVE_BUCKET, device=dev)
    return time.perf_counter() - t0


def connected_preemption_phase(n_nodes=PREEMPT_NODES, n_high=PREEMPT_PODS,
                               device=None):
    """ConnectedPreemption/128x5000 as ``benchmarks/connected.py``
    run_connected_preemption runs it at bench.py's sizes, through the
    port: the saturated cluster behind the port's APIServer in a spawned
    process (5000 nodes, 10000 bound pods), ``SchedulerRunner(HTTPClient(
    url, wire="json"))`` with ``batch_size=256, max_drain_batches=1`` and
    the default feature gate (PreemptionSimulation on), the explainer on
    (the reference's configuration there), the parity sentinel on every
    wave (the reference's bench samples every 16th: the cell has one or
    two waves, and they are judged); informers synced, ``warm_preempt``;
    then 128 preemptors created at once, the loop started, a watcher
    process counting their bindings. The window runs from the create to
    the last bound event. Gates: 128 of 128 bound within the timeout, 256
    victims evicted, 0 loop errors (of them 0 ``device_preempt`` and 0
    ``device_explain``), breaker "single", at least one wave sample and 0
    divergences; at least one preemptor's explanation read back over HTTP
    from the ``scheduler-explanations`` ConfigMap, and every one of them
    ``{"NodeResourcesFit": 5000}``, mode ``tensor``, with the message
    "0/5000 nodes are available: 5000 Insufficient resources.". The
    preemption and explain spans (``preempt/*``, ``explain/*``) come from
    the tracer."""
    import multiprocessing as mp
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.runner import (EXPLAIN_CONFIGMAP,
                                                   SchedulerRunner)
    from kubernetes_tpu_torch.testing.workloads import build_saturated
    from kubernetes_tpu_torch.utils.tracing import TRACER
    ctx = mp.get_context("spawn")
    server, server_pipe, url = start_apiserver(ctx)
    watcher = runner = None
    try:
        seed_client = HTTPClient(url, timeout=120.0, wire="json")
        node_objs, low_objs = build_saturated(n_nodes)
        low = _wire(low_objs)
        t0 = time.perf_counter()
        seed_client.nodes().create_many(_wire(node_objs))
        for i in range(0, len(low), CONNECTED_CHUNK):
            seed_client.pods("default").create_many(
                low[i:i + CONNECTED_CHUNK])
        seed_s = time.perf_counter() - t0
        runner = SchedulerRunner(
            HTTPClient(url, wire="json"),
            sched_config(batch_size=PREEMPT_BATCH, max_drain_batches=1,
                         parity_sample_every=1, explainer_enabled=True),
            feature_gate=preemption_gate(), device=device)
        t0 = time.perf_counter()
        runner.start(wait_sync=120.0, start_loop=False)
        check(runner.has_synced(),
              "connected preemption: the informers did not sync")
        sync_s = time.perf_counter() - t0
        warm_s = warm_preempt(runner, n_high)

        high = _wire(preemptors(n_high, ns="preempt"))
        _, rv0 = seed_client.pods("preempt").list_rv()
        count = ctx.Value("i", 0)
        all_bound, watch_dead, ready = ctx.Event(), ctx.Event(), ctx.Event()
        watcher = ctx.Process(target=watch_bound,
                              args=(url, "preempt", rv0, n_high, count,
                                    all_bound, watch_dead, ready),
                              daemon=True)
        watcher.start()
        check(ready.wait(120.0),
              "connected preemption: the watcher did not start")
        errors0 = dict(LOOP_ERRORS.items())
        TRACER.reset()
        kernels.reset_launches()
        t_start, t_start_wall = time.perf_counter(), time.time()
        seed_client.pods("preempt").create_many(high)
        runner.start_loop()
        deadline = t_start + PREEMPT_TIMEOUT_S
        completed = False
        while time.perf_counter() < deadline:
            if all_bound.wait(timeout=0.02):
                completed = True
                break
            check(runner.loop_error is None,
                  f"connected preemption: the scheduling loop died: "
                  f"{runner.loop_error!r}")
            check(not watch_dead.is_set(),
                  "connected preemption: the watcher died")
        window_s = time.perf_counter() - t_start
        check(completed, f"connected preemption: {count.value} of "
                         f"{n_high} bound in {PREEMPT_TIMEOUT_S} s")
        launches = dict(kernels.LAUNCHES)
        spans = _span_totals(t_start_wall)
        errors = {"/".join(v for _k, v in key): n - errors0.get(key, 0)
                  for key, n in LOOP_ERRORS.items().items()
                  if n != errors0.get(key, 0)}
        sentinel = runner.scheduler.sentinel
        sentinel.drain(120.0)
        backlog = sentinel._q.unfinished_tasks
        stats = sentinel.stats()
        remaining = len(seed_client.pods("default").list())
        bindings = {p["metadata"]["name"]: p["spec"].get("nodeName", "")
                    for p in seed_client.pods("preempt").list()}
        breaker = runner.scheduler.breaker.mode
        nominated = len(runner.scheduler._nominated)
        explainer = runner.scheduler.explainer
        explainer.drain(120.0)
        explain_stats = explainer.stats()
        explain_backlog = explainer._q.unfinished_tasks
        cm = seed_client.resource("configmaps", "default").get(
            EXPLAIN_CONFIGMAP)
        published = json.loads(cm["data"]["explanations"])
    finally:
        if runner is not None:
            runner.stop()  # re-raises a fatal error that ended the loop
        if watcher is not None:
            stop_process(watcher)
        stop_process(server, server_pipe)
    bound = sum(1 for n in bindings.values() if n)
    summary = {
        "nodes": n_nodes, "bound_low": len(low), "preemptors": n_high,
        "resolved": bound, "window_s": window_s,
        "PreemptionThroughput": bound / window_s, "measure_s": window_s,
        "victims_evicted": len(low) - remaining,
        "seed_s": seed_s, "informer_sync_s": sync_s, "warm_s": warm_s,
        "loop_errors": errors, "device_preempt_errors":
            errors.get("device_preempt", 0),
        "breaker": breaker, "nominated_left": nominated,
        "sentinel": stats, "sentinel_backlog": backlog,
        "spans": {k: v for k, v in spans.items()
                  if k.startswith(("preempt/", "scheduler/", "sentinel/",
                                   "runner/bind", "explain/"))},
        "launches": launches}
    want = {"filters": {"NodeResourcesFit": n_nodes}, "mode": "tensor",
            "message": f"0/{n_nodes} nodes are available: {n_nodes} "
                       "Insufficient resources."}
    explained = {k: v for k, v in published.items()
                 if k.startswith("preempt/")}
    wrong = {k: {f: v.get(f) for f in want} for k, v in explained.items()
             if any(v.get(f) != w for f, w in want.items())}
    summary["explainer"] = {**explain_stats, "backlog": explain_backlog,
                            "preemptors_explained": len(explained),
                            "published": len(published),
                            "sample": next(iter(explained.values()), None)}
    check(bound == n_high,
          f"connected preemption: {bound} of {n_high} bound in the store")
    check(summary["victims_evicted"] == 2 * n_high,
          f"connected preemption: {summary['victims_evicted']} victims "
          f"evicted, {2 * n_high} expected")
    check(not errors, f"connected preemption: loop errors {errors}")
    check(breaker == "single",
          f"connected preemption: the breaker degraded to {breaker!r}")
    check(stats["samples"]["wave"] >= 1,
          "connected preemption: the sentinel took no wave sample")
    check(stats["divergences"] == 0 and backlog == 0,
          f"connected preemption: sentinel {stats}, backlog {backlog}")
    check(len(explained) >= 1 and explain_backlog == 0,
          "connected preemption: no preemptor's explanation was published "
          f"({summary['explainer']})")
    check(not wrong, "connected preemption: explanations "
                     f"{dict(list(wrong.items())[:3])}, not {want}")
    check(explain_stats["errors"] == 0,
          f"connected preemption: explainer {explain_stats}")
    return summary


def preempt_sched_workload(n_nodes=12, n_hi=10, n_filler=6):
    """A small saturated cluster for the parity legs: ``n_hi`` preemptors
    interleaved with priority-0 pods that fit nowhere (they fail without
    preempting), and 8 warm-up pods. -> (nodes, bound, pending, warm) as
    wire dicts."""
    from kubernetes_tpu_torch.testing.workloads import build_saturated
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    nodes, bound = build_saturated(n_nodes)
    hi = preemptors(n_hi, ns="preempt")
    filler = [make_pod(f"fill-{k}", "preempt").req({"cpu": "2"}).obj()
              for k in range(n_filler)]
    pending = [p for pair in zip(hi, filler) for p in pair] + hi[n_filler:]
    warm = preemptors(8, ns="warmup", prefix="warm")
    return tuple(_wire(objs) for objs in (nodes, bound, pending, warm))


def preemption_parity_phase(seed=SEED, devices=("cuda", "cpu"),
                            depths=(1, 2)):
    """The port's preemption on each device, three legs, every result
    equal on every device:

    - ``_wave_scan``'s four outputs bit-equal, all Qb steps and stopped
      after the last preemptor, on a 64-node saturated cluster with a PDB
      over a third of the bound pods and 40 preemptors of four priorities
      (the wave padded to WAVE_BUCKET); and ``tensor_static_masks`` on a
      32-node MixedHeterogeneous cluster;
    - the Scheduler with PreemptionSimulation on over a 12-node saturated
      cluster, 10 preemptors among 6 pods that fit nowhere, at each
      pipeline depth: binder logs, evictions in order, nominations,
      ctx_stats and the sentinel's wave samples (every wave sampled);
    - the SchedulerRunner over a DirectClient, the sentinel on every
      drain and wave, on a 16-node saturated cluster and 12 preemptors:
      the store's bindings and the evicted pods."""
    import numpy as np
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.client.clientset import DirectClient
    from kubernetes_tpu_torch.ops.preemption import _wave_scan, wave_inputs
    from kubernetes_tpu_torch.sched import preemption as pmod
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.store.store import ObjectStore
    from kubernetes_tpu_torch.testing.workloads import (build_saturated,
                                                        mixed_heterogeneous)
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    out = {}

    # leg 1: the raw scan and the static masks
    nodes, bound = build_saturated(64)
    for i, p in enumerate(bound):
        if i % 3 == 0:
            p.metadata.labels["app"] = "db"
    pdbs = [{"metadata": {"name": "db", "namespace": "default"},
             "spec": {"maxUnavailable": 4,
                      "selector": {"matchLabels": {"app": "db"}}}}]
    budgets = pmod._pdb_budgets(pdbs, bound)
    pre = [make_pod(f"hi-{k}").req({"cpu": "6", "memory": "8Gi"})
           .priority(3 + 30 * (k % 4)).obj() for k in range(40)]
    m_nodes, m_pods = mixed_heterogeneous(pods=40, nodes=32, seed=seed)
    runs = {}
    for device in devices:
        staged, _ = wave_inputs(nodes, bound, pre, budgets,
                                min_q=pmod.WAVE_BUCKET, device=device)
        full = [t.cpu().numpy() for t in _wave_scan(*staged)]
        cut = [t.cpu().numpy() for t in _wave_scan(*staged, steps=len(pre))]
        for a, b in zip(full, cut):
            check(np.array_equal(a, b), f"preemption parity: the scan "
                                        f"stopped after Q differs on {device}")
        masks = pmod.tensor_static_masks(m_nodes, m_pods, bound_pods=[],
                                         min_p=pmod.WAVE_BUCKET,
                                         device=device)
        runs[device] = (full, masks)
    first = runs[devices[0]]
    for device in devices[1:]:
        for name, a, b in zip(("found", "zero_evict", "cand_nodes",
                               "evict_sel"), first[0], runs[device][0]):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"preemption parity: _wave_scan {name} on {devices[0]} "
                  f"differs from {device}")
        check(np.array_equal(first[1], runs[device][1]),
              f"preemption parity: static masks on {devices[0]} differ "
              f"from {device}")
    found = first[0][0]
    check(found.any() and not found.all(),
          "preemption parity: the scan found every or no preemptor")
    out["scan"] = {"qb": int(found.shape[0]), "found": int(found.sum()),
                   "victims": int(first[0][3].sum()),
                   "masks_true": int(first[1].sum())}

    # leg 2: the Scheduler
    s_nodes, s_bound, pending, warm = preempt_sched_workload()
    for depth in depths:
        runs = {}
        for device in devices:
            sched, log = make_scheduler(
                sched_config(batch_size=8, max_drain_batches=2,
                             pipeline_depth=depth, parity_sample_every=1),
                [Node.from_dict(d) for d in s_nodes],
                [Pod.from_dict(d) for d in s_bound], device=device,
                confirm=False, gate=preemption_gate())
            sched._drain_ready = lambda pend: False
            evicted = []
            evict = sched._evict
            sched._evict = lambda v: evicted.append(v.key) or evict(v)
            try:
                check(sched.warm_drain([Pod.from_dict(d) for d in warm],
                                       slot_headroom=256),
                      "preemption parity: the context did not arm")
                for d in pending:
                    sched.queue.add(Pod.from_dict(d))
                for _ in range(12):
                    sched.run_once(wait=0.01)
                    sched.sentinel.drain(60.0)
                sched._resolve_pending()
                sched.wait_for_bindings()
                runs[device] = {
                    "log": {k: n for k, n, _t in log}, "evicted": evicted,
                    "nominated": {k: e[0] for k, e in
                                  sched._nominated.items()},
                    "ctx_stats": json.loads(json.dumps(sched.ctx_stats)),
                    "samples": dict(sched.sentinel.samples),
                    "divergences": sched.sentinel.divergences}
            finally:
                sched.close()
        first = runs[devices[0]]
        where = f"preemption parity (scheduler, depth {depth})"
        for device in devices[1:]:
            for key, value in first.items():
                check(runs[device][key] == value,
                      f"{where}: {key} on {devices[0]} differs from {device}")
        check(len(first["evicted"]) == 20 and first["samples"]["wave"] >= 1
              and first["divergences"] == 0,
              f"{where}: {len(first['evicted'])} evicted, sentinel "
              f"{first['samples']}, {first['divergences']} divergences")
        out[f"scheduler_depth_{depth}"] = {
            "bound": len(first["log"]), "evicted": len(first["evicted"]),
            "samples": first["samples"], "ctx_stats": first["ctx_stats"]}

    # leg 3: the runner over a DirectClient
    r_nodes, r_bound = build_saturated(16)
    r_pending = preemptors(12, ns="preempt")
    runs = {}
    for device in devices:
        client = DirectClient(ObjectStore())
        client.nodes().create_many(_wire(r_nodes))
        client.pods("default").create_many(_wire(r_bound))
        client.pods("preempt").create_many(_wire(r_pending))
        runner = SchedulerRunner(
            client, sched_config(batch_size=16, max_drain_batches=1,
                                 parity_sample_every=1,
                                 backoff_initial_s=3600.0,
                                 backoff_max_s=3600.0, assume_ttl_s=3600.0,
                                 audit_interval_s=3600.0),
            feature_gate=preemption_gate(), device=device)
        try:
            runner.start(start_loop=False)
            check(runner.has_synced(),
                  "preemption parity: the informers did not sync")
            sched = runner.scheduler
            sched._drain_ready = lambda pend: False
            for _ in range(8):
                sched.run_once(wait=0.01)
                sched.sentinel.drain(60.0)
            sched._resolve_pending()
            sched.wait_for_bindings()
            runs[device] = {
                "bindings": {
                    p["metadata"]["namespace"] + "/" + p["metadata"]["name"]:
                        p["spec"].get("nodeName", "")
                    for p in client.pods(None).list()},
                "samples": dict(sched.sentinel.samples),
                "divergences": sched.sentinel.divergences,
                "breaker": sched.breaker.mode}
        finally:
            runner.stop()
    first = runs[devices[0]]
    for device in devices[1:]:
        for key, value in first.items():
            check(runs[device][key] == value,
                  f"preemption parity (runner): {key} on {devices[0]} "
                  f"differs from {device}")
    placed = sum(1 for k, n in first["bindings"].items()
                 if k.startswith("preempt/") and n)
    check(placed == 12 and len(first["bindings"]) == 32 - 24 + 12,
          f"preemption parity (runner): {placed} of 12 bound, "
          f"{len(first['bindings'])} pods left")
    check(first["samples"]["wave"] >= 1 and first["divergences"] == 0
          and first["breaker"] == "single",
          f"preemption parity (runner): {first}")
    out["runner"] = {"bound": placed, "samples": first["samples"]}
    return out


# ------------------------------------------------------------------ explain

EXPLAIN_MIXED_PODS = BATCH   # the MixedHeterogeneous pods the explain phase judges
EXPLAIN_ORACLE_SAMPLE = 8    # of them, re-judged by the port's oracle


def device_explain_errors() -> int:
    """LOOP_ERRORS{site=device_explain}: failures of the explainer's device
    judge, whose pods got no verdict. Every phase fails while it is above
    0 (``emit``)."""
    from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS
    return int(LOOP_ERRORS.items().get((("site", "device_explain"),), 0))


def _explain_encode(nodes, bound, pending, ns_labels=None):
    """A private encoder's encoding of one capture, as the explainer's
    judge makes it. -> (ct, pb, meta, encode ms) on the host."""
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    enc = SnapshotEncoder()
    if ns_labels:
        enc.set_namespaces(ns_labels)
    t0 = time.perf_counter()
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=pending)
    pb = enc.encode_pods(pending, meta, cache_rows=False)
    return ct, pb, meta, (time.perf_counter() - t0) * 1e3


def _explain_verdicts(ct, pb, meta, device):
    """explain_step on ``device`` with the verdicts read back, as the
    explainer's judge reads them. -> (verdicts, valid) numpy."""
    from kubernetes_tpu_torch.models.explain import explain_step
    v, valid = explain_step(ct.to(device), pb.to(device),
                            topo_keys=meta.topo_keys)
    return v.cpu().numpy(), valid.cpu().numpy()


def _explain_rows(verdicts, valid, n_pods, n_nodes):
    """-> (first_fail [P,N] over the real pods and nodes, per-pod
    histograms, per-pod messages)."""
    from kubernetes_tpu_torch.models.explain import (
        failed_scheduling_message, first_fail, reject_histogram)
    ff = first_fail(verdicts, valid)[:n_pods, :n_nodes]
    hists = [reject_histogram(row) for row in ff]
    msgs = [failed_scheduling_message(n_nodes, h, int((row == -1).sum()))
            for h, row in zip(hists, ff)]
    return ff, hists, msgs


def constraint_mix(n_nodes=24, n_pods=32, seed=SEED):
    """A small cluster whose pods fail on taints, host ports, nodeSelectors,
    an unschedulable node and resources. -> (nodes, bound, pending)."""
    import random
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        w = (make_node(f"node-{i}")
             .capacity({"cpu": rng.choice(["2", "4", "8"]),
                        "memory": "8Gi", "pods": "16"})
             .label("disk", rng.choice(["ssd", "hdd"])))
        if i % 3 == 0:
            w.taint("dedicated", "infra", "NoSchedule")
        if i == 5:
            w.unschedulable()
        nodes.append(w.obj())
    bound = [make_pod(f"web-{i}").req({"cpu": "500m"}).host_port(8080)
             .node(f"node-{i}").obj() for i in range(0, n_nodes, 2)]
    pending = []
    for i in range(n_pods):
        w = make_pod(f"pod-{i}").req({"cpu": rng.choice(["1", "3", "16"])})
        r = rng.random()
        if r < 0.3:
            w.host_port(8080)
        elif r < 0.55:
            w.node_selector({"disk": "ssd"})
        elif r < 0.7:
            w.toleration(key="dedicated", operator="Equal", value="infra",
                         effect="NoSchedule")
        pending.append(w.obj())
    return nodes, bound, pending


def explain_parity_phase(devices=("cuda", "cpu")):
    """``explain_step`` on each device over one host encoding of three small
    clusters — ``relational_mix`` (relational filters, a second namespace),
    ``constraint_mix`` (taints, host ports, nodeSelectors, an unschedulable
    node) and a saturated cluster with preemptors (resources): the
    verdicts [F,P,N] and ``valid`` bit-equal, and so the first-fail
    verdicts, histograms and messages."""
    import numpy as np
    from kubernetes_tpu_torch.testing.workloads import (build_saturated,
                                                        relational_mix)
    r_nodes, r_bound, r_pending, ns_labels = relational_mix(
        pods=48, nodes=24, bound=24, seed=SEED)
    s_nodes, s_bound = build_saturated(16)
    cases = {"relational_mix": (r_nodes, r_bound, r_pending, ns_labels),
             "constraint_mix": (*constraint_mix(), None),
             "saturated": (s_nodes, s_bound, preemptors(8), None)}
    out = {}
    for name, (nodes, bound, pending, ns) in cases.items():
        ct, pb, meta, _ = _explain_encode(nodes, bound, pending, ns)
        got = {d: _explain_verdicts(ct, pb, meta, d) for d in devices}
        first = got[devices[0]]
        for d in devices[1:]:
            for i, what in enumerate(("verdicts", "valid")):
                check(np.array_equal(got[d][i], first[i]),
                      f"explain parity {name}: {what} on {devices[0]} "
                      f"differs from {d}")
        rows = {d: _explain_rows(*got[d], len(pending), len(nodes))
                for d in devices}
        ff, hists, msgs = rows[devices[0]]
        for d in devices[1:]:
            check(np.array_equal(rows[d][0], ff) and rows[d][1] == hists
                  and rows[d][2] == msgs,
                  f"explain parity {name}: first-fail verdicts differ")
        total: dict[str, int] = {}
        for h in hists:
            for f, c in h.items():
                total[f] = total.get(f, 0) + c
        out[name] = {"pods": len(pending), "nodes": len(nodes),
                     "shape": list(first[0].shape), "rejects": total,
                     "message_0": msgs[0]}
    check(len({f for o in out.values() for f in o["rejects"]}) >= 6,
          f"explain parity: too few filters reject anything ({out})")
    return out


def explain_count_cases(prefix, ct, pb):
    """{term set: (ct, count_pn arguments)}: the count_pn calls of one
    ``explain_step`` over ``ct`` and ``pb`` — the spread terms whenever the
    batch has any (``spread_mask``), the required affinity and
    anti-affinity terms where it has them (``interpod_required_mask``)."""
    cases = {}
    if pb.sc_valid.shape[1]:
        cases[f"{prefix}_spread"] = (ct, (pb.sc_sel, pb.pod_ns, None, None))
    if pb.aff_valid.shape[1]:
        cases[f"{prefix}_required_affinity"] = (
            ct, (pb.aff_sel, pb.pod_ns, pb.aff_ns_explicit, pb.aff_ns_mask))
    if pb.anti_valid.shape[1]:
        cases[f"{prefix}_required_anti_affinity"] = (
            ct, (pb.anti_sel, pb.pod_ns, pb.anti_ns_explicit,
                 pb.anti_ns_mask))
    return cases


def explain_phase(n_nodes=PREEMPT_NODES, n_pre=PREEMPT_PODS,
                  device="cuda"):
    """``explain_step`` at full width on the card, as the explainer's judge
    runs it (a private encoder's encoding, the verdicts read back): the
    ConnectedPreemption cluster (5000 saturated nodes, 10000 bound pods)
    and its 128 preemptors, every row's histogram
    ``{"NodeResourcesFit": 5000}``; and the path phase's MixedHeterogeneous
    cluster (5000 nodes, 2000 bound) with its first 256 pending pods, the
    first-fail verdicts of 8 sampled pods equal to the port's oracle's
    reasons. For each: the encode ms, ``explain_step`` ms (CUDA events
    around back-to-back calls, read-back included), its launches and the
    device's busy share under torch.profiler, and count_pn's launches a
    call (the driven calls' counts are the ``explain`` path's). -> (the
    summary, count_pn's cases at the shapes those calls gave it: one for
    each launch of a call, for ``kernels_phase``). On the CPU (a
    rehearsal) the times and the cases are left out."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.models.explain import (EXPLAIN_FILTERS,
                                                     REASON_TO_FILTER)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.oracle import OracleScheduler
    from kubernetes_tpu_torch.testing.workloads import build_saturated
    s_nodes, s_bound = build_saturated(n_nodes)
    node_dicts, bound_dicts, batches = workload(n_requests=1)
    m_nodes = [Node.from_dict(d) for d in node_dicts]
    m_bound = [Pod.from_dict(d) for d in bound_dicts]
    m_pending = [Pod.from_dict(d) for d in batches[0][:EXPLAIN_MIXED_PODS]]
    cases = {"connected_preemption": (s_nodes, s_bound,
                                      preemptors(n_pre, ns="preempt")),
             "mixed_heterogeneous": (m_nodes, m_bound, m_pending)}
    enc = {name: _explain_encode(*c) for name, c in cases.items()}
    # the path's driven calls: one judge call per cluster
    kernels.reset_launches()
    verdicts = {}
    per_call = {}
    for name, (ct, pb, meta, _ms) in enc.items():
        before = dict(kernels.LAUNCHES)
        verdicts[name] = _explain_verdicts(ct, pb, meta, device)
        per_call[name] = {k: kernels.LAUNCHES[k] - before[k]
                          for k in kernels.LAUNCHES}
    launches = dict(kernels.LAUNCHES)
    out = {"launches": launches}
    count_cases = {}
    for name, (nodes, bound, pending) in cases.items():
        ct, pb, meta, encode_ms = enc[name]
        if device == "cuda":
            mine = explain_count_cases(f"explain_{name}", ct.to(device),
                                       pb.to(device))
            check(len(mine) == per_call[name].get("count_pn", 0),
                  f"explain {name}: {len(mine)} count_pn cases for "
                  f"{per_call[name].get('count_pn', 0)} launches")
            count_cases.update(mine)
        ff, hists, msgs = _explain_rows(*verdicts[name], len(pending),
                                        len(nodes))
        row = {"nodes": len(nodes), "bound": len(bound),
               "pods": len(pending), "shape": list(verdicts[name][0].shape),
               "encode_ms": encode_ms, "count_pn_launches_per_call":
                   per_call[name].get("count_pn", 0)}
        if name == "connected_preemption":
            want = {"NodeResourcesFit": len(nodes)}
            bad = [i for i, h in enumerate(hists) if h != want]
            check(not bad, f"explain {name}: pods {bad[:4]} judged "
                           f"{[hists[i] for i in bad[:4]]}, not {want}")
            row["message"] = msgs[0]
        else:
            orc = OracleScheduler(nodes, bound)
            step = max(1, len(pending) // EXPLAIN_ORACLE_SAMPLE)
            sample = list(range(0, len(pending), step))[
                :EXPLAIN_ORACLE_SAMPLE]
            t0 = time.perf_counter()
            for pi in sample:
                mask, reasons = orc.feasible(pending[pi])
                for ni, node in enumerate(nodes):
                    got = int(ff[pi, ni])
                    want = (-1 if mask[ni] else EXPLAIN_FILTERS.index(
                        REASON_TO_FILTER[reasons[node.metadata.name]]))
                    check(got == want,
                          f"explain {name}: {pending[pi].key} on "
                          f"{node.metadata.name}: oracle {want}, card {got}")
            row["oracle_sample"] = len(sample)
            row["oracle_s"] = time.perf_counter() - t0
            rejects: dict[str, int] = {}
            for h in hists:
                for f, c in h.items():
                    rejects[f] = rejects.get(f, 0) + c
            row["rejects"] = rejects
        out[name] = row
        if device != "cuda":
            continue
        ct_d, pb_d = ct.to(device), pb.to(device)

        def call(ct_d=ct_d, pb_d=pb_d, meta=meta):
            from kubernetes_tpu_torch.models.explain import explain_step
            v, valid = explain_step(ct_d, pb_d, topo_keys=meta.topo_keys)
            return v.cpu(), valid.cpu()
        row["explain_step_ms"] = cuda_ms(call, iters=10, warmup=2)
        row["profile"] = profile_call(call, f"explain_{name}")
    return out, count_cases


# ------------------------------------------------------------------ extender

EXTENDER_PODS = 512     # the extender cell: MixedHeterogeneous pods placed
EXTENDER_BATCH = 256    # in pops of 256 (the reference's batch_size)
EXTENDER_SERVER_PODS = 4
ZONE_KEY = "topology.kubernetes.io/zone"


def serve_zone_extender(conn, vetoed, zone_of, table) -> None:
    """Extender-process entry (``ZoneExtender``): an HTTP extender whose
    ``/filter`` drops the ``vetoed`` nodes and whose ``/prioritize`` scores
    each node by its zone's entry in ``table``. Sends its port on
    ``conn``; any message received on ``conn`` stops it, and it answers
    with its call counts."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    lock = threading.Lock()
    calls = {"filter": 0, "prioritize": 0}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(n) or b"{}")
            names = payload.get("nodenames") or []
            verb = "filter" if self.path.endswith("/filter") else "prioritize"
            with lock:
                calls[verb] += 1
            if verb == "filter":
                body = {"nodenames": [x for x in names if x not in vetoed]}
            else:
                body = [{"host": x, "score": table.get(zone_of.get(x), 0)}
                        for x in names]
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    class Server(ThreadingHTTPServer):
        # run_extenders fans a batch out on 16 threads: the default listen
        # backlog of 5 refuses some of their connections
        request_queue_size = 128
        daemon_threads = True

    httpd = Server(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    conn.send(httpd.server_address[1])
    try:
        conn.recv()
    except EOFError:
        pass  # the parent went away: stop all the same
    httpd.shutdown()
    httpd.server_close()
    with lock:
        conn.send(dict(calls))


class ZoneExtender:
    """A scheduler extender in its own spawned process, as an extender is
    a service of its own: ``/filter`` vetoes the nodes of a seeded subset
    of zones (3 of 10), ``/prioritize`` scores every node 0..10 by a
    seeded per-zone table. Node-cache capable: it keeps its own node ->
    zone map, as such an extender watches nodes."""

    def __init__(self, node_dicts, seed=SEED):
        import multiprocessing as mp
        import random
        rng = random.Random(seed)
        zone_of = {d["metadata"]["name"]: d["metadata"]["labels"].get(ZONE_KEY)
                   for d in node_dicts}
        zones = sorted({z for z in zone_of.values() if z})
        banned_zones = set(rng.sample(zones, max(1, 3 * len(zones) // 10)))
        table = {z: rng.randint(0, 10) for z in zones}
        self.vetoed = {n for n, z in zone_of.items() if z in banned_zones}
        self.calls = None  # filled in by stop()
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=serve_zone_extender,
                                 args=(child, self.vetoed, zone_of, table),
                                 daemon=True)
        self._proc.start()
        check(self._conn.poll(120.0), "the zone extender did not start")
        self.url = f"http://127.0.0.1:{self._conn.recv()}"

    def config(self):
        """The scheduler's extender entry: filter and prioritize verbs,
        node-cache capable, weight 1."""
        from kubernetes_tpu_torch.sched.extender import ExtenderConfig
        return ExtenderConfig(url_prefix=self.url, filter_verb="filter",
                              prioritize_verb="prioritize", weight=1.0,
                              node_cache_capable=True, timeout_s=60.0)

    def stop(self):
        """Stop the process; ``calls`` then holds its call counts."""
        if self._proc is None:
            return
        try:
            self._conn.send("stop")
            if self._conn.poll(30.0):
                self.calls = self._conn.recv()
        except (OSError, EOFError):
            pass
        stop_process(self._proc)
        self._proc = None


def _drive_extender_scheduler(node_dicts, pod_dicts, ext, device, batch):
    """The port's Scheduler with ``ext`` configured, PreemptionSimulation
    off, pops of ``batch`` (max_drain_batches 1: the group path, which
    extenders take anyway). -> (binder log {pod: node}, window s from the
    first queue.add to the last binding)."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    sched, log = make_scheduler(
        sched_config(batch_size=batch, max_drain_batches=1,
                     extenders=[ext.config()]),
        [Node.from_dict(d) for d in node_dicts], device=device)
    pods = [Pod.from_dict(d) for d in pod_dicts]
    try:
        t0 = time.perf_counter()
        for p in pods:
            sched.queue.add(p)
        while (sched.queue.stats()["active"] or sched._pending
               or sched._staged):
            sched.run_once(wait=0.01)
        sched.wait_for_bindings(60.0)
        window = (max(t for _k, _n, t in log) - t0) if log else 0.0
    finally:
        sched.close()
    return {k: n for k, n, _t in log}, window


def extender_parity_phase(devices=("cuda", "cpu")):
    """The port's Scheduler with one HTTP extender (``ZoneExtender``:
    a seeded zone veto and per-zone scores) over a 32-node
    MixedHeterogeneous cluster, 96 pods in pops of 32, on each device: the
    placements equal, none on a vetoed node, the placements checked."""
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    node_objs, pod_objs = mixed_heterogeneous(pods=96, nodes=32, seed=SEED)
    node_dicts, pod_dicts = _wire(node_objs), _wire(pod_objs)
    ext = ZoneExtender(node_dicts)
    try:
        logs = {d: _drive_extender_scheduler(node_dicts, pod_dicts, ext, d,
                                             32)[0] for d in devices}
    finally:
        ext.stop()
    first = logs[devices[0]]
    for d in devices[1:]:
        check(logs[d] == first, f"extender parity: placements on "
                                f"{devices[0]} differ from {d}")
    check(not set(first.values()) & ext.vetoed,
          "extender parity: a pod landed on a vetoed node")
    check(ext.calls["filter"] == len(pod_dicts) * len(devices),
          f"extender parity: {ext.calls} extender calls for "
          f"{len(pod_dicts)} pods on {len(devices)} devices")
    by_name = {d["metadata"]["name"]: d for d in pod_dicts}
    placed = [dict(by_name[k.split("/", 1)[1]],
                   spec=dict(by_name[k.split("/", 1)[1]]["spec"],
                             nodeName=n)) for k, n in first.items()]
    check_placements(node_dicts, [], placed, len(pod_dicts))
    return {"pods": len(pod_dicts), "nodes": len(node_dicts),
            "placed": len(first), "vetoed_nodes": len(ext.vetoed),
            "extender_calls": dict(ext.calls)}


def _post_json(url, payload, timeout=300.0):
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = json.loads(r.read())
    return body, (time.perf_counter() - t0) * 1e3


def extender_count_cases(node_dicts, pod_dicts, placements,
                         batch=EXTENDER_BATCH):
    """count_pn's inputs as the extender scheduler's last pop met them in
    its first gang round: the last pop's pods (the queue pops in arrival
    order: MixedHeterogeneous pods carry no priority) encoded against the
    nodes with every earlier pod bound where it was placed, the cluster
    extended by the batch as ``gang_schedule`` extends it. Every earlier
    pod must have been placed, or the last pop saw another cluster."""
    last = (len(pod_dicts) - 1) // batch * batch
    earlier = pod_dicts[:last]
    keys = [f"{d['metadata'].get('namespace', 'default')}/"
            f"{d['metadata']['name']}" for d in earlier]
    missing = [k for k in keys if k not in placements]
    check(not missing, f"extender: earlier pods {missing[:4]} were not "
                       "placed, so the last pop's cluster is not known")
    bound = [dict(d, spec=dict(d["spec"], nodeName=placements[k]))
             for d, k in zip(earlier, keys)]
    ct, pb = _encoded(node_dicts, bound, pod_dicts[last:])
    return _term_cases("extender", ct, pb)


def extender_phase(n_nodes=N_NODES, n_pods=EXTENDER_PODS, device=None):
    """Extenders at full width. (a) The port's Scheduler with one
    HTTPExtender (``ZoneExtender``: filter and prioritize, node-cache
    capable, weight 1) places 512 MixedHeterogeneous pods on 5000 nodes in
    pops of 256, through the group path (extenders turn the drain off):
    every placement passes the veto and ``check_placements``, 0 loop
    errors; pods/s over the window from the first queue.add to the last
    binding, the ``scheduler/extenders`` span. (b) ``TPUExtenderServer``
    on the card over the same cluster with (a)'s pods bound answers
    ``/filter`` and ``/prioritize`` for 4 more pods in both wire forms
    (``nodenames``, and full node objects as a stock kube-scheduler sends
    them); each response equals the CPU server's for the same request —
    node names exactly, the 0..10 scores within 1 (a float32 score at a
    rounding step may round either way; the count that differ is
    reported) — with the card server's ms a request. ``device``: the
    scheduler's and the first server's (the card unless a rehearsal on
    the CPU asks for it). -> (the summary, count_pn's cases at the shapes
    of (a)'s last pop, for ``kernels_phase``; none on the CPU)."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.metrics.registry import (LOOP_ERRORS,
                                                       SCHEDULE_ATTEMPTS)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.extender_server import TPUExtenderServer
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    from kubernetes_tpu_torch.utils.tracing import TRACER
    node_objs, pod_objs = mixed_heterogeneous(
        pods=n_pods + EXTENDER_SERVER_PODS, nodes=n_nodes, seed=SEED)
    node_dicts = _wire(node_objs)
    pod_dicts = _wire(pod_objs[:n_pods])
    extra = _wire(pod_objs[n_pods:])
    ext = ZoneExtender(node_dicts)
    try:
        errors0 = sum(LOOP_ERRORS.items().values())
        attempt_errors0 = SCHEDULE_ATTEMPTS.get({"result": "error"})
        TRACER.reset()
        kernels.reset_launches()
        log, window = _drive_extender_scheduler(
            node_dicts, pod_dicts, ext, device, EXTENDER_BATCH)
        launches = dict(kernels.LAUNCHES)
        spans = _span_totals()
        errors = sum(LOOP_ERRORS.items().values()) - errors0
        attempt_errors = (SCHEDULE_ATTEMPTS.get({"result": "error"})
                          - attempt_errors0)
    finally:
        ext.stop()
    check(errors == 0, f"extender: {errors} loop errors")
    check(attempt_errors == 0,
          f"extender: {attempt_errors} attempt errors (extender calls failed)")
    check(not set(log.values()) & ext.vetoed,
          "extender: a pod landed on a vetoed node")
    by_name = {d["metadata"]["name"]: d for d in pod_dicts}
    placed = [dict(by_name[k.split("/", 1)[1]],
                   spec=dict(by_name[k.split("/", 1)[1]]["spec"],
                             nodeName=n)) for k, n in log.items()]
    check_placements(node_dicts, [], placed, len(pod_dicts))
    sched_sum = {
        "pods": len(pod_dicts), "nodes": len(node_dicts),
        "placed": len(log), "vetoed_nodes": len(ext.vetoed),
        "window_s": window, "pods_per_s": len(log) / window,
        "extender_calls": dict(ext.calls), "loop_errors": errors,
        "attempt_errors": attempt_errors,
        "spans": {k: v for k, v in spans.items()
                  if k.startswith("scheduler/")}}

    nodes = [Node.from_dict(d) for d in node_dicts]
    bound = [Pod.from_dict(d) for d in placed]
    servers = {"cuda": TPUExtenderServer(device=device).start(),
               "cpu": TPUExtenderServer(device="cpu").start()}
    requests = []
    try:
        for s in servers.values():
            s.set_cluster(nodes, bound)
        names = [d["metadata"]["name"] for d in node_dicts]
        for d in extra:
            for wire in ("nodenames", "nodes"):
                payload = {"pod": d}
                if wire == "nodenames":
                    payload["nodenames"] = names
                else:
                    payload["nodes"] = {"items": node_dicts}
                for verb in ("filter", "prioritize"):
                    got = {dev: _post_json(f"{s.url}/{verb}", payload)
                           for dev, s in servers.items()}
                    card, cpu = got["cuda"][0], got["cpu"][0]
                    for dev, body in (("card", card), ("CPU", cpu)):
                        check(not (isinstance(body, dict) and "error" in body),
                              f"extender server on the {dev}: {body}")
                    row = {"pod": d["metadata"]["name"], "wire": wire,
                           "verb": verb, "ms": got["cuda"][1],
                           "cpu_ms": got["cpu"][1]}
                    if verb == "filter":
                        check(card == cpu, f"extender server: /filter "
                                           f"({wire}) differs from the CPU's")
                        kept = (card.get("nodenames") if wire == "nodenames"
                                else [it["metadata"]["name"]
                                      for it in card["nodes"]["items"]])
                        row["feasible"] = len(kept)
                    else:
                        check([h["host"] for h in card]
                              == [h["host"] for h in cpu],
                              f"extender server: /prioritize ({wire}) hosts "
                              "differ from the CPU's")
                        diff = [abs(a["score"] - b["score"])
                                for a, b in zip(card, cpu)]
                        check(max(diff) <= 1, f"extender server: a score "
                                              f"differs by {max(diff)}")
                        row["scores_differing"] = sum(1 for x in diff if x)
                    requests.append(row)
    finally:
        for s in servers.values():
            s.stop()
    ms = [r["ms"] for r in requests]
    count_cases = (extender_count_cases(node_dicts, pod_dicts, log)
                   if device in (None, "cuda") else {})
    return ({**sched_sum, "launches": launches,
             "server": {"requests": len(requests),
                        "ms_per_request": sum(ms) / len(ms),
                        "max_ms": max(ms), "rows": requests}},
            count_cases)


# ------------------------------------------------------------------ main

# ------------------------------------------------------------------ slices

# SliceCarve/16x16x16: a TPU v4 pod's 4096-position 3D torus (Jouppi et
# al., ISCA 2023; the Cloud TPU v4 slice topologies 2x2x4 ... 16x16x16),
# one node per torus cell as benchmarks/slicecarve.py maps cells, one
# member filling one host as GKE TPU pods do
SLICE_DIMS = (16, 16, 16)
SLICE_NODE_CAPACITY = {"cpu": "240", "memory": "407Gi",
                       "google.com/tpu": "4", "pods": "110"}
SLICE_MEMBER = {"cpu": "8", "memory": "32Gi", "google.com/tpu": "4"}
SLICE_SHAPES = (("2x2x4", 0.4), ("4x4x4", 0.3), ("4x4x8", 0.2),
                ("8x8x8", 0.1))
# single-host background: 5% of the cells at seeded uniform positions,
# priority 0. Such a background leaves no 8x8x8 box free (each box clears
# all 205 with probability (1 - 512/4096)**205, about 1e-12), so the
# fill's gangs run at a priority above it and a gang that finds no free
# box slice-preempts the background pods on the cheapest one.
SLICE_BACKGROUND = 205
SLICE_FILL_PRIORITY = 100
SLICE_GANGS = 40          # the fill's gangs
SLICE_HOLD = 0.70         # gangs stay bound until this share is occupied
SLICE_SPREAD_EVERY = 4    # one gang in four carries a soft hostname spread
SLICE_FAIL = "8x8x16"
SLICE_PREEMPT = "4x4x8"
SLICE_PREEMPT_PRIORITY = 1000
SLICE_NS = "slice"
SLICE_GANG_TIMEOUT_S = 120.0
SLICE_CARVE_CALLS = 10


def _prod(shape):
    return shape[0] * shape[1] * shape[2]


def slice_node_objs(dims=SLICE_DIMS, capacity=None, holes=(),
                    unschedulable=()):
    """One node per torus cell, ``tn-x-y-z``, with its topology labels;
    ``holes`` and ``unschedulable`` are flat cell indices."""
    from kubernetes_tpu_torch.testing.wrappers import make_node
    from kubernetes_tpu_torch.topology.slicing import topology_labels
    holes, unschedulable = set(holes), set(unschedulable)
    out = []
    for i in range(_prod(dims)):
        if i in holes:
            continue
        x, y, z = (i // (dims[1] * dims[2]), (i // dims[2]) % dims[1],
                   i % dims[2])
        nb = make_node(f"tn-{x}-{y}-{z}").capacity(
            capacity or SLICE_NODE_CAPACITY)
        for k, v in topology_labels(x, y, z).items():
            nb = nb.label(k, v)
        if i in unschedulable:
            nb = nb.unschedulable()
        out.append(nb.obj())
    return out


def slice_gang_objs(gid, shape, prio=0, spread=False, ns=SLICE_NS,
                    request=None):
    """A slice gang: members ``gid-0000`` ... carrying the gang and
    slice-shape labels; ``spread`` adds a ScheduleAnyway hostname spread
    over the gang's label (the gang program then reaches count_pn)."""
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    from kubernetes_tpu_torch.topology.slicing import (GANG_LABEL,
                                                       SLICE_SHAPE_LABEL,
                                                       parse_shape)
    pods = []
    for m in range(_prod(parse_shape(shape))):
        pw = (make_pod(f"{gid}-{m:04d}", ns).req(request or SLICE_MEMBER)
              .labels({GANG_LABEL: gid, SLICE_SHAPE_LABEL: shape}))
        if prio:
            pw = pw.priority(prio)
        if spread:
            pw = pw.spread(1, "kubernetes.io/hostname", "ScheduleAnyway",
                           {GANG_LABEL: gid})
        pods.append(pw.obj())
    return pods


def carve_full_cluster(seed=SEED, dims=SLICE_DIMS):
    """The full-size carve check's cluster: the torus cut into 4x4x4 cubes,
    each drawn empty (40%), full (35%: a member-sized pod on every cell)
    or mixed (25%: seeded holes, unschedulable nodes, member-sized and
    small pods, claimed cells), so that small shapes fit, large ones have
    finite eviction costs, and every branch of the cell verdict is hit.
    -> (nodes, bound pods, claimed node indices, a member pod)."""
    import numpy as np
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    rng = np.random.default_rng(seed)
    n = _prod(dims)
    cube = [((i // (dims[1] * dims[2])) // 4, ((i // dims[2]) % dims[1])
             // 4, (i % dims[2]) // 4) for i in range(n)]
    state = {c: rng.choice(3, p=[0.4, 0.35, 0.25]) for c in sorted(set(cube))}
    kind = rng.random(n)
    mixed = np.array([state[c] == 2 for c in cube])
    nodes = slice_node_objs(dims, holes=np.flatnonzero(mixed & (kind < 0.05)),
                            unschedulable=np.flatnonzero(
                                mixed & (kind >= 0.05) & (kind < 0.1)))
    cell_of = {nd.metadata.name: i for i, nd in enumerate(
        slice_node_objs(dims))}
    bound = []
    claimed = set()
    for j, nd in enumerate(nodes):
        i = cell_of[nd.metadata.name]
        s, u = state[cube[i]], kind[i]
        if s == 1 or (s == 2 and 0.1 <= u < 0.4):
            req = SLICE_MEMBER
        elif s == 2 and u < 0.7:
            req = {"cpu": "2", "memory": "4Gi"}
        else:
            if s == 2 and u >= 0.9:
                claimed.add(j)
            continue
        bound.append(make_pod(f"bound-{j}").req(req)
                     .node(nd.metadata.name).obj())
    member = slice_gang_objs("g", "2x2x4", ns="default")[0]
    return nodes, bound, claimed, member


def carve_full_encoding(nodes, bound, member, device):
    """(ct on ``device``, member_req, tenant) as the scheduler's carve
    reads them: the port's encoder over the cluster, the member's
    request row and tenant label value."""
    import numpy as np
    from kubernetes_tpu_torch.encode.snapshot import (TENANT_KEY_ID,
                                                      SnapshotEncoder)
    enc = SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, bound, pending_pods=[member])
    pb = enc.encode_pods([member], meta)
    member_req = np.asarray(pb.requests)[0]
    tenant = int(np.asarray(pb.pod_labels)[0, TENANT_KEY_ID])
    return ct.to(device), member_req, tenant


def carve_full_parity(device, seed=SEED, dims=SLICE_DIMS):
    """carve_step on ``device`` against the numpy twin (the port's oracle
    carver over NodeStates) at 16x16x16, every shape of the slice phase
    and the failing 8x8x16, every rotation: fits, cost, node_grid and
    free_grid bit-equal, select_assignment and select_eviction equal.
    -> {shape: summary}."""
    import numpy as np
    from kubernetes_tpu_torch.sched.oracle import OracleScheduler
    from kubernetes_tpu_torch.topology import carve
    from kubernetes_tpu_torch.topology.slicing import parse_shape
    nodes, bound, claimed, member = carve_full_cluster(seed, dims)
    ct, member_req, tenant = carve_full_encoding(nodes, bound, member,
                                                 device)
    claimed_np = np.zeros(ct.node_valid.shape[0], bool)
    claimed_np[sorted(claimed)] = True
    orc = OracleScheduler(nodes, bound)
    out = {}
    for shape in [s for s, _w in SLICE_SHAPES] + [SLICE_FAIL]:
        shp = parse_shape(shape)
        got = carve.carve_device(ct, member_req, tenant, claimed_np,
                                 dims, shp)
        want = orc.oracle_carve([member], shp, claimed)
        if got is None or want is None:
            check(got is None and want is None,
                  f"parity.slice: {shape} fits the grid on one side only")
            out[shape] = {"rotations": 0}
            continue
        for f in ("fits", "cost", "node_grid", "free_grid"):
            a, b = getattr(got, f), getattr(want, f)
            check(a.dtype == b.dtype and a.shape == b.shape
                  and np.array_equal(a, b),
                  f"parity.slice: carve_step {f} for {shape} differs from "
                  "the numpy twin")
        check(got.rots == want.rots, f"parity.slice: rotations of {shape}")
        asg = carve.select_assignment(got)
        ev = carve.select_eviction(got)
        check(asg == carve.select_assignment(want)
              and ev == carve.select_eviction(want),
              f"parity.slice: selections for {shape} differ")
        out[shape] = {"rotations": len(got.rots),
                      "origins": int(got.fits.sum()),
                      "free_cells": int(got.free_grid.sum()),
                      "first_fit": None if asg is None else asg[0],
                      "cheapest_cost": None if ev is None else ev[2]}
    return out


def _slice_small_run(device):
    """The reference's SliceCarve layout through the port's Scheduler on
    ``device``: a 4x4x2 torus (8 CPU a node), 4 cells pinned near-full,
    two 2x2x2 gangs of full-node members, a 4x4x2 gang that cannot be
    carved (its events and explanations), then a 2x2x2 gang at priority
    100 that only slice preemption can place. -> what must be equal."""
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    dims = (4, 4, 2)
    nodes = slice_node_objs(dims, capacity={"cpu": "8", "memory": "16Gi",
                                            "pods": "32"})
    frag = [make_pod(f"frag-{i}", "default").req({"cpu": "7500m"})
            .node(nodes[i * 8].metadata.name).obj() for i in range(4)]
    cfg = sched_config(batch_size=8, explainer_enabled=True,
                       parity_sample_every=1)
    sched, log = make_scheduler(cfg, nodes, frag, device=device,
                                gate=preemption_gate())
    events, evicted = [], []

    class Recorder:
        def event(self, obj, type_, reason, message):
            events.append((obj.key, type_, reason, message))

        def flush(self):
            pass
    sched.recorder = Recorder()
    evict = sched._evict
    sched._evict = lambda v: evicted.append(v.key) or evict(v)
    sched._drain_ready = lambda pend: False
    full = {"cpu": "8", "memory": "1Gi"}
    gangs = [slice_gang_objs(f"g{k}", "2x2x2", ns="default", request=full)
             for k in range(2)]
    big = slice_gang_objs("big", "4x4x2", ns="default", request=full)
    hi = slice_gang_objs("hi", "2x2x2", prio=100, ns="default",
                         request=full)

    def drive(pods, pops=6):
        for p in pods:
            sched.queue.add(p)
        for _ in range(pops):
            if sum(sched.queue.stats().values()) == 0:
                break
            sched.run_once(wait=0.01)
            sched.sentinel.drain(60.0)
        sched.wait_for_bindings(30.0)

    try:
        for g in gangs:
            drive(g)
        drive(big, pops=1)
        for p in big:
            sched.queue.delete(p)
        drive(hi)
        sched.explainer.drain(60.0)
        with sched._carve_lock:
            stats = dict(sched._carve_stats)
        return {
            "binds": sorted((k, n) for k, n, _t in log),
            "events": sorted(events), "evicted": evicted,
            "nominated": sorted((p.key, p.status.nominated_node_name)
                                for p in hi if p.status.nominated_node_name),
            # the distinct verdicts: how many members the explainer takes
            # before its backlog is full depends on its thread's pace
            "explanations": sorted({json.dumps(
                {k: v for k, v in e.items() if k != "ts"}, sort_keys=True)
                for e in (sched.explainer.explain_of(p.key) for p in big)
                if e}),
            "carve_stats": stats, "topology": sched.topology_status(),
            "sentinel": {"carve": sched.sentinel.samples["carve"],
                         "divergences": sched.sentinel.divergences}}
    finally:
        sched.close()


def slice_parity_phase(devices=("cuda", "cpu"), dims=SLICE_DIMS):
    """parity.slice: the small SliceCarve layout through the port's
    Scheduler on both devices (binder logs, events, evictions,
    nominations, explanations, carve counters, topology_status and the
    sentinel's carve samples equal), and carve_step on the first device
    against the numpy twin at 16x16x16."""
    runs = [_slice_small_run(d) for d in devices]
    check(runs[0] == runs[1], "parity.slice: the Scheduler differs between "
                              f"{devices[0]} and {devices[1]}")
    r = runs[0]
    stats = r["carve_stats"]
    check(stats == {"carved": 3, "failed": 2, "slicePreempts": 1},
          f"parity.slice: carve counters {stats}")
    check(len(r["binds"]) == 3 * 8,
          f"parity.slice: {len(r['binds'])} binds, want 24")
    check(r["evicted"] and r["nominated"],
          "parity.slice: the slice preemption evicted or nominated nothing")
    check(r["explanations"] and all(json.loads(e)["mode"] == "carve"
                                    for e in r["explanations"]),
          f"parity.slice: explanations {r['explanations']}")
    check(r["sentinel"]["carve"] >= stats["carved"]
          and r["sentinel"]["divergences"] == 0,
          f"parity.slice: sentinel {r['sentinel']}")
    full = carve_full_parity(devices[0], dims=dims)
    return {"small": {"binds": len(r["binds"]), "evicted": len(r["evicted"]),
                      "nominated": len(r["nominated"]),
                      "events": len(r["events"]), "carve_stats": stats,
                      "topology": r["topology"],
                      "sentinel": r["sentinel"]},
            "full": full}


def _slice_delete(client, runner, gangs, pool):
    """Delete the gangs' pods over HTTP and wait until the scheduler's
    cache has dropped them (the next carve must see the cells free)."""
    names = [n for _gid, members, _cells in gangs for n in members]
    list(pool.map(lambda n: client.pods(SLICE_NS).delete(n), names))
    keys = [f"{SLICE_NS}/{n}" for n in names]
    deadline = time.perf_counter() + SLICE_GANG_TIMEOUT_S
    while any(runner.cache.is_assumed_or_bound(k) for k in keys):
        check(time.perf_counter() < deadline,
              "slice: deleted pods are still in the scheduler's cache")
        time.sleep(0.005)


def _slice_run_gang(client, runner, pods):
    """Create one gang over HTTP, wait until the informer queued all of
    it, drive run_once until every member is assumed, then until the API
    shows every member bound. -> (create-to-full-bind s, queued s,
    {name: node})."""
    from kubernetes_tpu_torch.topology.slicing import GANG_LABEL
    sched = runner.scheduler
    gid = pods[0].metadata.labels[GANG_LABEL]
    keys = [p.key for p in pods]
    t0 = time.perf_counter()
    client.pods(SLICE_NS).create_many(_wire(pods))
    deadline = t0 + SLICE_GANG_TIMEOUT_S
    while sum(runner.queue.stats().values()) < len(pods):
        check(time.perf_counter() < deadline,
              f"slice: gang {gid} never reached the queue")
        time.sleep(0.001)
    queued_s = time.perf_counter() - t0
    while not all(runner.cache.is_assumed_or_bound(k) for k in keys):
        check(time.perf_counter() < deadline,
              f"slice: gang {gid} was not placed in "
              f"{SLICE_GANG_TIMEOUT_S} s")
        sched.run_once(wait=0.01)
    sched.wait_for_bindings(SLICE_GANG_TIMEOUT_S)
    while True:
        listed = client.pods(SLICE_NS).list(
            label_selector=f"{GANG_LABEL}={gid}")
        placed = {p["metadata"]["name"]: p["spec"].get("nodeName")
                  for p in listed}
        if len(placed) == len(pods) and all(placed.values()):
            return time.perf_counter() - t0, queued_s, placed
        check(time.perf_counter() < deadline,
              f"slice: gang {gid} not bound in the API")
        time.sleep(0.002)


def _slice_grids(occupied, shape, coords, dims):
    """The numpy twin over the phase's own view of the torus: one node a
    cell, one pod on each ``occupied`` cell, every cell evictable for a
    member on its own (the scheduler's carve reads the same verdicts)."""
    from kubernetes_tpu_torch.topology.carve import numpy_grids
    from kubernetes_tpu_torch.topology.slicing import parse_shape
    n = len(coords)
    return numpy_grids(coords, [i not in occupied for i in range(n)],
                       [True] * n, [int(i in occupied) for i in range(n)],
                       dims, parse_shape(shape))


def _slice_origins(occupied, shape, coords, dims):
    """Carveable origins of ``shape`` with the ``occupied`` cells taken."""
    res = _slice_grids(occupied, shape, coords, dims)
    return 0 if res is None else int(res.fits.sum())


def _slice_placeable(gang_cells, background, shape, coords, dims):
    """Whether a fill gang of ``shape`` binds: on a free box, or on the
    box its slice preemption picks (the cheapest, first in flat order) if
    that box holds only background pods, which the gang may preempt.
    Another gang's member on that box (the same priority) abandons the
    preemption."""
    from kubernetes_tpu_torch.topology import carve
    res = _slice_grids(gang_cells | background, shape, coords, dims)
    if carve.select_assignment(res) is not None:
        return True
    ev = carve.select_eviction(res)
    return ev is not None and not gang_cells.intersection(ev[0])


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), q)) if xs else None


def slice_phase(device=None, dims=SLICE_DIMS, n_gangs=SLICE_GANGS,
                n_background=SLICE_BACKGROUND, seed=SEED):
    """SliceCarve/16x16x16 through the port: the APIServer in a spawned
    process, 4096 nodes (one a torus cell) and the background pods seeded,
    ``SchedulerRunner(HTTPClient(url, wire="json"))`` with the reference
    defaults, PreemptionSimulation on, the explainer on, the parity
    sentinel on every carve and a fail-fast auditor every 2 s; informers
    synced. The phase drives ``run_once`` itself once a gang's members all
    sit in the queue, a stand-in for the runner's loop: the loop pops
    whatever the informer has queued, so a gang created while it runs
    reaches it in fragments, each failing its carve on the member count,
    in the reference as here (``tests/test_torch_carve.py``
    ``test_runner_loop_carves_a_gang_only_when_it_arrives_whole``, ROADMAP
    Queue C).

    Fill: a seeded stream of gangs (2x2x4 : 4x4x4 : 4x4x8 : 8x8x8 = 0.4 :
    0.3 : 0.2 : 0.1) at priority 100 over a uniform 5% background at
    priority 0, one gang in four with a soft hostname spread; each gang is
    created once the previous one is bound in the API, on a free box or,
    when none is left, by slice-preempting the background pods on the
    cheapest box; from 70% occupancy on the oldest gang is deleted before
    each new one, and more until the new gang can bind without evicting
    another gang. Fail: an 8x8x16 gang at
    priority 0 (the carve's FailedScheduling event and its
    ``{"SliceCarve": N}`` explanation), deleted again. Preempt: 2x2x4 gangs
    until no 4x4x8 origin is free, then a 4x4x8 gang at priority 1000,
    which must bind on the box ``select_eviction`` names, by one slice
    preemption whose victims are the pods on that box.

    Reports gangs, carves/s, create-to-bind p50/p99, the carve and gang
    spans, carve_step ms per shape (CUDA events, 10 calls with the
    read-back), its launches and busy share under torch.profiler,
    topology_status(), the sentinel, the auditor, loop errors and
    count_pn's launches. -> (summary, count_pn cases)."""
    import multiprocessing as mp
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from kubernetes_tpu_torch.audit.auditor import (InvariantAuditor,
                                                    InvariantViolationError)
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.encode.snapshot import TENANT_KEY_ID
    from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS
    from kubernetes_tpu_torch.models.gang import extend_cluster
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.oracle import OracleScheduler
    from kubernetes_tpu_torch.sched.runner import (EXPLAIN_CONFIGMAP,
                                                   SchedulerRunner)
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    from kubernetes_tpu_torch.topology import carve
    from kubernetes_tpu_torch.topology.slicing import (is_contiguous_slice,
                                                       parse_shape, rotations)
    from kubernetes_tpu_torch.utils.tracing import TRACER
    rng = np.random.default_rng(seed)
    n_cells = _prod(dims)
    nodes = slice_node_objs(dims)
    coords = [(i // (dims[1] * dims[2]), (i // dims[2]) % dims[1],
               i % dims[2]) for i in range(n_cells)]
    node_cell = {nd.metadata.name: i for i, nd in enumerate(nodes)}
    bg_cells = rng.choice(n_cells, n_background, replace=False)
    background = [make_pod(f"bg-{i}", SLICE_NS)
                  .req({"google.com/tpu": "4"})
                  .node(nodes[int(c)].metadata.name).obj()
                  for i, c in enumerate(bg_cells)]
    ctx = mp.get_context("spawn")
    server, server_pipe, url = start_apiserver(ctx)
    runner = None
    pool = ThreadPoolExecutor(max_workers=8)
    try:
        client = HTTPClient(url, timeout=120.0, wire="json")
        t0 = time.perf_counter()
        client.nodes().create_many(_wire(nodes))
        client.pods(SLICE_NS).create_many(_wire(background))
        seed_s = time.perf_counter() - t0
        cfg = sched_config(parity_sample_every=1, explainer_enabled=True,
                           audit_interval_s=CONNECTED_AUDIT_S,
                           audit_fail_fast=True)
        runner = SchedulerRunner(HTTPClient(url, wire="json"), cfg,
                                 feature_gate=preemption_gate(),
                                 device=device)
        runner.auditor = InvariantAuditor(
            client=HTTPClient(url, timeout=60.0, wire="json"),
            cache=runner.cache, scheduler=runner.scheduler,
            interval_s=CONNECTED_AUDIT_S, fail_fast=True,
            pre_sweep=runner.sweep_stale_nominations,
            post_sweep=runner.publish_status,
            relists=runner._total_relists)
        t0 = time.perf_counter()
        runner.start(wait_sync=120.0, start_loop=False)
        check(runner.has_synced(), "slice: the informers did not sync")
        sync_s = time.perf_counter() - t0
        sched = runner.scheduler
        sched._drain_ready = lambda pend: False

        # one warm gang, deleted again: the first carve, gang program and
        # bind pay their one-time costs outside the measured traffic
        warm = slice_gang_objs("warm", "2x2x4")
        t0 = time.perf_counter()
        _w_s, _w_q, w_placed = _slice_run_gang(client, runner, warm)
        _slice_delete(client, runner, [("warm", [p.metadata.name
                                                 for p in warm], ())], pool)
        warm_s = time.perf_counter() - t0

        errors0 = dict(LOOP_ERRORS.items())
        with sched._carve_lock:
            stats0 = dict(sched._carve_stats)
        samples0 = sched.sentinel.samples["carve"]
        # every span of the traffic kept (a few dozen a gang)
        TRACER.max_spans = max(TRACER.max_spans, 64 * 1024)
        TRACER.reset()
        kernels.reset_launches()
        gang_cells: set = set()  # cells of the live gangs
        live: deque = deque()   # (gid, member names, cells), oldest first
        gangs: list = []        # every gang carved and bound
        # shape -> the last spread gang's count_pn inputs on the host,
        # captured while it is bound (a later delete empties its counts);
        # the capture's time is taken out of the traffic's windows
        spread_inputs: dict = {}
        capture_s = 0.0
        k = 0

        def background_cells():
            return {node_cell[p.spec.node_name]
                    for p in runner.cache.bound_pods()
                    if p.metadata.name.startswith("bg-")}

        background_left = background_cells()

        def run(shape, prio=SLICE_FILL_PRIORITY, spread=None):
            nonlocal k, background_left, capture_s
            gid = f"s{k:03d}-{shape}"
            if spread is None:
                spread = k % SLICE_SPREAD_EVERY == SLICE_SPREAD_EVERY - 1
            pods = slice_gang_objs(gid, shape, prio=prio, spread=spread)
            k += 1
            took, queued, placed = _slice_run_gang(client, runner, pods)
            cells = {node_cell[n] for n in placed.values()}
            ok = is_contiguous_slice([coords[c] for c in cells],
                                     parse_shape(shape), dims)
            check(ok, f"slice: gang {gid} is not a contiguous {shape}: "
                      f"{sorted(placed.values())[:8]}")
            gang_cells.update(cells)
            live.append((gid, sorted(placed), cells))
            left = background_cells()
            gangs.append({"gang": gid, "shape": shape, "bind_s": took,
                          "queued_s": queued, "spread": spread,
                          "evicted": len(background_left - left)})
            background_left = left
            if spread:
                t_cap = time.perf_counter()
                views = [Pod.from_dict(_wire([p])[0]) for p in pods]
                _n, sct, smeta = runner.cache.snapshot(pending_pods=views)
                spread_inputs[shape] = (sct, runner.cache.encode_pods(
                    views, smeta, min_p=sched.cfg.batch_size))
                capture_s += time.perf_counter() - t_cap
            return cells

        t_start, t_start_wall = time.perf_counter(), time.time()
        draws = rng.choice(len(SLICE_SHAPES), n_gangs,
                           p=[w for _s, w in SLICE_SHAPES])
        deleted = 0
        for d in draws:
            shape = SLICE_SHAPES[int(d)][0]
            drop = []
            if ((len(gang_cells) + len(background_left)) / n_cells
                    >= SLICE_HOLD and live):
                drop.append(live.popleft())
            while not _slice_placeable(
                    gang_cells - {c for g in drop for c in g[2]},
                    background_left, shape, coords, dims):
                check(live, f"slice: no {shape} box on a torus without "
                            "gangs")
                drop.append(live.popleft())
            if drop:
                _slice_delete(client, runner, drop, pool)
                for g in drop:
                    gang_cells.difference_update(g[2])
                deleted += len(drop)
            run(shape)
        fill_s = time.perf_counter() - t_start - capture_s
        fill_gangs = len(gangs)
        with sched._carve_lock:
            fill_preempts = (sched._carve_stats["slicePreempts"]
                             - stats0["slicePreempts"])
        occupancy = (len(gang_cells) + len(background_left)) / n_cells

        # fail: a slice no origin can host
        fail = slice_gang_objs("fail", SLICE_FAIL)
        t0 = time.perf_counter()
        client.pods(SLICE_NS).create_many(_wire(fail))
        while sum(runner.queue.stats().values()) < len(fail):
            check(time.perf_counter() - t0 < SLICE_GANG_TIMEOUT_S,
                  "slice: the failing gang never reached the queue")
            time.sleep(0.001)
        sched.run_once(wait=0.01)
        sched.recorder.flush(60.0)
        sched.explainer.drain(120.0)
        fail_events = [e for e in client.resource("events", SLICE_NS).list()
                       if e.get("reason") == "FailedScheduling"
                       and (e.get("involvedObject") or {}).get("name", "")
                       .startswith("fail-")]
        cm = client.resource("configmaps", "default").get(EXPLAIN_CONFIGMAP)
        published = json.loads(cm["data"]["explanations"])
        fail_exps = [v for k2, v in published.items()
                     if k2.startswith(f"{SLICE_NS}/fail-")]
        _slice_delete(client, runner,
                      [("fail", [p.metadata.name for p in fail], ())], pool)
        deadline = time.perf_counter() + SLICE_GANG_TIMEOUT_S
        while sum(runner.queue.stats().values()):
            check(time.perf_counter() < deadline,
                  "slice: the failing gang stayed queued after its delete")
            time.sleep(0.005)
        fail_s = time.perf_counter() - t0

        # preempt: 2x2x4 gangs until no 4x4x8 origin is free, then a
        # 4x4x8 gang at priority 1000
        t0 = time.perf_counter()
        prep = 0
        capture0 = capture_s
        while _slice_origins(gang_cells | background_left, SLICE_PREEMPT,
                             coords, dims):
            run("2x2x4")
            prep += 1
        status_before = sched.topology_status()
        hi = slice_gang_objs("preempt", SLICE_PREEMPT,
                             prio=SLICE_PREEMPT_PRIORITY)
        bound_before = {p.key: p.spec.node_name
                        for p in runner.cache.bound_pods()}
        orc = OracleScheduler(runner.cache.list_nodes(),
                              runner.cache.bound_pods())
        named = carve.select_eviction(orc.oracle_carve(
            hi, parse_shape(SLICE_PREEMPT), set()))
        check(named is not None, "slice: no 4x4x8 box can ever be freed")
        box = {orc.states[i].node.metadata.name for i in named[0]}
        with sched._carve_lock:
            preempts0 = sched._carve_stats["slicePreempts"]
        took, queued, placed = _slice_run_gang(client, runner, hi)
        bound_after = {p.key for p in runner.cache.bound_pods()}
        victims = {k2: n for k2, n in bound_before.items()
                   if k2 not in bound_after}
        preempt_s = time.perf_counter() - t0 - (capture_s - capture0)
        gangs.append({"gang": "preempt", "shape": SLICE_PREEMPT,
                      "bind_s": took, "queued_s": queued, "spread": False,
                      "evicted": len(victims)})
        traffic_s = time.perf_counter() - t_start - capture_s

        launches = dict(kernels.LAUNCHES)
        spans = _span_totals(t_start_wall)
        errors = {"/".join(v for _k, v in key): n - errors0.get(key, 0)
                  for key, n in LOOP_ERRORS.items().items()
                  if n != errors0.get(key, 0)}
        with sched._carve_lock:
            stats = {key: v - stats0[key]
                     for key, v in sched._carve_stats.items()}
        sched.sentinel.drain(120.0)
        sentinel = sched.sentinel.stats()
        carve_samples = sentinel["samples"]["carve"] - samples0
        sentinel_backlog = sched.sentinel._q.unfinished_tasks
        status = sched.topology_status()
        runner.auditor.stop()
        for _ in range(2):
            try:
                runner.auditor.run_once()
            except InvariantViolationError:
                pass  # counted below
        audit = runner.auditor.status()

        # carve_step alone at the end state, every shape: CUDA events over
        # 10 calls with the read-back, and one call under torch.profiler
        _n, ct, meta = runner.cache.snapshot(pending_pods=[hi[0]])
        pb = runner.cache.encode_pods([hi[0]], meta)
        member_req = np.asarray(pb.requests)[0]
        tenant = int(np.asarray(pb.pod_labels)[0, TENANT_KEY_ID])
        ct_dev = ct.to(sched.device)
        claimed = np.zeros(ct.node_valid.shape[0], bool)
        carve_ms = {}
        for shape in [s for s, _w in SLICE_SHAPES] + [SLICE_FAIL]:
            shp = parse_shape(shape)
            if not rotations(shp, dims):
                continue

            def one(shp=shp):
                return carve.carve_device(ct_dev, member_req, tenant,
                                          claimed, dims, shp)
            prof = profile_call(one, f"slice_carve_{shape}", top=4)
            carve_ms[shape] = {
                "ms": cuda_ms(one, iters=SLICE_CARVE_CALLS),
                "rotations": len(rotations(shp, dims)),
                "launches": prof["launches"],
                "device_busy_share": prof["device_busy_share"],
                "device_busy_ms": prof["device_busy_ms"],
                "wall_ms": prof["wall_ms"]}

        # count_pn at the slice path's shapes: for each gang shape that
        # carried a spread, the last such gang's terms (P = its pod
        # bucket) over the cluster with it bound
        check(spread_inputs, "slice: no gang carried a spread")
        cases = {}
        for shape, (sct, spb) in sorted(spread_inputs.items()):
            spb = spb.to(sched.device)
            cases[f"slice_spread_{shape}"] = (
                extend_cluster(sct.to(sched.device), spb),
                (spb.sc_sel, spb.pod_ns, None, None))
    finally:
        pool.shutdown(wait=True)
        if runner is not None:
            runner.stop()  # re-raises a fatal error that ended the loop
        stop_process(server, server_pipe)

    binds = [g["bind_s"] for g in gangs]
    fill_binds = binds[:fill_gangs]
    summary = {
        "cell": "SliceCarve/16x16x16", "grid": "x".join(map(str, dims)),
        "nodes": len(nodes), "background": n_background,
        "gangs": len(gangs), "fill_gangs": fill_gangs,
        "prep_gangs": prep, "gangs_deleted": deleted,
        "members_bound": sum(_prod(parse_shape(g["shape"])) for g in gangs),
        "occupancy_after_fill": occupancy,
        "fill_s": fill_s, "fail_s": fail_s, "preempt_s": preempt_s,
        "traffic_s": traffic_s,
        "carves_per_s": len(gangs) / traffic_s,
        "fill_carves_per_s": fill_gangs / fill_s,
        "bind_p50_s": _pct(binds, 50), "bind_p99_s": _pct(binds, 99),
        "fill_bind_p50_s": _pct(fill_binds, 50),
        "fill_bind_p99_s": _pct(fill_binds, 99),
        "queued_p50_s": _pct([g["queued_s"] for g in gangs], 50),
        "by_shape": {s: {"gangs": sum(1 for g in gangs if g["shape"] == s),
                         "spread_gangs": sum(1 for g in gangs
                                             if g["shape"] == s
                                             and g["spread"]),
                         "preempting_gangs": sum(1 for g in gangs
                                                 if g["shape"] == s
                                                 and g["evicted"]),
                         "bind_p50_s": _pct([g["bind_s"] for g in gangs
                                             if g["shape"] == s], 50)}
                     for s, _w in SLICE_SHAPES},
        "fill_slice_preempts": fill_preempts,
        "count_pn_capture_s": capture_s,
        "background_evicted": n_background - len(background_left),
        "carve_stats": stats, "carve_step": carve_ms,
        "spans": {k2: v for k2, v in spans.items()
                  if k2.startswith(("scheduler/", "sentinel/",
                                    "runner/bind", "explain/"))},
        "topology": status, "topology_before_preempt": status_before,
        "fail": {"events": len(fail_events),
                 "message": fail_events[0]["message"] if fail_events
                 else None,
                 "explanations": len(fail_exps),
                 "explanation": fail_exps[0] if fail_exps else None},
        "preempt": {"box_cost": named[2], "victims": len(victims),
                    "on_the_box": sorted(set(placed.values())) ==
                    sorted(box)},
        "sentinel": sentinel, "carve_samples": carve_samples,
        "sentinel_backlog": sentinel_backlog,
        "audit": {key: audit[key] for key in ("sweeps", "violations",
                                              "byInvariant", "failed")},
        "loop_errors": errors, "launches": launches,
        "seed_s": seed_s, "informer_sync_s": sync_s, "warm_s": warm_s,
        "warm_placed": len(w_placed)}
    fail_n = len(nodes)
    want_msg = f"origins can host a {SLICE_FAIL} slice: "
    check(fail_events and all(want_msg in e["message"]
                              for e in fail_events),
          f"slice: the {SLICE_FAIL} gang's FailedScheduling events "
          f"{summary['fail']}")
    check(fail_events[0]["message"].startswith("0/"),
          f"slice: {fail_events[0]['message']}")
    check(fail_exps and all(v.get("mode") == "carve"
                            and v.get("filters") == {"SliceCarve": fail_n}
                            for v in fail_exps),
          f"slice: the {SLICE_FAIL} gang's explanations {summary['fail']}")
    check(stats["failed"] >= 1, f"slice: carve counters {stats}")
    check(stats["slicePreempts"] - (preempts0 - stats0["slicePreempts"])
          == 1, f"slice: the {SLICE_PREEMPT} gang's slice preemptions "
                f"{stats}, {fill_preempts} in the fill")
    check(summary["preempt"]["on_the_box"],
          f"slice: the {SLICE_PREEMPT} gang bound on "
          f"{sorted(set(placed.values()))[:6]}..., not the box "
          f"select_eviction named ({sorted(box)[:6]}...)")
    check(victims and all(n in box for n in victims.values())
          and {k2 for k2, n in bound_before.items() if n in box}
          == set(victims),
          f"slice: victims {sorted(victims.items())[:6]} are not the pods "
          "on the box")
    check(carve_samples >= stats["carved"] and sentinel["divergences"] == 0
          and sentinel_backlog == 0,
          f"slice: sentinel carve samples {carve_samples} for "
          f"{stats['carved']} carves, {sentinel}")
    check(summary["audit"]["violations"] == 0,
          f"slice: audit {summary['audit']}")
    check(not errors, f"slice: loop errors {errors}")
    check(launches.get("count_pn", 0) > 0,
          "slice: kernel count_pn was never launched on the slice path")
    return summary, cases


# ------------------------------------------------------ the resident planners

PLANNER_SEEDS = (0, 1, 2)   # tests/test_planner.py's parity fuzz
AUTOSCALE_NODES = 1000      # ClusterAutoscalerScaleUp/1000Nodes2000Pending
AUTOSCALE_FILL = 1000
AUTOSCALE_PENDING = 2000
AUTOSCALE_LIMIT_S = 60.0    # its ScaleUpDecisionSeconds threshold
DEFRAG_NODES = 1000         # DeschedulerDefrag/1000Nodes100Gang
DEFRAG_FILL = 1000
DEFRAG_GANG = 100
DEFRAG_MAX_DRAIN = 110
DEFRAG_LIMIT_S = 60.0       # its DefragPlanSeconds threshold
LOOP_NODES = N_NODES        # PlannerLoop at the north star's width
LOOP_PODS_PER_NODE = 3      # benchmarks/plannerloop.py's defaults below
LOOP_WINDOW = 3              # benchmarks/plannerloop.py's 6, cut to fit
LOOP_MAX_WARMUP = 14
LOOP_QUIET = 2
LOOP_CREATE_CHUNK = 5000


def norm_scale_up(options) -> list:
    """``benchmarks/plannerloop.py``'s normal forms of the four plans."""
    return [(o.group.name, sorted(o.pod_indices), o.nodes_needed,
             round(float(o.waste), 9)) for o in options]


def norm_scale_down(plan) -> tuple:
    return (sorted(plan.removable),
            {n: sorted(m) for n, m in plan.placements.items()},
            dict(plan.blocked))


def norm_evictions(plan) -> tuple:
    return ([(s.name, s.strategy, sorted(p.key for p in s.victims),
              sorted(s.moves), s.reason) for s in plan.accepted],
            dict(plan.blocked), plan.batch_victims, plan.batch_sets)


def norm_gang(plan) -> tuple:
    acc = None
    if plan.accepted is not None:
        acc = (plan.accepted.name, plan.accepted.strategy,
               sorted(p.key for p in plan.accepted.victims),
               sorted(plan.accepted.moves))
    return (plan.gang, acc, sorted(plan.gang_moves),
            plan.fits_without_evictions, dict(plan.blocked))


def planner_questions(seed):
    """``tests/test_planner.py``'s fuzz for ``seed``: the cluster, pending
    pods only a template absorbs (with a pod-side label no node carries),
    one node group, one drain set and a pending gang with one candidate
    set per occupied node."""
    import random
    from kubernetes_tpu_torch.autoscaler import NodeGroup
    from kubernetes_tpu_torch.descheduler import GANG_LABEL, CandidateSet
    from kubernetes_tpu_torch.testing.workloads import planner_fuzz_cluster
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
    rng = random.Random(1000 + seed)
    nodes, bound = planner_fuzz_cluster(seed)
    pending = [make_pod(f"pend{j}").req({"cpu": rng.choice(["20", "24"])})
               .label(GANG_LABEL, "noise").obj()
               for j in range(rng.randint(1, 3))]
    groups = [NodeGroup(name="ng-big", min_size=0, max_size=4,
                        template=make_node("ng-big-t").capacity(
                            {"cpu": "32", "memory": "64Gi",
                             "pods": "32"}).obj())]
    per_node = {}
    for p in bound:
        per_node.setdefault(p.spec.node_name, []).append(p)
    victim_node = min(per_node, key=lambda n: len(per_node[n]))
    sets = [CandidateSet(name=f"drain-{victim_node}", strategy="Fuzz",
                         victims=per_node[victim_node],
                         exclude_targets={victim_node})]
    gang = [make_pod(f"g{j}").req({"cpu": "2"}).label(GANG_LABEL, "fuzz")
            .obj() for j in range(2)]
    gsets = [CandidateSet(name=f"consolidate-{n}", strategy="GangFuzz",
                          victims=list(ps), exclude_targets={n})
             for n, ps in sorted(per_node.items())]
    return nodes, bound, pending, groups, sets, gang, gsets


def planner_plans(seed, resident, device):
    """The four planners' plans for fuzz ``seed`` in normal form, through
    ``resident`` (a ResidentPlanner) or cold (None) on ``device``."""
    from kubernetes_tpu_torch.autoscaler import (simulate_scale_down,
                                                 simulate_scale_up)
    from kubernetes_tpu_torch.descheduler import (plan_evictions,
                                                  plan_gang_defrag)
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    nodes, bound, pending, groups, sets, gang, gsets = planner_questions(seed)
    kw = dict(encoder=SnapshotEncoder(), resident=resident, device=device)
    return {
        "scale_up": norm_scale_up(simulate_scale_up(
            nodes, bound, pending, groups, **kw)),
        "scale_down": norm_scale_down(simulate_scale_down(
            nodes, bound, [n.metadata.name for n in nodes],
            utilization_threshold=0.6, **kw)),
        "evictions": norm_evictions(plan_evictions(nodes, bound, sets,
                                                   **kw)),
        "gang_defrag": norm_gang(plan_gang_defrag(nodes, bound, gang, "fuzz",
                                                  gsets, **kw)),
    }


def _two_on_one_node(enc, bound):
    st = enc._patch
    by_node = {}
    for p in bound:
        if p.key in st.slot_of and p.key not in st.unpatchable:
            by_node.setdefault(p.spec.node_name, []).append(p.key)
    shared = next(keys for keys in by_node.values() if len(keys) >= 2)
    other = next(keys[0] for keys in by_node.values()
                 if keys[0] not in shared)
    return [shared[0], shared[1], other]


def planner_parity_phase(devices=("cuda", "cpu"), seeds=PLANNER_SEEDS):
    """The resident planners on each device: for each fuzz seed, the port's
    Scheduler armed over the fuzz cluster, the four plans through its
    ResidentPlanner (every one a hit, no decline) and cold; resident equal
    to cold on each device, and each plan equal across the devices. Then
    ``tenant_quota_mask`` on seeded tenants and quotas, and ``without_pods``
    (two victims on one node) on the tensors of each device, equal across
    the devices and to the host path."""
    import numpy as np
    from kubernetes_tpu_torch.encode.overlay import (ResidentPlanner,
                                                     tenant_quota_mask)
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.testing.workloads import planner_fuzz_cluster
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    out = {"seeds": list(seeds), "devices": list(devices)}
    plans = {}
    for device in devices:
        for seed in seeds:
            nodes, bound = planner_fuzz_cluster(seed)
            sched, _log = make_scheduler(
                sched_config(batch_size=4, max_drain_batches=2), nodes,
                bound, device=device)
            try:
                check(sched.warm_drain(
                    [make_pod(f"__warm{i}").req({"cpu": "100m"}).obj()
                     for i in range(4)], slot_headroom=64),
                    "parity.planner: warm_drain did not arm the context")
                rp = ResidentPlanner(sched.resident_plan_view, sched.cache)
                resident = planner_plans(seed, rp, device)
                stats = rp.stats()
                check(stats == {"hits": {"autoscaler": 2, "descheduler": 1,
                                         "gangDefrag": 1}, "declines": {}},
                      f"parity.planner: {device} seed {seed}: {stats}")
                cold = planner_plans(seed, None, device)
                check(resident == cold,
                      f"parity.planner: {device} seed {seed}: resident "
                      f"{resident} != cold {cold}")
                check(cold["scale_up"], "parity.planner: no scale-up option")
                plans.setdefault(seed, []).append(cold)
            finally:
                sched.close()
    for seed, per_device in plans.items():
        check(all(p == per_device[0] for p in per_device),
              f"parity.planner: seed {seed}: the plans differ across "
              f"{devices}")
    out["plans"] = {str(s): {"scale_up_options": len(p["scale_up"]),
                             "removable": len(p["scale_down"][0]),
                             "accepted_sets": len(p["evictions"][0]),
                             "gang_moves": len(p["gang_defrag"][2])}
                    for s, (p, *_rest) in plans.items()}
    rng = np.random.default_rng(SEED)
    quota_cases = 0
    for V, T in ((1, 1), (5, 2), (40, 3), (300, 7), (1000, 16)):
        ids = rng.integers(-1, T, V).tolist()
        quotas = rng.integers(-1, 6, T).tolist()
        got = [tenant_quota_mask(ids, quotas, device=d).tolist()
               for d in devices]
        check(all(g == got[0] for g in got),
              f"parity.planner: tenant_quota_mask differs at V={V}, T={T}")
        quota_cases += 1
    out["quota_cases"] = quota_cases
    nodes, bound = planner_fuzz_cluster(1)
    enc = SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, bound)
    keys = _two_on_one_node(enc, bound)
    host = enc.without_pods(ct, meta, keys)
    for d in devices:
        got = enc.without_pods(ct.to(d), meta, keys)
        for f in ("requested", "epod_valid"):
            check(np.array_equal(getattr(got, f).cpu().numpy(),
                                 getattr(host, f)),
                  f"parity.planner: without_pods {f} on {d} != host")
    out["without_pods_victims"] = keys
    return out


def autoscaler_phase(device=None, n_nodes=AUTOSCALE_NODES,
                     fill=AUTOSCALE_FILL, pending=AUTOSCALE_PENDING):
    """ClusterAutoscalerScaleUp/1000Nodes2000Pending as
    ``benchmarks/scheduler_perf.py`` runs it: 1000 node-default nodes, one
    pod-autoscaler-fill pod bound on each, 2000 pod-default pods pending,
    node-group-default and node-group-large, the least-waste expander; a
    warm-up call excluded, then ScaleUpDecisionSeconds of
    ``simulate_scale_up`` on the cold path (host encode, ``run_filters`` on
    the card) and on the resident path (a Scheduler armed over the same
    cluster with ``warm_drain``, its ResidentPlanner). The groups' template
    label key is not in the resident key bucket: the first resident call
    declines ``template_bucket`` and asks the cache for a full encode, which
    a second ``warm_drain`` makes, as the live scheduler's next cycle would.
    Gates: that one decline and one full encode, the options equal on both
    paths (and to the CPU's cold options), every pending pod placed by the
    chosen option, each decision within 60 s, every later resident call a
    hit. One more resident call under torch.profiler."""
    from kubernetes_tpu_torch.autoscaler import (EXPANDERS, load_node_group,
                                                 simulate_scale_up)
    from kubernetes_tpu_torch.encode.overlay import ResidentPlanner
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.testing.workloads import autoscaler_scale_up
    from kubernetes_tpu_torch.utils.tracing import TRACER
    nodes, bound, pods, group_dicts = autoscaler_scale_up(n_nodes, fill,
                                                          pending)
    groups = [load_node_group(d) for d in group_dicts]
    expander = EXPANDERS["least-waste"]

    def cold():
        return simulate_scale_up(nodes, bound, pods, groups, device=device)

    cfg = sched_config()
    sched, _log = make_scheduler(cfg, nodes, bound, device=device)
    try:
        pop = cfg.batch_size * cfg.max_drain_batches
        t0 = time.perf_counter()
        check(sched.warm_drain(pods[:pop], slot_headroom=len(pods) + pop),
              "autoscaler: warm_drain did not arm the context")
        warm_drain_s = time.perf_counter() - t0
        rp = ResidentPlanner(sched.resident_plan_view, sched.cache)

        def resident():
            return simulate_scale_up(nodes, bound, pods, groups,
                                     resident=rp, device=device)

        full0 = sched.cache.stats()["full_encodes"]
        t0 = time.perf_counter()
        resident()
        declined_s = time.perf_counter() - t0
        first = rp.stats()
        check(first == {"hits": {}, "declines": {
            "autoscaler": {"template_bucket": 1}}},
              f"autoscaler: the first resident call did not decline "
              f"template_bucket: {first}")
        t0 = time.perf_counter()
        check(sched.warm_drain(pods[:pop], slot_headroom=len(pods) + pop),
              "autoscaler: warm_drain did not re-arm the context")
        rearm_s = time.perf_counter() - t0
        full_encodes = sched.cache.stats()["full_encodes"] - full0
        check(full_encodes == 1,
              f"autoscaler: {full_encodes} full encodes after the template "
              f"decline, not 1")
        t0 = time.perf_counter()
        cold()
        resident()
        warmup_s = time.perf_counter() - t0
        TRACER.reset()
        kernels.reset_launches()
        t0 = time.perf_counter()
        cold_opts = cold()
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_opts = resident()
        res_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        spans = _span_totals()
        prof = profile_call(resident, "autoscaler_resident")
        stats = rp.stats()
    finally:
        sched.close()
    cpu_opts = simulate_scale_up(nodes, bound, pods, groups, device="cpu")
    choice = expander(cold_opts, seed=0)
    placed = choice.pods_placed if choice else 0
    summary = {
        "case": "ClusterAutoscalerScaleUp/1000Nodes2000Pending",
        "nodes": len(nodes), "bound": len(bound), "pending": len(pods),
        "candidate_groups": len(groups),
        "ScaleUpDecisionSeconds": {"cold": cold_s, "resident": res_s},
        "warmup_s": warmup_s, "warm_drain_s": warm_drain_s,
        "declined_s": declined_s, "rearm_s": rearm_s,
        "rearm_full_encodes": full_encodes,
        "options": [{"group": o.group.name, "pods": o.pods_placed,
                     "nodes_needed": o.nodes_needed, "waste": o.waste}
                    for o in cold_opts],
        "chosen_group": choice.group.name if choice else None,
        "nodes_needed": choice.nodes_needed if choice else 0,
        "pods_placed": placed, "overlay": stats,
        "spans": {k: v for k, v in spans.items()
                  if k.startswith("planner/")},
        "profile": {k: prof[k] for k in ("wall_ms", "launches",
                                         "device_busy_ms",
                                         "device_busy_share",
                                         "top_device_ops", "trace")},
        "launches": launches}
    check(norm_scale_up(res_opts) == norm_scale_up(cold_opts),
          "autoscaler: resident options != cold options")
    check(norm_scale_up(cpu_opts) == norm_scale_up(cold_opts),
          "autoscaler: the card's options != the CPU's")
    check(stats == {"hits": {"autoscaler": 3},
                    "declines": {"autoscaler": {"template_bucket": 1}}},
          f"autoscaler: the resident path declined again: {stats}")
    check(placed == len(pods),
          f"autoscaler: pods_placed {placed} != {len(pods)}")
    for path, s in (("cold", cold_s), ("resident", res_s)):
        check(s <= AUTOSCALE_LIMIT_S,
              f"autoscaler: the {path} decision took {s:.1f} s")
    return summary


def defrag_phase(device=None, n_nodes=DEFRAG_NODES, fill=DEFRAG_FILL,
                 gang_pods=DEFRAG_GANG, max_drain=DEFRAG_MAX_DRAIN):
    """DeschedulerDefrag/1000Nodes100Gang as ``scheduler_perf.py`` runs it:
    1000 node-default nodes fragmented by one pod-defrag-fill pod each (12
    of 32 CPU), a pending gang of 100 pod-defrag-gang pods (24 CPU), drain
    prefixes capped at 110; a warm-up plan excluded, then
    DefragPlanSeconds of ``gang_consolidation_candidates`` +
    ``plan_gang_defrag`` (one ``run_filters`` + ``combined_score`` on the
    card over every prefix's victims and the gang, then the host's
    fewest-evictions ledger scan). Gates: all 100 gang pods seated, within
    60 s, the plan equal to the CPU's, every gang pod on its own drained
    node, no victim parked on a drained node. One more plan under
    torch.profiler."""
    from kubernetes_tpu_torch.descheduler import (
        gang_consolidation_candidates, plan_gang_defrag)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.testing.workloads import descheduler_defrag
    nodes, bound, gang = descheduler_defrag(n_nodes, fill, gang_pods)

    def plan(on=device):
        cands = gang_consolidation_candidates(nodes, bound,
                                              max_nodes=max_drain)
        return plan_gang_defrag(nodes, bound, gang, "bench", cands,
                                device=on)

    t0 = time.perf_counter()
    plan()
    warmup_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    gp = plan()
    plan_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    prof = profile_call(plan, "defrag_plan")
    cpu = plan("cpu")
    seated = len(gp.gang_moves)
    drained = {p.spec.node_name for p in gp.accepted.victims} \
        if gp.accepted else set()
    summary = {
        "case": "DeschedulerDefrag/1000Nodes100Gang",
        "nodes": len(nodes), "bound": len(bound), "gang": len(gang),
        "max_drain": max_drain, "DefragPlanSeconds": plan_s,
        "warmup_s": warmup_s, "batch_victims": gp.batch_victims,
        "candidate_sets": gp.batch_sets, "evictions": gp.evictions,
        "accepted_set": gp.accepted.name if gp.accepted else None,
        "blocked_sets": len(gp.blocked), "gang_seated": seated,
        "profile": {k: prof[k] for k in ("wall_ms", "launches",
                                         "device_busy_ms",
                                         "device_busy_share",
                                         "top_device_ops", "trace")},
        "launches": launches}
    check(norm_gang(gp) == norm_gang(cpu),
          "defrag: the card's plan != the CPU's")
    check(seated == len(gang), f"defrag: gang_seated {seated} != {len(gang)}")
    check(plan_s <= DEFRAG_LIMIT_S, f"defrag: the plan took {plan_s:.1f} s")
    seats = [node for _key, node in gp.gang_moves]
    check(len(set(seats)) == len(seats) and set(seats) <= drained,
          "defrag: a gang pod is not alone on a drained node")
    check(not {node for _key, node in gp.accepted.moves} & drained,
          "defrag: a victim was parked on a drained node")
    return summary


def planner_loop_phase(device=None, n_nodes=LOOP_NODES,
                       pods_per_node=LOOP_PODS_PER_NODE,
                       window=LOOP_WINDOW, max_warmup=LOOP_MAX_WARMUP,
                       quiet_cycles=LOOP_QUIET):
    """PlannerLoop (``benchmarks/plannerloop.py``) at 5000 nodes: the port's
    APIServer in a spawned process, ``planner_loop``'s cluster (pl-n0 with
    one small pod, every other node 3 pods of 2 CPU, two pods nothing fits,
    a pending 3-pod gang), the port's SchedulerRunner (pops of 8, one
    batch, the loop not started: the fleet is static) with a fail-fast
    auditor, ``warm_drain``; ClusterAutoscaler (pool-a and pool-big,
    utilization 0.5, reclaim never), a dry-run Descheduler with the
    default strategies, one BackgroundPlanner over them. Adaptive warm-up
    until ``quiet_cycles`` cycles count no ``steadyCompiles``, then a
    window of ``window`` cycles; then the same observation planned through
    the resident view and cold (scale-up with headroom, scale-down over
    every node, the descheduler's evictions and gang plans); one more
    cycle under torch.profiler. Gates: the warm-up goes quiet; the window
    counts 0 ``steadyCompiles``, 0 resident declines and 0 scheduler full
    encodes; every planner's hits advance; the four parity legs equal and
    the scale-up options not empty; 0 invariant violations; count_pn never
    launched. -> summary (cycle_ms, the planner/* spans)."""
    import multiprocessing as mp
    from kubernetes_tpu_torch.audit.auditor import (InvariantAuditor,
                                                    InvariantViolationError)
    from kubernetes_tpu_torch.autoscaler import (ClusterAutoscaler,
                                                 StaticNodeGroupProvider,
                                                 load_node_group,
                                                 simulate_scale_down,
                                                 simulate_scale_up)
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.descheduler import (Descheduler,
                                                  DeschedulerConfiguration)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.bgplanner import BackgroundPlanner
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.testing.workloads import planner_loop
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    from kubernetes_tpu_torch.utils.tracing import TRACER
    nodes, bound, pending, group_dicts = planner_loop(n_nodes, pods_per_node)
    ctx = mp.get_context("spawn")
    server, server_pipe, url = start_apiserver(ctx)
    runner = None
    summary = {"case": "PlannerLoop", "nodes": n_nodes, "bound": len(bound),
               "pending": len(pending), "window_cycles": window}
    try:
        client = HTTPClient(url, timeout=120.0, wire="json")
        t0 = time.perf_counter()
        client.nodes().create_many(_wire(nodes))
        bound_dicts = _wire(bound)
        for i in range(0, len(bound_dicts), LOOP_CREATE_CHUNK):
            client.pods("default").create_many(
                bound_dicts[i:i + LOOP_CREATE_CHUNK])
        summary["seed_s"] = time.perf_counter() - t0
        cfg = sched_config(batch_size=8, max_drain_batches=1,
                           explainer_enabled=True, parity_sample_every=16)
        runner = SchedulerRunner(HTTPClient(url, wire="json"), cfg,
                                 device=device)
        runner.auditor = InvariantAuditor(
            client=HTTPClient(url, timeout=60.0, wire="json"),
            cache=runner.cache, scheduler=runner.scheduler,
            interval_s=CONNECTED_AUDIT_S, fail_fast=True,
            pre_sweep=runner.sweep_stale_nominations,
            post_sweep=runner.publish_status,
            relists=runner._total_relists)
        t0 = time.perf_counter()
        runner.start(wait_sync=120.0, start_loop=False)
        check(runner.has_synced(), "planner: the informers did not sync")
        summary["sync_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        check(runner.scheduler.warm_drain(
            [make_pod(f"pl-w{k}", "default").req({"cpu": "2"}).obj()
             for k in range(8)], slot_headroom=len(bound) + 64),
            "planner: warm_drain did not arm the context")
        summary["warm_drain_s"] = time.perf_counter() - t0
        client.pods("default").create_many(_wire(pending))

        groups = [load_node_group(d) for d in group_dicts]
        autoscaler = ClusterAutoscaler(
            HTTPClient(url, timeout=60.0, wire="json"),
            StaticNodeGroupProvider(HTTPClient(url, timeout=60.0,
                                               wire="json"), groups),
            utilization_threshold=0.5, scale_down_unneeded_s=10 ** 9,
            device=device)
        descheduler = Descheduler(HTTPClient(url, timeout=60.0, wire="json"),
                                  DeschedulerConfiguration(), device=device)
        planner = BackgroundPlanner(client, runner.scheduler,
                                    autoscaler=autoscaler,
                                    descheduler=descheduler,
                                    descheduler_dry_run=True,
                                    warmup_cycles=1)
        kernels.reset_launches()
        t0 = time.perf_counter()
        quiet = warm = 0
        while warm < max_warmup and quiet < quiet_cycles:
            s = planner.run_once()
            warm += 1
            quiet = quiet + 1 if s.get("steadyCompiles", 1) == 0 else 0
        summary["warmup_cycles"] = warm
        summary["warmup_s"] = time.perf_counter() - t0
        check(quiet >= quiet_cycles,
              f"planner: the warm-up never went quiet in {warm} cycles")

        stats0 = planner.resident.stats()
        enc0 = runner.cache.stats()["full_encodes"]
        TRACER.max_spans = max(TRACER.max_spans, 4096)
        TRACER.reset()
        compiles = 0
        cycle_ms = []
        for _ in range(window):
            t0 = time.perf_counter()
            s = planner.run_once()
            cycle_ms.append((time.perf_counter() - t0) * 1e3)
            compiles += s.get("steadyCompiles", 0)
        stats1 = planner.resident.stats()
        summary["cycle_ms"] = sum(cycle_ms) / len(cycle_ms)
        summary["cycles_ms"] = cycle_ms
        summary["window_compiles"] = compiles
        summary["window_declines"] = (
            sum(sum(v.values()) for v in stats1["declines"].values())
            - sum(sum(v.values()) for v in stats0["declines"].values()))
        summary["window_full_encodes"] = \
            runner.cache.stats()["full_encodes"] - enc0
        summary["window_hits"] = {
            name: stats1["hits"].get(name, 0) - stats0["hits"].get(name, 0)
            for name in ("autoscaler", "descheduler", "gangDefrag")}
        summary["spans"] = {k: v for k, v in _span_totals().items()
                            if k.startswith("planner/")}
        summary["planner_spans_s"] = dict(planner._spans)

        # the same observation through the resident view and cold
        nodes_o, pods_o, pod_dicts_o = autoscaler._observe()
        bound_o = [p for p in pods_o if p.spec.node_name]
        pending_o = [p for p in pods_o if not p.spec.node_name]
        headroom = {"pool-a": 4, "pool-big": 2}  # force a real option
        up = [norm_scale_up(simulate_scale_up(
            nodes_o, bound_o, pending_o, groups, headroom=headroom,
            encoder=autoscaler.encoder, resident=r, device=device))
            for r in (planner.resident, None)]
        down = [norm_scale_down(simulate_scale_down(
            nodes_o, bound_o, [n.metadata.name for n in nodes_o],
            utilization_threshold=0.5, all_pod_dicts=pod_dicts_o,
            encoder=autoscaler.encoder, resident=r, device=device))
            for r in (planner.resident, None)]
        obs = descheduler._observe()
        dplans = []
        for r in (planner.resident, None):
            descheduler.resident = r
            ep, gps = descheduler.plan(*obs)
            dplans.append((norm_evictions(ep), [norm_gang(g) for g in gps]))
        descheduler.resident = planner.resident
        summary["plan_parity"] = {
            "scale_up": up[0] == up[1], "scale_down": down[0] == down[1],
            "evictions": dplans[0][0] == dplans[1][0],
            "gang_defrag": dplans[0][1] == dplans[1][1]}
        summary["parity_scale_up_options"] = len(up[1])
        summary["parity_gang_plans"] = len(dplans[1][1])
        summary["parity_hits"] = {
            k: v - stats1["hits"].get(k, 0)
            for k, v in planner.resident.stats()["hits"].items()}
        prof = profile_call(planner.run_once, "planner_cycle")
        summary["profile"] = {k: prof[k] for k in (
            "wall_ms", "launches", "device_busy_ms", "device_busy_share",
            "top_device_ops", "trace")}
        summary["launches"] = dict(kernels.LAUNCHES)
        summary["planner_status"] = planner.status()
        summary["overlay"] = planner.resident.stats()
        runner.auditor.stop()
        for _ in range(2):
            try:
                runner.auditor.run_once()
            except InvariantViolationError:
                pass  # counted below
        audit = runner.auditor.status()
        summary["audit"] = {k: audit[k] for k in ("sweeps", "violations",
                                                  "byInvariant", "failed")}
    finally:
        if runner is not None:
            runner.stop()
        stop_process(server, server_pipe)
    check(summary["window_compiles"] == 0,
          f"planner: {summary['window_compiles']} steadyCompiles in the "
          "window")
    check(summary["window_declines"] == 0,
          f"planner: {summary['window_declines']} resident declines in the "
          f"window ({summary['overlay']['declines']})")
    check(summary["window_full_encodes"] == 0,
          f"planner: {summary['window_full_encodes']} scheduler full "
          "encodes in the window")
    for name, d in summary["window_hits"].items():
        check(d > 0, f"planner: {name}'s hits did not advance ({d})")
    for leg, ok in summary["plan_parity"].items():
        check(ok, f"planner: resident/cold plan divergence: {leg}")
    check(summary["parity_scale_up_options"] > 0,
          "planner: the parity scale-up compared no option")
    check(all(summary["parity_hits"].get(k, 0) > 0
              for k in ("autoscaler", "descheduler", "gangDefrag")),
          f"planner: a parity leg did not hit ({summary['parity_hits']})")
    check(summary["audit"]["violations"] == 0,
          f"planner: invariant violations {summary['audit']['byInvariant']}")
    check(all(n == 0 for n in summary["launches"].values()),
          f"planner: count_pn launched on the planner path "
          f"{summary['launches']}")
    return summary

# ------------------------------------------------------------------ fleet

FLEET_TENANTS = 4
FLEET_NODES = 1250         # per tenant: 5000 nodes in all
FLEET_UPFRONT = 2500       # upfront pods per tenant
FLEET_BATCH = 512
FLEET_DRAIN_BATCHES = 4    # one drain block per tenant (fleetchurn.py's B)
FLEET_WARMUP_S = 8.0       # benchmarks/fleetchurn.py run_fleet_churn's
FLEET_WINDOW_S = 12.0      # defaults, from here down
FLEET_CHURN_PERIOD_S = 0.4
FLEET_NOISY = 4            # tenant 0 churns 4x
FLEET_LIVE_CAP = 6         # bound churn pods kept alive per tenant
FLEET_BIND_TIMEOUT_S = 120.0   # the starvation wall
FLEET_P99_SLO_S = 10.0     # reported, not gated (see fleet_slo)
FLEET_MIN_RATIO = 0.5
FLEET_QUIET_S = 4.0        # the window opens after this long without a
FLEET_QUIET_TIMEOUT_S = 45.0   # CompileCounter event
FLEET_PROFILE_S = 1.0      # churn under torch.profiler after the window
FLEET_DRAIN_PODS = 512     # fleet.drain: one block per tenant
FLEET_PARITY_SEEDS = (0, 1, 2)
FLEET_ZONES = ("z0", "z1", "z2")   # SHARED across tenants on purpose


def fleet_failures(result) -> list:
    """The FleetChurn phase's hard gates over its summary: every tenant's
    upfront pods bound; 0 invariant violations and 0 sentinel divergences;
    0 CompileCounter events and 0 resident-context rebuilds in the window;
    per tenant churn created, a completion ratio of at least 0.5 and every
    churn pod bound within 120 s of its creation (the reference's
    ``bind_timeout``, its starvation wall); no ``t<id>.`` name on a tenant's
    apiserver; the fleet status ConfigMap on every tenant. The reference's
    10 s bind p99 is not among them: ``fleet_slo`` reports it."""
    out = []
    for t, b in enumerate(result["upfront_bound"]):
        if b < result["upfront_per_tenant"]:
            out.append(f"tenant {t}: only {b}/{result['upfront_per_tenant']}"
                       " upfront pods bound")
    if result["audit"]["violations"]:
        out.append(f"invariant violations {result['audit']['byInvariant']}")
    if result["sentinel"]["divergences"]:
        out.append(f"{result['sentinel']['divergences']} sentinel "
                   "divergence(s)")
    win = result["ctx_window"]
    if win["steady_compiles"]:
        out.append(f"{win['steady_compiles']} CompileCounter event(s) in "
                   "the window")
    if win["rebuilds"]:
        out.append(f"{win['rebuilds']} resident-context rebuild(s) in the "
                   "window")
    for t, s in sorted(result["tenant"].items()):
        if s["created"] <= 0:
            out.append(f"tenant {t}: churn created nothing")
            continue
        if s["unbound"]:
            out.append(f"tenant {t}: {s['unbound']} churn pod(s) still "
                       f"unbound {FLEET_BIND_TIMEOUT_S:.0f} s after "
                       "creation (starved)")
        if s["max_bind_s"] > FLEET_BIND_TIMEOUT_S:
            out.append(f"tenant {t}: a churn pod bound only after "
                       f"{s['max_bind_s']:.1f} s, past the "
                       f"{FLEET_BIND_TIMEOUT_S:.0f} s wall")
        if s["ratio"] is None or s["ratio"] < FLEET_MIN_RATIO:
            out.append(f"tenant {t}: bind ratio {s['ratio']} below "
                       f"{FLEET_MIN_RATIO}")
    if result["prefix_leaks"]:
        out.append(f"fleet names on tenant apiservers: "
                   f"{result['prefix_leaks'][:5]}")
    for t, n in enumerate(result["fleet_configmaps"]):
        if n != result["tenants"]:
            out.append(f"tenant {t}: fleet status ConfigMap missing or "
                       f"wrong ({n} tenants)")
    return out


def fleet_slo(result) -> dict:
    """The reference's FleetChurn SLO, each tenant's bind p99 within 10 s,
    as a verdict. It is measured and reported, not gated: a tenant binds
    tens of churn pods in a 12 s window, so its p99 is its slowest bind,
    which host time moves by 2x between calls."""
    met = {t: s["p99_bind_s"] <= FLEET_P99_SLO_S
           for t, s in sorted(result["tenant"].items())}
    return {"p99_slo_s": FLEET_P99_SLO_S, "tenant_p99_slo_met": met,
            "p99_slo_met": all(met.values())}


def fleet_workload(rng, n_nodes, n_pods):
    """One tenant's randomized cluster (tests/test_fleet.py's generator):
    shared zone values, 2/4/8-CPU nodes, pods of 250m-1 CPU at priority 0
    or 10, 30% with a DoNotSchedule zone spread, 20% anti-affine on the
    hostname. -> (node dicts, pod dicts), untenanted."""
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
    nodes = [make_node(f"n{i}")
             .capacity({"cpu": rng.choice(["2", "4", "8"]),
                        "memory": "16Gi", "pods": "64"})
             .label("kubernetes.io/hostname", f"n{i}")
             .label("topology.kubernetes.io/zone", rng.choice(FLEET_ZONES))
             .obj().to_dict() for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        w = (make_pod(f"p{i}")
             .req({"cpu": rng.choice(["250m", "500m", "1"])})
             .label("app", rng.choice(["a", "b"]))
             .priority(rng.choice([0, 0, 10])))
        r = rng.random()
        if r < 0.3:
            w = w.spread(1, "topology.kubernetes.io/zone", "DoNotSchedule",
                         {"app": "a"})
        elif r < 0.5:
            w = w.pod_anti_affinity("kubernetes.io/hostname", {"app": "b"})
        pods.append(w.obj().to_dict())
    for d in nodes + pods:
        d["metadata"].pop("uid", None)
    return nodes, pods


def _fleet_drain(node_dicts, chunks, batch, device, capture=True,
                 repeat=1):
    """gang_drain of ``chunks`` (pod dict lists) over the nodes, every
    chunk's bucket pinned to ``batch``, ``repeat`` times (``capture=False``:
    the rounds run eagerly on the card). -> ({pod key: node or None},
    rounds, seconds of prepare_drain and the first call, (plan,
    assignments, (host encoding, batches, meta), seconds of the last call
    alone))."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models.gang import gang_drain, prepare_drain
    enc = SnapshotEncoder()
    batches = [[Pod.from_dict(d) for d in c] for c in chunks]
    ct, meta = enc.encode_cluster([Node.from_dict(d) for d in node_dicts],
                                  [], pending_pods=[p for c in batches
                                                    for p in c])
    pbs = [enc.encode_pods(b, meta, min_p=batch) for b in batches]
    t0 = time.perf_counter()
    plan = prepare_drain(ct, pbs, device=device)
    for i in range(repeat):
        t1 = time.perf_counter()
        a, rounds, _req = gang_drain(seed=SEED, topo_keys=meta.topo_keys,
                                     prepared=plan, capture=capture)
        last_s = time.perf_counter() - t1
        if i == 0:
            seconds = time.perf_counter() - t0
    out = {}
    for b, chunk in enumerate(batches):
        for i, p in enumerate(chunk):
            ni = int(a[b][i])
            out[p.key] = meta.node_names[ni] if ni >= 0 else None
    return (out, [int(r) for r in rounds], seconds,
            (plan, a, (ct, pbs, meta), last_s))


def _interleave(per_tenant_nodes):
    """Tenants' rekeyed nodes interleaved on the node axis (the worst case
    for index-based tie-breaks)."""
    from kubernetes_tpu_torch.sched.fleet import rekey_for_tenant
    out = []
    for i in range(max(len(n) for n in per_tenant_nodes)):
        for t, nodes in enumerate(per_tenant_nodes):
            if i < len(nodes):
                out.append(rekey_for_tenant(t, "nodes", nodes[i]))
    return out


def _fleet_vs_singles(per_tenant, fleet, singles):
    """[(fleet key, standalone node, fleet node)] where a tenant's fleet
    placement differs from its standalone run; a cross-tenant placement
    fails the phase."""
    from kubernetes_tpu_torch.sched.fleet import split_fleet_name
    bad = []
    for t, (_nodes, pods) in enumerate(per_tenant):
        for p in pods:
            name = p["metadata"]["name"]
            got = fleet.get(f"t{t}.default/{name}")
            if got is not None:
                tid, got = split_fleet_name(got)
                check(tid == t, f"fleet: cross-tenant placement of "
                                f"t{t}.default/{name} on tenant {tid}")
            want = singles[t][f"default/{name}"]
            if want != got:
                bad.append((f"t{t}.default/{name}", want, got))
    return bad


def _fleet_parity_drains(seed, device):
    """tests/test_fleet.py's randomized parity case at ``seed`` on
    ``device``: three tenants' standalone drains and their fleet-batched
    drain. -> (singles, fleet, rounds)."""
    import random
    from kubernetes_tpu_torch.sched.fleet import rekey_for_tenant
    rng = random.Random(seed)
    batch = 8
    per_tenant = [fleet_workload(rng, rng.randint(3, 6), rng.randint(6, 12))
                  for _t in range(3)]
    singles, rounds = [], []
    for nodes, pods in per_tenant:
        got, r, _s, _p = _fleet_drain(
            nodes, [pods[i:i + batch] for i in range(0, len(pods), batch)],
            batch, device)
        singles.append(got)
        rounds.append(r)
    chunks = []
    for t, (_nodes, pods) in enumerate(per_tenant):
        rk = [rekey_for_tenant(t, "pods", p) for p in pods]
        chunks += [rk[i:i + batch] for i in range(0, len(rk), batch)]
    fleet, r, _s, _p = _fleet_drain(
        _interleave([n for n, _p in per_tenant]), chunks, batch, device)
    rounds.append(r)
    check(not _fleet_vs_singles(per_tenant, fleet, singles),
          f"parity.fleet: seed {seed} on {device}: fleet placements differ "
          "from the standalone runs")
    return singles, fleet, rounds


def _fleet_wave(device):
    """tests/test_fleet.py's fleet preemption wave on ``device``: two
    tenants of two saturated nodes and one preemptor each, and the same
    tenant standalone. -> [(node, sorted victim keys)] per leg."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.sched.fleet import rekey_for_tenant
    from kubernetes_tpu_torch.sched.preemption import preempt_wave
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

    def leg(t_ids):
        nodes, bound, views = [], [], []
        for t in t_ids:
            def rk(plural, d):
                return rekey_for_tenant(t, plural, d) if t is not None else d
            for i in range(2):
                nodes.append(Node.from_dict(rk("nodes", make_node(f"n{i}")
                    .capacity({"cpu": "2", "memory": "4Gi", "pods": "8"})
                    .label("kubernetes.io/hostname", f"n{i}")
                    .obj().to_dict())))
                pd = make_pod(f"victim{i}").req({"cpu": "2"}).priority(0) \
                    .obj().to_dict()
                pd["spec"]["nodeName"] = f"n{i}"
                bound.append(Pod.from_dict(rk("pods", pd)))
            views.append(Pod.from_dict(rk("pods", make_pod("vip")
                .req({"cpu": "2"}).priority(100).obj().to_dict())))
        res = preempt_wave(nodes, bound, views, device=device)
        check(all(r is not None for r in res),
              f"parity.fleet: a preemptor found no victims on {device}")
        return [(r.node_name, sorted(v.key for v in r.victims)) for r in res]

    fleet, single = leg([0, 1]), leg([None])
    for t, (node, victims) in enumerate(fleet):
        check(node == f"t{t}.{single[0][0]}"
              and victims == [f"t{t}.{v}" for v in single[0][1]],
              f"parity.fleet: tenant {t}'s wave differs from the standalone "
              f"wave on {device}")
    return fleet


def _fleet_runner_run(device, per_tenant):
    """A FleetRunner over one DirectClient per tenant, its loop stopped,
    driven pop by pop to an empty queue. -> (bindings per tenant,
    ctx_stats, pops)."""
    import copy
    from kubernetes_tpu_torch.client.clientset import DirectClient
    from kubernetes_tpu_torch.sched.fleet import FleetRunner
    from kubernetes_tpu_torch.store.store import ObjectStore
    clients = [DirectClient(ObjectStore()) for _ in per_tenant]
    for c, (nodes, pods) in zip(clients, per_tenant):
        c.nodes().create_many(copy.deepcopy(nodes))
        c.pods("default").create_many(copy.deepcopy(pods))
    cfg = sched_config(batch_size=8, max_drain_batches=len(per_tenant),
                       backoff_initial_s=3600.0, backoff_max_s=3600.0,
                       assume_ttl_s=3600.0)
    runner = FleetRunner(clients, cfg, device=device,
                         feature_gate=no_preemption_gate())
    try:
        runner.start(wait_sync=60.0, start_loop=False)
        n_pods = sum(len(p) for _n, p in per_tenant)
        deadline = time.time() + 60.0
        while runner.queue.stats()["active"] < n_pods:
            check(time.time() < deadline, "parity.fleet: pods not queued")
            time.sleep(0.01)
        sched = runner.scheduler
        sched._drain_ready = lambda pend: False
        pops = []
        for _ in range(64):
            before = dict(runner.queue.batch_share)
            sched.run_once(wait=0.01)
            pops.append({t: n - before.get(t, 0) for t, n in
                         runner.queue.batch_share.items()
                         if n != before.get(t, 0)})
            if runner.queue.stats()["active"] == 0 and not sched._pending:
                break
        sched._resolve_pending()
        sched.wait_for_bindings()
        bindings = [{p["metadata"]["name"]: p["spec"].get("nodeName", "")
                     for p in c.pods("default").list()} for c in clients]
        ctx_stats = json.loads(json.dumps(sched.ctx_stats))
    finally:
        runner.stop()
    return bindings, ctx_stats, [p for p in pops if p]


def fleet_parity_phase(devices=("cuda", "cpu"), seeds=FLEET_PARITY_SEEDS):
    """Fleet mode on the card and on the CPU: tests/test_fleet.py's
    randomized parity workloads (seeds 0-2; three tenants, nodes
    interleaved, zone values shared) — each device's fleet-batched drain
    equal to its standalone drains, and assignments and rounds bit-equal
    across the devices; the fleet preemption wave (nodes and victims equal
    to the standalone wave's, and across the devices); a FleetRunner over
    three DirectClients (seed 0's tenants) driven pop by pop: the bindings
    on every tenant, ctx_stats and the pops equal across the devices."""
    import random
    out = {"seeds": list(seeds), "devices": list(devices)}
    for seed in seeds:
        got = [_fleet_parity_drains(seed, d) for d in devices]
        check(got[0] == got[1], f"parity.fleet: seed {seed}: the card's "
                                "drains differ from the CPU's")
        out.setdefault("placed", {})[seed] = sum(
            v is not None for v in got[0][1].values())
        out.setdefault("pods", {})[seed] = len(got[0][1])
        out.setdefault("rounds", {})[seed] = got[0][2]
    waves = [_fleet_wave(d) for d in devices]
    check(waves[0] == waves[1], "parity.fleet: the card's wave differs from "
                                "the CPU's")
    out["wave"] = waves[0]
    rng = random.Random(FLEET_PARITY_SEEDS[0])
    per_tenant = [fleet_workload(rng, rng.randint(3, 6), rng.randint(6, 12))
                  for _t in range(3)]
    runs = [_fleet_runner_run(d, per_tenant) for d in devices]
    check(runs[0] == runs[1], "parity.fleet: the card's FleetRunner differs "
                              f"from the CPU's: {runs}")
    for b in runs[0][0]:
        check(all(not v.startswith("t") for v in b.values() if v),
              "parity.fleet: a fleet node name on a tenant apiserver")
    out["runner"] = {"bound": [sum(1 for v in b.values() if v)
                               for b in runs[0][0]],
                     "ctx_stats": runs[0][1], "pops": runs[0][2]}
    return out


def fleet_drain_phase(device=None, tenants=FLEET_TENANTS,
                      nodes_per_tenant=FLEET_NODES, pods=FLEET_DRAIN_PODS,
                      batch=FLEET_BATCH):
    """The fleet-batched drain at full width: ``tenants`` randomized
    clusters of ``nodes_per_tenant`` nodes (fleet_workload, one seed
    each), ``pods`` pending pods each. The fleet leg: the rekeyed nodes
    interleaved, every pod in one FleetQueue (block = ``batch``), one pop
    split by a fleet-mode Scheduler's ``_tenant_chunks``, one gang_drain on
    the card, its count_pn launches counted. The standalone legs: each
    tenant's raw cluster, its pods popped from a plain SchedulingQueue,
    one gang_drain each. Gate: every tenant's fleet placements bit-equal
    to its standalone drain's. Then the fleet drain again, eager on the
    card (rounds not captured), and twice captured (the second replays
    only): placements and rounds bit-equal to the first. -> (summary,
    count_pn cases, (the fleet's plan, the host encoding))."""
    import random
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.cache import SchedulerCache
    from kubernetes_tpu_torch.sched.fleet import FleetQueue, rekey_for_tenant
    from kubernetes_tpu_torch.sched.queue import SchedulingQueue
    from kubernetes_tpu_torch.sched.scheduler import Scheduler
    per_tenant = [fleet_workload(random.Random(SEED + t), nodes_per_tenant,
                                 pods) for t in range(tenants)]
    sched = Scheduler(sched_config(batch_size=batch,
                                   max_drain_batches=tenants),
                      SchedulerCache(), FleetQueue(block=batch),
                      lambda p, n: True, feature_gate=no_preemption_gate(),
                      device=device)
    try:
        sched.fleet_mode = True
        by_key = {}
        for t, (_nodes, pod_dicts) in enumerate(per_tenant):
            for d in pod_dicts:
                rk = rekey_for_tenant(t, "pods", d)
                p = Pod.from_dict(rk)
                by_key[p.key] = rk
                sched.queue.add(p)
        popped = sched.queue.pop_batch(tenants * batch, wait=1.0)
        check(len(popped) == tenants * pods,
              f"fleet.drain: one pop took {len(popped)} pods")
        chunks = [[by_key[p.key] for p, _a in c]
                  for c in sched._tenant_chunks(popped, batch)]
    finally:
        sched.close()
    check(len(chunks) == tenants and all(
        len({d["metadata"]["namespace"] for d in c}) == 1 for c in chunks),
        "fleet.drain: the pop did not split into one block per tenant")
    node_dicts = _interleave([n for n, _p in per_tenant])
    kernels.reset_launches()
    g0 = graph_counters()
    fleet, fleet_rounds, fleet_s, (plan, a, host, _l) = _fleet_drain(
        node_dicts, chunks, batch, device)
    launches = dict(kernels.LAUNCHES)
    graphs = graph_report(g0, len(chunks))
    legs = {}
    for leg, kw in (("eager", {"capture": False}), ("replayed",
                                                     {"repeat": 2})):
        got, got_rounds, _s, extra = _fleet_drain(node_dicts, chunks,
                                                  batch, device, **kw)
        legs[leg] = extra[3]
        check(got == fleet and got_rounds == fleet_rounds,
              f"fleet.drain: the {leg} drain differs from the captured one")
    singles, single_s = [], 0.0
    for nodes, pod_dicts in per_tenant:
        q = SchedulingQueue()
        raw = {}
        for d in pod_dicts:
            p = Pod.from_dict(d)
            raw[p.key] = d
            q.add(p)
        order = [raw[p.key] for p, _a in q.pop_batch(batch, wait=1.0)]
        q.close()
        got, _r, s, _p = _fleet_drain(nodes, [order], batch, device)
        singles.append(got)
        single_s += s
    bad = _fleet_vs_singles(per_tenant, fleet, singles)
    check(not bad, f"fleet.drain: {len(bad)} placements differ from the "
                   f"standalone drains, e.g. {bad[:3]}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched in the fleet drain")
    placed = {}
    for key, node in fleet.items():
        if node is not None:
            t = key.split(".", 1)[0][1:]
            placed[t] = placed.get(t, 0) + 1
    summary = {"tenants": tenants, "nodes_per_tenant": nodes_per_tenant,
               "nodes": len(node_dicts), "pods_per_tenant": pods,
               "placed": placed, "fleet_drain_s": fleet_s,
               "standalone_drains_s": single_s,
               "fleet_pods_per_s": sum(placed.values()) / fleet_s,
               "fleet_rounds": fleet_rounds, "launches": launches,
               "bit_equal": True, "graphs": graphs,
               # pods/s without the first call's captures, and eager
               "replayed_drain_s": legs["replayed"],
               "replayed_pods_per_s": sum(placed.values())
               / legs["replayed"],
               "eager_drain_s": legs["eager"],
               "eager_pods_per_s": sum(placed.values()) / legs["eager"]}
    return summary, fleet_count_cases(plan, a), (plan, host)


def fleet_count_cases(plan, assignments):
    """count_pn's inputs as the fleet drain's last tenant block meets them
    in its last round: every committed pod of the drain valid, the
    block's own included (a tenant's terms match only its own pods: the
    other tenants' blocks count nothing), its spread and its
    anti-affinity terms (E = the fleet's existing-pod bucket, P = 512,
    N = 8192)."""
    import torch
    from kubernetes_tpu_torch.models.gang import _batch
    ct_all, pb_stack, e0 = plan
    B, P = pb_stack.pod_valid.shape
    a = torch.as_tensor(assignments, device=ct_all.epod_node.device)
    node = ct_all.epod_node.clone()
    valid = ct_all.epod_valid.clone()
    node[e0:] = a.reshape(-1)
    valid[e0:] = a.reshape(-1) >= 0
    ct = ct_all.replace(epod_node=node, epod_valid=valid)
    pb = _batch(pb_stack, B - 1)
    return {"fleet_spread": (ct, (pb.sc_sel, pb.pod_ns, None, None)),
            "fleet_anti_affinity": (ct, (pb.anti_sel, pb.pod_ns,
                                         pb.anti_ns_explicit,
                                         pb.anti_ns_mask))}


def fleet_nodes(t, n):
    """Tenant ``t``'s nodes as a kubemark hollow node registers (8 CPU,
    16Gi, 110 pods, its hostname label), created as objects."""
    from kubernetes_tpu_torch.testing.wrappers import make_node
    out = []
    for i in range(n):
        name = f"fc{t}-node-{i}"
        d = (make_node(name)
             .capacity({"cpu": "8", "memory": "16Gi", "pods": "110"})
             .label("kubernetes.io/hostname", name).obj().to_dict())
        d["metadata"].pop("uid", None)
        out.append(d)
    return out


def churn_loop(url, stop, period_s, stats, live_cap=FLEET_LIVE_CAP):
    """One tenant's churn (benchmarks/fleetchurn.py _tenant_churn_loop):
    create a 50m pod in namespace ``churn``, then list ``churn`` and
    record the bind latency of every pod seen bound since, delete the
    oldest bound pods beyond ``live_cap``, wait ``period_s``. ``stats``:
    created, bound, latencies, errors, and the unbound pods' create times
    (``pending``)."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    client = HTTPClient(url, timeout=60.0, wire="json")
    pending = stats.setdefault("pending", {})
    bound_live = []
    i = 0
    while not stop.is_set():
        try:
            name = f"fc-{i}"
            i += 1
            d = make_pod(name, "churn").req({"cpu": "50m"}).obj().to_dict()
            d["metadata"].pop("uid", None)
            client.pods("churn").create(d)
            pending[name] = time.time()
            stats["created"] = stats.get("created", 0) + 1
            for p in client.pods("churn").list():
                nm = p["metadata"]["name"]
                if nm in pending and (p.get("spec") or {}).get("nodeName"):
                    stats.setdefault("lat", []).append(
                        time.time() - pending.pop(nm))
                    stats["bound"] = stats.get("bound", 0) + 1
                    bound_live.append(nm)
            while len(bound_live) > live_cap:
                client.pods("churn").delete(bound_live.pop(0))
        except Exception as e:  # churn is load; the gates own correctness
            stats["errors"] = stats.get("errors", 0) + 1
            stats["last_error"] = repr(e)
        stop.wait(period_s)


def churn_stragglers(url, stats, timeout_s=FLEET_BIND_TIMEOUT_S):
    """After the window: wait for the pods created before it closed until
    each is bound or ``timeout_s`` has passed since its creation; their
    latencies join ``stats["late"]``."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    client = HTTPClient(url, timeout=60.0, wire="json")
    pending = stats.get("pending") or {}
    while pending:
        now = time.time()
        for p in client.pods("churn").list():
            nm = p["metadata"]["name"]
            if nm in pending and (p.get("spec") or {}).get("nodeName"):
                stats.setdefault("late", []).append(now - pending.pop(nm))
        if not pending or now > max(pending.values()) + timeout_s:
            break
        time.sleep(0.3)


def _pctl(xs, q):
    """The reference's percentile (benchmarks/fleetchurn.py _p99): the
    sorted sample at int(q·n)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


def _prefix_leaks(client):
    """``t<id>.`` names on a tenant's apiserver: pods' node references and
    namespaces, events' involved objects."""
    import re
    fleet = re.compile(r"^t\d+\.")
    leaks = []
    for p in client.resource("pods", None).list():
        md, spec = p.get("metadata") or {}, p.get("spec") or {}
        for v in (md.get("namespace"), spec.get("nodeName"),
                  (p.get("status") or {}).get("nominatedNodeName")):
            if v and fleet.match(v):
                leaks.append(v)
    for e in client.resource("events", None).list():
        v = (e.get("involvedObject") or {}).get("namespace")
        if v and fleet.match(v):
            leaks.append(v)
    return leaks


def fleet_phase(device=None, smi="", tenants=FLEET_TENANTS,
                nodes_per_tenant=FLEET_NODES, upfront=FLEET_UPFRONT,
                batch=FLEET_BATCH, drain_batches=FLEET_DRAIN_BATCHES,
                warmup_s=FLEET_WARMUP_S, window_s=FLEET_WINDOW_S):
    """FleetChurn (``benchmarks/fleetchurn.py`` run_fleet_churn's defaults:
    an 8 s warm-up, a 12 s window, churn every 0.4 s, tenant 0 churning
    4x) on the port's FleetRunner at 4 tenants x 1250 nodes: one APIServer
    per tenant in a spawned process, the nodes created as objects (the
    hollow kubelets are not ported), FleetRunner over the four
    HTTPClient(url, wire="json") with pops of 4 x 512 (one block per
    tenant), the explainer on, the parity sentinel every 4th drain and a
    fail-fast auditor (``cross_tenant`` live) over a FleetClient of clean
    clients every 2 s; informers synced, ``warm_drain``, the loop started,
    2500 pods per tenant created at once and counted bound by one watcher
    process per tenant; then churn threads per tenant, the warm-up, an
    adaptive quiet tail (4 s without a CompileCounter event), the window
    and 1 s more of churn under torch.profiler; each churn pod created
    before then waited for up to 120 s. Reports upfront pods/s, each
    tenant's bind p50/p99/max and count, ``fleet_slo``, the window's spans
    and the device's busy share; ``fleet_failures`` lists the gates
    missed. -> summary."""
    import multiprocessing as mp
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.audit.auditor import (InvariantAuditor,
                                                    InvariantViolationError)
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.encode.overlay import CompileCounter
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.fleet import (FLEET_SCHED_CONFIGMAP,
                                                  FleetClient, FleetRunner,
                                                  rekey_for_tenant)
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    from kubernetes_tpu_torch.utils.tracing import TRACER
    import torch
    ctx = mp.get_context("spawn")
    servers, watchers, runner = [], [], None
    churn_stop = threading.Event()
    threads = []
    summary = {"tenants": tenants, "nodes_per_tenant": nodes_per_tenant,
               "upfront_per_tenant": upfront, "batch": batch,
               "max_drain_batches": drain_batches, "window_s": window_s,
               "noisy_factor": FLEET_NOISY, "card": smi}
    try:
        t0 = time.perf_counter()
        servers = [start_apiserver(ctx) for _ in range(tenants)]
        urls = [url for _p, _pipe, url in servers]
        clients = [HTTPClient(u, timeout=120.0, wire="json") for u in urls]
        for t, c in enumerate(clients):
            c.nodes().create_many(fleet_nodes(t, nodes_per_tenant))
        summary["register_s"] = time.perf_counter() - t0
        cfg = sched_config(batch_size=batch, max_drain_batches=drain_batches,
                           explainer_enabled=True,
                           parity_sample_every=CONNECTED_PARITY_EVERY,
                           audit_interval_s=CONNECTED_AUDIT_S,
                           audit_fail_fast=True)
        runner = FleetRunner([HTTPClient(u, wire="json") for u in urls], cfg,
                             device=device)
        # fail-fast audit over CLEAN clients, as fleetchurn.py's
        # _bench_auditor: the scheduler's transport is not the auditor's
        runner.auditor = InvariantAuditor(
            client=FleetClient([HTTPClient(u, timeout=60.0, wire="json")
                                for u in urls]),
            cache=runner.cache, scheduler=runner.scheduler,
            interval_s=CONNECTED_AUDIT_S, fail_fast=True,
            pre_sweep=runner.sweep_stale_nominations,
            post_sweep=runner.publish_status,
            relists=runner._total_relists)
        t0 = time.perf_counter()
        runner.start(wait_sync=120.0, start_loop=False)
        check(runner.has_synced(), "fleet: the informers did not sync")
        summary["informer_sync_s"] = time.perf_counter() - t0
        # the drain context armed at the window's shapes with fleet-keyed
        # sample pods, so the tenant plane is in the warm shapes
        warm = [Pod.from_dict(rekey_for_tenant(
            k % tenants, "pods", make_pod(f"warm-{k}", "default")
            .req({"cpu": "50m"}).obj().to_dict()))
            for k in range(batch * drain_batches)]
        t0 = time.perf_counter()
        check(runner.scheduler.warm_drain(
            warm, slot_headroom=tenants * upfront + batch * drain_batches
            + 64), "fleet: warm_drain did not arm the context")
        summary["warm_s"] = time.perf_counter() - t0
        runner.start_loop()

        # ---- upfront: every tenant's pods, counted by a watcher each ----
        rv0 = [c.pods("default").list_rv()[1] for c in clients]
        counts, dones, deads = [], [], []
        for u, rv in zip(urls, rv0):
            count = ctx.Value("i", 0)
            done, dead, ready = ctx.Event(), ctx.Event(), ctx.Event()
            w = ctx.Process(target=watch_bound,
                            args=(u, "default", rv, upfront, count, done,
                                  dead, ready), daemon=True)
            w.start()
            watchers.append(w)
            check(ready.wait(120.0), "fleet: a watcher did not start")
            counts.append(count)
            dones.append(done)
            deads.append(dead)
        kernels.reset_launches()
        pods = []
        for k in range(upfront):
            d = make_pod(f"up-{k}", "default").req({"cpu": "100m"}) \
                .obj().to_dict()
            d["metadata"].pop("uid", None)
            pods.append(d)
        t_bind = time.perf_counter()
        with ThreadPoolExecutor(max_workers=tenants) as pool:
            list(pool.map(lambda c: c.pods("default").create_many(pods),
                          clients))
        summary["upfront_create_s"] = time.perf_counter() - t_bind
        deadline = t_bind + FLEET_BIND_TIMEOUT_S
        while time.perf_counter() < deadline and not all(
                d.is_set() for d in dones):
            check(runner.loop_error is None,
                  f"fleet: the scheduling loop died: {runner.loop_error!r}")
            check(not any(d.is_set() for d in deads),
                  "fleet: a watcher died")
            time.sleep(0.05)
        summary["upfront_bind_s"] = time.perf_counter() - t_bind
        summary["upfront_bound"] = [c.value for c in counts]
        summary["upfront_pods_per_s"] = (sum(summary["upfront_bound"])
                                         / summary["upfront_bind_s"])
        for w in watchers:
            stop_process(w)
        watchers = []

        # ---- churn: tenant 0 at 4x -------------------------------------
        stats = [{} for _ in range(tenants)]
        for t, u in enumerate(urls):
            period = FLEET_CHURN_PERIOD_S / (FLEET_NOISY if t == 0 else 1)
            th = threading.Thread(target=churn_loop,
                                  args=(u, churn_stop, period, stats[t]),
                                  daemon=True)
            th.start()
            threads.append(th)
        time.sleep(warmup_s)
        compiles = CompileCounter()
        compiles.arm()
        t0 = time.perf_counter()
        last, last_change = compiles.take(), t0
        while time.perf_counter() - t0 < FLEET_QUIET_TIMEOUT_S:
            time.sleep(0.25)
            n = compiles.take()
            if n != last:
                last, last_change = n, time.perf_counter()
            elif time.perf_counter() - last_change >= FLEET_QUIET_S:
                break
        compiles.disarm()
        summary["warmup_quiet_s"] = time.perf_counter() - t0
        summary["warmup_compile_events"] = compiles.take()

        # ---- the window ---------------------------------------------------
        ctx0 = dict(runner.scheduler.ctx_stats)
        enc0 = runner.cache.stats()["full_encodes"]
        for s in stats:
            s["created"] = s["bound"] = 0
            s["lat"] = []
        TRACER.max_spans = max(TRACER.max_spans, 200000)
        TRACER.reset()
        window = CompileCounter()
        window.arm()
        t_win = time.perf_counter()
        time.sleep(window_s)
        window.disarm()
        summary["window_wall_s"] = time.perf_counter() - t_win
        ctx1 = dict(runner.scheduler.ctx_stats)
        enc1 = runner.cache.stats()["full_encodes"]
        spans = _span_totals()
        summary["spans_dropped"] = TRACER.dropped
        # the device's busy share: 1 s of the same churn under
        # torch.profiler, just after the window (the reference's window
        # runs no profiler, and starting one stalls the host threads)
        torch.cuda.synchronize()
        trace_path = os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "build", "profile", "fleet_churn.json")
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        with profiled() as prof:
            tp = time.perf_counter()
            time.sleep(FLEET_PROFILE_S)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - tp) * 1e3
        churn_stop.set()
        for th in threads:
            th.join(30.0)
        for t, u in enumerate(urls):
            churn_stragglers(u, stats[t])
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        tsum = trace_summary(events, top=6)
        summary["profile"] = {
            "wall_ms": prof_wall_ms,
            "launches": sum(1 for e in events if e.get("ph") == "X"
                            and e.get("cat") == "kernel"),
            "device_busy_ms": tsum["device_busy_ms"],
            "device_busy_share": tsum["device_busy_ms"] / prof_wall_ms,
            "top_device_ops": tsum["top_device_ops"],
            "hand_kernels": tsum["hand_kernels"],
            "trace": os.path.relpath(trace_path)}
        summary["launches"] = dict(kernels.LAUNCHES)
        summary["ctx_window"] = {
            "steady_compiles": window.take(),
            "rebuilds": ctx1["rebuilds"] - ctx0["rebuilds"],
            "folds": ctx1["folds"] - ctx0["folds"],
            "patches": ctx1["patches"] - ctx0["patches"],
            "full_encodes": enc1 - enc0,
            "resident_ctx_live": runner.scheduler._drain_ctx is not None,
            "rebuild_reasons": dict(ctx1.get("reasons") or {})}
        summary["window_spans_top"] = dict(sorted(
            spans.items(), key=lambda kv: -kv[1]["total_ms"])[:12])

        # ---- per tenant --------------------------------------------------
        out = {}
        for t, s in enumerate(stats):
            lat = s.get("lat") or []
            late = s.get("late") or []
            created, bound = s.get("created", 0), s.get("bound", 0)
            every = lat + late
            out[str(t)] = {
                "noisy": t == 0, "created": created, "bound": bound,
                "binds": len(lat), "late_binds": len(late),
                "unbound": len(s.get("pending") or {}),
                "binds_per_s": bound / summary["window_wall_s"],
                "ratio": bound / created if created else None,
                "p50_bind_s": _pctl(lat, 0.5), "p99_bind_s": _pctl(lat, 0.99),
                "max_bind_s": max(every) if every else 0.0,
                "slowest_s": sorted(lat)[-5:],
                "churn_errors": s.get("errors", 0),
                "last_churn_error": s.get("last_error")}
        summary["tenant"] = out
        summary["fleet_sched"] = runner.fleet_sched_status()
        summary["relists"] = runner._total_relists()
        sentinel = runner.scheduler.sentinel
        sentinel.drain(120.0)
        summary["sentinel"] = sentinel.stats()
        runner.auditor.stop()
        for _ in range(2):
            try:
                runner.auditor.run_once()
            except InvariantViolationError:
                pass  # counted below
        audit = runner.auditor.status()
        summary["audit"] = {k: audit[k] for k in ("sweeps", "violations",
                                                  "byInvariant", "failed")}
        summary["breaker"] = runner.scheduler.breaker.mode
        summary["loop_error"] = (repr(runner.loop_error)
                                 if runner.loop_error is not None else None)
        fleet_cms = []
        for c in clients:
            try:
                cm = c.resource("configmaps", "default").get(
                    FLEET_SCHED_CONFIGMAP)
                fleet_cms.append(json.loads(cm["data"]["fleetSched"])
                                 ["tenants"])
            except Exception:
                fleet_cms.append(0)
        summary["fleet_configmaps"] = fleet_cms
        summary["prefix_leaks"] = [v for c in clients
                                   for v in _prefix_leaks(c)]
    finally:
        churn_stop.set()
        for th in threads:
            th.join(30.0)
        if runner is not None:
            runner.stop()  # re-raises a fatal failure that ended the loop
        for w in watchers:
            stop_process(w)
        for proc, pipe, _url in servers:
            stop_process(proc, pipe)
    summary.update(fleet_slo(summary))
    summary["failures"] = fleet_failures(summary)
    check(summary["breaker"] == "single",
          f"fleet: the breaker degraded to {summary['breaker']!r}")
    check(summary["spans_dropped"] == 0,
          f"fleet: the tracer dropped {summary['spans_dropped']} spans")
    return summary


# --------------------------------------------------------------------- DRA

DRA_PARITY_NODES = 48      # dra_mix: the claim parity cluster
DRA_PARITY_PODS = 160
DRA_NODES = 500            # SchedulingWithResourceClaimTemplate/5000pods_500nodes
DRA_DEVICES = 10           # one ResourceSlice of 10 devices a node
DRA_INIT_PODS = 2500       # namespace init
DRA_MEASURED_PODS = 2500   # namespace test: the measured pods
DRA_RELEASE = 500          # measured pods deleted, then as many new ones
DRA_TIMEOUT_S = 120.0      # each leg's wall


def _dra_scheduler(w, device, serial=False, **cfg):
    """A port Scheduler (make_scheduler) over ``dra_mix`` dicts ``w``: its
    nodes and bound pods, and its DeviceClasses, ResourceSlices and
    ResourceClaims fed to the cache as the runner's informers feed them.
    ``serial``: TPUBatchScheduling off (one acceptance a round: the
    oracle's serial semantics). -> (scheduler, binder log)."""
    import copy
    from kubernetes_tpu_torch.api.types import Node, Pod
    gate = no_preemption_gate()
    if serial:
        gate.set("TPUBatchScheduling", False)
    sched, log = make_scheduler(
        sched_config(**cfg), [Node.from_dict(copy.deepcopy(d))
                              for d in w["nodes"]],
        [Pod.from_dict(copy.deepcopy(d)) for d in w["bound"]],
        device=device, confirm=False, gate=gate)
    for kind, key in (("DeviceClass", "classes"), ("ResourceSlice", "slices"),
                      ("ResourceClaim", "claims")):
        for obj in w[key]:
            sched.cache.update_dra_object(kind, copy.deepcopy(obj))
    sched._drain_ready = lambda pend: False
    return sched, log


def _dra_drive(sched, w, churn=True, pops=8):
    """Queue every pending pod, then ``pops`` run_once, the churn of
    tests/test_torch_dra.py landing first (before the second pop the late
    node joins, its slice published before it: a folded node patch;
    before the third a new ResourceSlice: a full encode)."""
    import copy
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.testing import workloads
    for d in w["pending"]:
        sched.queue.add(Pod.from_dict(copy.deepcopy(d)))
    for i in range(pops):
        if churn and i == 1:
            sched.cache.add_node(Node.from_dict(copy.deepcopy(
                w["late_nodes"][0])))
        if churn and i == 2:
            sched.cache.update_dra_object(
                "ResourceSlice", workloads.resource_slice("node-1", 3))
        sched.run_once(wait=0.01)
    sched._resolve_pending()
    sched.wait_for_bindings()


def _dra_devices_held(w, log, extra_slices=()):
    """node -> (devices the bound and placed claim pods hold, devices the
    node's slices publish)."""
    demand = {}
    for c in w["claims"]:
        md = c["metadata"]
        demand[(md["namespace"], md["name"])] = sum(
            r.get("count", 1) for r in c["spec"]["devices"]["requests"])
    held: dict = {}
    pods = [(p, log.get(f"{p['metadata']['namespace']}/"
                       f"{p['metadata']['name']}", ""))
            for p in w["pending"]]
    pods += [(p, p["spec"]["nodeName"]) for p in w["bound"]]
    for p, node in pods:
        if not node:
            continue
        ns, name = p["metadata"]["namespace"], p["metadata"]["name"]
        for ref in p["spec"].get("resourceClaims") or []:
            cname = ref.get("resourceClaimName") or f"{name}-{ref['name']}"
            held[node] = held.get(node, 0) + demand.get((ns, cname), 0)
    cap: dict = {}
    for sl in list(w["slices"]) + list(extra_slices):
        node = sl["spec"]["nodeName"]
        cap[node] = cap.get(node, 0) + sum(
            d.get("count", 1) for d in sl["spec"]["devices"])
    return {n: (held.get(n, 0), cap.get(n, 0)) for n in set(held) | set(cap)}


def dra_parity_phase(devices=("cuda", "cpu"), seed=SEED,
                     n_nodes=DRA_PARITY_NODES, n_pods=DRA_PARITY_PODS):
    """DRA device claims on the card, on the CPU and through the oracle, on
    one seeded claim workload (``testing/workloads.dra_mix``: one
    DeviceClass, ResourceSlices on every other node, template and named
    claims, a pod whose claim is not made yet, a pod whose claim is
    already allocated, three pods contending for one node's two devices,
    bound pods holding claims):

    - ``gang_drain`` of the pending pods (batches of 32) over the host
      encoding with its ``dra:`` column: assignments, rounds and the final
      requested bit-equal across the devices;
    - the port's Scheduler, drain path with fold (batches of 16, 4 a pop,
      depth 2), the churn of tests/test_torch_dra.py between pops: binder
      logs, ctx_stats and the folded context (resources, requested and
      allocatable with the ``dra:`` column, epod slots) equal across the
      devices; no node over the devices its slices publish; the unready
      pod unplaced, the pinned pod on its claim's node, two of the three
      contenders placed;
    - the Scheduler with TPUBatchScheduling off (serial rounds, pops of
      one batch of 16) on each device, and the same Scheduler at the
      breaker's oracle level (the numpy oracle): every placement equal to
      the oracle's.
    -> summary."""
    import copy
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models.gang import gang_drain
    from kubernetes_tpu_torch.sched.dra import DRA_PREFIX, DraCatalog
    from kubernetes_tpu_torch.testing import workloads
    w = workloads.dra_mix(nodes=n_nodes, pods=n_pods, seed=seed)
    out = {"nodes": n_nodes, "pending": len(w["pending"]),
           "claims": len(w["claims"]), "slices": len(w["slices"])}
    # gang_drain over the host encoding
    enc = SnapshotEncoder()
    enc.set_dra(DraCatalog.from_lists(copy.deepcopy(w["claims"]),
                                      copy.deepcopy(w["classes"]),
                                      copy.deepcopy(w["slices"])))
    pending = [Pod.from_dict(copy.deepcopy(d)) for d in w["pending"]]
    ct, meta = enc.encode_cluster(
        [Node.from_dict(copy.deepcopy(d)) for d in w["nodes"]],
        [Pod.from_dict(copy.deepcopy(d)) for d in w["bound"]],
        pending_pods=pending, pending_slots=False)
    P = 32
    pbs = [enc.encode_pods(pending[i:i + P], meta, min_p=P)
           for i in range(0, len(pending), P)]
    drains = {d: gang_drain(ct, pbs, topo_keys=meta.topo_keys, seed=seed,
                            device=d) for d in devices}
    for d in devices[1:]:
        check(_same(drains[devices[0]], drains[d]),
              f"parity.dra: gang_drain on {d} differs from {devices[0]}")
    a, rounds, requested = drains[devices[0]]
    col = meta.resources.index(DRA_PREFIX + workloads.DRA_CLASS)
    out["gang_drain"] = {"placed": int((a >= 0).sum()),
                         "rounds": rounds.tolist(),
                         "devices_requested": int(requested[:, col].sum()),
                         "resources": list(meta.resources)}
    # the Scheduler's drain path with fold
    runs = {}
    for d in devices:
        sched, log = _dra_scheduler(w, d, batch_size=16, max_drain_batches=4,
                                    pipeline_depth=2)
        try:
            _dra_drive(sched, w)
            ctx = sched._drain_ctx
            cs, cct = ctx["cs"], ctx["ct"]
            runs[d] = {"log": {k: n for k, n, _t in log},
                       "ctx_stats": json.loads(json.dumps(sched.ctx_stats)),
                       "fill_host": cs.fill_host, "top": cs.top,
                       "resources": list(ctx["meta"].resources),
                       "requested": cct.requested.cpu().tolist(),
                       "allocatable": cct.allocatable.cpu().tolist(),
                       "epod_valid": cct.epod_valid.cpu().tolist(),
                       "epod_node": cct.epod_node.cpu().tolist()}
        finally:
            sched.close()
    first = runs[devices[0]]
    for d in devices[1:]:
        for key, value in first.items():
            check(runs[d][key] == value,
                  f"parity.dra: the scheduler's {key} on {d} differs from "
                  f"{devices[0]}")
    log = first["log"]
    held = _dra_devices_held(w, log, [workloads.resource_slice("node-1", 3)])
    over = {n: hc for n, hc in held.items() if hc[0] > hc[1]}
    check(not over, f"parity.dra: nodes over their devices: {over}")
    pin = next(c for c in w["claims"] if c["metadata"]["name"]
               == "c-pinned")["status"]["allocation"]["nodeName"]
    check("default/unready" not in log,
          "parity.dra: the pod whose claim is missing was placed")
    check(log.get("default/pinned") == pin,
          f"parity.dra: the pinned pod went to {log.get('default/pinned')!r}"
          f", its claim is allocated on {pin}")
    contenders = sorted(k for k in log if k.startswith("default/contend-"))
    check(len(contenders) == 2,
          f"parity.dra: {len(contenders)} of 3 contenders placed on 2 "
          "devices")
    check(first["ctx_stats"]["folds"] >= 1
          and first["ctx_stats"]["rebuilds"] >= 2,
          f"parity.dra: the churn did not fold and rebuild "
          f"({first['ctx_stats']})")
    out["scheduler"] = {
        "placed": len(log), "ctx_stats": first["ctx_stats"],
        "resources": first["resources"],
        "devices_held": sum(h for h, _c in held.values()),
        "devices_published": sum(c for _h, c in held.values())}
    # serial rounds against the oracle
    logs = {}
    for leg, d in [(f"serial_{d}", d) for d in devices] + [("oracle",
                                                             devices[-1])]:
        # one batch a pop: the oracle's tie-break salt is the pod's index
        # in the pop, the serial rounds' its index in the batch
        sched, log = _dra_scheduler(w, d, serial=True, batch_size=16,
                                    max_drain_batches=1)
        if leg == "oracle":
            sched.breaker.attempt_level = lambda: "oracle"
        try:
            _dra_drive(sched, w, churn=False, pops=14)
            logs[leg] = {k: n for k, n, _t in log}
        finally:
            sched.close()
    for leg, got in logs.items():
        check(got == logs["oracle"],
              f"parity.dra: {leg}'s placements differ from the oracle's")
    out["serial"] = {"placed": len(logs["oracle"]),
                     "legs": sorted(logs)}
    return out


def serve_claim_controller(url, stop, ready, failed):
    """Child process: the port's ResourceClaimController over its own HTTP
    client and informers, as a controller manager beside the scheduler
    runs it; ``ready`` once its informers synced, until ``stop``."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.controllers import ResourceClaimController
    ctrl = ResourceClaimController(HTTPClient(url, wire="json"))
    factory = InformerFactory(HTTPClient(url, wire="json"))
    try:
        ctrl.register(factory)
        factory.start_all()
        if not factory.wait_for_cache_sync(120.0):
            failed.set()
            return
        ctrl.start()
        ready.set()
        stop.wait()
    except Exception:
        import traceback
        traceback.print_exc()
        failed.set()
    finally:
        ctrl.stop()
        factory.stop_all()


def _claims_by_pod(client, namespaces):
    """(namespace, pod name) -> the pod's template claim ``<pod>-dev``."""
    out = {}
    for ns in namespaces:
        for c in client.resource("resourceclaims", ns).list():
            name = c["metadata"]["name"]
            if name.endswith("-dev"):
                out[(ns, name[:-len("-dev")])] = c
    return out


def dra_phase(device=None, smi="", n_nodes=DRA_NODES, devices=DRA_DEVICES,
              n_init=DRA_INIT_PODS, n_measured=DRA_MEASURED_PODS,
              n_release=DRA_RELEASE):
    """SchedulingWithResourceClaimTemplate/5000pods_500nodes (upstream
    test/integration/scheduler_perf's DRA config, structured parameters),
    through the port: the APIServer in a spawned process; 500 nodes, each
    with one ResourceSlice of 10 devices of one DeviceClass; one
    ResourceClaimTemplate (1 device) in each of the namespaces init and
    test; the SchedulerRunner over HTTP (reference defaults: pops of 8 x
    256, depth 2; the parity sentinel every 4th drain and a fail-fast
    auditor every 2 s, as in the connected phase; the explainer off) and
    the port's ResourceClaimController in a spawned process of its own
    (serve_claim_controller), as a controller manager runs beside the
    scheduler. Informers synced, ``warm_drain``, the loop started; then
    2500 init pods, all bound; then the 2500 measured pods (the window:
    first create to the last bound event, a watcher process counting);
    then the release leg: 500 measured pods deleted, 500 new ones created
    under torch.profiler (the device's busy share), all bound on the freed
    devices, and the controller's release of the deleted pods' claims.
    Gates: every pod bound; every pod's claim allocated on its node with
    the pod (its uid) in reservedFor; no node over its 10 allocated
    devices; no pod bound while its claim was missing (a count at the
    binder); 0 audit violations; 0 sentinel divergences; 0 loop errors,
    breaker "single", 0 pods through the oracle; the release leg's pods
    bound. Reported: the measured pods/s (upstream's
    SchedulingThroughput), attempt p50/p99, the claim events the
    scheduler's informer saw, rebuilds, full encodes and captures in the
    window, the busy share. -> summary."""
    import multiprocessing as mp
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from kubernetes_tpu_torch.audit.auditor import (InvariantAuditor,
                                                    InvariantViolationError)
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.metrics.registry import (ATTEMPT_DURATION,
                                                       LOOP_ERRORS)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.testing import workloads
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.utils.tracing import TRACER
    node_dicts, classes, slices, templates = \
        workloads.claim_template_cluster(n_nodes, devices)
    init_pods = _wire_dicts(workloads.claim_template_pods(
        "init", n_init, "init"))
    measured = _wire_dicts(workloads.claim_template_pods(
        "test", n_measured, "test"))
    fresh = _wire_dicts(workloads.claim_template_pods(
        "rel", n_release, "test"))
    ctx = mp.get_context("spawn")
    server, server_pipe, url = start_apiserver(ctx)
    runner = ctrl = None
    ctrl_stop = ctx.Event()
    watchers = []
    summary = {"nodes": n_nodes, "devices_per_node": devices,
               "init_pods": n_init, "measured_pods": n_measured,
               "release": n_release, "card": smi}

    def wait_leg(ns, rv0, n, what, prefix=""):
        count = ctx.Value("i", 0)
        done, dead, ready = ctx.Event(), ctx.Event(), ctx.Event()
        proc = ctx.Process(target=watch_bound,
                           args=(url, ns, rv0, n, count, done, dead, ready,
                                 prefix), daemon=True)
        proc.start()
        watchers.append(proc)
        check(ready.wait(120.0), f"dra: the {what} watcher did not start")
        return count, done, dead

    def until(done, dead, count, n, t0, what):
        while not done.wait(timeout=0.02):
            check(runner.loop_error is None,
                  f"dra: the scheduling loop died: {runner.loop_error!r}")
            check(ctrl.is_alive(), "dra: the claim controller died")
            check(not dead.is_set(), f"dra: the {what} watcher died")
            check(time.perf_counter() - t0 < DRA_TIMEOUT_S,
                  f"dra: {count.value} of {n} {what} pods bound in "
                  f"{DRA_TIMEOUT_S} s")
        return time.perf_counter() - t0

    try:
        seed_client = HTTPClient(url, timeout=120.0, wire="json")
        t0 = time.perf_counter()
        seed_client.resource("deviceclasses", None).create_many(classes)
        seed_client.nodes().create_many(node_dicts)
        seed_client.resource("resourceslices", None).create_many(slices)
        for tpl in templates:
            seed_client.resource("resourceclaimtemplates",
                                 tpl["metadata"]["namespace"]).create(tpl)
        summary["seed_s"] = time.perf_counter() - t0
        # the claim controller in its own process, as a controller manager
        # beside the scheduler runs it
        ctrl_ready, ctrl_failed = ctx.Event(), ctx.Event()
        ctrl = ctx.Process(target=serve_claim_controller,
                           args=(url, ctrl_stop, ctrl_ready, ctrl_failed),
                           daemon=True)
        ctrl.start()
        check(ctrl_ready.wait(120.0) and not ctrl_failed.is_set(),
              "dra: the claim controller did not start")
        cfg = sched_config(parity_sample_every=CONNECTED_PARITY_EVERY,
                           audit_interval_s=CONNECTED_AUDIT_S,
                           audit_fail_fast=True)
        runner = SchedulerRunner(HTTPClient(url, wire="json"), cfg,
                                 feature_gate=no_preemption_gate(),
                                 device=device)
        runner.auditor = InvariantAuditor(
            client=HTTPClient(url, timeout=60.0, wire="json"),
            cache=runner.cache, scheduler=runner.scheduler,
            interval_s=CONNECTED_AUDIT_S, fail_fast=True,
            pre_sweep=runner.sweep_stale_nominations,
            post_sweep=runner.publish_status,
            relists=runner._total_relists)
        t0 = time.perf_counter()
        runner.start(wait_sync=120.0, start_loop=False)
        check(runner.has_synced(), "dra: the informers did not sync")
        check(runner.cache.dra_catalog is not None
              and len(runner.cache.dra_catalog.slices) == n_nodes,
              "dra: the scheduler's catalog lacks the slices")
        summary["informer_sync_s"] = time.perf_counter() - t0
        sched = runner.scheduler
        pop = cfg.batch_size * cfg.max_drain_batches
        t0 = time.perf_counter()
        check(sched.warm_drain([Pod.from_dict(d) for d in init_pods[:pop]],
                               slot_headroom=n_init + n_measured + n_release
                               + pop),
              "dra: warm_drain did not arm the context")
        summary["warm_drain_s"] = time.perf_counter() - t0
        # instrumentation, read-only: a binding whose claims the
        # scheduler's catalog cannot resolve, and the DRA events its
        # informers deliver
        missing, events = [], {}
        binder = sched.binder

        def counting_binder(pod, node):
            if not runner.cache.dra_catalog.pod_claims_ready(pod):
                missing.append(pod.key)
            return binder(pod, node)
        sched.binder = counting_binder
        on_dra = runner.cache.update_dra_object

        def counting_update(kind, obj, deleted=False):
            key = (kind, "deleted" if deleted else
                   "allocated" if (obj.get("status") or {}).get("allocation")
                   else "unallocated")
            events[key] = events.get(key, 0) + 1
            return on_dra(kind, obj, deleted=deleted)
        runner.cache.update_dra_object = counting_update

        errors0 = sum(LOOP_ERRORS.items().values())
        kernels.reset_launches()
        runner.start_loop()
        # init pods
        _, rv0 = seed_client.pods("init").list_rv()
        count, done, dead = wait_leg("init", rv0, n_init, "init")
        t0 = time.perf_counter()
        seed_client.pods("init").create_many(init_pods)
        summary["init_s"] = until(done, dead, count, n_init, t0, "init")
        # the measured pods
        _, rv0 = seed_client.pods("test").list_rv()
        count, done, dead = wait_leg("test", rv0, n_measured, "measured",
                                     prefix="test-")
        ATTEMPT_DURATION.reset()
        TRACER.max_spans = max(TRACER.max_spans, 8 * n_measured)
        TRACER.reset()
        ctx0 = json.loads(json.dumps(sched.ctx_stats))
        full0 = runner.cache.stats()["full_encodes"]
        ev0 = dict(events)
        g0 = graph_counters()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as pool:
            chunk = -(-n_measured // 4)
            list(pool.map(lambda objs: seed_client.pods("test")
                          .create_many(objs),
                          [measured[i:i + chunk]
                           for i in range(0, n_measured, chunk)]))
        create_s = time.perf_counter() - t0
        window_s = until(done, dead, count, n_measured, t0, "measured")
        q = {"result": "scheduled"}
        ctx1 = json.loads(json.dumps(sched.ctx_stats))
        pops = sum(1 for _ in TRACER.spans("scheduler/gang_dispatch"))
        summary.update({
            "window_s": window_s, "create_s": create_s,
            "pods_per_s": n_measured / window_s,
            "attempt_p50_s": ATTEMPT_DURATION.percentile(0.5, q),
            "attempt_p99_s": ATTEMPT_DURATION.percentile(0.99, q),
            "attempts_observed": ATTEMPT_DURATION.count(q),
            "window_ctx": {k: ctx1[k] - ctx0[k] for k in
                           ("folds", "patches", "rebuilds", "unfit")},
            "window_full_encodes":
                runner.cache.stats()["full_encodes"] - full0,
            "window_claim_events": {
                f"{k[0]}/{k[1]}": events.get(k, 0) - ev0.get(k, 0)
                for k in events},
            "window_graphs": graph_report(g0, pops * cfg.max_drain_batches),
            "window_spans": {k: v for k, v in _span_totals().items()
                             if k.startswith(("scheduler/", "runner/"))}})
        # the release leg: measured pods deleted, as many new ones bound
        # on the devices they freed, under torch.profiler
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(lambda d: seed_client.pods("test").delete(
                d["metadata"]["name"]), measured[:n_release]))
        _, rv0 = seed_client.pods("test").list_rv()
        count, done, dead = wait_leg("test", rv0, n_release, "release",
                                     prefix="rel-")
        trace_path = os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "build", "profile", "dra_release.json")
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        torch.cuda.synchronize()
        with profiled() as prof:
            t0 = time.perf_counter()
            seed_client.pods("test").create_many(fresh)
            release_s = until(done, dead, count, n_release, t0, "release")
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        summary["release_s"] = release_s
        summary["release_bound"] = count.value
        # the controller releases the deleted pods' claims (its sweep)
        gone = {("test", d["metadata"]["name"]) for d in measured[:n_release]}
        t0 = time.perf_counter()
        while True:
            claims = _claims_by_pod(seed_client, ("init", "test"))
            stale = [k for k in gone if (claims.get(k, {}).get("status")
                                         or {}).get("allocation")]
            if not stale or time.perf_counter() - t0 > 30.0:
                break
            time.sleep(0.25)
        summary["release_sweep_s"] = time.perf_counter() - t0
        check(not stale, f"dra: {len(stale)} deleted pods' claims still "
                         "allocated after 30 s")
        summary["launches"] = dict(kernels.LAUNCHES)
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            tsum = trace_summary(json.load(f)["traceEvents"], top=6)
        summary["profile"] = {
            "wall_ms": prof_wall_ms, "device_busy_ms": tsum["device_busy_ms"],
            "device_busy_share": tsum["device_busy_ms"] / prof_wall_ms,
            "top_device_ops": tsum["top_device_ops"],
            "trace": os.path.relpath(trace_path)}
        summary["claim_events"] = {f"{k[0]}/{k[1]}": n
                                   for k, n in events.items()}
        summary["ctx_stats"] = json.loads(json.dumps(sched.ctx_stats))
        summary["full_encodes"] = runner.cache.stats()["full_encodes"]
        summary["loop_errors"] = sum(LOOP_ERRORS.items().values()) - errors0
        summary["oracle_pods"] = sum(
            sp.attributes["pods"] for sp in TRACER.spans("scheduler/oracle"))
        summary["breaker"] = sched.breaker.mode
        summary["bound_while_claim_missing"] = len(missing)
        sentinel = sched.sentinel
        sentinel.drain(120.0)
        runner.auditor.stop()
        for _ in range(2):
            try:
                runner.auditor.run_once()
            except InvariantViolationError:
                pass  # counted below
        audit = runner.auditor.status()
        summary["audit"] = {k: audit[k] for k in ("sweeps", "violations",
                                                  "byInvariant")}
        summary["sentinel"] = sentinel.stats()
        pods = {(ns, p["metadata"]["name"]): p
                for ns in ("init", "test")
                for p in seed_client.pods(ns).list()}
        claims = _claims_by_pod(seed_client, ("init", "test"))
    finally:
        if runner is not None:
            runner.stop()  # re-raises a fatal failure that ended the loop
        if ctrl is not None:
            ctrl_stop.set()
            stop_process(ctrl)
        for proc in watchers:
            stop_process(proc)
        stop_process(server, server_pipe)
    unbound = [k for k, p in pods.items() if not p["spec"].get("nodeName")]
    wrong, per_node = [], {}
    for k, p in pods.items():
        node = p["spec"].get("nodeName", "")
        c = claims.get(k)
        st = (c or {}).get("status") or {}
        alloc = (st.get("allocation") or {}).get("nodeName")
        held = [(r.get("name"), r.get("uid")) for r in
                st.get("reservedFor") or []]
        if not node or alloc != node or held != [
                (k[1], p["metadata"].get("uid"))]:
            wrong.append(k)
    for c in claims.values():
        node = ((c.get("status") or {}).get("allocation") or {}).get(
            "nodeName")
        if node:
            per_node[node] = per_node.get(node, 0) + 1
    over = {n: k for n, k in per_node.items() if k > devices}
    summary.update({"pods_total": len(pods), "unbound": len(unbound),
                    "claims_wrong": len(wrong),
                    "max_devices_allocated_on_a_node":
                        max(per_node.values(), default=0),
                    "nodes_with_devices_allocated": len(per_node)})
    check(len(pods) == n_init + n_measured and not unbound,
          f"dra: {len(unbound)} of {len(pods)} pods unbound")
    check(not wrong, f"dra: {len(wrong)} pods whose claim is not allocated "
                     f"on their node to them (first {sorted(wrong)[:3]})")
    check(not over, f"dra: nodes over {devices} allocated devices: {over}")
    check(summary["bound_while_claim_missing"] == 0,
          f"dra: {len(missing)} pods bound while their claim was missing")
    check(summary["release_bound"] == n_release,
          f"dra: {summary['release_bound']} of {n_release} release pods bound")
    check(summary["audit"]["violations"] == 0,
          f"dra: invariant violations {summary['audit']['byInvariant']}")
    check(summary["sentinel"]["divergences"] == 0,
          f"dra: parity divergence {summary['sentinel']}")
    check(summary["loop_errors"] == 0,
          f"dra: {summary['loop_errors']} loop errors")
    check(summary["breaker"] == "single",
          f"dra: the breaker degraded to {summary['breaker']!r}")
    check(summary["oracle_pods"] == 0,
          f"dra: {summary['oracle_pods']} pods went through the oracle")
    return summary


# ------------------------------------------------------------------ graphs

# parity.graph's round cut: the CPU leg converges a full-width batch in
# seconds a round, so every leg of the three-way comparison stops at this
# many rounds (the same cut on each: the reference's max_rounds cut)
GRAPH_CPU_ROUNDS = 2


def graph_counters() -> dict:
    from kubernetes_tpu_torch.models import graphs
    return {"captures": graphs.CAPTURES, "replays": graphs.REPLAYS,
            "host_reads": graphs.HOST_READS}


def graph_report(before: dict, batches: int) -> dict:
    """The round graphs' counters since ``before`` (captures, replays,
    host reads of the progress flag; replays and reads per batch over
    ``batches``), the keys held, the graph pool's bytes and K."""
    from kubernetes_tpu_torch.models import gang, graphs
    now = graph_counters()
    out = {k: now[k] - before[k] for k in now}
    out.update(replays_per_batch=out["replays"] / max(batches, 1),
               host_reads_per_batch=out["host_reads"] / max(batches, 1),
               keys=graphs.counters()["keys"],
               pool_bytes=graphs.pool_bytes(), K=gang.GRAPH_CHUNK)
    return out


def _host_tree(tree) -> list:
    from kubernetes_tpu_torch.models.gang import _tree_leaves
    return [t.cpu().numpy().copy() for t in _tree_leaves(tree)]


def _same(a, b) -> bool:
    import numpy as np
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def drain_step_legs(ct, e0, fill, stack, cut_stack, topo_keys, name,
                    card="cuda", cut=True, cpu=True):
    """One ``drain_step`` at a resident context's shape (``ct``, never
    written: every leg runs on its own copy). Of ``stack`` at the full
    round limit, captured and eager on the card, each warmed by one call
    on its copy and the copy restored, then profiled (torch.profiler: the
    device's busy share of the call, the host's launch calls and the
    kernels a round): assignments, rounds, new fill and the folded context
    bit-equal. With ``cut``: the first batch of ``cut_stack`` through the
    drain's batch loop (``gang._drain_batches``, its slots at ``e0``) at
    GRAPH_CPU_ROUNDS, captured, eager and (with ``cpu``) on the CPU:
    assignments, rounds, requested and the context's slots bit-equal.
    -> the report (graph counters of the profiled captured call)."""
    from kubernetes_tpu_torch.models.gang import (_batch, _drain_batches,
                                                  _drain_kw, _tree_map,
                                                  adopt_storage, drain_step,
                                                  stack_batches)
    B = int(stack.pod_valid.shape[0])
    out, results = {}, {}
    for leg, capture in (("captured", True), ("eager", False)):
        ctx = _tree_map(lambda x: x.to(card, copy=True), ct)
        kw = dict(e0=e0, topo_keys=topo_keys, capture=capture)
        drain_step(ctx, stack, fill, **kw)
        adopt_storage(ctx, ct)
        res = []
        g0 = graph_counters()
        prof = profile_call(lambda: res.append(drain_step(
            ctx, stack, fill, **kw)), f"{name}_drain_step_{leg}")
        rounds = int(res[0][1].sum())
        out[leg] = {"wall_ms": prof["wall_ms"], "rounds": rounds,
                    "device_busy_share": prof["device_busy_share"],
                    "launches_per_round": prof["api_launches"] / rounds,
                    "kernels_per_round": prof["launches"] / rounds}
        if capture:
            out[leg]["graphs"] = graph_report(g0, B)
        a, r, folded, new_fill = res[0]
        results[leg] = (a.cpu().numpy(), r.cpu().numpy(), int(new_fill),
                        _host_tree(folded))
        del ctx, folded
    check(_same(results["captured"], results["eager"]),
          f"parity.graph ({name}): the eager drain_step differs from the "
          "captured one")
    if cut:
        first = stack_batches([_batch(cut_stack, 0)])
        legs = [("captured_cut", True, card), ("eager_cut", False, card)]
        if cpu:
            legs.append(("cpu_cut", True, "cpu"))
        for leg, capture, device in legs:
            ctx = _tree_map(lambda x: x.to(device, copy=True), ct)
            kw = _drain_kw(0, "LeastAllocated", topo_keys, (), (),
                           GRAPH_CPU_ROUNDS, capture)
            t0 = time.perf_counter()
            a, r, req = _drain_batches(ctx, first.to(device), e0, kw)
            out[leg] = {"seconds": time.perf_counter() - t0}
            results[leg] = [x.cpu().numpy() for x in (
                a, r, req, ctx.epod_node, ctx.epod_valid)]
            del ctx
        for leg in [leg for leg, _c, _d in legs[1:]]:
            check(_same(results["captured_cut"], results[leg]),
                  f"parity.graph ({name}): {leg} differs from captured_cut")
    out["bit_equal"] = True
    return out


def gang_drain_legs(ct, pbs, topo_keys, name, seed=0, card="cuda",
                    cpu=True):
    """``gang_drain`` of a drain's first batch (the host encoding ``ct``,
    ``pbs``), three ways: at GRAPH_CPU_ROUNDS captured, eager on the card
    and (with ``cpu``) on the CPU (assignments, rounds, requested
    bit-equal); at the
    full round limit captured and eager, each warmed by one call, under
    torch.profiler: the device's busy share and the host's launch calls a
    round, and bit-equal. -> the report."""
    from kubernetes_tpu_torch.models.gang import gang_drain, prepare_drain
    out, res = {}, {}
    cut_legs = [("captured_cut", True, card), ("eager_cut", False, card)]
    if cpu:
        cut_legs.append(("cpu_cut", True, "cpu"))
    for leg, capture, device in cut_legs:
        t0 = time.perf_counter()
        res[leg] = gang_drain(ct, pbs[:1], topo_keys=topo_keys, seed=seed,
                              max_rounds=GRAPH_CPU_ROUNDS, device=device,
                              capture=capture)
        out[leg] = {"seconds": time.perf_counter() - t0}
    plan = prepare_drain(ct, pbs[:1], device=card)
    for leg, capture in (("captured", True), ("eager", False)):
        got = []
        gang_drain(topo_keys=topo_keys, seed=seed, prepared=plan,
                   capture=capture)
        g0 = graph_counters()
        prof = profile_call(lambda: got.append(gang_drain(
            topo_keys=topo_keys, seed=seed, prepared=plan,
            capture=capture)), f"{name}_gang_drain_{leg}")
        rounds = int(got[0][1].sum())
        out[leg] = {"wall_ms": prof["wall_ms"], "rounds": rounds,
                    "device_busy_share": prof["device_busy_share"],
                    "launches_per_round": prof["api_launches"] / rounds,
                    "kernels_per_round": prof["launches"] / rounds}
        if capture:
            out[leg]["graphs"] = graph_report(g0, 1)
        res[leg] = got[0]
    for want, leg in [("captured_cut", leg) for leg, _c, _d in cut_legs[1:]
                      ] + [("captured", "eager")]:
        check(_same(res[want], res[leg]),
              f"parity.graph ({name}): gang_drain {leg} differs from {want}")
    out["bit_equal"] = True
    return out


def sched_drain_inputs(ctx, encode_pods, B, P, pod_dicts):
    """A resident context (a scheduler's ``_drain_ctx``, a ResidentDrain's
    ``ctx``) and two drains of it, padded to the context's batch shapes:
    the first P of ``pod_dicts`` encoded against the context's meta in
    every one of the B batches, and the same with only the first batch
    valid. -> (ct, e0, fill, stack, cut stack, topo_keys)."""
    import numpy as np
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.models.gang import pad_batch_to, stack_batches
    pb = encode_pods([Pod.from_dict(d) for d in pod_dicts[:P]],
                     ctx["meta"], min_p=P)
    pad = pb.replace(pod_valid=np.zeros_like(np.asarray(pb.pod_valid)))
    stacks = [pad_batch_to(stack_batches(batches), ctx["pb_shape"])
              for batches in ([pb] * B, [pb] + [pad] * (B - 1))]
    check(None not in stacks, "parity.graph: the batch exceeds the context")
    return (ctx["ct"], ctx["e0"], ctx["fill_dev"], *stacks,
            ctx["meta"].topo_keys)



# K settings of chunk_sweep_phase: the rounds a replay between host reads
SWEEP_CHUNKS = (1, 2, 3, 4, 8)


def chunk_sweep_phase(chunks=SWEEP_CHUNKS):
    """The chunk K of the captured rounds (models/gang.GRAPH_CHUNK) against
    its cost: at the drain's shape (MixedHeterogeneous, 10 x 1024 pods on
    5000 nodes) gang_drain three times for each K, captured (the first
    call captures; seconds of the two replay-only calls), and eager with
    K = 1 and 2; at the resident shape (8 x 256 on 5000 nodes, 2000
    bound) four resident cycles for each K, captured, and eager. Each
    result bit-equal to the first; one line each: seconds, replays, host
    reads and count_pn launches a call, the rounds, dead rounds run."""
    import numpy as np
    import torch
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models import gang, graphs
    from kubernetes_tpu_torch.models.gang import gang_drain, prepare_drain
    from kubernetes_tpu_torch.ops import kernels
    nodes, pods = drain_workload()
    enc = SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods,
                                  pending_slots=False)
    pbs = [enc.encode_pods(pods[i:i + DRAIN_BATCH], meta)
           for i in range(0, len(pods), DRAIN_BATCH)]
    plan = prepare_drain(ct, pbs, device="cuda")
    first, default_k = None, gang.GRAPH_CHUNK
    for K, capture in ([(k, True) for k in chunks]
                       + [(1, False), (2, False)]):
        gang.GRAPH_CHUNK = K
        calls = []
        for _ in range(3):
            g0 = graph_counters()
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gang_drain(topo_keys=meta.topo_keys, prepared=plan,
                             capture=capture)
            calls.append((time.perf_counter() - t0,
                          {k: graph_counters()[k] - g0[k] for k in g0},
                          kernels.LAUNCHES["count_pn"]))
        first = first or out
        check(_same(first, out), f"chunk sweep: drain K={K} differs")
        rounds = [int(r) for r in out[1]]
        emit({"phase": "sweep.chunk", "shape": "drain", "K": K,
              "captured": capture, "first_s": calls[0][0],
              "seconds": [c[0] for c in calls[1:]],
              "counters": calls[-1][1], "launches": calls[-1][2],
              "rounds": rounds,
              "dead_rounds": sum(-(-r // K) * K - r for r in rounds),
              "pool_bytes": graphs.pool_bytes()})
    del plan
    graphs.reset()
    r_nodes, r_bound, r_pending = resident_workload(cycles=4)
    quiet, placed = emit, None
    for K, capture in [(k, True) for k in chunks[:4]] + [(2, False)]:
        gang.GRAPH_CHUNK = K
        g0 = graph_counters()
        globals()["emit"] = lambda obj: None
        try:
            summary, drv, _c = resident_phase(r_nodes, r_bound, r_pending,
                                              cycles=4, capture=capture)
        finally:
            globals()["emit"] = quiet
        placed = placed or summary["placements"]
        check(summary["placements"] == placed,
              f"chunk sweep: resident K={K} differs")
        emit({"phase": "sweep.chunk", "shape": "resident", "K": K,
              "captured": capture, "drain_ms": summary["drain_ms"],
              "counters": {k: graph_counters()[k] - g0[k] for k in g0},
              "launches": summary["launches"],
              "pool_bytes": graphs.pool_bytes()})
        del drv
    gang.GRAPH_CHUNK = default_k

# ------------------------------------------------------------------ warm

WARM_NODES = 64      # the warm boots' cluster (MixedHeterogeneous)
WARM_PODS = 128
WARM_BATCH = 32


def warm_boot(cache_dir: str, device=None) -> dict:
    """One scheduler boot on ``cache_dir`` (``aotCacheDir``), in this
    process: a SchedulerRunner over a DirectClient holding a small
    MixedHeterogeneous cluster, the parity sentinel on (every 1000th
    drain: it samples the first drain only when the boot found entries
    and forced its canary), warm_drain (the ladder: the kernel is built
    or loaded from the cache, the rounds captured), the pods created and
    run_once until they are placed, the sentinel's verdicts landed, the
    cache sealed. -> the boot's report."""
    import torch
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.client.clientset import DirectClient
    from kubernetes_tpu_torch.models import graphs
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.store.store import ObjectStore
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    t_boot = time.perf_counter()
    nodes, pods = mixed_heterogeneous(pods=WARM_PODS, nodes=WARM_NODES,
                                      seed=SEED)
    client = DirectClient(ObjectStore())
    client.nodes().create_many([n.to_dict() for n in nodes])
    runner = SchedulerRunner(
        client, sched_config(batch_size=WARM_BATCH, max_drain_batches=2,
                             aot_cache_dir=cache_dir,
                             parity_sample_every=1000,
                             backoff_initial_s=3600.0, backoff_max_s=3600.0,
                             assume_ttl_s=3600.0, audit_interval_s=3600.0),
        feature_gate=no_preemption_gate(), device=device)
    report = {}
    try:
        boot = dict(runner.aot_cache.boot)
        runner.start(start_loop=False)
        sched = runner.scheduler
        sched._drain_ready = lambda pend: False
        t0 = time.perf_counter()
        check(sched.warm_drain(pods, slot_headroom=2 * WARM_PODS),
              "warm: warm_drain did not arm the context")
        if sched.device.type == "cuda":
            torch.cuda.synchronize()
        ladder_s = time.perf_counter() - t0
        client.pods("default").create_many([p.to_dict() for p in pods])
        deadline = time.perf_counter() + 60.0
        while (runner.queue.stats()["active"] < len(pods)
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        c0 = graphs.CAPTURES
        t0 = time.perf_counter()
        sched.run_once(wait=0.01)
        sched._resolve_pending()
        first_drain_s = time.perf_counter() - t0
        for _ in range(16):
            if runner.queue.stats()["active"] == 0 and not sched._pending:
                break
            sched.run_once(wait=0.01)
        sched._resolve_pending()
        sched.wait_for_bindings()
        sched.sentinel.drain(60.0)
        bound = sum(1 for p in client.pods("default").list()
                    if p["spec"].get("nodeName"))
        sealed = runner.aot_cache.seal()
        entries = sorted(os.listdir(runner.aot_cache.entries_dir))
        report = {"boot": boot, "fingerprint": runner.aot_cache.fingerprint,
                "builds": kernels.BUILDS, "ladder": sched.warm_stats,
                "ladder_s": ladder_s, "first_drain_s": first_drain_s,
                "first_drain_captures": graphs.CAPTURES - c0,
                "bound": bound, "pods": len(pods),
                "sentinel": sched.sentinel.stats(),
                "stats": runner.aot_cache.stats(), "sealed": sealed,
                "entries": entries, "loaded": sorted(kernels._LIBS),
                "boot_to_bound_s": time.perf_counter() - t_boot}
    finally:
        runner.stop()
    # the threads left once the runner stopped (informers, the event
    # broadcaster: none of them in a torch call)
    report["threads_after_stop"] = sorted(
        t.name for t in threading.enumerate()
        if t is not threading.main_thread())
    return report


def warm_phase(seconds_limit=300.0) -> dict:
    """Warm start: three boots of a scheduler, each in a child process
    (``python3 chip_smoke.py --warm-boot DIR``), on one empty temporary
    ``aotCacheDir``: cold (count_pn is built, the ladder captures), warm
    (nothing built, the same fingerprint, the canary sample judged with 0
    divergences), and after one byte of the cached library is flipped
    (swept and counted at boot, built again: the damaged library is never
    loaded). Then the fingerprint's wholesale invalidation on a changed
    build flag, in this process (the flags are restored and the cache
    disarmed after it). -> the report."""
    import shutil
    import tempfile
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.aotcache import (AotExecutableCache,
                                                     cache_knobs)
    root = tempfile.mkdtemp(prefix="warm-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    cache_dir = os.path.join(root, "aot")
    boots = {}
    try:
        for leg in ("cold", "warm", "flipped"):
            if leg == "flipped":
                lib = os.path.join(cache_dir, "entries",
                                   boots["warm"]["entries"][0])
                blob = bytearray(open(lib, "rb").read())
                blob[len(blob) // 2] ^= 0xFF
                with open(lib, "wb") as f:
                    f.write(bytes(blob))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--warm-boot",
                 cache_dir], capture_output=True, text=True,
                timeout=seconds_limit)
            check(proc.returncode == 0,
                  f"warm: the {leg} boot failed: {proc.stderr[-2000:]}")
            boots[leg] = json.loads(proc.stdout.strip().splitlines()[-1])
            boots[leg]["process_s"] = time.perf_counter() - t0
        cold, warm, flipped = boots["cold"], boots["warm"], boots["flipped"]
        for leg, b in boots.items():
            check(b["bound"] >= 0.9 * b["pods"],
                  f"warm: the {leg} boot bound {b['bound']} of {b['pods']}")
            check(b["sentinel"]["divergences"] == 0,
                  f"warm: the {leg} boot's sentinel diverged")
            check(b["first_drain_captures"] == 0,
                  f"warm: the {leg} boot's first drain captured "
                  f"{b['first_drain_captures']} graphs past its ladder")
        check(cold["builds"] >= 1 and cold["ladder"]["captures"] >= 1,
              f"warm: the cold boot built {cold['builds']} kernels and "
              f"captured {cold['ladder']['captures']} graphs")
        check(cold["boot"]["entries"] == 0 and cold["sealed"] >= 1,
              f"warm: the cold boot found {cold['boot']} and sealed "
              f"{cold['sealed']}")
        check(warm["builds"] == 0 and warm["stats"]["realBuilds"] == 0,
              f"warm: the warm boot built {warm['builds']} kernels")
        check(warm["fingerprint"] == cold["fingerprint"]
              and not warm["boot"]["fingerprintStale"],
              "warm: the warm boot's fingerprint differs")
        check(warm["boot"]["entries"] >= 1 and warm["loaded"] == ["count_pn"],
              f"warm: the warm boot found {warm['boot']}")
        check(warm["sentinel"]["samples"]["drain"] >= 1,
              "warm: the canary sample was not taken")
        check(flipped["boot"]["corruptSwept"] == 1
              and flipped["stats"]["errors"] == 1 and flipped["builds"] == 1,
              f"warm: the flipped entry: boot {flipped['boot']}, stats "
              f"{flipped['stats']}, builds {flipped['builds']}")
        # a changed build flag: the fingerprint no longer matches
        flags = kernels.NVCC_FLAGS
        kernels.NVCC_FLAGS = flags + ("-lineinfo",)
        stale = AotExecutableCache(cache_dir,
                                   knobs=cache_knobs(sched_config()))
        try:
            boot = stale.activate()
        finally:
            kernels.NVCC_FLAGS = flags
            AotExecutableCache.disarm()
        check(boot["fingerprintStale"] and stale.invalidations >= 1
              and boot["entries"] == 0,
              f"warm: the changed build flag did not invalidate the cache: "
              f"{boot}")
        keep = ("boot", "builds", "ladder", "ladder_s", "first_drain_s",
                "first_drain_captures", "bound", "sentinel", "stats",
                "process_s", "boot_to_bound_s", "threads_after_stop")
        return {**{leg: {k: b[k] for k in keep} for leg, b in boots.items()},
                "fingerprint_equal": True,
                "flags_changed": {"boot": boot,
                                  "invalidations": stale.invalidations}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# past this many seconds the script prints every thread's stack and exits
# 1, inside the 1200 s the card's check allows: a hang names its place
DEADLINE_S = 1100.0


def main() -> int:
    import faulthandler
    import signal
    import torch
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--warm-boot"]:
        # one boot of the warm phase, in its own process, which exits as
        # any process does: the parent holds its exit code at 0; should it
        # abort, every thread's stack goes to stderr
        faulthandler.enable(all_threads=True)
        print(json.dumps(warm_boot(sys.argv[2])), flush=True)
        return 0
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
    if "--chunks" in sys.argv[1:]:
        chunk_sweep_phase()
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
    emit({"phase": "parity.preemption", **preemption_parity_phase()})
    emit({"phase": "parity.explain", **explain_parity_phase()})
    emit({"phase": "parity.extender", **extender_parity_phase()})
    emit({"phase": "parity.slice", **slice_parity_phase()})
    emit({"phase": "parity.planner", **planner_parity_phase()})
    emit({"phase": "parity.fleet", **fleet_parity_phase()})
    # DRA claims at the parity size: the card's counts of this comparison
    # are read (0 expected: the claim pods carry no topology term)
    kernels.reset_launches()
    t0 = time.perf_counter()
    dra_parity = {**dra_parity_phase(), "launches": dict(kernels.LAUNCHES)}
    emit({"phase": "parity.dra", **dra_parity,
          "seconds": time.perf_counter() - t0})

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

    # the drain, resident, scheduler, connected and fleet.drain paths run
    # captured here (the main path: its launches fill the table); their
    # eager runs, parity.graph and warm follow the last path, so that no
    # comparison (nor its profiler sessions) sits between timed windows
    drain = drain_phase(*drain_workload())
    for name, n in drain["launches"].items():
        check(n > 0, f"kernel {name} was never launched in the drain")
        launches.setdefault(name, {})["drain"] = n
    emit({"phase": "drain", **{k: v for k, v in drain.items()
                               if k not in ("plan", "assignments", "meta",
                                            "requested", "host")}})
    drain_rows = kernels_phase(drain_count_cases(drain))
    emit({"phase": "kernels.drain", "rows": drain_rows})
    # the same plan eager: the captured drain's numbers against the eager
    # loop's, one after the other
    emit({"phase": "drain.eager", **drain_eager_phase(drain)})
    drain_host = (*drain["host"], drain["meta"].topo_keys)
    del drain

    r_nodes, r_bound, r_pending = resident_workload()
    resident, drv, churn = resident_phase(r_nodes, r_bound, r_pending,
                                          tree_at=RESIDENT_EAGER_CYCLES)
    for name, n in resident["launches"].items():
        launches.setdefault(name, {})["resident"] = n
    emit({"phase": "resident",
          **{k: v for k, v in resident.items()
             if k not in ("placements", "tree")}})
    resident_out = (resident["placements"], resident.pop("tree"))
    resident_rows = kernels_phase(resident_count_cases(drv))
    emit({"phase": "kernels.resident", "rows": resident_rows})
    emit({"phase": "profile.drain",
          **profile_drain_phase(drv, churn, r_pending[-1],
                                resident["cycles"])})
    resident_in = sched_drain_inputs(drv.ctx, drv.cache.encode_pods,
                                     RESIDENT_B, RESIDENT_P, r_pending[-1])
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
    sched_in = sched_drain_inputs(sched._drain_ctx, sched.cache.encode_pods,
                                  sched.cfg.max_drain_batches,
                                  sched.cfg.batch_size, s_profiled)
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
    conn_in = sched_drain_inputs(runner.scheduler._drain_ctx,
                                 runner.cache.encode_pods,
                                 CONNECTED_DRAIN_BATCHES, CONNECTED_BATCH,
                                 c_pods)
    del runner

    # default preemption: no hand kernel on its path (its device work is
    # torch ops, ROADMAP B7); count_pn's launches there are recorded
    pre_sum = preemption_phase()
    emit({"phase": "preemption", **pre_sum})
    cpre_sum = connected_preemption_phase()
    emit({"phase": "connected_preemption", **cpre_sum})
    # the explainer's judge and the extender path at full width
    expl_sum, expl_cases = explain_phase()
    emit({"phase": "explain", **expl_sum})
    expl_rows = kernels_phase(expl_cases)
    del expl_cases
    emit({"phase": "kernels.explain", "rows": expl_rows})
    ext_sum, ext_cases = extender_phase()
    emit({"phase": "extender", **ext_sum})
    ext_rows = kernels_phase(ext_cases)
    del ext_cases
    emit({"phase": "kernels.extender", "rows": ext_rows})
    # topology slice carving at SliceCarve/16x16x16
    slice_sum, slice_cases = slice_phase()
    emit({"phase": "slice", **slice_sum})
    slice_rows = kernels_phase(slice_cases)
    del slice_cases
    emit({"phase": "kernels.slice", "rows": slice_rows})
    # the resident planners: no hand kernel on their path (the static
    # filters and the B9 programs are torch ops); count_pn's 0 is recorded
    auto_sum = autoscaler_phase()
    emit({"phase": "autoscaler", **auto_sum})
    defrag_sum = defrag_phase()
    emit({"phase": "defrag", **defrag_sum})
    loop_sum = planner_loop_phase()
    emit({"phase": "planner", **loop_sum})
    # fleet mode: the fleet-batched drain at 4 x 1250 nodes, then
    # FleetChurn on the FleetRunner (its churn pods carry no topology term:
    # count_pn's count there is recorded, 0 included)
    fdrain_sum, fleet_cases, (_plan, (f_ct, f_pbs, f_meta)) = \
        fleet_drain_phase()
    emit({"phase": "fleet.drain", **fdrain_sum})
    fleet_rows = kernels_phase(fleet_cases)
    del fleet_cases, _plan
    emit({"phase": "kernels.fleet", "rows": fleet_rows})
    fleet_sum = fleet_phase(smi=smi)
    emit({"phase": "fleet", **fleet_sum})
    check(not fleet_sum["failures"],
          f"fleet: {fleet_sum['failures']}")
    # DRA: SchedulingWithResourceClaimTemplate/5000pods_500nodes (its pods
    # carry no topology term: count_pn's 0 is recorded)
    t0 = time.perf_counter()
    dra_sum = dra_phase(smi=smi)
    emit({"phase": "dra", **dra_sum, "seconds": time.perf_counter() - t0})
    # ---- captured against eager, parity.graph, warm start --------------
    # (parity.graph profiles drain_step captured and eager at the
    # resident, scheduler and connected shapes)
    res_eager, drv, _churn = resident_phase(r_nodes, r_bound, r_pending,
                                            cycles=RESIDENT_EAGER_CYCLES,
                                            capture=False)
    check(res_eager["placements"] == resident_out[0][:RESIDENT_EAGER_CYCLES]
          and _same(_host_tree(drv.ctx["ct"]), resident_out[1]),
          "resident: the eager cycles differ from the captured ones")
    emit({"phase": "resident.eager", "bit_equal": True,
          **{k: res_eager[k] for k in ("cycles", "arm_s", "placed",
                                       "drain_ms", "launches")}})
    del drv, res_eager, resident_out
    sched_eager, sched, _churn = scheduler_phase(s_nodes, s_pods, smi=smi,
                                                 capture=False)
    emit({"phase": "scheduler.eager", **sched_eager})
    sched.close()
    del sched
    conn_eager, runner = connected_phase(c_nodes, c_pods[:CONNECTED_EAGER],
                                         smi=smi, capture=False)
    emit({"phase": "connected.eager", **conn_eager})
    del runner
    # the CPU leg at one shape (the resident cycle's); the card's captured
    # and eager legs at every shape
    graph_legs = {}   # shape -> its legs and their seconds
    for shape, legs in (
            ("drain", lambda: gang_drain_legs(*drain_host, "drain",
                                              cpu=False)),
            ("resident", lambda: drain_step_legs(*resident_in, "resident")),
            ("scheduler", lambda: drain_step_legs(*sched_in, "scheduler",
                                                  cpu=False)),
            ("connected", lambda: drain_step_legs(*conn_in, "connected",
                                                  cut=False)),
            ("fleet.drain", lambda: gang_drain_legs(
                f_ct, f_pbs, f_meta.topo_keys, "fleet.drain", seed=SEED,
                cpu=False))):
        t0 = time.perf_counter()
        graph_legs[shape] = {**legs(), "seconds": time.perf_counter() - t0}
    emit({"phase": "parity.graph", "cpu_round_cut": GRAPH_CPU_ROUNDS,
          "cpu_leg_at": ["resident"], **graph_legs})
    del resident_in, sched_in, conn_in, f_ct, f_pbs
    # warm start: three scheduler boots on one kernel cache
    emit({"phase": "warm", **warm_phase()})

    for path, summary in (("preemption", pre_sum),
                          ("connected_preemption", cpre_sum),
                          ("explain", expl_sum), ("extender", ext_sum),
                          ("slice", slice_sum), ("autoscaler", auto_sum),
                          ("defrag", defrag_sum), ("planner", loop_sum),
                          ("fleet.drain", fdrain_sum), ("fleet", fleet_sum),
                          ("parity.dra", dra_parity), ("dra", dra_sum)):
        for name, n in summary["launches"].items():
            launches.setdefault(name, {})[path] = n

    # one entry per kernel, at the shape of the path with its most launches
    # among those whose rows are taken from the path's own context
    # (resident, scheduler, connected, explain, extender, slice,
    # fleet.drain), launches
    # summed over every path; every row of the kernels phases was held
    # bit-equal to the plain version
    rows_by_path = {"resident": resident_rows, "scheduler": sched_rows,
                    "connected": conn_rows, "explain": expl_rows,
                    "extender": ext_rows, "slice": slice_rows,
                    "fleet.drain": fleet_rows}
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
                                   + sched_rows + conn_rows + expl_rows
                                   + ext_rows + slice_rows + fleet_rows
                                   if r["name"].startswith(name + "[")])
        table.append(row)
    # the whole script's seconds, the kernels' build included
    emit({"phase": "script", "seconds": time.perf_counter() - _T0,
          "deadline_s": DEADLINE_S})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
