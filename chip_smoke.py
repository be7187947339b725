#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA card and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one JSON line each:

  device   the card, and its name and power limit from nvidia-smi
  build    nvcc builds every kernel of ``kubernetes_tpu_torch/ops/csrc``
           (the build counter, ops/kernels.BUILDS, reads the libraries
           built)
  kernels  each kernel against its plain PyTorch version on the card, at the
           shapes of the path's first Schedule (seeded inputs) and, for the
           required (anti-)affinity terms the path does not reach, of a
           5000-node ``required_terms_mix`` cluster; with times: kernel_ms
           (the call as the path makes it, CUDA events around back-to-back
           calls), device_ms (20 calls captured once in a CUDA graph and
           replayed: the kernel without its Python wrapper), plain_ms,
           library_ms and the bound
  domain_counts  ROADMAP B2: ops/topology._domain_counts' [N,N]
           same-domain matmuls and its factored scatter/gather at N = 4096,
           8192 and 16384 on seeded synthetic encodings (3 topology keys, P x T
           = 256), each timed with CUDA events, bit-equal to each other and
           to the CPU's factored branch
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
           the placements are checked and 90% must be placed, and the
           round graphs' counters read no capture and a replay and a host
           read for each chunk of K rounds (graph_counts_hold)
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
  plugins  the scheduler cell again with two out-of-tree tensor plugins
           (testing/plugins.py: a filter vetoing every 10th node row, a
           cpu-packing score of weight 5) inside the captured rounds: the
           scheduler's gates, every pod placed or unschedulable, every
           binding on a row the filter allows (checked on the host), 0
           captures in the window; pods/s and attempt p50/p99 beside the
           scheduler phase's (reported, not gated)
  kernels.plugins, profile.plugins  as kernels.scheduler and
           profile.scheduler, on the plugins phase's scheduler
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
           by one BackgroundPlanner; adaptive warm-up, a window of 1
           cycle (the reference's 6, cut so that the script keeps to its
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
           ControllerManager running the ResourceClaimController alone
           in a spawned process; 2500 init pods,
           then 2500 measured pods (pods/s, attempt p50/p99, claim
           events, rebuilds, full encodes and captures of the window),
           then 500 measured pods deleted and 500 new ones bound under
           torch.profiler (the busy share). Gates (dra_phase): every pod
           bound with its claim allocated on its node to it, no node over
           10 allocated devices, no pod bound while its claim was
           missing, the deleted pods' claims released, 0 violations, 0
           divergences, 0 loop errors, breaker "single", 0 oracle pods
  parity.plugins  (after parity.dra) the two tensor plugins of the
           plugins phase on a 48-node relational_mix cluster, three ways
           (the card captured, the card eager, the CPU): gang_drain and
           the Scheduler's group path and drain path at depth 1 and 2
           bit-equal across the three, every placement on a row the
           filter allows, and other placements without the plugins
  ktpu     (after dra) the port's ktpu (cli/ktpu.py) against an in-process
           APIServer and a SchedulerRunner on the card (66 nodes, 257
           MixedHeterogeneous pods, one pod held by an untolerated taint):
           get pods -o json lists the store's bound pods, status -o json
           carries ctx and aotCache, why names TaintToleration with its 2
           nodes, trace dump is valid Chrome trace JSON, audit status has
           0 violations, deschedule run --dry-run plans on the card;
           scenario generate builtin:smoke and scenario describe on the
           written file; lint --json over kubernetes_tpu_torch/proxy
           against the port's baseline (no new finding); every command
           exits 0
  explainab  (after ktpu) ExplainAB as benchmarks/connected.py
           run_explain_ab runs it: ConnectedChurn (2000 MixedHeterogeneous
           pods on 1000 nodes, pops of 2 x 512, the reference's churn loop
           of nodes and pods in namespace churn through the window and on
           to 500 operations) with the explainer and the flight recorder
           off, then on, each leg the connected phase's runner (spawned
           APIServer, sentinel, fail-fast auditor). Gates
           (explainab_failures): the on leg with both, the off leg with
           neither, every pod bound, 0 violations, divergences, loop
           errors, device_explain errors and oracle pods, a measured
           ratio. The on/off pods/s ratio is reported beside the
           reference's min_ratio 0.95, not gated (host time)
  secured  the same ConnectedChurn, at 1000 pods (cut for time), behind
           an APIServer with
           authentication (anonymous off), RBAC's bootstrap policy, the
           audit log, API Priority and Fairness and the default admission
           chain (PodSecurity enforce: baseline and a LimitRange default
           on namespace default); pods and nodes created with an admin
           token, the runner as system:kube-scheduler. Once: no token ->
           401, a dry-run create stores nothing, server-side apply by two
           field managers -> 409 then forced, ktpu apply --server-side
           exits 0. Gates: the connected run's (the failed lists of the
           kinds the role may not list reported, not gated), no 401, 403
           or 429 on the scheduler's pods/binding and pods/status
           requests, its bindings in the audit log under its own user,
           its requests dispatched at APF's system level. Reported: its
           403s by resource, pods/s, attempt p50/p99
  frontdoor  the same ConnectedChurn, at 1000 pods (cut for time),
           behind FrontDoorCluster(n=3) in one
           spawned process, every client but the auditor (the leader)
           spreading over the three endpoints. Gates: the connected run's,
           reads served by each replica, and each replica converged on
           the leader's pods and nodeNames once its replay lag is under
           2 s. Reported: pods/s, attempt p50/p99, 421s, the leader's
           commit wait
  controllers  ControllerLoad/100Nodes3000Pods: clusterloader2's load
           test on 100 nodes (328 Deployments of 250, 30 and 5 replicas,
           28 Services) through the port's ControllerManager (its default
           controllers, leader-elected, in a spawned process), a stand-in
           for the kubelets in another, and the connected runner on the
           card (the sentinel every 4th drain, a fail-fast auditor).
           Steps: saturate, scale and roll, 5 nodes NotReady, delete.
           Gates (controllers_phase): each step's end state within its
           timeout (Deployments at spec, old ReplicaSets at 0, every pod
           bound and ready, Endpoints and EndpointSlices exactly the ready
           pods, the failed nodes tainted and emptied, the clean-up: no
           Endpoints, EndpointSlices, ReplicaSets or pods left once the
           Services and Deployments are deleted), the manager alive until
           stopped and its
           exit code 0, 0 violations, divergences, loop errors and oracle
           pods. Reported: each step's seconds, pods/s, attempt p50/p99,
           the manager's evictions
  chaos    (a) ChaosChurnQueued: benchmarks/connected.py
           run_chaos_churn at its defaults, the explainab cell (2000 x
           1000, churn) under FaultSchedule.generate(0, profile="churn")
           on the runner's transport (ChaosClient), DeviceChaos on
           gang_schedule, drain_step and preempt_wave and ThreadChaos at
           the loop's chaos points, installed after the warm drain; the
           breaker's cooldown 5 s, the sentinel every 4th drain; but the
           loop starts once the informer has queued the measured pods
           (the reference starts it right after the creates), so the
           device faults land on the churn's pops and the oracle places
           no measured pod: its pods/s are not the reference's
           ChaosChurn's. The churn runs on until the breaker has
           restored, then recovery waves of 513 pods (the loop stopped
           while they queue: one deep pop) until a drain ran past the
           drain_step burst, then until no site is left unrecovered
           (chaos_settle). Gates (chaos_failures): no pod lost, every
           class whose op the run reached fired (the others reported),
           no site unrecovered, the breaker at single after a restore and
           a drain on the card after it with count_pn launched, 0
           violations and divergences, no fatal error.
           (b) chaos.kill, beside the parity phases (cut for time):
           SchedulerKill as benchmarks/disaster.py run_scheduler_kill
           runs it: 16 nodes, 48 pods, an InProcessApiServer on a
           durable dir, a SchedulerProcess child on the card with an
           aotCacheDir,
           SIGKILLed mid-churn and restarted. Gates: the cold child built
           the kernel library, the restarted one built nothing and loaded
           the cached entry, no pod lost or unbound, 0 violations and
           divergences; the first bind after the restart is reported
  cluster  (beside the parity phases, cut for time) ClusterUp/20Nodes100Pods:
           ktpu-up (cli/cluster.py), the kubeadm analog, as its users boot
           a dev or CI cluster. A child runs ``python -m
           kubernetes_tpu_torch.cli.cluster init --nodes 16 --auth`` (the
           apiserver with auth and admission, the scheduler on the card,
           the controller manager with the cloud controllers, 16 hollow
           kubelets), a second ``ktpu-up join --nodes 4`` with the admin
           token; the 20 nodes get their hostname label and a podCIDR
           (nodeipam); a Deployment of 100 replicas (10m, 10Mi, port 8080,
           a hard hostname spread) and a ClusterIP Service (80 -> 8080).
           Gates (cluster_failures): the child's scheduler on the card,
           every replica bound and Running with its own IP in its node's
           podCIDR, pods a node within 1 of each other, the port's
           iptables, nftables and ipvs renders and its Proxier (in this
           process, on the child's URL) sending the VIP only to the
           Running pods' ip:8080 and holding all of them, both children
           exiting 0 within 10 s of SIGTERM, count_pn launched in the
           child (its count, printed at its exit, is the path's)
  parity.mesh  (after parity.plugins) drain_parity_check
           (benchmarks/connected.py) at the main path's width:
           MixedHeterogeneous at 5000 nodes (the 8192 bucket), P=512, B=2,
           one drain_step on the card single-device (captured), on the CPU
           (beside the card's legs, cut for time) and split over meshes
           (1,2), (2,2) and (1,4) of logical shards of the card
           (parallel/mesh.py, built from an explicit device list). Gates:
           each mesh's assignments, rounds, fill and folded state equal
           the single-device drain's and the CPU's, and count_pn launched on
           every shard; reported: each drain's ms, its launches a shard and
           the bytes its collectives moved
  kernels.mesh  count_pn at a shard's shape (the (1,2) mesh's shard 0
           over the folded context: N = 4096, the existing pods' node ids
           remapped to the shard's rows) against its plain version
  mesh     (after connected) Connected/10000Pods5000Nodes's first 2048
           pods through the connected runner with its scheduler on a (1,2)
           mesh of logical shards (Scheduler.set_mesh), the loop started
           once every pod is queued, the sentinel judging the second drain;
           beside it the same pods through a single-device Scheduler with
           the same pops (cut for time). Gates: the mesh active (2 devices,
           the breaker at "mesh"), every pod bound, the same placements,
           connected_run's gates; pods/s reported (logical shards share the
           card). The kernels line lists count_pn at the shard's shape too
           (count_pn.mesh_shard, the mesh phase's launches)
  scenario  ScenarioReplay as bench.py runs benchmarks/scenario.py:
           builtin:smoke at speed 4, seed 0, pops of 2 x 64, the runner on
           the card. Gates: every trace-resident pod bound, two
           resolutions plan alike and the live dispatch order is the plan,
           a p99 for every phase, 0 violations, divergences, loop errors

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
  scheduler.eager  the scheduler phase eager, cut to 2048 pods (one pop)
  connected.eager  the connected phase eager, cut to 4096 pods
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
           cache wholesale. The three boots run one after another on a
           thread beside the parity phases (which time nothing) and end
           before the path phase; their gates are read here

Every phase fails while LOOP_ERRORS{site=device_preempt} is above 0 (a
device preemption failure the scheduler degraded to the host scan) or
LOOP_ERRORS{site=device_explain} is (a failure of the explainer's device
judge, whose pods then got no verdict).

Each path (path, drain, resident, scheduler, plugins, connected,
preemption, connected_preemption, explain, extender, slice, autoscaler,
defrag, planner, fleet.drain, fleet, parity.dra, dra, parity.plugins,
ktpu, explainab, secured, frontdoor, controllers, chaos, scenario, and
cluster, whose scheduler is a child process that counts its own) is
driven with the launch
counts set to 0 just before it and read just after; the preemption and
planner paths launch no hand kernel (their device work is torch ops),
nor do the fleet, DRA and controllers paths (the FleetChurn, claim and
load-test pods carry no topology term; fleet.drain launches count_pn), and
every path's count is
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

import atexit
import contextlib
import gc
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
_TIMES = [0.0]   # this process's CPU seconds at the last phase line
_GC = {"s": 0.0, "full": 0, "start": 0.0}   # collections since that line


def _gc_timer(phase, info) -> None:
    if phase == "start":
        _GC["start"] = time.perf_counter()
    else:
        _GC["s"] += time.perf_counter() - _GC["start"]
        _GC["full"] += info["generation"] == 2


gc.callbacks.append(_gc_timer)


def settle_heap() -> None:
    """Collect, then move every object alive to the collector's permanent
    generation: what the script keeps for later phases (workloads, the
    contexts of parity.graph) is no longer traversed by the collections
    that the next phases' allocations trigger. Called between phases,
    once the last phase's runner is dropped (a frozen cycle is never
    collected)."""
    gc.collect()
    gc.freeze()


def emit(obj) -> None:
    """Print one phase's line, with the seconds since the script started
    (``at_s``) and, under ``proc``, since the last phase line: this
    process's CPU seconds (all its threads), the seconds and the full
    collections of its garbage collector, with its live threads and the
    objects ``settle_heap`` froze; a phase in
    which the scheduler degraded a device preemption failure to the host
    scan, or the explainer a failure of its device judge to the oracle,
    fails instead."""
    if "phase" in obj:
        now = os.times()
        obj = {**obj, "at_s": time.perf_counter() - _T0,
               "proc": {"cpu_s": now.user + now.system - _TIMES[0],
                        "threads": threading.active_count(),
                        "gc_s": _GC["s"], "gc_full": _GC["full"],
                        "frozen": gc.get_freeze_count()}}
        _TIMES[0] = now.user + now.system
        _GC.update(s=0.0, full=0)
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


def _encoded(node_dicts, bound, pending_dicts, ns_labels=None,
             device="cuda"):
    """(ClusterTensors extended by the batch, PodBatch) on ``device``."""
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
    pb = enc.encode_pods(pending, meta).to(device)
    return extend_cluster(ct.to(device), pb), pb


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

B2_NODES = (4096, 8192, 16384)   # the buckets around the threshold
B2_PODS = 128              # P x T = 256, the resident spread's PT
B2_TERMS = 2
B2_ITERS = 5


def domain_counts_inputs(n_nodes, seed=SEED):
    """A synthetic encoding for ``ops/topology._domain_counts`` at
    ``n_nodes``: three topology keys (a hostname, 3 zones, racks of 32 with
    a tenth of the nodes unlabelled), per-term counts 0-3 and eligibility
    drawn from the seed. -> (ct, cnt_pn, term_topo, elig, topo_keys), on
    the CPU."""
    from types import SimpleNamespace
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n = n_nodes
    racks = n // 32
    labels = np.stack([np.arange(n), n + rng.integers(0, 3, n),
                       np.where(rng.random(n) < 0.1, -1,
                                n + 3 + rng.integers(0, racks, n))], axis=1)
    ct = SimpleNamespace(
        node_valid=torch.ones(n, dtype=torch.bool),
        node_labels=torch.from_numpy(labels.astype(np.int32)),
        label_value_num=torch.zeros(n + 3 + racks, dtype=torch.float32))
    cnt_pn = torch.from_numpy(rng.integers(
        0, 4, (B2_PODS, B2_TERMS, n)).astype(np.float32))
    term_topo = torch.from_numpy(rng.integers(
        0, 3, (B2_PODS, B2_TERMS)).astype(np.int32))
    elig = torch.from_numpy(rng.random((B2_PODS, B2_TERMS, n)) < 0.9)
    return ct, cnt_pn, term_topo, elig, (0, 1, 2)


def _domain_counts_with(factored: bool, *args):
    """``_domain_counts`` with its branch forced by KTPU_DOMAIN_FACTORED
    (restored after the call); every output, ``want_domains`` on."""
    from kubernetes_tpu_torch.ops import topology
    prev = os.environ.get("KTPU_DOMAIN_FACTORED")
    os.environ["KTPU_DOMAIN_FACTORED"] = "1" if factored else "0"
    try:
        ct, cnt_pn, term_topo, elig, keys = args
        return topology._domain_counts(ct, cnt_pn, term_topo, keys,
                                       elig=elig, want_domains=True)
    finally:
        if prev is None:
            os.environ.pop("KTPU_DOMAIN_FACTORED")
        else:
            os.environ["KTPU_DOMAIN_FACTORED"] = prev


def domain_counts_phase(sizes=B2_NODES, card="cuda"):
    """ROADMAP B2 on the card: ``_domain_counts``' [N,N] same-domain
    matmuls and its factored scatter/gather at N = 4096, 8192 and 16384, on
    seeded synthetic encodings (``domain_counts_inputs``). Each branch
    timed with CUDA events (B2_ITERS calls after one warm-up); the two
    branches' outputs (cnt_dom, has_key, num_domains) bit-equal to each
    other and to the CPU's factored branch on the same inputs (the CPU's
    [N,N] branch, ~100 GFLOP a call here, is held equal to it by the CPU
    tests). -> {N: {dense_ms, factored_ms, bit_equal}, threshold}."""
    import torch
    from kubernetes_tpu_torch.ops import topology

    def on(dev, args):
        ct, cnt_pn, term_topo, elig, keys = args
        return (type(ct)(**{k: v.to(dev) for k, v in vars(ct).items()}),
                cnt_pn.to(dev), term_topo.to(dev), elig.to(dev), keys)

    def same(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))

    out = {"threshold": topology._FACTORED_THRESHOLD, "iters": B2_ITERS}
    t0 = time.perf_counter()
    for n in sizes:
        host = domain_counts_inputs(n)
        args = on(card, host)
        got = {f: _domain_counts_with(f, *args) for f in (False, True)}
        cpu = _domain_counts_with(True, *host)
        check(same(got[False], got[True]) and same(got[True], cpu),
              f"domain_counts: the branches differ at N={n}")
        ms = {f: cuda_ms(lambda f=f: _domain_counts_with(f, *args),
                         iters=B2_ITERS, warmup=1) for f in (False, True)}
        out[str(n)] = {"dense_ms": ms[False], "factored_ms": ms[True],
                       "bit_equal": True,
                       "domains": int(got[True][2].sum().item())}
        del args, got, cpu
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


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
    check(graph_counts_hold(graphs, rounds),
          f"drain: the round graphs' counters moved by {graphs} over "
          f"rounds {[int(r) for r in rounds]}")
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
RESIDENT_EAGER_CYCLES = 1   # resident.eager: the first cycles, eager


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
SCHED_EAGER = 2048     # scheduler.eager's pods: one pop, cut for time


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
                   device=None, confirm=True, gate=None, registry=None):
    """A port Scheduler over a fresh SchedulerCache and SchedulingQueue,
    PreemptionSimulation off unless ``gate`` says otherwise (the cells of
    the main path preempt nothing: every pod fits), and an in-process
    binder that logs (pod key, node, seconds) and, with ``confirm``,
    confirms the binding in the cache as the runner's informer would.
    ``registry``: out-of-tree plugins (sched/framework.Registry).
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
                      device=device, registry=registry)
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
                    capture=True, registry=None):
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
    window's graph counters are reported, and the context rows each churn
    node held after each pop (``churn_rows``). ``registry``: out-of-tree
    plugins for the scheduler (the messages then say "plugins"). ->
    (summary, scheduler, churn state, {pod key: node} of the binder's
    log)."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.metrics.registry import (ATTEMPT_DURATION,
                                                       LOOP_ERRORS)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.utils.tracing import TRACER
    name = "scheduler" if registry is None else "plugins"
    cfg = sched_config()
    sched, log = make_scheduler(cfg, [Node.from_dict(d) for d in node_dicts],
                                device=device, registry=registry)
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
          f"{name}: warm_drain did not arm the context")
    warm_s = time.perf_counter() - t0
    errors0 = sum(LOOP_ERRORS.items().values())
    ATTEMPT_DURATION.reset()
    TRACER.reset()
    kernels.reset_launches()
    g0 = graph_counters()
    churn = ([], [])
    churn_rows = {}
    pops = 0
    t_start = time.perf_counter()
    for p in pods:
        sched.queue.add(p)
    while True:
        _churn(sched.cache, pops, *churn)
        sched.run_once(wait=0.05)
        pops += 1
        if sched._drain_ctx is not None:
            rows = sched._drain_ctx["cs"].node_index
            for n in churn[0]:
                if n in rows:
                    churn_rows.setdefault(n, set()).add(rows[n])
        if (not sched._pending and not sched._staged
                and sched.queue.stats()["active"] == 0):
            break
        check(pops < 100, f"{name}: the queue did not drain in 100 pops")
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
    check(len(placed) == len(log), f"{name}: a pod was bound twice")
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
          f"{name}: the breaker degraded to {sched.breaker.mode!r}")
    check(errors == 0, f"{name}: {errors} loop errors")
    check(not oracle_pods, f"{name}: {sum(oracle_pods)} pods went "
                           "through the numpy oracle")
    check(stats["patches"] == 0,
          f"{name}: {stats['patches']} separate patch dispatches in "
          "fused mode (the fusion degraded)")
    for kernel, n in launches.items():
        check(n > 0, f"kernel {kernel} was never launched by the {name} "
                     "phase")
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
             "graphs": graphs, "churn_rows": {n: sorted(r) for n, r in
                                              sorted(churn_rows.items())},
             "card": smi}, sched, churn, placed)


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
CONNECTED_EAGER = 4096   # connected.eager's pods: the eager run, cut to
                         # four drains of 2 x 512 (the sentinel samples
                         # every 4th)
# ConnectedChurn (benchmarks/connected.py run_connected(churn=True)): the
# churn loop's period and the fixed budget of operations it makes
CHURN_PERIOD_S = 0.1
CHURN_MIN_OPS = 500
# LOOP_ERRORS sites where the bootstrap policy's system:kube-scheduler role
# is refused: it may not list ConfigMaps or the DRA kinds the informers
# watch, nor write the status ConfigMaps (runner, auditor's post-sweep
# publish, explainer)
RBAC_DENIED_SITES = ("informer_listwatch", "publish_status",
                     "audit_post_sweep", "explainer_publish")


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


WATCH_RESUMES = 100  # streams a watcher opens before it counts itself dead


def _wire_dicts(dicts):
    for d in dicts:
        d["metadata"].pop("uid", None)
    return dicts


def watch_bound(url, ns, rv0, n_pods, count, done, dead, ready, prefix="",
                token=None):
    """Watcher process: count the pods whose nodeName got set (one event
    per binding), of those whose name starts with ``prefix``; a deletion
    is not a binding. Its JSON decode burns its own interpreter, not the
    scheduler's. A stream that ends (a server dropping a slow watcher, a
    front door's replica) is watched again from the last resourceVersion
    seen, or relisted when that is compacted, as an informer would.
    ``url`` may be a front door's endpoints; ``token`` is the bearer token
    of a server with authentication on."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.store.store import TooOld
    client = HTTPClient(url, timeout=30.0, wire="json", token=token)
    seen = set()

    def saw(obj) -> bool:
        if (obj.get("metadata", {}).get("name", "").startswith(prefix)
                and (obj.get("spec") or {}).get("nodeName")):
            seen.add(obj["metadata"]["name"])
            count.value = len(seen)
        return len(seen) >= n_pods

    rv = rv0
    try:
        for _ in range(WATCH_RESUMES):
            try:
                w = client.pods(ns).watch(since_rv=rv)
            except TooOld:
                pods, rv = client.pods(ns).list_rv()
                if any([saw(p) for p in pods]):
                    done.set()
                    return
                continue
            ready.set()
            for ev in w:
                rv = max(rv, ev.resource_version)
                if ev.type in ("ADDED", "MODIFIED") and saw(ev.object or {}):
                    done.set()
                    return
    except Exception:
        import traceback
        traceback.print_exc()
    dead.set()


def start_apiserver(ctx, **planes):
    """The port's APIServer in its own process (spawned: this process holds
    a CUDA context and must not fork), with the ``planes`` that
    ``store/apiserver.serve`` takes. -> (process, stop pipe, url)."""
    from kubernetes_tpu_torch.store.apiserver import serve
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=serve, args=(child,), kwargs=planes,
                       daemon=True)
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
                    capture=True, mesh=None, queued_first=False,
                    parity_every=None):
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
    the rounds run eagerly on the card. ``mesh``, ``queued_first`` and
    ``parity_every``: as ``connected_run``. -> (summary, stopped
    runner)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    server, server_pipe, url = start_apiserver(ctx)
    try:
        return connected_run(ctx, url, node_dicts, pod_dicts, device=device,
                             smi=smi, capture=capture, mesh=mesh,
                             queued_first=queued_first,
                             parity_every=parity_every)
    finally:
        stop_process(server, server_pipe)


def churn_nodes_and_pods(client, stop, stats, period_s=CHURN_PERIOD_S,
                         hurry=None):
    """scheduler_perf's ``churn`` op as the reference's ConnectedChurn runs
    it (``benchmarks/connected.py`` _churn_loop): recycle nodes and
    short-lived pods (namespace ``churn``, outside the measured set) while
    the window runs. Node and pod names count up; at most 3 of each live.
    ``stats``: ops, errors, and the nodes created (their dicts: a measured
    pod may bind to one). ``hurry``: once set, a 10 ms cadence."""
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
    live_nodes, live_pods = [], []
    i = 0
    while not stop.is_set():
        try:
            node = _wire([make_node(f"churn-n{i}").capacity(
                {"cpu": "2", "memory": "4Gi", "pods": "8"}).obj()])[0]
            client.nodes().create(node)
            stats.setdefault("nodes", []).append(node)
            live_nodes.append(node["metadata"]["name"])
            pod = _wire([make_pod(f"churn-p{i}", "churn")
                         .req({"cpu": "100m"}).obj()])[0]
            client.pods("churn").create(pod)
            live_pods.append(pod["metadata"]["name"])
            if len(live_nodes) > 3:
                client.nodes().delete(live_nodes.pop(0))
            if len(live_pods) > 3:
                client.pods("churn").delete(live_pods.pop(0))
            stats["ops"] = stats.get("ops", 0) + 4
        except Exception as e:  # churn is load; the gates own correctness
            stats["errors"] = stats.get("errors", 0) + 1
            stats["last_error"] = repr(e)
        i += 1
        stop.wait(period_s if hurry is None or not hurry.is_set()
                  else min(period_s, 0.01))


def connected_run(ctx, url, node_dicts, pod_dicts, device=None, smi="",
                  capture=True, what="connected", explain=True,
                  churn_ops=None, admin_token=None, sched_token=None,
                  audit_url=None, chaos=None, mesh=None, queued_first=False,
                  parity_every=None):
    """The connected phase's run against a server at ``url`` (or a front
    door's endpoints, which every client but the auditor spreads over):
    seed, runner, auditor and watcher as ``connected_phase`` says, gated
    the same way (messages start with ``what``). ``explain``: the
    explainer on (its gates with it). ``churn_ops``: the reference's
    churn loop (``churn_nodes_and_pods``) runs from the first create
    until every pod is bound, then at a 10 ms cadence until it made this
    many operations (60 s at most); churn pods and nodes are outside the
    measured set, a measured pod bound to a churn node is checked against
    it, and the sentinel samples every drain (CHURN_PARITY_EVERY; else
    every CONNECTED_PARITY_EVERY). ``admin_token`` authenticates the seed,
    the auditor, the watcher and the churn; ``audit_url``: the auditor's
    server (default ``url``). ``sched_token`` authenticates the runner as
    a user holding only the bootstrap policy's ``system:kube-scheduler``
    role, which may not list every kind the runner watches: the informers
    of the kinds the role may list must sync; the failures of what the
    role does not allow (``RBAC_DENIED_SITES``: the other kinds' lists,
    the status ConfigMaps' writes) are reported and not gated.
    ``chaos``: a ``FaultSchedule`` (ChaosChurnQueued, ``chaos_churn``): the
    runner's transport is wrapped in ``ChaosClient``, the breaker's
    cooldown is CHAOS_COOLDOWN_S, the sentinel samples every
    CHAOS_PARITY_EVERY-th drain, ``DeviceChaos`` and ``ThreadChaos`` are
    installed after the warm drain, the loop starts once the informer has
    queued the measured pods, ``chaos_settle`` runs after the churn
    budget (the churn on beside it; the tracer's dropped spans are read
    before it, whose pops may fill the ring) and the faults are taken out
    before
    the settle of the sentinel and the auditor; the "0 loop errors, 0
    oracle pods" gates give way to ``chaos_failures``, which the caller
    checks. ``mesh``: the runner's scheduler is given this device mesh
    (``Scheduler.set_mesh``) before its informers start; the breaker then
    must end at "mesh", and the summary carries the mesh, its device
    count and every measured pod's node (``placements``).
    ``queued_first``: the pods are created chunk after chunk and the loop
    starts once the informer has queued every one, so the pops take the
    same pods on every run (as under ``chaos``, whose creates stay
    concurrent). ``parity_every``: the sentinel's sampling period, for a
    run too short for the default's (a run of two pops samples its
    second with 2).
    -> (summary, stopped runner)."""
    rbac = sched_token is not None
    import threading
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
    watcher = runner = churn = injected = chaos_block = None
    churn_stop, churn_hurry, churn_stats = (threading.Event(),
                                            threading.Event(), {})
    try:
        seed_client = HTTPClient(url, timeout=120.0, wire="json",
                                 token=admin_token)
        t0 = time.perf_counter()
        seed_client.nodes().create_many(node_dicts)
        seed_s = time.perf_counter() - t0
        chaos_cfg = {} if chaos is None else {
            "breaker_cooldown_s": CHAOS_COOLDOWN_S}
        cfg = sched_config(batch_size=CONNECTED_BATCH,
                           max_drain_batches=CONNECTED_DRAIN_BATCHES,
                           parity_sample_every=(
                               parity_every if parity_every is not None
                               else CHAOS_PARITY_EVERY if chaos is not None
                               else CONNECTED_PARITY_EVERY
                               if churn_ops is None
                               else CHURN_PARITY_EVERY),
                           audit_interval_s=CONNECTED_AUDIT_S,
                           audit_fail_fast=True, explainer_enabled=explain,
                           **chaos_cfg)
        sched_client = HTTPClient(url, wire="json",
                                  token=sched_token or admin_token)
        if chaos is not None:
            # the SCHEDULER's transport only: the seed, the auditor, the
            # watcher and the churn keep clean clients (ground truth)
            from kubernetes_tpu_torch.chaos import ChaosClient
            sched_client = ChaosClient(sched_client, chaos)
        runner = SchedulerRunner(
            sched_client, cfg, feature_gate=no_preemption_gate(),
            device=device)
        runner.scheduler.capture = capture
        if mesh is not None:
            runner.scheduler.set_mesh(mesh)
        # fail-fast audit over a CLEAN client, as run_connected's
        # _bench_auditor: the scheduler's transport is not the auditor's
        runner.auditor = InvariantAuditor(
            client=HTTPClient(audit_url or url, timeout=60.0, wire="json",
                              token=admin_token),
            cache=runner.cache, scheduler=runner.scheduler,
            interval_s=CONNECTED_AUDIT_S, fail_fast=True,
            pre_sweep=runner.sweep_stale_nominations,
            post_sweep=runner.publish_status,
            relists=runner._total_relists)
        t0 = time.perf_counter()
        runner.start(wait_sync=0.1 if rbac else 120.0, start_loop=False)
        informers = runner._all_informers()
        if rbac:
            listable = scheduler_listable()
            informers = [inf for inf in informers
                         if inf.resource.plural in listable]
        for inf in informers:
            inf.wait_for_cache_sync(max(0.0, t0 + 120.0 - time.perf_counter()))
        check(all(inf.has_synced() for inf in informers),
              f"{what}: the informers did not sync")
        unsynced = sorted(inf.resource.plural
                          for inf in runner._all_informers()
                          if not inf.has_synced())
        sync_s = time.perf_counter() - t0
        from kubernetes_tpu_torch.api.types import Pod
        pods = [Pod.from_dict(d) for d in pod_dicts]
        pop = CONNECTED_BATCH * CONNECTED_DRAIN_BATCHES
        t0 = time.perf_counter()
        check(runner.scheduler.warm_drain(pods, slot_headroom=len(pods)
                                          + pop),
              f"{what}: warm_drain did not arm the context")
        warm_s = time.perf_counter() - t0
        del pods
        if chaos is not None:
            # after the warm drain, as the reference's ChaosChurn
            from kubernetes_tpu_torch.chaos import (DeviceChaos, ThreadChaos,
                                                    hooks)
            from kubernetes_tpu_torch.metrics.registry import BIND_RETRIES
            injected = DeviceChaos(chaos).install()
            hooks.install(ThreadChaos(chaos))
            retries0 = BIND_RETRIES.get()

        _, rv0 = seed_client.pods("default").list_rv()
        count = ctx.Value("i", 0)
        all_bound, watch_dead, ready = ctx.Event(), ctx.Event(), ctx.Event()
        watcher = ctx.Process(target=watch_bound,
                              args=(url, "default", rv0, len(pod_dicts),
                                    count, all_bound, watch_dead, ready),
                              kwargs={"token": admin_token}, daemon=True)
        watcher.start()
        check(ready.wait(120.0), f"{what}: the watcher did not start")

        errors0 = dict(LOOP_ERRORS.items())
        ATTEMPT_DURATION.reset()
        E2E_SCHEDULING.reset()
        FLIGHT.reset()
        # every pod's timeline kept: E2E_SCHEDULING is derived from them
        FLIGHT.max_pods = max(FLIGHT.max_pods, 2 * len(pod_dicts))
        # the window's spans all kept: one per pod watch event (two events
        # a pod), the loop's and the binds', the sweeps' and the checks'
        TRACER.max_spans = max(TRACER.max_spans, 8 * len(pod_dicts)
                               + (0 if churn_ops is None else 40_000))
        TRACER.reset()
        enc0 = runner.cache.encode_cache_stats()
        kernels.reset_launches()
        g0 = graph_counters()
        jobs = [pod_dicts[i:i + CONNECTED_CHUNK]
                for i in range(0, len(pod_dicts), CONNECTED_CHUNK)]
        t_start, t_start_wall = time.perf_counter(), time.time()
        if churn_ops is not None:
            churn = threading.Thread(
                target=churn_nodes_and_pods,
                args=(HTTPClient(url, timeout=60.0, wire="json",
                                 token=admin_token), churn_stop,
                      churn_stats),
                kwargs={"hurry": churn_hurry}, daemon=True)
            churn.start()
        # queued_first compares runs pod for pod: its chunks are created
        # one after another, so the informer queues the pods in the same
        # order on every run (concurrent chunks interleave by chance)
        workers = 1 if queued_first else min(4, len(jobs))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(lambda objs: seed_client.pods("default")
                          .create_many(objs), jobs))
        t_created = time.perf_counter()
        enc_created = runner.cache.encode_cache_stats()
        if chaos is not None or queued_first:
            # the loop starts once the informer has queued every measured
            # pod: the first two pops take them whole on any host, and the
            # drain and gang bursts land on the churn's pops (after an
            # informer lag they landed on measured pops, and the oracle
            # placed 0, 257 or 672 of them in three calls)
            while (runner.queue.stats()["active"] < len(pod_dicts)
                   and time.perf_counter() < t_start + 60.0):
                time.sleep(0.01)
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
                  f"{what}: the scheduling loop died: "
                  f"{runner.loop_error!r}")
            check(not watch_dead.is_set(), f"{what}: the watcher died")
        window_s = time.perf_counter() - t_start
        check(completed, f"{what}: {count.value} of {len(pod_dicts)} "
                         f"pods bound in {CONNECTED_TIMEOUT_S} s")
        q = {"result": "scheduled"}
        launches = dict(kernels.LAUNCHES)
        pops = sum(1 for sp in TRACER.spans("scheduler/gang_dispatch"))
        graphs = graph_report(g0, pops * CONNECTED_DRAIN_BATCHES)
        spans = _span_totals(t_start_wall)
        oracle_pods = sum(sp.attributes["pods"]
                          for sp in TRACER.spans("scheduler/oracle"))
        enc = runner.cache.encode_cache_stats()
        by_site = {dict(k).get("site", "?"): n - errors0.get(k, 0)
                   for k, n in LOOP_ERRORS.items().items()
                   if n - errors0.get(k, 0)}
        errors = sum(n for site, n in by_site.items()
                     if not (rbac and site in RBAC_DENIED_SITES))
        ctx_stats = json.loads(json.dumps(runner.scheduler.ctx_stats))
        if churn is not None:
            # the reference's fixed churn budget, decoupled from the
            # window: a fast drain must not leave the churn path unrun
            churn_hurry.set()
            budget_end = time.perf_counter() + 60.0
            while (churn_stats.get("ops", 0) < churn_ops
                   and time.perf_counter() < budget_end):
                time.sleep(0.05)
            if chaos is not None:
                # the spans of the window and the churn budget: the chaos
                # settle's pops may fill the ring after them
                spans_dropped = TRACER.dropped
                chaos_block = chaos_settle(runner, chaos, seed_client, what)
            churn_stop.set()
            churn.join(30.0)
        if chaos is None:
            spans_dropped = TRACER.dropped
        if chaos is not None:
            injected.uninstall()
            hooks.uninstall()
            injected = None
            chaos_block.update(
                recovery=chaos.report(),
                resilience=runner._resilience_status(),
                bind_retries=BIND_RETRIES.get() - retries0,
                breaker={"mode": runner.scheduler.breaker.mode,
                         "trips": runner.scheduler.breaker.trips,
                         "restores": runner.scheduler.breaker.restores},
                loop_error=(None if runner.loop_error is None
                            else repr(runner.loop_error)))
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
            "spans": spans, "spans_dropped": spans_dropped,
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
            "loop_errors": errors, "loop_errors_by_site": by_site,
            "unsynced_informers": unsynced, "oracle_pods": oracle_pods,
            "relists": runner._total_relists(),
            "launches": launches, "captured": capture,
            "warm_ladder": runner.scheduler.warm_stats, "graphs": graphs,
            "explainer_constructed": runner.scheduler.explainer is not None,
            "flight_enabled": FLIGHT.enabled,
            "churn": None if churn is None else {
                "ops": churn_stats.get("ops", 0),
                "nodes": len(churn_stats.get("nodes", ())),
                "errors": churn_stats.get("errors", 0),
                "last_error": churn_stats.get("last_error")},
            "chaos": chaos_block,
            "card": smi}
        if mesh is not None:
            from kubernetes_tpu_torch.metrics.registry import MESH_DEVICES
            summary.update(mesh=mesh.describe(),
                           mesh_active=runner.scheduler.mesh is mesh,
                           mesh_devices=MESH_DEVICES.get())
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
        summary["explainer"] = None
        if explainer is not None:
            explainer.drain(120.0)
            summary["explainer"] = explainer.stats()
        summary["explain_spans"] = {k: v for k, v in _span_totals().items()
                                    if k.startswith("explain/")}
        stored = [p for p in seed_client.pods("default").list()
                  if p["spec"].get("nodeName")]
    finally:
        churn_stop.set()
        if injected is not None:  # a failed run never leaks installed chaos
            from kubernetes_tpu_torch.chaos import hooks
            injected.uninstall()
            hooks.uninstall()
        if runner is not None:
            runner.stop()  # re-raises a KernelError that ended the loop
        if watcher is not None:
            stop_process(watcher)
    # the stored pods, as admission left them, on the nodes they hold
    names = {d["metadata"]["name"] for d in pod_dicts}
    placed = [p for p in stored if p["metadata"]["name"] in names]
    check(len(placed) == len(pod_dicts),
          f"{what}: {len(placed)} of {len(pod_dicts)} pods bound in the "
          "store")
    check_placements(node_dicts + churn_stats.get("nodes", []), [], placed,
                     len(pod_dicts))
    if mesh is not None or queued_first:
        # the caller compares them (and drops them before emitting)
        summary["placements"] = {p["metadata"]["name"]:
                                 p["spec"]["nodeName"] for p in placed}
    check(summary["breaker"] == ("mesh" if mesh is not None else "single"),
          f"{what}: the breaker degraded to {summary['breaker']!r} "
          f"({summary['breaker_trip_reasons']})")
    check(summary["spans_dropped"] == 0,
          f"{what}: the tracer dropped {summary['spans_dropped']} spans "
          "of the window")
    if chaos is None:
        check(summary["oracle_pods"] == 0,
              f"{what}: {summary['oracle_pods']} pods went through the "
              "oracle")
        check(summary["loop_errors"] == 0,
              f"{what}: {summary['loop_errors']} loop errors "
              f"{summary['loop_errors_by_site']}")
    check(summary["audit"]["sweeps"] >= 1, f"{what}: the auditor never swept")
    check(summary["audit"]["violations"] == 0,
          f"{what}: invariant violations {summary['audit']['byInvariant']}")
    # under churn, a sampled drain that races a churn node's delta cannot
    # be judged and is skipped (counted): there the sentinel must have
    # seen a drain, sampled or skipped
    seen = summary["sentinel"]["samples"]["drain"] + (
        summary["sentinel"]["skipped"] if churn_ops is not None else 0)
    check(seen >= 1, f"{what}: the sentinel took no sample")
    check(summary["sentinel"]["divergences"] == 0,
          f"{what}: parity divergence {summary['sentinel']}")
    check(summary["sentinel_backlog"] == 0,
          f"{what}: the sentinel's verdicts did not land in 120 s")
    check(summary["explainer_constructed"] == explain,
          f"{what}: the explainer was constructed: "
          f"{summary['explainer_constructed']}, asked for {explain}")
    if explain:
        check(summary["explainer"]["errors"] == 0,
              f"{what}: explainer errors {summary['explainer']}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched by the {what} "
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
                         batch=EXTENDER_BATCH, device="cuda"):
    """count_pn's inputs as the extender scheduler's last pop met them in
    its first gang round: the last pop's pods (the queue pops in arrival
    order: MixedHeterogeneous pods carry no priority) encoded against the
    nodes with every earlier pod bound where it was placed, the cluster
    extended by the batch as ``gang_schedule`` extends it. Every earlier
    pod must have been placed, or the last pop saw another cluster. What
    the terms count does not depend on where the earlier pods went (a
    match counts on its pod's node, and every node is valid), only on
    there being an earlier pop: with one pop the case counts nothing."""
    last = (len(pod_dicts) - 1) // batch * batch
    earlier = pod_dicts[:last]
    keys = [f"{d['metadata'].get('namespace', 'default')}/"
            f"{d['metadata']['name']}" for d in earlier]
    missing = [k for k in keys if k not in placements]
    check(not missing, f"extender: earlier pods {missing[:4]} were not "
                       "placed, so the last pop's cluster is not known")
    bound = [dict(d, spec=dict(d["spec"], nodeName=placements[k]))
             for d, k in zip(earlier, keys)]
    ct, pb = _encoded(node_dicts, bound, pod_dicts[last:], device=device)
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
LOOP_WINDOW = 1              # benchmarks/plannerloop.py's 6, cut to fit
LOOP_MAX_WARMUP = 14
LOOP_QUIET = 1               # quiet warm-up cycles (2 until cut to fit)
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
    """Child process: the port's ControllerManager running the
    ResourceClaim controller alone (``controllers=("resourceclaim",)``,
    no garbage collector), over its own HTTP client and informers, as a
    controller manager runs beside the scheduler; ``ready`` once its
    informers synced, until ``stop``."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.controllers.manager import ControllerManager
    mgr = None
    try:
        mgr = ControllerManager(HTTPClient(url, wire="json"),
                                controllers=("resourceclaim",),
                                gc_enabled=False).start(wait_sync=120.0)
        if not mgr.factory.wait_for_cache_sync(1.0):
            failed.set()
            return
        ready.set()
        stop.wait()
    except Exception:
        import traceback
        traceback.print_exc()
        failed.set()
    finally:
        if mgr is not None:
            mgr.stop()


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
    the port's ControllerManager running the ResourceClaimController in a
    spawned process of its own (serve_claim_controller), as a controller
    manager runs beside the scheduler. Informers synced, ``warm_drain``, the loop started; then
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


# ------------------------------------------------------------------ plugins

PLUGIN_MODULUS = 10        # the stripe filter vetoes every 10th node row
PLUGIN_PARITY_NODES = 48
PLUGIN_PARITY_PODS = 160
PLUGIN_LEGS = (("captured", "cuda", True), ("eager", "cuda", False),
               ("cpu", "cpu", True))


def plugin_registry():
    """A Registry holding the two out-of-tree tensor plugins of
    ``testing/plugins.py``: the stripe filter (every ``PLUGIN_MODULUS``th
    node row) and the cpu-packing score."""
    from kubernetes_tpu_torch.sched.framework import Registry
    from kubernetes_tpu_torch.testing.plugins import smoke_plugins
    reg = Registry()
    for p in smoke_plugins(PLUGIN_MODULUS):
        reg.register(p)
    return reg


def _vetoed_rows(assignments, modulus=PLUGIN_MODULUS) -> int:
    """Placements (node rows, -1 unplaced) on a row the stripe filter
    vetoes, by its numpy copy."""
    import numpy as np
    from kubernetes_tpu_torch.testing.plugins import stripe_allows
    a = np.asarray(assignments).reshape(-1)
    a = a[a >= 0]
    if not a.size:
        return 0
    return int((~stripe_allows(int(a.max()) + 1, modulus)[a]).sum())


def plugin_parity_phase(legs=PLUGIN_LEGS, seed=SEED,
                        n_nodes=PLUGIN_PARITY_NODES,
                        n_pods=PLUGIN_PARITY_PODS):
    """Out-of-tree tensor plugins inside the rounds, on a seeded
    ``relational_mix`` cluster of 48 nodes (spread and affinity terms, so
    count_pn runs), with the stripe filter (every 10th node row vetoed)
    and the cpu-packing score (weight 5) registered in the default
    profile, three ways (``legs``: the card with the rounds captured, the
    card eager, the CPU):

    - ``gang_drain`` of the pending pods in batches of 32;
    - the port's Scheduler on its group path (one batch of 16 a pop) and
      its drain path (4 x 16 a pop) at pipeline depth 1 and 2.

    Assignments and rounds, and the binder logs, must be bit-equal across
    the legs; every placement passes the filter (its numpy copy, on the
    host; the cache's rows follow the order the nodes were added); and
    the first leg without the plugins places otherwise, so the plugins
    ran. -> summary (count_pn's launches over the plugin legs, the
    controls without the plugins not counted)."""
    import copy
    from kubernetes_tpu_torch.api.types import Node, Pod
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models.gang import gang_drain
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.framework import Registry
    from kubernetes_tpu_torch.testing.plugins import smoke_plugins
    from kubernetes_tpu_torch.testing.workloads import relational_mix
    nodes, bound, pending, ns = relational_mix(pods=n_pods, nodes=n_nodes,
                                               bound=n_nodes // 2, seed=seed)
    node_dicts = [n.to_dict() for n in nodes]
    bound_dicts = [p.to_dict() for p in bound]
    pending_dicts = [p.to_dict() for p in pending]
    names = [d["metadata"]["name"] for d in node_dicts]
    plugins = smoke_plugins(PLUGIN_MODULUS)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = {"nodes": n_nodes, "pending": len(pending_dicts),
           "legs": [leg for leg, _d, _c in legs],
           "plugins": [p.name for p in plugins]}
    # gang_drain over the host encoding
    enc = SnapshotEncoder()
    enc.set_namespaces(ns)
    pods = [Pod.from_dict(copy.deepcopy(d)) for d in pending_dicts]
    ct, meta = enc.encode_cluster(
        [Node.from_dict(copy.deepcopy(d)) for d in node_dicts],
        [Pod.from_dict(copy.deepcopy(d)) for d in bound_dicts],
        pending_pods=pods, pending_slots=False)
    P = 32
    pbs = [enc.encode_pods(pods[i:i + P], meta, min_p=P)
           for i in range(0, len(pods), P)]
    drains = {leg: gang_drain(ct, pbs, topo_keys=meta.topo_keys, seed=seed,
                              device=dev, plugins=plugins, capture=capture)
              for leg, dev, capture in legs}
    first = legs[0][0]
    for leg in drains:
        check(_same(drains[first], drains[leg]),
              f"parity.plugins: gang_drain {leg} differs from {first}")
    a, rounds, _req = drains[first]
    check(_vetoed_rows(a) == 0,
          "parity.plugins: gang_drain placed pods on vetoed node rows")
    out["gang_drain"] = {"placed": int((a >= 0).sum()),
                         "rounds": rounds.tolist()}
    # the Scheduler's group and drain paths
    vetoed = {n for i, n in enumerate(names) if i % PLUGIN_MODULUS == 0}
    paths = {"group": dict(batch_size=16, max_drain_batches=1),
             "drain_depth1": dict(batch_size=16, max_drain_batches=4,
                                  pipeline_depth=1),
             "drain_depth2": dict(batch_size=16, max_drain_batches=4,
                                  pipeline_depth=2)}

    def drive(cfg, dev, capture, registry):
        sched, log = make_scheduler(
            sched_config(**cfg),
            [Node.from_dict(copy.deepcopy(d)) for d in node_dicts],
            [Pod.from_dict(copy.deepcopy(d)) for d in bound_dicts],
            ns_labels=ns, device=dev, confirm=False, registry=registry)
        sched.capture = capture
        sched._drain_ready = lambda pend: False
        try:
            for d in pending_dicts:
                sched.queue.add(Pod.from_dict(copy.deepcopy(d)))
            for _ in range(12):
                sched.run_once(wait=0.01)
            sched._resolve_pending()
            sched.wait_for_bindings()
            return ({k: n for k, n, _t in log},
                    json.loads(json.dumps(sched.ctx_stats)),
                    sched._drain_ctx is not None)
        finally:
            sched.close()

    out["scheduler"] = {}
    for path, cfg in paths.items():
        runs = {leg: drive(cfg, dev, capture, plugin_registry())
                for leg, dev, capture in legs}
        for leg in runs:
            check(runs[leg] == runs[first],
                  f"parity.plugins: the scheduler's {path} on {leg} differs "
                  f"from {first}")
        log, stats, armed = runs[first]
        check(armed == (path != "group"),
              f"parity.plugins: {path} took the wrong path")
        bad = sorted(k for k, n in log.items() if n in vetoed)
        check(not bad, f"parity.plugins: {path} bound {bad[:3]} on vetoed "
                       "nodes")
        check(len(log) >= 0.5 * len(pending_dicts),
              f"parity.plugins: {path} placed only {len(log)}")
        out["scheduler"][path] = {"placed": len(log), "ctx_stats": stats}
    out["launches"] = dict(kernels.LAUNCHES)
    # the controls, on the first leg without the plugins (their launches
    # are not counted above)
    plain = gang_drain(ct, pbs, topo_keys=meta.topo_keys, seed=seed,
                       device=legs[0][1], capture=legs[0][2])
    check(not _same(plain[0], a),
          "parity.plugins: gang_drain places the same without the plugins")
    out["gang_drain"]["moved_by_plugins"] = int((plain[0] != a).sum())
    plain_log = drive(paths["drain_depth2"], legs[0][1], legs[0][2],
                      Registry())[0]
    check(plain_log != runs[first][0],
          "parity.plugins: the scheduler places the same without plugins")
    out["scheduler"]["moved_by_plugins"] = sum(
        1 for k, n in runs[first][0].items() if plain_log.get(k) != n)
    out["seconds"] = time.perf_counter() - t0
    return out


def plugins_phase(node_dicts, pod_dicts, smi="", plain=None, device=None):
    """Scheduler/10000Pods5000Nodes as the scheduler phase runs it (its
    workload, warm_drain, pops of 8 x 256 with Recreate churn, rounds
    captured, K = 2), with the stripe filter and the cpu-packing score
    registered (``plugin_registry``). Beside the scheduler phase's own
    gates: every pod placed or reported unschedulable; every binding on a
    node row the filter allows, checked on the host (a base node's row is
    its place in ``node_dicts``, which is checked against the context's
    row map; a churn node's rows are those the scheduler phase read from
    the context after every pop, and a binding passes where one of them
    does); 0 captures in the measured window, so the warm ladder captured
    with the plugins. ``plain``: the scheduler phase's summary of this
    call, for the comparison. -> (summary, scheduler, churn state)."""
    from kubernetes_tpu_torch.testing.plugins import stripe_allows
    summary, sched, churn, placed = scheduler_phase(
        node_dicts, pod_dicts, device=device, smi=smi,
        registry=plugin_registry())
    base = {d["metadata"]["name"]: i for i, d in enumerate(node_dicts)}
    churn_rows = summary["churn_rows"]
    rows = sched._drain_ctx["cs"].node_index
    moved = sorted(n for n, i in base.items() if rows.get(n) != i)
    check(not moved, f"plugins: base node rows moved: {moved[:3]}")
    allow = stripe_allows(max([len(base)] + [max(r) + 1 for r in
                                             churn_rows.values()]),
                          PLUGIN_MODULUS)
    bad = sorted(k for k, n in placed.items()
                 if n in base and not allow[base[n]])
    check(not bad, f"plugins: {len(bad)} bindings on vetoed node rows "
                   f"({bad[:3]})")
    on_churn = [n for n in placed.values() if n not in base]
    churn_bad = [n for n in on_churn
                 if not any(allow[r] for r in churn_rows.get(n, ()))]
    check(not churn_bad, f"plugins: bindings on vetoed churn node rows "
                         f"{sorted(set(churn_bad))[:3]}")
    q = sched.queue.stats()
    unsched = q["backoff"] + q["unschedulable"]
    check(len(placed) + unsched == len(pod_dicts),
          f"plugins: {len(placed)} placed + {unsched} unschedulable of "
          f"{len(pod_dicts)}")
    check(summary["graphs"]["captures"] == 0,
          f"plugins: {summary['graphs']['captures']} captures in the "
          "measured window (the warm ladder missed the plugins' graphs)")
    summary.update(
        unschedulable=unsched, bindings_checked=len(placed),
        bindings_on_churn_nodes=len(on_churn),
        vetoed_nodes=int((~allow[:len(base)]).sum()),
        plugins=[p.name for p in sched.registry.tensor_plugins()])
    if plain is not None:
        summary["vs_scheduler"] = {
            "pods_per_s": plain["pods_per_s"],
            "pods_per_s_ratio": summary["pods_per_s"] / plain["pods_per_s"],
            "attempt_p50_s": plain["attempt_p50_s"],
            "attempt_p99_s": plain["attempt_p99_s"]}
    return summary, sched, churn


KTPU_NODES = 64
KTPU_PODS = 256
KTPU_KUBELET = "kubelet-0"   # the served hollow kubelet's node


def ktpu_phase(device=None, n_nodes=KTPU_NODES, n_pods=KTPU_PODS,
               seed=SEED, timeout_s=60.0):
    """The port's ``ktpu`` (cli/ktpu.py) against a port APIServer (in
    process) and a SchedulerRunner on the card: a MixedHeterogeneous
    cluster of 64 nodes and 256 pods, two more nodes tainted
    ``dedicated=ml:NoSchedule`` and labelled ``pool=ml``, and one pod that
    selects ``pool=ml`` without the toleration (it stays pending). The
    explainer, the flight recorder, the sentinel (every drain) and the
    auditor (every 0.5 s) are on. ``ktpu.main(argv, out=StringIO())``
    then runs, and every command must exit 0:

    - ``get pods -o json``: the bound pods it lists hold every pod the
      store held bound before the command and none it did not after;
    - ``status -o json``: carries the ``ctx`` and ``aotCache`` blocks;
    - ``why stuck -o json``: names TaintToleration with its 2 nodes;
    - ``trace dump`` (after ``publish_trace``): valid Chrome trace JSON;
    - ``audit status -o json``: at least one sweep, 0 violations;
    - ``deschedule run --dry-run -o json``: a plan, computed on the card;
    - ``status``, ``get nodes`` and ``top nodes`` in table form;
    - the kubelet's commands, on a pod the runner binds to a served hollow
      kubelet (``HollowNode(...).start(serve=True)``, labelled
      ``pool=kubelet``, the pod selecting it): ``logs`` and ``attach``
      print the lines its ``FakeRuntime`` holds for the container,
      ``exec -- echo`` prints what the runtime answers, and
      ``port-forward --one-shot`` carries one connection through the
      apiserver and the kubelet to the container, which answers;
    - ``scenario generate builtin:smoke`` into a temporary file, and
      ``scenario describe`` on that file (its 32 events).
    - ``lint --json`` over ``kubernetes_tpu_torch/proxy``: exit 0 and no
      new finding against the port's committed baseline.

    -> summary (per command: exit code, seconds, output bytes)."""
    import io
    import tempfile
    from kubernetes_tpu_torch.cli import ktpu
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.kubelet.kubelet import HollowNode
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.store.apiserver import APIServer
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
    from kubernetes_tpu_torch.utils.tracing import validate_chrome_trace
    t_phase = time.perf_counter()
    node_objs, pod_objs = mixed_heterogeneous(pods=n_pods, nodes=n_nodes,
                                              seed=seed)
    server = APIServer().start()
    runner = hollow = None
    try:
        client = HTTPClient(server.url)
        client.nodes().create_many(
            [n.to_dict() for n in node_objs]
            + [make_node(f"tainted-{i}").capacity(
                {"cpu": "8", "memory": "16Gi", "pods": "32"})
               .label("pool", "ml").taint("dedicated", "ml", "NoSchedule")
               .obj().to_dict() for i in range(2)])
        # the served hollow kubelet registers its node itself
        hollow = HollowNode(HTTPClient(server.url), KTPU_KUBELET,
                            labels={"pool": "kubelet"}).start(serve=True)
        cfg = sched_config(batch_size=64, max_drain_batches=2,
                           explainer_enabled=True, parity_sample_every=1,
                           audit_interval_s=0.5, backoff_initial_s=0.2,
                           backoff_max_s=1.0)
        runner = SchedulerRunner(HTTPClient(server.url), cfg,
                                 feature_gate=no_preemption_gate(),
                                 device=device)
        runner.start(wait_sync=60.0, start_loop=False)
        check(runner.scheduler.warm_drain(pod_objs[:128], slot_headroom=512),
              "ktpu: warm_drain did not arm the context")
        kernels.reset_launches()
        runner.start_loop()
        client.pods("default").create_many([p.to_dict() for p in pod_objs])
        stuck = make_pod("stuck").req({"cpu": "100m"}).obj().to_dict()
        stuck["spec"]["nodeSelector"] = {"pool": "ml"}
        client.pods("default").create(stuck)

        def bound_in_store():
            return sorted(p["metadata"]["name"] for p in
                          client.pods(None).list()
                          if p["spec"].get("nodeName"))

        flags = ["--server", server.url] + (
            ["--device", str(device)] if device is not None else [])

        def run(*argv):
            out = io.StringIO()
            t0 = time.perf_counter()
            rc = ktpu.main([*flags, *argv], out=out)
            return rc, out.getvalue(), time.perf_counter() - t0

        deadline = time.perf_counter() + timeout_s
        why = None
        while time.perf_counter() < deadline:
            rc, text, _s = run("why", "stuck", "-o", "json")
            if (rc == 0 and len(bound_in_store()) >= 0.9 * n_pods
                    and runner.auditor.sweeps >= 1):
                why = json.loads(text)
                break
            time.sleep(0.2)
        check(why is not None, "ktpu: no explanation, binding or audit "
                               f"sweep within {timeout_s}s")
        check(runner.loop_error is None,
              f"ktpu: the runner's loop stopped: {runner.loop_error!r}")
        # a pod for the kubelet's commands, bound by the runner on the card
        target = make_pod("kubelet-target").req({"cpu": "100m"}).obj() \
            .to_dict()
        target["spec"]["nodeSelector"] = {"pool": "kubelet"}
        client.pods("default").create(target)

        def running():
            p = client.pods("default").get("kubelet-target")
            return (p["spec"].get("nodeName") == KTPU_KUBELET
                    and (p.get("status") or {}).get("phase") == "Running")
        end = time.perf_counter() + timeout_s
        while time.perf_counter() < end and not running():
            time.sleep(0.1)
        check(running(), f"ktpu: the pod for the kubelet's commands was not "
                         f"bound to {KTPU_KUBELET} and Running")
        runner.publish_status()
        runner.publish_trace()
        launches = dict(kernels.LAUNCHES)
        results, docs = {}, {}
        for key, argv, parse in (
                ("get_pods", ("get", "pods", "-o", "json"), True),
                ("status_json", ("status", "-o", "json"), True),
                ("why", ("why", "stuck", "-o", "json"), True),
                ("trace_dump", ("trace", "dump"), True),
                ("audit", ("audit", "status", "-o", "json"), True),
                ("deschedule", ("deschedule", "run", "--dry-run", "-o",
                                "json"), True),
                ("status", ("status",), False),
                ("get_nodes", ("get", "nodes"), False),
                ("top_nodes", ("top", "nodes"), False)):
            if key == "get_pods":
                # the runner may still bind (and bindings only grow here):
                # the listing must hold every pod bound before the command
                # and no pod unbound after it
                bound_before = set(bound_in_store())
            rc, text, secs = run(*argv)
            if key == "get_pods":
                bound_after = set(bound_in_store())
            check(rc == 0, f"ktpu: {' '.join(argv)} exited {rc}: "
                           f"{text[:300]}")
            results[key] = {"rc": rc, "seconds": secs, "bytes": len(text)}
            if parse:
                docs[key] = json.loads(text)
        listed = sorted(p["metadata"]["name"] for p in
                        docs["get_pods"]["items"]
                        if p["spec"].get("nodeName"))
        check(bound_before <= set(listed) <= bound_after,
              "ktpu: get pods lists other bound pods than the store holds "
              f"({len(bound_before)} before, {len(listed)} listed, "
              f"{len(bound_after)} after)")
        st = docs["status_json"]
        check("ctx" in st and "aotCache" in st,
              f"ktpu: status lacks ctx/aotCache ({sorted(st)})")
        check((docs["why"].get("filters") or {}).get("TaintToleration") == 2,
              f"ktpu: why names {docs['why'].get('filters')}")
        problems = validate_chrome_trace(docs["trace_dump"])
        check(not problems, f"ktpu: trace dump: {problems[:2]}")
        audit = docs["audit"]
        check(audit.get("sweeps", 0) >= 1 and audit.get("violations") == 0,
              f"ktpu: audit {audit.get('sweeps')} sweeps, "
              f"{audit.get('violations')} violations")
        plan = docs["deschedule"]
        check("planned" in plan, f"ktpu: deschedule returned {sorted(plan)}")
        results.update(kubelet_commands(flags, hollow, "kubelet-target"))
        with tempfile.TemporaryDirectory() as tmp:
            trace = os.path.join(tmp, "smoke.trace.jsonl")
            for key, argv in (
                    ("scenario_generate", ("scenario", "generate",
                                           "builtin:smoke", "--out", trace)),
                    ("scenario_describe", ("scenario", "describe", trace))):
                rc, text, secs = run(*argv)
                check(rc == 0, f"ktpu: {' '.join(argv)} exited {rc}: "
                               f"{text[:300]}")
                results[key] = {"rc": rc, "seconds": secs,
                                "bytes": len(text)}
            described = json.loads(text)
        check(described.get("events") == 32
              and described.get("name") == "smoke",
              f"ktpu: scenario describe gave {described}")
        # ktpu lint over one subtree of the port, against its baseline
        rc, text, secs = run("lint", "--json", os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "kubernetes_tpu_torch", "proxy"))
        lint = json.loads(text.strip().splitlines()[-1].split(" ", 1)[1])
        check(rc == 0 and lint["findings_new"] == 0
              and lint["files_scanned"] > 0,
              f"ktpu: lint exited {rc}: {text[-300:]}")
        results["lint"] = {"rc": rc, "seconds": secs, "bytes": len(text),
                           "files": lint["files_scanned"],
                           "findings_new": lint["findings_new"]}
        return {"nodes": n_nodes + 2, "pods": n_pods + 1,
                "bound": len(listed), "commands": results,
                "why": {"message": docs["why"].get("message"),
                        "filters": docs["why"].get("filters")},
                "status_blocks": sorted(st),
                "trace_events": len(docs["trace_dump"]["traceEvents"]),
                "audit": {"sweeps": audit.get("sweeps"),
                          "violations": audit.get("violations")},
                "deschedule": {"planned": len(plan["planned"]),
                               "gangs": len(plan.get("gangs", []))},
                "ctx": st.get("ctx"), "launches": launches,
                "seconds": time.perf_counter() - t_phase}
    finally:
        if runner is not None:
            runner.stop()
        if hollow is not None:
            hollow.stop()
        server.stop()


def kubelet_commands(flags, hollow, pod) -> dict:
    """``ktpu logs``, ``attach``, ``exec`` and ``port-forward`` (``ktpu
    <flags> ...``) on ``pod``, which the served HollowNode ``hollow``
    runs. Each must exit 0; logs and attach print the lines the node's
    FakeRuntime holds for the pod's container, exec prints the runtime's
    answer, and one connection through the forwarded port is answered by
    the container. -> per command: exit code, seconds, output bytes."""
    import io
    import socket
    from kubernetes_tpu_torch.cli import ktpu
    kubelet = hollow.kubelet
    uid = kubelet._uid_of("default", pod)
    check(uid is not None, f"ktpu: {kubelet.node_name} does not run {pod}")
    container = kubelet._pods[uid]["spec"]["containers"][0]["name"]
    held = kubelet.runtime.logs(uid, container)
    check(bool(held), f"ktpu: the runtime holds no log line for {pod}")
    results = {}

    def run(argv, out):
        t0 = time.perf_counter()
        rc = ktpu.main([*flags, *argv], out=out)
        return rc, time.perf_counter() - t0

    for key, argv, want in (
            ("logs", ("logs", pod), "\n".join(held) + "\n"),
            ("attach", ("attach", pod), "\n".join(held) + "\n"),
            ("exec", ("exec", pod, "--", "echo", "hello", "kubelet"),
             kubelet.runtime.exec(uid, container,
                                  ["echo", "hello", "kubelet"])[1])):
        out = io.StringIO()
        rc, secs = run(argv, out)
        text = out.getvalue()
        check(rc == 0 and text == want,
              f"ktpu: {' '.join(argv)} exited {rc} with {text[:200]!r}, "
              f"the runtime holds {want[:200]!r}")
        results[key] = {"rc": rc, "seconds": secs, "bytes": len(text)}
    out, done = io.StringIO(), {}
    forward = threading.Thread(target=lambda: done.setdefault("run", run(
        ("port-forward", pod, "0", "--one-shot"), out)), daemon=True)
    forward.start()
    end = time.perf_counter() + 30.0
    while ("127.0.0.1:" not in out.getvalue()
           and time.perf_counter() < end):
        time.sleep(0.05)
    check("127.0.0.1:" in out.getvalue(),
          "ktpu: port-forward did not listen")
    port = int(out.getvalue().split("127.0.0.1:")[1].split()[0])
    with socket.create_connection(("127.0.0.1", port), timeout=10.0) as c:
        banner = c.recv(1024)
        c.sendall(b"ping")
        echo = c.recv(1024)
    forward.join(30.0)
    rc, secs = done.get("run", (None, 0.0))
    check(rc == 0 and banner == f"pod {uid[:8]} ready\n".encode()
          and echo == b"echo: ping",
          f"ktpu: port-forward exited {rc}, the container answered "
          f"{banner!r} then {echo!r}")
    results["port_forward"] = {"rc": rc, "seconds": secs,
                               "bytes": len(banner) + len(echo)}
    return results


# ---------------------------------- ExplainAB, the secured cluster, front door

EXPLAINAB_PODS = 2000        # run_explain_ab's defaults (benchmarks/
EXPLAINAB_NODES = 1000       # connected.py:513): ConnectedChurn 2000 x 1000
EXPLAINAB_MIN_RATIO = 0.95   # the reference's floor: reported, not gated
CHURN_PARITY_EVERY = 1       # every drain: 2000 pods are two pops, and a
                             # sample racing a churn node's delta is skipped
SECURED_ADMIN = "ktpu-admin-smoke"   # system:masters, as LocalCluster mints
SECURED_SCHED = "ktpu-sched-smoke"   # system:kube-scheduler
SECURED_AUDIT_KEEP = 500_000         # every request of the phase kept
SECURED_PODS = 1000          # of ExplainAB's 2000: cut for time
FRONTDOOR_NODES = 3          # FrontDoorCluster(n=3)
FRONTDOOR_PODS = 1000        # of ExplainAB's 2000: cut for time
FRONTDOOR_CONVERGE_S = 60.0


def scheduler_listable() -> set:
    """The kinds ``system:kube-scheduler`` may list under the bootstrap
    policy (``store/auth.bootstrap_policy``)."""
    from kubernetes_tpu_torch.store.auth import bootstrap_policy
    role = next(o for o in bootstrap_policy()
                if o["kind"] == "ClusterRole"
                and o["metadata"]["name"] == "system:kube-scheduler")
    return {r for rule in role["rules"] if "list" in rule["verbs"]
            for r in rule["resources"]}


def _leg(summary) -> dict:
    """A leg's summary without its spans, tracer and encode detail."""
    keep = ("pods", "nodes", "bound", "window_s", "pods_per_s", "create_s",
            "seed_nodes_s", "informer_sync_s", "warm_drain_s",
            "attempt_p50_s", "attempt_p99_s", "attempts_observed",
            "e2e_p50_s", "e2e_p99_s", "breaker", "loop_errors",
            "loop_errors_by_site", "unsynced_informers", "oracle_pods",
            "launches", "audit", "sentinel", "explainer", "explain_spans",
            "explainer_constructed", "flight_enabled", "churn",
            "device_explain_errors")
    return {k: summary.get(k) for k in keep}


def explainab_failures(result) -> list:
    """The reference's failures list (``benchmarks/connected.py:552-561``)
    without its throughput floor: the on leg ran with the explainer
    constructed and the flight recorder on, the off leg with neither;
    every measured pod bound in each leg; 0 invariant violations,
    divergences, loop errors, ``device_explain`` errors and oracle pods;
    and the ratio was measured (a missing number fails). The ratio itself
    is a host-time ratio of two windows and is reported only."""
    failures = []
    legs = result.get("legs") or {}
    on, off = legs.get("on"), legs.get("off")
    if on is None or off is None:
        return [f"legs missing: {sorted(legs)}"]
    if not on.get("explainer_constructed"):
        failures.append("on leg ran without the explainer constructed")
    if not on.get("flight_enabled"):
        failures.append("on leg ran with the flight recorder disabled")
    if off.get("explainer_constructed"):
        failures.append("off leg ran WITH the explainer (A/B invalid)")
    if off.get("flight_enabled"):
        failures.append("off leg ran WITH the flight recorder (A/B invalid)")
    for name, leg in (("off", off), ("on", on)):
        if leg.get("bound") != leg.get("pods"):
            failures.append(f"{name} leg: {leg.get('bound')} of "
                            f"{leg.get('pods')} pods bound")
        counts = {"invariant violations": (leg.get("audit") or {})
                  .get("violations"),
                  "divergences": (leg.get("sentinel") or {})
                  .get("divergences"),
                  "loop errors": leg.get("loop_errors"),
                  "device_explain errors": leg.get("device_explain_errors"),
                  "oracle pods": leg.get("oracle_pods")}
        for what, n in counts.items():
            if n != 0:
                failures.append(f"{name} leg: {what} {n!r}")
    if not isinstance(result.get("throughput_ratio"), float):
        failures.append(
            f"throughput ratio unavailable (on={result.get('throughput_on')!r}"
            f", off={result.get('throughput_off')!r})")
    return failures


def explainab_phase(device=None, smi="", pods=EXPLAINAB_PODS,
                    nodes=EXPLAINAB_NODES):
    """ExplainAB as ``benchmarks/connected.py`` run_explain_ab runs it:
    ConnectedChurn (MixedHeterogeneous, pops of 2 x 512, the churn loop
    from the first create to the last binding and on to its budget of 500
    operations; namespace ``churn`` is outside the measured set) with the
    explainer and the flight recorder off, then on, each leg as the
    ``connected`` phase runs its runner (a spawned APIServer, the
    sentinel, the fail-fast auditor on a clean client). ``FLIGHT.enabled``
    is restored afterwards. Gates: ``explainab_failures``. The on/off
    pods/s ratio is reported beside the reference's ``min_ratio`` 0.95
    and does not gate: it is a ratio of two host-time windows, which move
    up to 2x between calls (the FleetChurn p99 verdict that flipped
    between calls had a PR refused). The on leg's explainer ``stats()``
    and ``explain/*`` spans are reported. -> summary."""
    import copy
    import multiprocessing as mp
    from kubernetes_tpu_torch.utils.tracing import FLIGHT
    ctx = mp.get_context("spawn")
    node_dicts, pod_dicts = connected_workload(pods=pods, nodes=nodes)
    legs, launches = {}, {}
    flight0 = FLIGHT.enabled
    t0 = time.perf_counter()
    try:
        for name, on in (("off", False), ("on", True)):
            FLIGHT.enabled = on
            e0 = device_explain_errors()
            server, pipe, url = start_apiserver(ctx)
            try:
                summary, runner = connected_run(
                    ctx, url, copy.deepcopy(node_dicts),
                    copy.deepcopy(pod_dicts), device=device, smi=smi,
                    what=f"explainab.{name}", explain=on,
                    churn_ops=CHURN_MIN_OPS)
            finally:
                stop_process(server, pipe)
            del runner
            summary["device_explain_errors"] = device_explain_errors() - e0
            legs[name] = _leg(summary)
            for k, n in summary["launches"].items():
                launches[k] = launches.get(k, 0) + n
    finally:
        FLIGHT.enabled = flight0
    on_t = legs["on"]["pods_per_s"]
    off_t = legs["off"]["pods_per_s"]
    result = {"workload": f"{pods}x{nodes}churn",
              "throughput_on": on_t, "throughput_off": off_t,
              "throughput_ratio": (on_t / off_t if off_t else None),
              "min_ratio": EXPLAINAB_MIN_RATIO,
              "ratio_over_min": (None if not off_t
                                 else on_t / off_t >= EXPLAINAB_MIN_RATIO),
              "explain_on": legs["on"]["explainer"],
              "explain_spans_on": legs["on"]["explain_spans"],
              "legs": legs, "launches": launches, "card": smi,
              "seconds": time.perf_counter() - t0}
    result["failures"] = explainab_failures(result)
    check(not result["failures"], f"explainab: {result['failures']}")
    return result


def _pod_subresource(uri: str):
    """``.../pods/<name>/<sub>?...`` -> sub (binding, status), else None."""
    parts = [p for p in uri.split("?")[0].split("/") if p]
    if len(parts) >= 3 and parts[-3] == "pods":
        return parts[-1]
    return None


def _audit_resource(uri: str) -> str:
    """``/api/v1/namespaces/ns/pods/p/binding?x`` -> ``pods/binding``."""
    parts = [p for p in uri.split("?")[0].split("/") if p]
    parts = parts[2:] if parts[:1] == ["api"] else parts[3:]
    if len(parts) > 2 and parts[0] == "namespaces":
        parts = parts[2:]
    return (parts[0] if parts else "") + (f"/{parts[2]}" if len(parts) > 2
                                          else "")


def secured_checks(url) -> dict:
    """The requests made once against the secured server, each gated: no
    token -> 401; a ``?dryRun=All`` create stores nothing; server-side
    apply by two field managers -> 409 on the shared field, then the
    forced apply wins; ``ktpu apply --server-side`` of a JSON manifest
    exits 0 and the object carries its field manager."""
    import io
    import tempfile
    from kubernetes_tpu_torch.cli import ktpu
    from kubernetes_tpu_torch.client.clientset import ApiError, HTTPClient
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    admin = HTTPClient(url, timeout=60.0, wire="json", token=SECURED_ADMIN)
    out = {}
    try:
        HTTPClient(url, wire="json").pods("default").list()
        out["no_token"] = 200
    except ApiError as e:
        out["no_token"] = e.code
    check(out["no_token"] == 401,
          f"secured: a request without a token got {out['no_token']}")
    ghost = _wire([make_pod("dry-run-ghost").req({"cpu": "100m"}).obj()])[0]
    dry = admin.pods("default").create(ghost, dry_run=True)
    try:
        admin.pods("default").get("dry-run-ghost")
        out["dry_run_stored"] = True
    except ApiError as e:
        out["dry_run_stored"] = e.code != 404
    out["dry_run_tolerations"] = len(dry["spec"].get("tolerations") or [])
    check(not out["dry_run_stored"], "secured: a dry-run create was stored")
    cms = admin.resource("configmaps", "default")
    cm = {"apiVersion": "v1", "kind": "ConfigMap",
          "metadata": {"name": "ssa-smoke"}, "data": {"k": "one"}}
    cms.apply(dict(cm), field_manager="manager-one")
    try:
        cms.apply(dict(cm, data={"k": "two"}), field_manager="manager-two")
        out["ssa_conflict"] = None
    except ApiError as e:
        out["ssa_conflict"] = e.code
    forced = cms.apply(dict(cm, data={"k": "two"}),
                       field_manager="manager-two", force=True)
    out["ssa_forced"] = forced["data"]
    check(out["ssa_conflict"] == 409 and forced["data"] == {"k": "two"},
          f"secured: server-side apply {out}")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cm.json")
        with open(path, "w") as f:
            json.dump({"apiVersion": "v1", "kind": "ConfigMap",
                       "metadata": {"name": "ktpu-ssa-smoke"},
                       "data": {"a": "1"}}, f)
        buf = io.StringIO()
        out["ktpu_apply_rc"] = ktpu.main(
            ["--server", url, "--token", SECURED_ADMIN, "apply", "-f", path,
             "--server-side", "--field-manager", "ktpu-smoke"], out=buf)
        out["ktpu_apply_out"] = buf.getvalue().strip()
    got = cms.get("ktpu-ssa-smoke")
    managers = [m["manager"] for m in got["metadata"]["managedFields"]]
    check(out["ktpu_apply_rc"] == 0 and managers == ["ktpu-smoke"],
          f"secured: ktpu apply --server-side {out}, managers {managers}")
    return out


def secured_phase(device=None, smi="", pods=EXPLAINAB_PODS,
                  nodes=EXPLAINAB_NODES):
    """ConnectedChurn behind an APIServer with the planes a cluster turns on
    (``cli/cluster.py:62-73`` LocalCluster): authentication (bearer tokens,
    anonymous off), the bootstrap RBAC policy and the audit log, API
    Priority and Fairness, and the default admission chain (priority,
    toleration seconds, LimitRanger, PodSecurity, webhooks,
    ResourceQuota). Namespace ``default`` carries PodSecurity ``enforce:
    baseline`` and a LimitRange default. Pods and nodes are created with an
    admin token (``system:masters``); the runner authenticates as
    ``system:kube-scheduler`` under the bootstrap policy; the auditor uses
    the admin token. ``secured_checks`` runs first. Gates: those of the
    connected run (every pod bound, 0 violations, divergences, loop errors
    and oracle pods; the failed lists of the kinds the role may not list
    are reported, not gated), 0 answers of 401, 403 or 429 to the
    scheduler's requests on ``pods/binding`` and ``pods/status``, its
    binding requests in the audit log under its own user, and its requests
    dispatched at the ``system`` priority level. Reported: every 403 the
    scheduler's user got, by resource; pods/s and attempt p50/p99.
    -> summary."""
    import collections
    import multiprocessing as mp
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    ctx = mp.get_context("spawn")
    node_dicts, pod_dicts = connected_workload(pods=pods, nodes=nodes)
    t0 = time.perf_counter()
    server, pipe, url = start_apiserver(
        ctx, tokens={SECURED_ADMIN: ("system:admin", ["system:masters"]),
                     SECURED_SCHED: ("system:kube-scheduler", [])},
        anonymous=False, audit_keep=SECURED_AUDIT_KEEP, flow_control=True,
        admission=True)
    try:
        admin = HTTPClient(url, timeout=60.0, wire="json",
                           token=SECURED_ADMIN)
        nss = admin.resource("namespaces", None)
        ns = nss.get("default")
        ns["metadata"].setdefault("labels", {})[
            "pod-security.kubernetes.io/enforce"] = "baseline"
        nss.update(ns)
        admin.resource("limitranges", "default").create({
            "apiVersion": "v1", "kind": "LimitRange",
            "metadata": {"name": "defaults", "namespace": "default"},
            "spec": {"limits": [{"type": "Container", "defaultRequest": {
                "cpu": "100m", "memory": "128Mi"}}]}})
        checks = secured_checks(url)
        summary, runner = connected_run(
            ctx, url, node_dicts, pod_dicts, device=device, smi=smi,
            what="secured", churn_ops=CHURN_MIN_OPS, admin_token=SECURED_ADMIN,
            sched_token=SECURED_SCHED)
        del runner
        pipe.send("report")
        check(pipe.poll(120.0), "secured: the server sent no report")
        report = pipe.recv()
    finally:
        stop_process(server, pipe)
    sched = [e for e in report["audit"]
             if e["user"] == "system:kube-scheduler"]
    refused = collections.Counter(
        (e["code"], _pod_subresource(e["requestURI"])) for e in sched
        if e["code"] in (401, 403, 429)
        and _pod_subresource(e["requestURI"]) in ("binding", "status"))
    binds = sum(1 for e in sched if e["code"] in (200, 201)
                and _pod_subresource(e["requestURI"]) == "binding")
    forbidden = collections.Counter(
        f"{e['verb']} {_audit_resource(e['requestURI'])}" for e in sched
        if e["code"] == 403)
    flows = {level: n.get("system:kube-scheduler", 0)
             for level, n in report["dispatched"].items()
             if n.get("system:kube-scheduler")}
    out = {**_leg(summary), "checks": checks,
           "scheduler_requests": len(sched),
           "scheduler_binding_requests": binds,
           "scheduler_refused_bind_or_status": {
               f"{c} {sub}": n for (c, sub), n in refused.items()},
           "scheduler_403_by_resource": dict(forbidden),
           "scheduler_dispatched_by_level": flows,
           "apf_rejected": report["rejected"],
           "audit_events": len(report["audit"]),
           "audit_codes": dict(collections.Counter(
               e["code"] for e in report["audit"])),
           "card": smi, "seconds": time.perf_counter() - t0}
    check(not refused, f"secured: the scheduler's binding or status "
                       f"requests were refused: {dict(refused)}")
    check(binds > 0, "secured: no binding request of the scheduler in the "
                     "audit log")
    check(flows.get("system", 0) > 0,
          f"secured: the scheduler's requests were not dispatched at the "
          f"system level: {flows}")
    return out


def frontdoor_phase(device=None, smi="", pods=EXPLAINAB_PODS,
                    nodes=EXPLAINAB_NODES):
    """ConnectedChurn behind the front door: ``FrontDoorCluster(n=3)``
    (``store/frontdoor.py``: three raft nodes, an APIServer on each) in one
    spawned process. The seed, the watcher, the churn and the runner
    spread over the three endpoints (writes that reach a follower get 421
    and follow its leader hint); the auditor reads the leader. Gates:
    those of the connected run (every pod bound, 0 violations, divergences,
    loop errors and oracle pods); each follower's ``/frontdoor/status``
    counted reads; at the end, once each replica's replay lag is under the
    cluster's 2 s, each replica holds the leader's pods on the leader's
    nodes. Reported: pods/s, attempt p50/p99, the 421s, the leader's commit
    wait. -> summary."""
    import multiprocessing as mp
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.store.frontdoor import fetch_status
    from kubernetes_tpu_torch.store.frontdoor import serve as serve_frontdoor
    ctx = mp.get_context("spawn")
    node_dicts, pod_dicts = connected_workload(pods=pods, nodes=nodes)
    t0 = time.perf_counter()
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=serve_frontdoor, args=(child,),
                       kwargs={"n": FRONTDOOR_NODES}, daemon=True)
    proc.start()
    try:
        check(parent.poll(120.0), "frontdoor: the cluster did not start")
        info = parent.recv()
        endpoints, leader0 = info["endpoints"], info["leader"]
        summary, runner = connected_run(
            ctx, endpoints, node_dicts, pod_dicts, device=device, smi=smi,
            what="frontdoor", churn_ops=CHURN_MIN_OPS, audit_url=leader0)
        del runner

        def pods_on(url):
            return {f"{p['metadata']['namespace']}/{p['metadata']['name']}":
                    p["spec"].get("nodeName", "")
                    for p in HTTPClient(url, timeout=60.0,
                                        wire="json").pods(None).list()}

        deadline = time.perf_counter() + FRONTDOOR_CONVERGE_S
        while True:
            status = {url: fetch_status(url, timeout=10.0)
                      for url in endpoints}
            leaders = [u for u, st in status.items()
                       if st and st["role"] == "leader"]
            replicas = [u for u, st in status.items()
                        if st and st["role"] == "replica"]
            fresh = (len(leaders) == 1 and len(replicas) == len(endpoints) - 1
                     and all(status[u]["replayLagMs"] is not None
                             and status[u]["replayLagMs"] < 2000.0
                             for u in replicas))
            if fresh:
                want = pods_on(leaders[0])
                differ = [u for u in replicas if pods_on(u) != want]
                if not differ:
                    break
            check(time.perf_counter() < deadline,
                  f"frontdoor: the replicas did not converge on the "
                  f"leader in {FRONTDOOR_CONVERGE_S} s: {status}")
            time.sleep(0.5)
    finally:
        try:
            parent.send("stop")
        except (OSError, EOFError):
            pass
        stop_process(proc)
    reads = {u: status[u]["reads"] for u in endpoints}
    out = {**_leg(summary), "endpoints": len(endpoints),
           "leader_moved": leaders[0] != leader0,
           "reads": {f"{status[u]['role']}:{u.rsplit(':', 1)[1]}": n
                     for u, n in reads.items()},
           "not_leader_421": sum(st["notLeader"] for st in status.values()),
           "leader_commit_wait": status[leaders[0]]["commitWait"],
           "replay_lag_ms": {u: status[u]["replayLagMs"] for u in replicas},
           "pods_converged": len(want),
           "card": smi, "seconds": time.perf_counter() - t0}
    check(all(reads[u] > 0 for u in replicas),
          f"frontdoor: a replica served no read: {out['reads']}")
    return out


# ------------------------------------------------------------- controllers

# ControllerLoad/100Nodes3000Pods: clusterloader2's load test
# (kubernetes/perf-tests clusterloader2/testing/load/config.yaml) as the
# gce-100 performance jobs run it: PODS_PER_NODE 30 and NODES_PER_NAMESPACE
# 100 give one namespace of 3000 pods; a quarter of them in big
# Deployments (250 replicas), a quarter in medium ones (30), half in small
# ones (5), and a Service in front of each big and medium Deployment
CTRL_NODES = 100
CTRL_NS = "load"
CTRL_DEPLOYMENTS = (("big", 3, 250), ("medium", 25, 30), ("small", 300, 5))
CTRL_SERVICES = ("big", "medium")
# uniform nodes; a pod's requests small enough that 30 pods fit a node
CTRL_NODE_ALLOCATABLE = {"cpu": "2", "memory": "7680Mi", "pods": "110"}
CTRL_POD_REQUESTS = {"cpu": "10m", "memory": "10Mi"}
CTRL_IMAGE, CTRL_IMAGE_UPDATED = "registry.k8s.io/pause:3.9", \
    "registry.k8s.io/pause:3.10"
CTRL_SCALE = (0.5, 1.5)    # the scale step's seeded factor a Deployment
CTRL_FAILED_NODES = 5
CTRL_STEP_TIMEOUT_S = 240.0
CTRL_POLL_S = 0.5


def serve_controller_manager(conn, url):
    """Child process: the port's ControllerManager, its DEFAULT_CONTROLLERS
    over ``HTTPClient(url, wire="json")``, leader-elected. Sends the names
    of the controllers it runs once it leads, then waits for "stop" and
    answers with its report: the node lifecycle controller's evictions,
    the warnings and errors its controllers logged (a sync that fails is
    logged and requeued, as in the reference; the records are counted here
    instead of printed), each controller's syncs with their CPU seconds,
    and the seconds and deletions of each garbage-collector sweep that
    deleted something. An exception anywhere else ends the process with a
    non-zero exit code."""
    import logging
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.controllers.manager import ControllerManager
    logged = {"warnings": [], "errors": []}

    class _Kept(logging.Handler):
        def emit(self, record):
            exc = record.exc_info[1] if record.exc_info else None
            msg = record.getMessage() + (f": {exc!r}" if exc else "")
            logged["errors" if record.levelno >= logging.ERROR
                   else "warnings"].append(msg[:300])

    logging.getLogger("kubernetes_tpu_torch.controllers").addHandler(
        _Kept(logging.WARNING))
    mgr = ControllerManager(HTTPClient(url, wire="json"), leader_elect=True)
    # instrumentation, read-only: each controller's syncs and the CPU time
    # of their threads in them (time.thread_time: not the interpreter
    # lock's waits)
    syncs: dict = {}

    def timed(name, sync):
        def run(key):
            t = time.thread_time()
            try:
                return sync(key)
            finally:
                n, cpu = syncs.get(name, (0, 0.0))
                syncs[name] = (n + 1, cpu + time.thread_time() - t)
        return run
    for c in mgr.controllers:
        c.sync = timed(c.name, c.sync)
    sweeps = []   # (wall seconds, deletions) of each garbage-collector sweep
    if mgr.gc is not None:
        sweep = mgr.gc.sweep

        def timed_sweep():
            t = time.perf_counter()
            n = sweep()
            sweeps.append((time.perf_counter() - t, n))
            return n
        mgr.gc.sweep = timed_sweep
    mgr.start(wait_sync=120.0)
    if not mgr.factory.wait_for_cache_sync(1.0):
        raise RuntimeError("the controller manager's informers did not sync")
    end = time.monotonic() + 60.0
    while not mgr._started:
        if time.monotonic() > end:
            raise RuntimeError("the controller manager did not lead in 60 s")
        time.sleep(0.05)
    conn.send({"controllers": [c.name for c in mgr.controllers]})
    conn.recv()
    life = [c for c in mgr.controllers if c.name == "nodelifecycle"]
    report = {"evictions": life[0].evictions if life else None,
              "disruption_mode": life[0].mode if life else None,
              "warnings": len(logged["warnings"]),
              "errors": len(logged["errors"]),
              "first_warnings": logged["warnings"][:5],
              "first_errors": logged["errors"][:5],
              "syncs": {name: {"count": n, "cpu_s": cpu} for name, (n, cpu)
                        in sorted(syncs.items(), key=lambda kv: -kv[1][1])
                        if n},
              "gc_sweeps": [{"s": t, "deleted": n} for t, n in sweeps
                            if n]}
    mgr.stop()
    conn.send(report)


def serve_hollow_fleet(conn, url, n_nodes):
    """Child process: the nodes' kubelets, as the load test runs them on
    kubemark. The port's ``HollowCluster`` over ``HTTPClient(url,
    wire="json")`` registers ``n_nodes`` hollow kubelets in bulk, each with
    CTRL_NODE_ALLOCATABLE, heartbeating at the fleet's default period;
    they take every pod bound to them to Running with a pod IP and
    Ready=True through the fleet's status batcher, and keep their nodes
    fresh through the heartbeat and lease batchers. Sends the node names
    once the fleet watches pods, then answers:

    - ("out", names): take those kubelets out of service as
      ``HollowCluster.remove_node`` does (marked dead, out of the watch
      fan-out and the heartbeat and lease batchers, their pod workers
      stopped) but leave their Node objects: a node failure, not a
      scale-down. -> "ok";
    - "stats": -> the fleet's running pods and ``fleet_stats()``;
    - "stop": stops the fleet, -> its last stats."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.kubelet.kubemark import HollowCluster
    fleet = HollowCluster(HTTPClient(url, timeout=60.0, wire="json"),
                          n_nodes, prefix="load-node",
                          allocatable=dict(CTRL_NODE_ALLOCATABLE))
    fleet.start(wait_sync=120.0)

    def stats() -> dict:
        return {"running_pods": fleet.running_pods(),
                "fleet": fleet.fleet_stats()}

    conn.send([hn.kubelet.node_name for hn in fleet.nodes])
    while True:
        msg = conn.recv()
        if msg == "stop":
            break
        if msg == "stats":
            conn.send(stats())
            continue
        _, names = msg
        for name in names:
            kubelet = fleet._by_name.pop(name)
            kubelet.dead = True
            fleet.nodes = [hn for hn in fleet.nodes
                           if hn.kubelet.node_name != name]
            fleet._heartbeats.remove(name)
            fleet._leases.remove(name)
            kubelet.workers.stop()
        conn.send("ok")
    fleet.stop()
    conn.send(stats())


def process_cpu_s(pid) -> float:
    """User plus system CPU seconds of process ``pid`` so far, from
    /proc/<pid>/stat (read-only; 0.0 where there is no /proc)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rpartition(")")[2].split()
    except OSError:
        return 0.0
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def ctrl_workload(deployments=CTRL_DEPLOYMENTS):
    """The load test's objects (its nodes are the hollow fleet's): the
    namespace, its Deployments (one pod template each: app=<name>, the
    pause image, CTRL_POD_REQUESTS; RollingUpdate at the default
    25%/25%) and a Service in front of each big and medium one. ->
    (namespace, deployments, services)."""
    namespace = {"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": CTRL_NS}}
    deps, svcs = [], []
    for size, count, replicas in deployments:
        for i in range(count):
            name = f"{size}-{i}"
            deps.append({
                "apiVersion": "apps/v1", "kind": "Deployment",
                "metadata": {"name": name, "namespace": CTRL_NS},
                "spec": {
                    "replicas": replicas,
                    "selector": {"matchLabels": {"app": name}},
                    "strategy": {"type": "RollingUpdate", "rollingUpdate": {
                        "maxSurge": "25%", "maxUnavailable": "25%"}},
                    "template": {
                        "metadata": {"labels": {"app": name,
                                                "size": size}},
                        "spec": {"containers": [{
                            "name": "pause", "image": CTRL_IMAGE,
                            "ports": [{"containerPort": 8080}],
                            "resources": {"requests": dict(
                                CTRL_POD_REQUESTS)}}]}}},
                "status": {}})
            if size in CTRL_SERVICES:
                svcs.append({
                    "apiVersion": "v1", "kind": "Service",
                    "metadata": {"name": name, "namespace": CTRL_NS},
                    "spec": {"selector": {"app": name},
                             "ports": [{"port": 80, "targetPort": 8080}]}})
    return namespace, deps, svcs


def _ready(pod) -> bool:
    return any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in (pod.get("status") or {}).get("conditions") or [])


def deployments_lagging(deps, updated=False) -> list:
    """The Deployments whose status is not at their spec: available, ready
    and (``updated``) updated replicas."""
    out = []
    for d in deps:
        want = int(d["spec"].get("replicas", 1))
        st = d.get("status") or {}
        keys = ("availableReplicas", "readyReplicas", "replicas") + (
            ("updatedReplicas",) if updated else ())
        got = {k: int(st.get(k, 0)) for k in keys}
        if any(v != want for v in got.values()):
            out.append(f"deployment {d['metadata']['name']}: {got} of {want}")
    return out


def ctrl_failures(deps, rses, pods, endpoints, slices, services,
                  updated=False) -> list:
    """What keeps the namespace from the state its Deployments and
    Services ask for (empty when it holds): each Deployment available at
    its spec (``updated``: every replica of its newest ReplicaSet, every
    older ReplicaSet at 0), no pod beyond the Deployments' replicas, every
    pod bound, Running and Ready, and each Service's Endpoints and
    EndpointSlices holding exactly the pod IPs of its ready pods."""
    from kubernetes_tpu_torch.controllers.deployment import (HASH_LABEL,
                                                             template_hash)
    out = deployments_lagging(deps, updated)
    if updated:
        current = {d["metadata"]["name"]: template_hash(d) for d in deps}
        for rs in rses:
            owner = (rs["metadata"].get("ownerReferences") or [{}])[0]
            if (rs["metadata"].get("labels") or {}).get(HASH_LABEL) == \
                    current.get(owner.get("name")):
                continue
            n = (int(rs["spec"].get("replicas", 0)),
                 int((rs.get("status") or {}).get("replicas", 0)))
            if n != (0, 0):
                out.append(f"old replicaset {rs['metadata']['name']}: "
                           f"spec, status replicas {n}")
    want = sum(int(d["spec"].get("replicas", 1)) for d in deps)
    if len(pods) != want:
        out.append(f"{len(pods)} pods for {want} replicas")
    lagging = [p["metadata"]["name"] for p in pods
               if not p["spec"].get("nodeName") or not _ready(p)]
    if lagging:
        out.append(f"{len(lagging)} pods not bound and ready "
                   f"(first {lagging[:3]})")
    ready = {}
    for p in pods:
        if _ready(p) and (p.get("status") or {}).get("podIP"):
            ready.setdefault(p["metadata"]["labels"]["app"], set()).add(
                p["status"]["podIP"])
    eps = {e["metadata"]["name"]: e for e in endpoints}
    by_svc = {}
    for s in slices:
        svc = (s["metadata"].get("labels") or {}).get(
            "kubernetes.io/service-name")
        by_svc.setdefault(svc, []).extend(s.get("endpoints") or [])
    for svc in services:
        name = svc["metadata"]["name"]
        want_ips = ready.get(name, set())
        subsets = (eps.get(name) or {}).get("subsets") or []
        addrs = {a["ip"] for s in subsets for a in s.get("addresses") or []}
        not_ready = [a for s in subsets
                     for a in s.get("notReadyAddresses") or []]
        if addrs != want_ips or not_ready:
            out.append(f"endpoints {name}: {len(addrs)} addresses "
                       f"({len(not_ready)} not ready) for {len(want_ips)} "
                       "ready pods")
        ends = by_svc.get(name, [])
        slice_ips = sorted(e["addresses"][0] for e in ends
                           if (e.get("conditions") or {}).get("ready"))
        if sorted(want_ips) != slice_ips or len(ends) != len(slice_ips):
            out.append(f"endpointslices {name}: {len(slice_ips)} ready of "
                       f"{len(ends)} endpoints for {len(want_ips)} ready "
                       "pods")
    return out


def controllers_phase(device=None, smi="", seed=SEED, n_nodes=CTRL_NODES,
                      deployments=CTRL_DEPLOYMENTS,
                      n_failed=CTRL_FAILED_NODES,
                      step_timeout_s=CTRL_STEP_TIMEOUT_S):
    """ControllerLoad/100Nodes3000Pods: clusterloader2's load test on 100
    nodes through the port's controllers and the connected scheduler on
    the card. Processes: the port's APIServer (spawned, no admission: the
    pods carry no default 300 s not-ready toleration, so an eviction
    follows its taint); the port's ControllerManager with its
    DEFAULT_CONTROLLERS, leader-elected, in a spawned process of its own
    (serve_controller_manager); the nodes' kubelets, 100 hollow kubelets
    of the port's ``HollowCluster`` in a spawned process of their own
    (serve_hollow_fleet), which register the nodes, heartbeat, renew
    their leases and run the bound pods; and the
    SchedulerRunner here, on the card (reference defaults; the sentinel
    every 4th drain and a fail-fast auditor every 2 s, as in the
    connected phase), whose binder is wrapped to time the bindings.
    Steps, each gated within ``step_timeout_s`` and timed:

    1. saturate: the 328 Deployments and 28 Services created; every
       Deployment available at its spec, every pod bound and ready, each
       Service's Endpoints and EndpointSlices exactly its ready pods;
       pods/s from the first Deployment's create to the last binding;
    2. scale and update: every Deployment scaled to a seeded 0.5-1.5x of
       its size, the big ones' pod template changed (a rolling update at
       the default 25%/25%); every Deployment's updated, available and
       ready replicas at its spec, every old ReplicaSet at 0;
    3. node failure: 5 nodes' kubelets taken out of service (no more
       heartbeats or lease renewals; their Node objects stay), then
       Ready=False written into those nodes' status; those 5 must get the
       node.kubernetes.io/not-ready NoExecute taint, their pods evicted
       and replaced, the replacements bound off them, every Deployment
       back at its spec;
    4. delete: every Service and Deployment deleted, as the load test's
       clean-up deletes them; the endpoint controllers leave 0 Endpoints
       and 0 EndpointSlices, the garbage collector 0 ReplicaSets and 0
       pods in the namespace, and the fleet runs 0 pods.

    Gates besides: the manager and the fleet alive until the phase stops
    them, then the manager's exit code 0; no node but the 5 failed ever
    tainted not-ready or unreachable (every node event the runner's
    informer sees is read: the other kubelets' heartbeats and leases keep
    their nodes fresh against the node lifecycle controller's 40 s grace);
    0 loop errors, 0 audit violations, 0 sentinel
    divergences, breaker "single", 0 pods through the oracle. Reported:
    each step's seconds and each process's CPU seconds in it (apiserver,
    manager, fleet, this one), step 1's pods/s, attempt p50/p99, the
    manager's evictions, logged warnings and errors and garbage-collector
    sweeps, the fleet's heartbeat, lease and status flushes and their
    errors, count_pn's launches (0 expected: the load test's pods carry no
    topology term). -> summary."""
    import multiprocessing as mp
    import random
    from concurrent.futures import ThreadPoolExecutor
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.audit.auditor import (InvariantAuditor,
                                                    InvariantViolationError)
    from kubernetes_tpu_torch.client.clientset import ApiError, HTTPClient
    from kubernetes_tpu_torch.controllers.nodelifecycle import (
        TAINT_NOT_READY, TAINT_UNREACHABLE)
    from kubernetes_tpu_torch.metrics.registry import (ATTEMPT_DURATION,
                                                       LOOP_ERRORS)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner
    from kubernetes_tpu_torch.utils.tracing import TRACER
    LIFECYCLE_TAINTS = (TAINT_NOT_READY, TAINT_UNREACHABLE)
    rng = random.Random(seed)
    namespace, dep_dicts, svc_dicts = ctrl_workload(deployments)
    n_pods = sum(d["spec"]["replicas"] for d in dep_dicts)
    ctx = mp.get_context("spawn")
    t_phase = time.perf_counter()
    server, server_pipe, url = start_apiserver(ctx)
    runner = mgr = fleet = None
    mgr_pipe = fleet_pipe = None
    mgr_report = fleet_report = None
    summary = {"nodes": n_nodes, "deployments": len(dep_dicts),
               "services": len(svc_dicts), "pods": n_pods,
               "failed_nodes": n_failed, "card": smi}
    steps = {}
    tainted = {}  # node -> the lifecycle taints it was ever seen with
    cpu = {}     # step -> {process: CPU seconds in the step}
    cpu_at = {}  # process -> CPU seconds at the last step's end

    def cpu_split(step) -> None:
        """Each process's CPU seconds since the last step ended."""
        now = {"apiserver": process_cpu_s(server.pid),
               "manager": process_cpu_s(mgr.pid),
               "fleet": process_cpu_s(fleet.pid),
               "scheduler": process_cpu_s(os.getpid())}
        if step is not None:
            cpu[step] = {k: v - cpu_at.get(k, 0.0) for k, v in now.items()}
        cpu_at.update(now)

    def alive() -> None:
        check(runner.loop_error is None,
              f"controllers: the scheduling loop died: {runner.loop_error!r}")
        check(mgr.is_alive(), "controllers: the controller manager died "
                              f"(exit code {mgr.exitcode})")
        check(fleet.is_alive(), "controllers: the hollow fleet died "
                                f"(exit code {fleet.exitcode})")

    def state():
        c = seed_client
        return (c.resource("deployments", CTRL_NS).list(),
                c.resource("replicasets", CTRL_NS).list(),
                c.pods(CTRL_NS).list(),
                c.resource("endpoints", CTRL_NS).list(),
                c.resource("endpointslices", CTRL_NS).list())

    def lagging(updated=False) -> list:
        """The Deployments not at spec yet: a poll that reads the pods, the
        ReplicaSets and the endpoints only once none lags (each list of
        every pod loads the apiserver and this process, which runs the
        scheduler)."""
        return deployments_lagging(
            seed_client.resource("deployments", CTRL_NS).list(), updated)

    def until(step, t0, ok, what):
        """Poll ``ok() -> list of failures`` until it is empty."""
        while True:
            alive()
            fails = ok()
            if not fails:
                steps[step] = time.perf_counter() - t0
                cpu_split(step)
                return
            check(time.perf_counter() - t0 < step_timeout_s,
                  f"controllers: {what} not reached in {step_timeout_s} s: "
                  f"{len(fails)} failures, first {fails[:3]}")
            time.sleep(CTRL_POLL_S)

    def held(updated=False):
        def ok():
            fails = lagging(updated)
            if fails:
                return fails
            deps, rses, pods, eps, slices = state()
            return ctrl_failures(deps, rses, pods, eps, slices, svc_dicts,
                                 updated=updated)
        return ok

    def retried(fn, attempts=20):
        """A read-modify-write that a controller's status write can race."""
        for i in range(attempts):
            try:
                return fn()
            except ApiError as e:
                if e.code != 409 or i == attempts - 1:
                    raise
                time.sleep(0.05)

    try:
        seed_client = HTTPClient(url, timeout=120.0, wire="json")
        seed_client.resource("namespaces", None).create(namespace)
        # the hollow fleet (it registers the nodes) and the controller
        # manager, each in its own process
        t0 = time.perf_counter()
        fleet_pipe, child = ctx.Pipe()
        fleet = ctx.Process(target=serve_hollow_fleet,
                            args=(child, url, n_nodes), daemon=True)
        fleet.start()
        check(fleet_pipe.poll(180.0), "controllers: the hollow fleet did "
                                      f"not start (exit code {fleet.exitcode})")
        node_names = fleet_pipe.recv()
        check(len(node_names) == n_nodes
              and len(seed_client.nodes().list()) == n_nodes,
              f"controllers: the fleet registered {len(node_names)} of "
              f"{n_nodes} nodes")
        summary["fleet_start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr_pipe, child = ctx.Pipe()
        mgr = ctx.Process(target=serve_controller_manager, args=(child, url),
                          daemon=True)
        mgr.start()
        check(mgr_pipe.poll(180.0),
              "controllers: the controller manager did not lead "
              f"(exit code {mgr.exitcode})")
        summary["manager_controllers"] = mgr_pipe.recv()["controllers"]
        summary["manager_start_s"] = time.perf_counter() - t0
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
        check(runner.has_synced(), "controllers: the informers did not sync")
        summary["informer_sync_s"] = time.perf_counter() - t0

        def saw_node(_type, obj, _old) -> None:
            """Instrumentation, read-only: every lifecycle taint a node
            event carries."""
            for t in (obj.get("spec") or {}).get("taints") or []:
                if t.get("key") in LIFECYCLE_TAINTS:
                    tainted.setdefault(obj["metadata"]["name"], set()).add(
                        t["key"])
        runner.factory.informer("nodes", None).add_event_handler(saw_node)
        sched = runner.scheduler
        pop = cfg.batch_size * cfg.max_drain_batches
        samples = [Pod.from_dict({**d["spec"]["template"], "metadata": {
            **d["spec"]["template"]["metadata"], "name": f"warm-{i}",
            "namespace": CTRL_NS}}) for i, d in enumerate(dep_dicts[:pop])]
        t0 = time.perf_counter()
        check(sched.warm_drain(samples, slot_headroom=2 * n_pods + pop),
              "controllers: warm_drain did not arm the context")
        summary["warm_drain_s"] = time.perf_counter() - t0
        # instrumentation, read-only: when each binding succeeded (one at
        # a time, or many in one request)
        binds = []
        binder, bulk_binder = sched.binder, sched._bulk_binder

        def timed_binder(pod, node):
            ok = binder(pod, node)
            if ok:
                binds.append(time.perf_counter())
            return ok

        def timed_bulk_binder(pairs):
            oks = bulk_binder(pairs)
            now = time.perf_counter()
            binds.extend(now for ok in oks if ok)
            return oks
        sched.binder, sched._bulk_binder = timed_binder, timed_bulk_binder
        errors0 = dict(LOOP_ERRORS.items())
        ATTEMPT_DURATION.reset()
        TRACER.reset()
        kernels.reset_launches()
        cpu_split(None)
        runner.start_loop()

        # 1. saturate
        t0 = time.perf_counter()
        deps_api = seed_client.resource("deployments", CTRL_NS)
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(deps_api.create, dep_dicts))
            list(pool.map(seed_client.services(CTRL_NS).create, svc_dicts))
        summary["create_s"] = time.perf_counter() - t0
        until("saturate", t0, held(), "saturation")
        summary["saturate_binds"] = len(binds)
        summary["saturate_last_bind_s"] = binds[-1] - t0 if binds else None
        summary["pods_per_s"] = (n_pods / (binds[-1] - t0)) if binds else 0.0

        # 2. scale each Deployment, roll the big ones' template
        t0 = time.perf_counter()
        scaled = {}

        def scale(d):
            name = d["metadata"]["name"]
            r = d["spec"]["replicas"]
            n = max(1, round(r * rng.uniform(*CTRL_SCALE)))
            scaled[name] = n

            def write():
                cur = deps_api.get(name)
                cur["spec"]["replicas"] = n
                if name.startswith("big-"):
                    cur["spec"]["template"]["spec"]["containers"][0][
                        "image"] = CTRL_IMAGE_UPDATED
                return deps_api.update(cur)
            retried(write)
        for d in dep_dicts:   # in order: the draws are seeded
            scale(d)
        summary["scaled_pods"] = sum(scaled.values())
        until("scale_update", t0, held(updated=True),
              "the scaled, updated Deployments")

        # 3. node failure: n_failed kubelets out of service, then
        # Ready=False into their nodes' status
        failed = sorted(rng.sample(node_names, n_failed))
        on_failed = [p["metadata"]["name"]
                     for p in seed_client.pods(CTRL_NS).list()
                     if p["spec"].get("nodeName") in failed]
        summary["pods_on_failed_nodes"] = len(on_failed)
        check(not tainted, f"controllers: nodes tainted before any failed: "
                           f"{sorted(tainted)[:5]}")
        t0 = time.perf_counter()
        fleet_pipe.send(("out", failed))
        check(fleet_pipe.poll(60.0) and fleet_pipe.recv() == "ok",
              "controllers: the fleet did not take the failed kubelets out")
        rewrites = []

        def not_ready(name) -> None:
            """Ready=False into the node's status, unless it holds it (a
            heartbeat that was in flight when its kubelet went out of
            service may land after the first write: counted)."""
            def write():
                node = seed_client.nodes().get(name)
                conds = (node.get("status") or {}).get("conditions") or []
                if any(c.get("type") == "Ready" and c.get("status")
                       == "False" for c in conds):
                    return None
                node.setdefault("status", {})["conditions"] = [
                    {"type": "Ready", "status": "False",
                     "reason": "KubeletNotReady",
                     "lastHeartbeatTime": time.time()}]
                rewrites.append(name)
                return seed_client.nodes().update_status(node)
            retried(write)
        for name in failed:
            not_ready(name)

        def failed_out():
            fails = []
            for name in failed:
                not_ready(name)
                taints = seed_client.nodes().get(name)["spec"].get(
                    "taints") or []
                if not any(t.get("key") == TAINT_NOT_READY
                           and t.get("effect") == "NoExecute"
                           for t in taints):
                    fails.append(f"node {name} lacks the not-ready taint")
            fails += lagging(updated=True)
            if fails:
                return fails
            deps, rses, pods, eps, slices = state()
            left = [p["metadata"]["name"] for p in pods
                    if p["spec"].get("nodeName") in failed]
            if left:
                fails.append(f"{len(left)} pods on the failed nodes")
            gone = set(on_failed) & {p["metadata"]["name"] for p in pods}
            if gone:
                fails.append(f"{len(gone)} of their pods not evicted")
            return fails + ctrl_failures(deps, rses, pods, eps, slices,
                                         svc_dicts, updated=True)
        until("node_failure", t0, failed_out, "recovery from node failure")
        summary["ready_rewrites"] = len(rewrites) - n_failed

        # 4. delete every Service and Deployment, as the load test's
        # clean-up does: the endpoint controllers delete their objects, the
        # garbage collector cascades
        t0 = time.perf_counter()
        svcs_api = seed_client.services(CTRL_NS)
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(lambda s: svcs_api.delete(s["metadata"]["name"]),
                          svc_dicts))
            list(pool.map(lambda d: deps_api.delete(d["metadata"]["name"]),
                          dep_dicts))

        pod_store = runner.factory.informer("pods", None).store

        def collected():
            """The ReplicaSets, Endpoints, EndpointSlices and pods left:
            the pods counted in the runner's informer until it holds none
            of the namespace, then listed (a list of every pod while the
            collector deletes them loads the apiserver that serves its
            deletes)."""
            fails = [f"{len(objs)} {kind}" for kind in
                     ("replicasets", "endpoints", "endpointslices")
                     for objs in [seed_client.resource(kind, CTRL_NS).list()]
                     if objs]
            if fails:
                return fails
            left = sum(1 for k in pod_store.keys()
                       if k.startswith(CTRL_NS + "/"))
            if left:
                return [f"{left} pods in the runner's informer"]
            pods = seed_client.pods(CTRL_NS).list()
            if pods:
                return [f"{len(pods)} pods"]
            fleet_pipe.send("stats")
            running = fleet_pipe.recv()["running_pods"]
            return [f"the fleet runs {running} pods"] if running else []
        until("delete", t0, collected, "the clean-up")

        summary["launches"] = dict(kernels.LAUNCHES)
        q = {"result": "scheduled"}
        summary.update({
            "steps_s": steps, "steps_cpu_s": cpu, "binds": len(binds),
            "attempt_p50_s": ATTEMPT_DURATION.percentile(0.5, q),
            "attempt_p99_s": ATTEMPT_DURATION.percentile(0.99, q),
            "attempts_observed": ATTEMPT_DURATION.count(q)})
        by_site = {dict(k).get("site", "?"): n - errors0.get(k, 0)
                   for k, n in LOOP_ERRORS.items().items()
                   if n - errors0.get(k, 0)}
        summary["loop_errors"] = sum(by_site.values())
        summary["loop_errors_by_site"] = by_site
        summary["oracle_pods"] = sum(
            sp.attributes["pods"] for sp in TRACER.spans("scheduler/oracle"))
        summary["breaker"] = sched.breaker.mode
        summary["ctx_stats"] = json.loads(json.dumps(sched.ctx_stats))
        summary["full_encodes"] = runner.cache.stats()["full_encodes"]
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
        alive()
        mgr_pipe.send("stop")
        check(mgr_pipe.poll(60.0), "controllers: the controller manager did "
                                   "not report")
        mgr_report = mgr_pipe.recv()
        mgr.join(30.0)
        fleet_pipe.send("stop")
        check(fleet_pipe.poll(60.0), "controllers: the fleet did not report")
        fleet_report = fleet_pipe.recv()
    finally:
        if runner is not None:
            runner.stop()  # re-raises a fatal failure that ended the loop
        for proc, pipe in ((mgr, mgr_pipe), (fleet, fleet_pipe)):
            if proc is not None:
                stop_process(proc, pipe)
        stop_process(server, server_pipe)
    summary.update({"manager": mgr_report, "manager_exit_code": mgr.exitcode,
                    "fleet": fleet_report,
                    "tainted_nodes": {n: sorted(k)
                                      for n, k in sorted(tainted.items())},
                    "seconds": time.perf_counter() - t_phase})
    check(mgr.exitcode == 0,
          f"controllers: the controller manager exited {mgr.exitcode}")
    others = sorted(set(tainted) - set(failed))
    check(not others, f"controllers: {len(others)} nodes that did not fail "
                      f"were tainted: {summary['tainted_nodes']}")
    check(all(TAINT_NOT_READY in tainted.get(n, ()) for n in failed),
          f"controllers: a failed node was never seen tainted not-ready: "
          f"{summary['tainted_nodes']}")
    fl = fleet_report["fleet"]
    summary["fleet_flushes"] = {
        k: {"flushes": fl[k]["flushes"], "items": fl[k]["items"],
            "errors": fl[k]["errors"]} for k in ("heartbeat", "lease",
                                                 "status")}
    check(summary["audit"]["violations"] == 0,
          f"controllers: invariant violations {summary['audit']['byInvariant']}")
    check(summary["sentinel"]["divergences"] == 0,
          f"controllers: parity divergence {summary['sentinel']}")
    check(summary["loop_errors"] == 0,
          f"controllers: {summary['loop_errors']} loop errors "
          f"{summary['loop_errors_by_site']}")
    check(summary["breaker"] == "single",
          f"controllers: the breaker degraded to {summary['breaker']!r}")
    check(summary["oracle_pods"] == 0,
          f"controllers: {summary['oracle_pods']} pods went through the "
          "oracle")
    check(mgr_report["evictions"] >= summary["pods_on_failed_nodes"],
          f"controllers: {mgr_report['evictions']} evictions for "
          f"{summary['pods_on_failed_nodes']} pods on the failed nodes")
    return summary


# ----------------------------- the chaos harness, the scenario time machine

CHAOS_SEED = 0               # FaultSchedule.generate(0, profile="churn")
CHAOS_COOLDOWN_S = 5.0       # run_connected's breaker_cooldown_s under chaos
CHAOS_PARITY_EVERY = 4       # its parity_sample_every under chaos
CHAOS_SETTLE_S = 60.0        # the restore and the recovery waves, at most
CHAOS_WAVE_PODS = CONNECTED_BATCH + 1   # one deep pop: a drain on the card
CHAOS_WAVE_TIMEOUT_S = 120.0
KILL_NODES = 16              # benchmarks/disaster.py run_scheduler_kill's
KILL_PODS = 48               # defaults, from here down
KILL_CHURN_S = 4.0
KILL_BIND_SLO_S = 3.0        # reported, not gated: a host time
KILL_SETTLE_S = 120.0
KILL_TIMEOUT_S = 240.0
KILL_READY_S = 300.0
SCENARIO_SPEC = "builtin:smoke"   # bench.py's ScenarioReplay defaults
SCENARIO_SPEED = 4.0
SCENARIO_BATCH = 64
SCENARIO_TIMEOUT_S = 180.0


def chaos_unreached(schedule) -> list:
    """The fault classes whose op the run did not reach at their site:
    reported, not gated. Which they are depends on the run (the port
    writes pod status only to clear a stale nomination or a claim, each
    informer opens its watch once, the bind and resolver op indexes are
    reached only if enough pops come)."""
    return sorted(f.klass for f in schedule.faults
                  if schedule.peek(f.site) <= f.at)


def chaos_unfired(schedule) -> list:
    """The fault classes whose op the run reached and that did not fire:
    each is a fault of the harness or of the seam it wraps."""
    fired = schedule.report()["classes"]
    return [f.klass for f in schedule.faults
            if f.klass not in fired and schedule.peek(f.site) > f.at]


def chaos_settle(runner, schedule, seed_client, what):
    """The churn runs on (10 ms cadence) while the faults settle, at most
    CHAOS_SETTLE_S: until the breaker is back at ``single`` after a
    restore; then recovery waves (``chaos_recovery_wave``, at most 4)
    until a drain has run on the card past the ``device.drain`` burst (a
    failed drain drops the resident context, and only a deep pop builds
    it again, so each wave spends one op of the burst); then until no
    site that a fault hit is left without a healthy op after it (the
    churn's ops close them). -> what it saw: seconds, each stage's end,
    the waves, the op count of every site."""
    breaker = runner.scheduler.breaker
    t0 = time.perf_counter()
    end = t0 + CHAOS_SETTLE_S
    stages = {}

    def wait(pred):
        while not pred() and time.perf_counter() < end:
            check(runner.loop_error is None,
                  f"{what}: the scheduling loop died: {runner.loop_error!r}")
            time.sleep(0.05)
        return pred()

    drained = lambda: ("device.drain" not in  # noqa: E731
                       schedule.report()["unrecovered_sites"]
                       and schedule.peek("device.drain") > max(
                           f.at + f.count - 1 for f in schedule.faults
                           if f.site == "device.drain"))
    stages["restored"] = wait(lambda: breaker.mode == "single"
                              and breaker.restores >= 1)
    stages["restored_s"] = time.perf_counter() - t0
    waves = []
    while (stages["restored"] and not drained() and len(waves) < 4
           and time.perf_counter() < end):
        waves.append(chaos_recovery_wave(runner, schedule, seed_client,
                                         what, tag=len(waves)))
    stages["drained"] = drained()
    stages["drained_s"] = time.perf_counter() - t0
    stages["recovered"] = wait(
        lambda: not schedule.report()["unrecovered_sites"])
    return {"settle_s": time.perf_counter() - t0, "stages": stages,
            "waves": waves,
            "peeks": {site: schedule.peek(site)
                      for site in sorted({f.site for f in schedule.faults})}}


def chaos_recovery_wave(runner, schedule, seed_client, what, tag=0,
                        n_pods=CHAOS_WAVE_PODS):
    """After the restore: CHAOS_WAVE_PODS MixedHeterogeneous pods (named
    ``rw<tag>-*``, namespace ``default``) queued with the loop stopped,
    then the loop started, so that one deep pop takes them: a drain on the
    card with its count_pn launches, unless the drain's fault burst is not
    spent. -> the wave's numbers: pods bound, seconds, the drains
    dispatched (``drain_step`` calls at the ``device.drain`` seam) and
    those that failed, launches."""
    from kubernetes_tpu_torch.metrics.registry import LOOP_ERRORS
    from kubernetes_tpu_torch.ops import kernels
    restores = runner.scheduler.breaker.restores
    drain_failures0 = LOOP_ERRORS.get({"site": "device_drain"})
    _nodes, pod_dicts = connected_workload(pods=n_pods, nodes=EXPLAINAB_NODES,
                                           seed=SEED + 1 + tag)
    for d in pod_dicts:
        d["metadata"]["name"] = f"rw{tag}-" + d["metadata"]["name"]
    names = {d["metadata"]["name"] for d in pod_dicts}
    runner._stop_loop()
    seed_client.pods("default").create_many(pod_dicts)
    end = time.perf_counter() + 60.0
    while (runner.queue.stats()["active"] < n_pods
           and time.perf_counter() < end):
        time.sleep(0.02)
    queued = runner.queue.stats()["active"]
    launches0 = dict(kernels.LAUNCHES)
    drains0 = schedule.peek("device.drain")
    t0 = time.perf_counter()
    runner.start_loop()
    bound = 0
    end = t0 + CHAOS_WAVE_TIMEOUT_S
    while time.perf_counter() < end:
        check(runner.loop_error is None,
              f"{what}: the scheduling loop died in the recovery wave: "
              f"{runner.loop_error!r}")
        bound = sum(1 for p in seed_client.pods("default").list()
                    if p["metadata"]["name"] in names
                    and p["spec"].get("nodeName"))
        if bound == n_pods:
            break
        time.sleep(0.1)
    return {"pods": n_pods, "queued_at_start": queued, "bound": bound,
            "seconds": time.perf_counter() - t0,
            "restores_before": restores,
            "drain_failures": LOOP_ERRORS.get({"site": "device_drain"})
            - drain_failures0,
            "drains": schedule.peek("device.drain") - drains0,
            "launches": {k: n - launches0.get(k, 0)
                         for k, n in kernels.LAUNCHES.items()}}


def chaos_failures(summary, schedule) -> list:
    """ChaosChurnQueued's gates: no measured or recovery-wave pod lost;
    every fault class whose op the run reached fired (``chaos_unfired``;
    the others are reported, ``chaos_unreached``) and no site left
    unrecovered; the breaker
    back at ``single`` with at least one restore, and a drain on the card
    after it (the last recovery wave's: no drain failure, count_pn
    launched); 0 invariant violations and 0 sentinel divergences; no fatal
    error ended the loop. (``emit`` fails the phase on any
    ``device_preempt`` error.)"""
    failures = []
    ch = summary.get("chaos") or {}
    waves = ch.get("waves") or []
    lost = summary["pods"] - summary["bound"]
    wave_lost = sum(w["pods"] - w["bound"] for w in waves)
    if lost or wave_lost:
        failures.append(f"lost pods: {lost} measured, {wave_lost} of the "
                        "recovery waves")
    unfired = chaos_unfired(schedule)
    if unfired:
        failures.append(f"fault classes that never fired: {unfired}")
    rep = ch.get("recovery") or {}
    if rep.get("unrecovered_sites"):
        failures.append(f"unrecovered sites: {rep['unrecovered_sites']}")
    br = ch.get("breaker") or {}
    if br.get("mode") != "single" or br.get("restores", 0) < 1:
        failures.append(f"breaker {br} (want single after a restore)")
    last = waves[-1] if waves else {}
    if (not (ch.get("stages") or {}).get("drained")
            or last.get("restores_before", 0) < 1
            or last.get("drains", 0) < 1 or last.get("drain_failures")
            or not all(n >= 1 for n in (last.get("launches")
                                        or {"none": 0}).values())):
        failures.append(f"no drain on the card after the restore: "
                        f"stages {ch.get('stages')}, last wave {last}")
    if summary["audit"]["violations"]:
        failures.append(f"invariant violations "
                        f"{summary['audit']['byInvariant']}")
    if summary["sentinel"]["divergences"]:
        failures.append(f"sentinel divergences {summary['sentinel']}")
    if ch.get("loop_error") is not None:
        failures.append(f"the loop died: {ch['loop_error']}")
    return failures


CHAOS_CELL = "ChaosChurnQueued/2000x1000churn"


def chaos_churn(device=None, smi="", pods=EXPLAINAB_PODS,
                nodes=EXPLAINAB_NODES, seed=CHAOS_SEED):
    """ChaosChurnQueued: ``benchmarks/connected.py`` run_chaos_churn at its
    defaults (ConnectedChurn: 2000 MixedHeterogeneous pods on 1000 nodes,
    pops of 2 x 512, the churn loop to its 500 operations, under
    ``FaultSchedule.generate(seed, profile="churn")`` on the runner's
    transport, with ``DeviceChaos`` and ``ThreadChaos`` installed after
    the warm drain, the breaker's cooldown at 5 s, the sentinel on every
    4th drain and the fail-fast auditor on a clean client), through
    ``connected_run(chaos=...)``, but for one thing: the loop starts once
    the informer has queued the measured pods, where the reference starts
    it right after the creates. So the device faults land on the churn's
    pops, and the oracle never places measured pods: its pods/s and oracle
    count are not the reference's ChaosChurn's. Then ``chaos_settle``.
    Gates: ``chaos_failures``. -> summary."""
    import multiprocessing as mp
    from kubernetes_tpu_torch.chaos import FaultSchedule
    ctx = mp.get_context("spawn")
    schedule = FaultSchedule.generate(seed, profile="churn")
    node_dicts, pod_dicts = connected_workload(pods=pods, nodes=nodes)
    e0 = device_explain_errors()
    t0 = time.perf_counter()
    server, pipe, url = start_apiserver(ctx)
    try:
        summary, runner = connected_run(
            ctx, url, node_dicts, pod_dicts, device=device, smi=smi,
            what="chaos.churn", churn_ops=CHURN_MIN_OPS, chaos=schedule)
    finally:
        stop_process(server, pipe)
    del runner
    summary["device_explain_errors"] = device_explain_errors() - e0
    ch = summary["chaos"]
    out = {**_leg(summary), "cell": CHAOS_CELL, "seed": seed,
           "faults": [vars(f) for f in schedule.faults],
           "recovery": ch["recovery"], "peeks": ch["peeks"],
           "unreached": chaos_unreached(schedule),
           "settle_s": ch["settle_s"],
           "stages": ch["stages"], "waves": ch["waves"],
           "breaker_state": ch["breaker"],
           "resilience": ch["resilience"], "bind_retries": ch["bind_retries"],
           "loop_error": ch["loop_error"], "graphs": summary["graphs"],
           "seconds": time.perf_counter() - t0}
    out["failures"] = chaos_failures(summary, schedule)
    check(not out["failures"], f"chaos.churn: {out['failures']}")
    return out


def pod_churn(client, stop, stats, period_s=0.25):
    """``benchmarks/disaster.py`` _pod_churn_loop: a rolling window of
    short-lived pods in namespace ``churn`` (at most 4 live); errors are
    counted (the scheduler may be dead, the apiserver is not)."""
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    live, i = [], 0
    while not stop.is_set():
        try:
            pod = _wire([make_pod(f"churn-p{i}", "churn")
                         .req({"cpu": "100m"}).obj()])[0]
            client.pods("churn").create(pod)
            live.append(pod["metadata"]["name"])
            if len(live) > 4:
                client.pods("churn").delete(live.pop(0))
            stats["ops"] = stats.get("ops", 0) + 2
        except Exception as e:  # churn is load; the gates own correctness
            stats["errors"] = stats.get("errors", 0) + 1
            stats["last_error"] = repr(e)
        i += 1
        stop.wait(period_s)


def _unbound(client, namespaces=("default", "churn")) -> list:
    return [f"{ns}/{p['metadata']['name']}" for ns in namespaces
            for p in client.pods(ns).list()
            if not (p.get("spec") or {}).get("nodeName")]


class KillBoot:
    """SchedulerKill's cold boot (``SchedulerKill`` starts it beside the
    parity phases): an
    ``InProcessApiServer`` on a durable temporary directory with its 16
    nodes, and a ``SchedulerProcess`` on the card (``aotCacheDir`` on the
    same directory, the fail-fast auditor every 1 s, batches of 16, a
    warm ladder of 16 pods) started on a thread. ``join`` waits for the
    child's ready dict; ``stop`` ends the child and the server."""

    def __init__(self, device=None, n_nodes=KILL_NODES):
        self.device, self.n_nodes = device, n_nodes
        self.server = self.sched = self.ready = self.error = None
        self.boot_s = None
        self._thread = None

    def start(self) -> "KillBoot":
        import tempfile
        import threading
        from kubernetes_tpu_torch.chaos.apiserver import InProcessApiServer
        from kubernetes_tpu_torch.chaos.scheduler import SchedulerProcess
        from kubernetes_tpu_torch.client.clientset import HTTPClient
        from kubernetes_tpu_torch.testing.wrappers import make_node
        self.data_dir = tempfile.mkdtemp(prefix="ktpu-schedkill-")
        self.server = InProcessApiServer(
            data_dir=os.path.join(self.data_dir, "api"))
        self.server.start()
        HTTPClient(self.server.url, timeout=60.0).nodes().create_many(_wire([
            make_node(f"sk-n{i}").capacity(
                {"cpu": "8", "memory": "16Gi", "pods": "64"}).obj()
            for i in range(self.n_nodes)]))
        self.sched = SchedulerProcess(
            self.server.url,
            cfg={"aotCacheDir": os.path.join(self.data_dir, "aot-cache"),
                 "auditFailFast": True, "auditIntervalSeconds": 1.0,
                 "batchSize": 16,
                 "backoffInitialSeconds": 0.05, "backoffMaxSeconds": 0.5},
            warm={"pods": 16, "requests": {"cpu": "100m",
                                           "memory": "64Mi"}},
            device=self.device)

        def boot():
            t0 = time.perf_counter()
            try:
                self.ready = self.sched.start(ready_timeout=KILL_READY_S)
            except Exception as e:  # join() raises it
                self.error = e
            self.boot_s = time.perf_counter() - t0

        self._thread = threading.Thread(target=boot, daemon=True,
                                        name="kill-boot")
        self._thread.start()
        return self

    def join(self) -> dict:
        self._thread.join(KILL_READY_S)
        check(self.error is None and self.ready is not None,
              f"chaos.kill: the cold child did not boot: {self.error!r}")
        return self.ready

    def stop(self) -> list:
        """-> what failed in the teardown (reported; the gates decide)."""
        import shutil
        failures = []
        for closer in (self.sched, self.server):
            if closer is not None:
                try:
                    closer.stop()
                except Exception as e:
                    failures.append(f"teardown: {e!r}")
        shutil.rmtree(self.data_dir, ignore_errors=True)
        return failures


def scheduler_kill(boot, smi="", n_pods=KILL_PODS, churn_s=KILL_CHURN_S):
    """SchedulerKill as ``benchmarks/disaster.py`` run_scheduler_kill runs
    it at its defaults, from ``boot`` (a started ``KillBoot``: the
    apiserver, 16 nodes, the cold child): the child binds 48 pods, cold:
    it built the kernel library into the cache. Pod churn runs; at half
    its 4 s (the child's cache quiet) the child is SIGKILLed, and
    restarted at the end of it: warm, it loads the library and builds
    nothing. A probe pod's first bind after the restart is reported beside
    the reference's 3 s SLO and does not gate (a host time). Gates: the
    cold child built at least 1 library; the restarted child built 0 and
    loaded at least 1 cached entry; no pod lost or left unbound; 0
    violations and a fail-fast auditor that did not trip in the child; 0
    divergences; the restarted child's stats answered over the pipe.
    -> summary."""
    import threading
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.testing.wrappers import make_pod
    t_phase = time.perf_counter()
    result = {"workload": f"{boot.n_nodes}nodes_{n_pods}pods", "card": smi}
    failures = []
    churn_stop = threading.Event()
    churn_stats = {}
    sched, url = boot.sched, boot.server.url
    try:
        result["cold_ready"] = boot.join()
        result["cold_boot_s"] = boot.boot_s
        result["cold_boot_beside"] = "parity"
        seed_client = HTTPClient(url, timeout=60.0)
        t0 = time.perf_counter()
        seed_client.pods("default").create_many(_wire([
            make_pod(f"sk-{i}", "default")
            .req({"cpu": "100m", "memory": "64Mi"}).obj()
            for i in range(n_pods)]))
        while (_unbound(seed_client, ("default",))
               and time.perf_counter() - t0 < KILL_TIMEOUT_S):
            time.sleep(0.2)
        result["initial_bind_s"] = time.perf_counter() - t0
        threading.Thread(target=pod_churn,
                         args=(HTTPClient(url, timeout=30.0), churn_stop,
                               churn_stats),
                         daemon=True).start()
        time.sleep(churn_s / 2)
        # the cold child's cache quiet before the kill: builds and entries
        # no longer moving (the reference waits for compile quiescence)
        prev, cold = None, None
        end = time.perf_counter() + 30.0
        while time.perf_counter() < end:
            cold = sched.stats()
            cur = (cold["aotCache"].get("entries"),
                   cold["aotCache"].get("realBuilds"))
            if cur == prev:
                break
            prev = cur
            time.sleep(0.7)
        result["cold_stats"] = cold
        sched.kill()
        time.sleep(churn_s / 2)   # churn piles up against no scheduler
        result["restart_total_s"] = sched.restart(ready_timeout=KILL_READY_S)
        result["warm_ready"] = sched.ready
        probe = _wire([make_pod("probe-schedkill", "default")
                       .req({"cpu": "100m"}).obj()])[0]
        t0 = time.perf_counter()
        seed_client.pods("default").create(probe)
        bound_at = None
        while time.perf_counter() - t0 < 30.0:
            p = seed_client.pods("default").get("probe-schedkill")
            if (p.get("spec") or {}).get("nodeName"):
                bound_at = time.perf_counter() - t0
                break
            time.sleep(0.05)
        result["first_bind_after_restart_s"] = bound_at
        result["first_bind_slo_s"] = KILL_BIND_SLO_S
        result["first_bind_within_slo"] = (bound_at is not None
                                           and bound_at <= KILL_BIND_SLO_S)
        result["recovery_stats"] = sched.stats()
        churn_stop.set()
        time.sleep(1.0)
        end = time.perf_counter() + KILL_SETTLE_S
        while _unbound(seed_client) and time.perf_counter() < end:
            time.sleep(0.25)
        unbound = _unbound(seed_client)
        result["unbound"] = unbound[:20]
        result["churn"] = dict(churn_stats)
        try:
            stats = sched.stats()
        except Exception as e:  # the gate below names it
            stats = None
            failures.append(f"the restarted child's stats did not answer: "
                            f"{e!r}")
        result["child_stats"] = stats
    finally:
        churn_stop.set()
        failures.extend(boot.stop())
    cold_cache = (result.get("cold_stats") or {}).get("aotCache") or {}
    warm_cache = (result.get("recovery_stats") or {}).get("aotCache") or {}
    warm_boot = result["warm_ready"].get("aotCacheBoot") or {}
    if not cold_cache.get("realBuilds", 0) >= 1:
        failures.append(f"the cold child built no kernel library: "
                        f"{cold_cache}")
    if (warm_cache.get("realBuilds") != 0
            or not warm_cache.get("hits", 0) >= 1
            or not warm_boot.get("entries", 0) >= 1):
        failures.append(f"the restarted child did not load instead of "
                        f"building: boot {warm_boot}, stats {warm_cache}")
    if result["unbound"]:
        failures.append(f"{len(unbound)} pods never bound after the restart "
                        f"(first: {unbound[:5]})")
    if stats is not None:
        if stats["violations"] != 0 or stats["auditFailed"]:
            failures.append(f"the child's auditor: {stats['violations']} "
                            f"violations, failed {stats['auditFailed']}")
        if (stats.get("parity") or {}).get("divergences"):
            failures.append(f"parity divergence {stats['parity']}")
        if stats.get("loopError") is not None:
            failures.append(f"the child's loop died: {stats['loopError']}")
    result["failures"] = failures
    result["seconds"] = time.perf_counter() - t_phase
    check(not failures, f"chaos.kill: {failures}")
    return result


class SchedulerKill:
    """SchedulerKill (``scheduler_kill`` from a ``KillBoot``) on a thread,
    beside the parity phases (cut for time): its scheduler runs in child
    processes and its apiserver in this one, which records no span, launch
    or loop error; the parity phases time nothing. ``join`` waits for it
    (before the first timed path) and re-raises what failed it."""

    def __init__(self, device=None, smi=""):
        self.device, self.smi = device, smi
        self.out = {}
        self._thread = None

    def start(self) -> "SchedulerKill":
        import threading
        boot = KillBoot(device=self.device).start()

        def run():
            try:
                self.out["summary"] = scheduler_kill(boot, smi=self.smi)
            except BaseException as e:  # join() raises it
                self.out["error"] = e

        # a failed script ends the daemon thread and the child (a daemon
        # process) with it
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="kill")
        self._thread.start()
        return self

    def join(self) -> dict:
        self._thread.join(2 * KILL_READY_S + KILL_SETTLE_S)
        if "error" in self.out:
            raise self.out["error"]
        check("summary" in self.out, "chaos.kill: SchedulerKill did not "
                                     "finish")
        return self.out["summary"]


def chaos_phase(device=None, smi=""):
    """The chaos harness's ChaosChurnQueued on the card (``chaos_churn``;
    SchedulerKill runs earlier, ``SchedulerKill``). -> summary; its
    ``launches`` are this process's count_pn launches."""
    from kubernetes_tpu_torch.ops import kernels
    kernels.reset_launches()
    churn = chaos_churn(device=device, smi=smi)
    return {"churn": churn, "launches": dict(kernels.LAUNCHES), "card": smi}


def scenario_phase(device=None, smi="", spec=SCENARIO_SPEC,
                   speed=SCENARIO_SPEED, seed=SEED, batch=SCENARIO_BATCH):
    """ScenarioReplay as ``bench.py`` runs ``benchmarks/scenario.py``
    run_scenario_replay (``builtin:smoke``, speed 4, seed 0, batch 64):
    the trace's fleet seeded into the port's APIServer in a spawned
    process, ``SchedulerRunner(HTTPClient(url))`` on the card (pops of
    2 x 64, the explainer on, the sentinel every 16th drain) with the
    fail-fast auditor on a clean client, the trace's
    resident pods as the warm drain, the loop started, the driver
    replaying the trace through its own client. Gates: every
    trace-resident pod bound; ``plan()`` of two independent resolutions
    equal, and the live dispatch order equal to it; a p99 attempt
    latency for every phase with resident pods; the manifest's own SLO
    gates; 0 invariant violations, 0 divergences, 0 loop errors.
    -> summary."""
    import multiprocessing as mp
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.audit.auditor import (InvariantAuditor,
                                                    InvariantViolationError)
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    from kubernetes_tpu_torch.metrics.registry import (ATTEMPT_DURATION,
                                                       LOOP_ERRORS)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scenario import (ScenarioDriver, Trace,
                                               builtin_trace)
    from kubernetes_tpu_torch.sched.runner import SchedulerRunner

    def resolve():
        if spec.startswith("builtin:"):
            return builtin_trace(spec[len("builtin:"):], seed=seed)
        return Trace.load(spec)

    t_phase = time.perf_counter()
    trace = resolve()
    plan = ScenarioDriver(None, trace, publish=False).plan()
    plan2 = ScenarioDriver(None, resolve(), publish=False).plan()
    resident = trace.resident_pods()
    ctx = mp.get_context("spawn")
    server, pipe, url = start_apiserver(ctx)
    runner = None
    try:
        seed_client = HTTPClient(url, timeout=120.0, wire="json")
        fleet = trace.fleet_nodes()
        seed_client.nodes().create_many(fleet)
        # the reference's defaults beside its two settings: the explainer
        # on, the sentinel every 16th drain, the default feature gate
        cfg = sched_config(batch_size=batch, max_drain_batches=2,
                           explainer_enabled=True, parity_sample_every=16,
                           audit_interval_s=CONNECTED_AUDIT_S,
                           audit_fail_fast=True)
        runner = SchedulerRunner(HTTPClient(url, wire="json"), cfg,
                                 device=device)
        runner.auditor = InvariantAuditor(
            client=HTTPClient(url, timeout=60.0, wire="json"),
            cache=runner.cache, scheduler=runner.scheduler,
            interval_s=CONNECTED_AUDIT_S, fail_fast=True,
            pre_sweep=runner.sweep_stale_nominations,
            post_sweep=runner.publish_status,
            relists=runner._total_relists)
        runner.start(wait_sync=120.0, start_loop=False)
        warm_pods = [Pod.from_dict(trace.materialize(ev))
                     for ev in resident.values()]
        t0 = time.perf_counter()
        check(runner.scheduler.warm_drain(
            warm_pods, slot_headroom=len(warm_pods)
            + batch * runner.cfg.max_drain_batches),
            "scenario: warm_drain did not arm the context")
        warm_s = time.perf_counter() - t0
        errors0 = dict(LOOP_ERRORS.items())
        kernels.reset_launches()
        runner.start_loop()
        ATTEMPT_DURATION.reset()
        driver = ScenarioDriver(HTTPClient(url, wire="json"), trace,
                                speed=speed, bind_timeout_s=SCENARIO_TIMEOUT_S)
        replay = driver.run()
        q = {"result": "scheduled"}
        p99 = ATTEMPT_DURATION.percentile(0.99, q)
        p50 = ATTEMPT_DURATION.percentile(0.50, q)
        launches = dict(kernels.LAUNCHES)
        loop_error = runner.loop_error
        runner.auditor.stop()
        for _ in range(2):
            try:
                runner.auditor.run_once()
            except InvariantViolationError:
                pass  # counted below
        audit = runner.auditor.status()
        sentinel = runner.scheduler.sentinel
        sentinel.drain(120.0)
        by_site = {dict(k).get("site", "?"): n - errors0.get(k, 0)
                   for k, n in LOOP_ERRORS.items().items()
                   if n - errors0.get(k, 0)}
    finally:
        if runner is not None:
            runner.stop()
        stop_process(server, pipe)
    deterministic = plan == plan2 and replay["dispatch_order"] == plan
    wall = replay["wall_s"] or 1e-9
    out = {"spec": spec, "trace": replay["trace"], "seed": replay["seed"],
           "speed": speed, "events_total": replay["events_total"],
           "dispatched": replay["dispatched"],
           "dispatch_error_count": replay["error_count"],
           "dispatch_errors": replay["errors"][:10],
           "resident": replay["resident"], "bound": replay["bound"],
           "lost": replay["resident"] - replay["bound"],
           "completed": replay["completed"],
           "dispatch_s": replay["dispatch_s"], "wall_s": replay["wall_s"],
           "pods_per_s": replay["bound"] / wall, "skew": replay["skew"],
           "phases": replay["phases"], "attempt_p99_s": p99,
           "attempt_p50_s": p50, "deterministic": deterministic,
           "warm_drain_s": warm_s,
           "audit": {k: audit[k] for k in ("sweeps", "violations",
                                           "byInvariant", "failed")},
           "sentinel": sentinel.stats(), "loop_errors_by_site": by_site,
           "loop_error": None if loop_error is None else repr(loop_error),
           "launches": launches, "card": smi,
           "seconds": time.perf_counter() - t_phase}
    failures = []
    if out["lost"]:
        failures.append(f"{out['lost']} of {out['resident']} trace-resident "
                        "pods never bound")
    for ph, st in sorted(replay["phases"].items()):
        if st["pods"] and not isinstance(st.get("p99_attempt_latency_s"),
                                         (int, float)):
            failures.append(f"phase {ph!r}: p99 attempt latency missing "
                            f"({st['pods']} pods)")
    if not deterministic:
        failures.append("the dispatch order diverged from the plan, or two "
                        "resolutions of the spec planned differently")
    failures.extend(check_slo_gates(out, trace.manifest.slo_gates))
    if audit["violations"]:
        failures.append(f"invariant violations {audit['byInvariant']}")
    if out["sentinel"]["divergences"]:
        failures.append(f"sentinel divergences {out['sentinel']}")
    if by_site or loop_error is not None:
        failures.append(f"loop errors {by_site}, loop error {loop_error!r}")
    out["failures"] = failures
    check(not failures, f"scenario: {failures}")
    return out


CLUSTER_CELL = "ClusterUp/20Nodes100Pods"
CLUSTER_INIT_NODES = 16      # ktpu-up init --nodes 16 --auth
CLUSTER_JOIN_NODES = 4       # ktpu-up join --nodes 4
CLUSTER_REPLICAS = 100
CLUSTER_APP = "web"
CLUSTER_TARGET_PORT = 8080
CLUSTER_SERVICE_PORT = 80
CLUSTER_REQUESTS = {"cpu": "10m", "memory": "10Mi"}
CLUSTER_BOOT_S = 300.0       # the init child's import, CUDA and boot
CLUSTER_TIMEOUT_S = 180.0    # each wait after the boot
CLUSTER_EXIT_S = 10.0        # a child's exit after SIGTERM
HOSTNAME_KEY = "kubernetes.io/hostname"
# ``python -m kubernetes_tpu_torch.cli.cluster`` run as -m runs it (runpy),
# which at its exit prints its count_pn launches as its last line
_CLUSTER_CHILD = r"""
import atexit, json, runpy, sys


def _report():
    mod = sys.modules.get("kubernetes_tpu_torch.ops.kernels")
    print(json.dumps({"launches": dict(mod.LAUNCHES) if mod else {}}),
          flush=True)


atexit.register(_report)
runpy.run_module("kubernetes_tpu_torch.cli.cluster", run_name="__main__",
                 alter_sys=True)
"""


class _Child:
    """A ``ktpu-up`` child process whose stdout lines a thread collects;
    its stderr goes to a temporary file (its tail is reported on a
    failure)."""

    def __init__(self, argv):
        import tempfile
        import threading
        root = os.path.dirname(os.path.abspath(__file__))
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            argv, cwd=root, stdout=subprocess.PIPE, stderr=self.err,
            text=True, env=dict(os.environ, PYTHONPATH=root,
                                PYTHONUNBUFFERED="1"))
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name="ktpu-up-stdout")
        self._reader.start()
        # a script that fails before the phase's SIGTERM leaves no child
        atexit.register(self._kill)

    def _kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def wait_line(self, prefix: str, timeout_s: float) -> str:
        end = time.perf_counter() + timeout_s
        while time.perf_counter() < end:
            for line in list(self.lines):
                if line.startswith(prefix):
                    return line[len(prefix):].strip()
            check(self.proc.poll() is None,
                  f"cluster: ktpu-up exited {self.proc.returncode} before "
                  f"{prefix!r}: {self.stderr_tail()}")
            time.sleep(0.05)
        raise PhaseFailed(f"cluster: no {prefix!r} line from ktpu-up in "
                          f"{timeout_s}s: {self.stderr_tail()}")

    def stderr_tail(self, n: int = 1500) -> str:
        self.err.seek(0)
        return self.err.read()[-n:]

    def terminate(self, timeout_s: float = CLUSTER_EXIT_S):
        """SIGTERM -> (exit code or None, seconds to exit); killed if it
        did not exit in ``timeout_s``."""
        import signal
        t0 = time.perf_counter()
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
            self.proc.kill()
            self.proc.wait()
        seconds = time.perf_counter() - t0
        self._reader.join(5.0)
        return rc, seconds


def cluster_manifests(replicas=CLUSTER_REPLICAS):
    """The Deployment (``replicas`` pods of 10m and 10Mi serving 8080, a
    hard hostname spread: maxSkew 1, DoNotSchedule) and its ClusterIP
    Service (80 -> 8080)."""
    labels = {"app": CLUSTER_APP}
    deployment = {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": CLUSTER_APP, "namespace": "default"},
        "spec": {"replicas": replicas, "selector": {"matchLabels": labels},
                 "template": {"metadata": {"labels": labels}, "spec": {
                     "containers": [{
                         "name": "c", "image": "web:v1",
                         "ports": [{"containerPort": CLUSTER_TARGET_PORT}],
                         "resources": {"requests": dict(CLUSTER_REQUESTS)}}],
                     "topologySpreadConstraints": [{
                         "maxSkew": 1, "topologyKey": HOSTNAME_KEY,
                         "whenUnsatisfiable": "DoNotSchedule",
                         "labelSelector": {"matchLabels": labels}}]}}}}
    service = {
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": CLUSTER_APP, "namespace": "default"},
        "spec": {"selector": labels, "ports": [{
            "port": CLUSTER_SERVICE_PORT,
            "targetPort": CLUSTER_TARGET_PORT, "protocol": "TCP"}]}}
    return deployment, service


def _label_hostname(client, name: str) -> None:
    """Give node ``name`` its ``kubernetes.io/hostname`` label (a hollow
    kubelet registers none), retrying a write its heartbeat raced."""
    from kubernetes_tpu_torch.client.clientset import ApiError
    for _ in range(50):
        node = client.nodes().get(name)
        labels = node["metadata"].setdefault("labels", {})
        if labels.get(HOSTNAME_KEY) == name:
            return
        labels[HOSTNAME_KEY] = name
        try:
            client.nodes().update(node)
            return
        except ApiError as e:
            if e.code != 409:
                raise
        time.sleep(0.05)
    raise PhaseFailed(f"cluster: could not label node {name}")


def _node_ready(node) -> bool:
    return any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in (node.get("status") or {}).get("conditions") or [])


def cluster_failures(pods, nodes, backends, want_device, device_line,
                     exits, launches, replicas=CLUSTER_REPLICAS) -> list:
    """The cluster phase's gates on what it read -> what failed: the child
    runs its scheduler on ``want_device``; every replica bound and Running
    on a registered node, each with its own IP inside its node's podCIDR;
    pods a node within 1 of each other over every node (the hard spread);
    the proxy's backends for the Service's VIP
    (the iptables, nftables and ipvs renders and the Proxier's service
    table) each equal to the Running pods' ``ip:8080``, and every packet
    the Proxier resolves sent to one of them;
    each child exits 0 within CLUSTER_EXIT_S of its SIGTERM; count_pn
    launched on the card."""
    import ipaddress
    failures = []
    if not device_line.startswith(want_device):
        failures.append(f"the scheduler runs on {device_line!r}, not "
                        f"{want_device}")
    names = {n["metadata"]["name"] for n in nodes}
    running = [p for p in pods if p["spec"].get("nodeName") in names
               and (p.get("status") or {}).get("phase") == "Running"]
    if len(running) != replicas or len(pods) != replicas:
        failures.append(f"{len(running)} of {len(pods)} pods bound and "
                        f"Running (want {replicas})")
    per_node = {n: 0 for n in names}
    for p in running:
        per_node[p["spec"]["nodeName"]] += 1
    if per_node and max(per_node.values()) - min(per_node.values()) > 1:
        failures.append(f"pods a node from {min(per_node.values())} to "
                        f"{max(per_node.values())}: skew over 1")
    cidrs = {n["metadata"]["name"]: (n.get("spec") or {}).get("podCIDR")
             for n in nodes}
    ips = [p["status"].get("podIP") for p in running]
    outside = [p["metadata"]["name"] for p in running
               if not cidrs.get(p["spec"]["nodeName"])
               or ipaddress.ip_address(p["status"].get("podIP") or "0.0.0.0")
               not in ipaddress.ip_network(cidrs[p["spec"]["nodeName"]])]
    if len(set(ips)) != len(ips) or outside:
        failures.append(f"{len(ips) - len(set(ips))} pod IPs shared, "
                        f"{len(outside)} outside their node's podCIDR")
    want = sorted(f"{ip}:{CLUSTER_TARGET_PORT}" for ip in ips)
    for what in ("iptables", "nftables", "ipvs", "table"):
        got = backends.get(what, [])
        if sorted(got) != want:
            failures.append(f"{what}: {len(got)} backends, not the "
                            f"{len(want)} Running pods' ip:port")
    resolved = backends.get("resolved", [])
    if not resolved or not set(resolved) <= set(want):
        failures.append(f"the Proxier resolved the VIP to "
                        f"{sorted(set(resolved) - set(want))[:3]} outside "
                        f"the Running pods' ip:port")
    for who, (rc, seconds) in exits.items():
        if rc != 0 or seconds > CLUSTER_EXIT_S:
            failures.append(f"ktpu-up {who} exited {rc} after "
                            f"{seconds:.1f}s of its SIGTERM")
    if want_device == "cuda" and not launches.get("count_pn"):
        failures.append("kernel count_pn was never launched in the "
                        "ktpu-up child")
    return failures


def _proxy_backends(client, vip: str) -> dict:
    """The backends of ``vip``:80 as the port's three proxy renders and the
    Proxier's service table hold them, and where the Proxier resolves 400
    packets (``resolved``; ``"None"`` for a packet it rejects)."""
    import random
    from kubernetes_tpu_torch.proxy.ipvs import IpvsProxier, RestoredIpvsRules
    from kubernetes_tpu_torch.proxy.nftables import (NftablesProxier,
                                                     RestoredNftRules)
    from kubernetes_tpu_torch.proxy.proxier import Proxier, RestoredRules
    out = {}
    rng = random.Random(SEED)
    for what, cls, render, parse in (
            ("iptables", Proxier, "sync_proxy_rules_text", RestoredRules),
            ("nftables", NftablesProxier, "sync_nft_text", RestoredNftRules),
            ("ipvs", IpvsProxier, "sync_ipvs_text", RestoredIpvsRules)):
        proxier = cls(client).start()
        try:
            out[what] = parse(getattr(proxier, render)()).backends(
                vip, CLUSTER_SERVICE_PORT)
            if what == "iptables":
                out["table"] = [ep for spi in proxier.service_table().values()
                                if spi.cluster_ip == vip
                                and spi.port == CLUSTER_SERVICE_PORT
                                for ep in spi.endpoints]
                out["resolved"] = sorted({str(proxier.resolve(
                    vip, CLUSTER_SERVICE_PORT, rng=rng)) for _ in range(400)})
        finally:
            proxier.stop()
    return out


def cluster_phase(device=None, smi="", n_init=CLUSTER_INIT_NODES,
                  n_join=CLUSTER_JOIN_NODES, replicas=CLUSTER_REPLICAS):
    """ClusterUp/20Nodes100Pods: ``ktpu-up`` (cli/cluster.py), the kubeadm
    analog, as its users boot a dev or CI cluster. A child runs
    ``python -m kubernetes_tpu_torch.cli.cluster init --nodes 16 --auth``
    (its scheduler on the card unless ``device`` says otherwise: the
    apiserver with auth and admission, the scheduler, the controller
    manager with the cloud controllers, 16 hollow kubelets), and this
    process reads its device, URL and admin token from its stdout; a
    second child runs ``ktpu-up join --server URL --nodes 4 --token T``.
    Once the 20 nodes are registered each gets its hostname label, and
    once all are Ready with a podCIDR (nodeipam), a Deployment of 100
    replicas with a hard hostname spread and a ClusterIP Service go in.
    The port's three proxy backends then run in this process on the
    child's URL. Gates: ``cluster_failures``. Then SIGTERM to both
    children. -> summary: the seconds of the phase and of each step, the
    pods a node, the backends, the exits, the child's count_pn launches
    (``launches``)."""
    from kubernetes_tpu_torch.client.clientset import HTTPClient
    t_phase = time.perf_counter()
    children = {}
    out = {"cell": CLUSTER_CELL, "card": smi}
    try:
        argv = ["init", "--nodes", str(n_init), "--auth"] + (
            ["--device", str(device)] if device is not None else [])
        children["init"] = _Child([sys.executable, "-c", _CLUSTER_CHILD,
                                   *argv])
        device_line = children["init"].wait_line("device:", CLUSTER_BOOT_S)
        url = children["init"].wait_line("control plane up:", CLUSTER_BOOT_S)
        token = children["init"].wait_line("admin token:", CLUSTER_BOOT_S)
        children["init"].wait_line("nodes:", CLUSTER_BOOT_S)
        out["boot_s"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        children["join"] = _Child([
            sys.executable, "-m", "kubernetes_tpu_torch.cli.cluster", "join",
            "--server", url, "--nodes", str(n_join), "--token", token])
        children["join"].wait_line("joined:", CLUSTER_BOOT_S)
        out["join_s"] = time.perf_counter() - t0
        client = HTTPClient(url, token=token)
        want_nodes = n_init + n_join

        def wait(what, fn, timeout_s=CLUSTER_TIMEOUT_S):
            t0 = time.perf_counter()
            end = t0 + timeout_s
            while time.perf_counter() < end:
                got = fn()
                if got:
                    out[f"{what}_s"] = time.perf_counter() - t0
                    return got
                time.sleep(CTRL_POLL_S)
            raise PhaseFailed(f"cluster: {what} not within {timeout_s}s "
                              f"({fn()!r})")

        wait("registered", lambda: len(client.nodes().list()) == want_nodes)
        for node in client.nodes().list():
            _label_hostname(client, node["metadata"]["name"])
        wait("nodes_ready", lambda: all(
            _node_ready(n) and (n.get("spec") or {}).get("podCIDR")
            and n["metadata"].get("labels", {}).get(HOSTNAME_KEY)
            for n in client.nodes().list()))
        # each kubelet reads its podCIDR at a heartbeat (its GET comes just
        # before the stamp): pods go in once every node has stamped one a
        # second after the last CIDR was seen
        t_cidr = time.time() + 1.0
        wait("kubelets_cidr", lambda: all(
            c.get("type") != "Ready" or c.get("lastHeartbeatTime", 0) > t_cidr
            for n in client.nodes().list()
            for c in (n.get("status") or {}).get("conditions") or []))
        deployment, service = cluster_manifests(replicas)
        t0 = time.perf_counter()
        client.resource("deployments", "default").create(deployment)
        svc = client.resource("services", "default").create(service)
        vip = svc["spec"]["clusterIP"]

        def running():
            pods = [p for p in client.pods("default").list()
                    if (p["metadata"].get("labels") or {}).get("app")
                    == CLUSTER_APP]
            return pods if sum(
                1 for p in pods if p["spec"].get("nodeName")
                and (p.get("status") or {}).get("phase") == "Running"
            ) == replicas else None

        pods = wait("running", running)
        out["pods_per_s"] = replicas / (time.perf_counter() - t0)
        want = sorted(f"{p['status'].get('podIP')}:{CLUSTER_TARGET_PORT}"
                      for p in pods)
        # the endpoints controller publishes the ready pods; the renders
        # are read once they hold them (or the wait's limit passes)
        backends = {}

        def served():
            backends.update(_proxy_backends(client, vip))
            return all(sorted(backends[k]) == want for k in
                       ("iptables", "nftables", "ipvs", "table"))

        try:
            wait("endpoints", served)
        except PhaseFailed:
            pass  # cluster_failures names what the renders held
        nodes = client.nodes().list()
        per_node = {}
        for p in pods:
            per_node[p["spec"].get("nodeName")] = per_node.get(
                p["spec"].get("nodeName"), 0) + 1
        exits = {who: children[who].terminate()
                 for who in ("join", "init")}
        launches = {}
        for line in reversed(children["init"].lines):
            if line.startswith('{"launches"'):
                launches = json.loads(line)["launches"]
                break
        failures = cluster_failures(pods, nodes, backends,
                                    "cpu" if device == "cpu" else "cuda",
                                    device_line, exits, launches, replicas)
        out.update(device=device_line, url_scheme=url.split(":")[0],
                   nodes=len(nodes), pods=len(pods), vip=vip,
                   pods_per_node={"min": min(per_node.values() or [0]),
                                  "max": max(per_node.values() or [0]),
                                  "nodes": len(per_node)},
                   backends={k: len(v) for k, v in backends.items()},
                   exits={k: {"rc": rc, "seconds": s}
                          for k, (rc, s) in exits.items()},
                   launches=launches, failures=failures,
                   seconds=time.perf_counter() - t_phase)
        return out
    finally:
        for child in children.values():
            if child.proc.poll() is None:
                child.terminate()


class ClusterUp:
    """The cluster phase (``cluster_phase``) on a thread, beside the parity
    phases (cut for time): its control plane and kubelets run in child
    processes; this process only reads them over HTTP and runs the proxy
    renders, and records no span, launch or loop error. ``join`` waits for
    it (before the first timed path) and re-raises what failed it."""

    def __init__(self, device=None, smi=""):
        self.device, self.smi = device, smi
        self.out = {}
        self._thread = None

    def start(self) -> "ClusterUp":
        import threading

        def run():
            try:
                self.out["summary"] = cluster_phase(device=self.device,
                                                    smi=self.smi)
            except BaseException as e:  # join() raises it
                self.out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="cluster-up")
        self._thread.start()
        return self

    def join(self) -> dict:
        self._thread.join(CLUSTER_BOOT_S + 4 * CLUSTER_TIMEOUT_S)
        if "error" in self.out:
            raise self.out["error"]
        check("summary" in self.out, "cluster: ClusterUp did not finish")
        summary = self.out["summary"]
        check(not summary["failures"], f"cluster: {summary['failures']}")
        return summary


def check_slo_gates(result, gates) -> list:
    """``benchmarks/connected.py`` check_slo_gates on this script's keys:
    ``SchedulingThroughput`` (pods/s, a floor) and
    ``p99AttemptLatencySeconds`` (the attempt p99, a ceiling); a missing
    number fails, and so does an unknown gate."""
    failures = []
    for key, bound in (gates or {}).items():
        if key == "SchedulingThroughput":
            val, ok = result.get("pods_per_s"), "floor"
        elif key == "p99AttemptLatencySeconds":
            val, ok = result.get("attempt_p99_s"), "ceiling"
        else:
            failures.append(f"unknown SLO gate {key!r}")
            continue
        if not isinstance(val, (int, float)):
            failures.append(f"{key}: value missing ({val!r})")
        elif ok == "floor" and val < bound:
            failures.append(f"{key}: {val} below the {bound} floor")
        elif ok == "ceiling" and val > bound:
            failures.append(f"{key}: {val} above the {bound}s ceiling")
    return failures


# ------------------------------------------------------------------ mesh

MESH_NODES = N_NODES           # MixedHeterogeneous at 5000 nodes: the 8192 bucket
MESH_P = CONNECTED_BATCH       # drain_parity_check's P, at the main path's 512
MESH_B = CONNECTED_DRAIN_BATCHES
MESH_SHAPES = ((1, 2), (2, 2), (1, 4))
MESH_CONNECTED = (1, 2)        # the mesh phase's scheduler
MESH_PODS = SCHED_EAGER        # 2048 of Connected's 10000 pods
# two pops of 2 x 512: the sentinel judges the second drain of each leg
MESH_PARITY_EVERY = 2


def logical_mesh(shape, card="cuda:0"):
    """A (pods, nodes) mesh of logical shards on one card, built from an
    explicit device list (``make_mesh``), as an operator hands one to
    ``Scheduler.set_mesh``."""
    from kubernetes_tpu_torch.parallel.mesh import make_mesh
    return make_mesh([card] * (shape[0] * shape[1]), pods_axis=shape[0])


def mesh_drain(ct, pbs, topo_keys, device=None, mesh=None, count=True):
    """One fused ``drain_step`` over a fresh resident context (split over
    ``mesh`` when given) -> its winners, fill, folded state (host copies),
    milliseconds, and with ``count`` its launches per shard and the bytes
    its collectives moved (a leg run beside another passes False: the
    counters are the process's)."""
    import torch
    from kubernetes_tpu_torch.models import gang
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.parallel import mesh as mesh_mod
    ct_all, e0, fill = gang.build_drain_context(ct, pbs, device=device,
                                                mesh=mesh)
    stack = gang.stack_batches(gang.unify_batches(pbs))
    kw = dict(e0=e0, seed=SEED, fit_strategy="LeastAllocated",
              topo_keys=topo_keys, weights=(), enabled_filters=(),
              max_rounds=64)
    card = device != "cpu"
    if card:
        torch.cuda.synchronize()
    if count:
        kernels.reset_launches()
    ex0, peer0 = mesh_mod.EXCHANGED_BYTES, mesh_mod.PEER_BYTES
    t0 = time.perf_counter()
    a, r, ct_all, new_fill = gang.drain_step(ct_all, stack, fill, **kw)
    if card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"assignments": a.cpu().numpy(), "rounds": r.cpu().numpy(),
            "fill": int(new_fill), "ms": ms,
            "folded": _host_tree(mesh_mod.full_view(ct_all)),
            "launches": dict(kernels.LAUNCHES),
            "shard_launches": {f"{n}@{i},{j}": c for (n, i, j), c
                               in kernels.SHARD_LAUNCHES.items()},
            "exchanged_bytes": mesh_mod.EXCHANGED_BYTES - ex0,
            "peer_bytes": mesh_mod.PEER_BYTES - peer0, "ct": ct_all}


def mesh_parity_phase(seed=SEED, shapes=MESH_SHAPES):
    """parity.mesh: ``drain_parity_check`` (benchmarks/connected.py) at the
    main path's width -- MixedHeterogeneous at 5000 nodes (the 8192
    bucket), P=512, B=2 -- drained on the card single-device (the
    captured rounds), on the CPU, and split over meshes of logical shards
    of this card (``logical_mesh``: (1,2), (2,2), (1,4)). Gates: each
    mesh's assignments, rounds, fill and folded state equal the card's
    single-device drain's and the CPU's, bit for bit, and count_pn
    launched on every shard. -> (summary, count_pn's cases at a shard's
    shape: the (1,2) mesh's second shard over the folded context)."""
    from kubernetes_tpu_torch.encode.snapshot import SnapshotEncoder
    from kubernetes_tpu_torch.models.gang import _batch, stack_batches
    from kubernetes_tpu_torch.models.gang import unify_batches
    from kubernetes_tpu_torch.parallel import mesh as mesh_mod
    from kubernetes_tpu_torch.testing.workloads import mixed_heterogeneous
    t_phase = time.perf_counter()
    nodes, pods = mixed_heterogeneous(pods=MESH_P * MESH_B,
                                      nodes=MESH_NODES, seed=seed)
    enc = SnapshotEncoder()
    ct, meta = enc.encode_cluster(nodes, [], pending_pods=pods)
    pbs = [enc.encode_pods(pods[i:i + MESH_P], meta, min_p=MESH_P)
           for i in range(0, MESH_P * MESH_B, MESH_P)]
    keys = tuple(meta.topo_keys)
    # the CPU leg runs beside the card's legs, which it does not count
    import threading
    cpu_out = {}
    cpu_thread = threading.Thread(
        target=lambda: cpu_out.update(leg=mesh_drain(ct, pbs, keys,
                                                     device="cpu",
                                                     count=False)),
        daemon=True, name="mesh-cpu-leg")
    cpu_thread.start()
    single = mesh_drain(ct, pbs, keys, device="cuda")

    def same(a, b):
        return (_same(a["assignments"], b["assignments"])
                and _same(a["rounds"], b["rounds"]) and a["fill"] == b["fill"]
                and _same(a["folded"], b["folded"]))

    check(single["fill"] > 0, "parity.mesh: the single-device drain placed "
                              "nothing")
    legs, cases = {}, None
    for shape in shapes:
        m = logical_mesh(shape)
        leg = mesh_drain(ct, pbs, keys, mesh=m)
        name = f"{shape[0]}x{shape[1]}"
        check(same(leg, single), f"parity.mesh: the {name} mesh's drain "
                                 "differs from the single-device drain")
        for i in range(shape[0]):
            for j in range(shape[1]):
                check(leg["shard_launches"].get(f"count_pn@{i},{j}", 0) > 0,
                      f"parity.mesh: count_pn never launched on shard "
                      f"({i},{j}) of the {name} mesh")
        legs[name] = {"devices": [str(d) for d in m.device_list()],
                      "logical_shards": True,
                      **{k: leg[k] for k in ("ms", "launches",
                                             "shard_launches",
                                             "exchanged_bytes",
                                             "peer_bytes")}}
        if shape == MESH_CONNECTED:
            ct_s = leg["ct"]
            # shard 0 of the (1,2) mesh: the folded pods on shard 1's
            # nodes are in its copy and count nowhere there
            piece = ct_s.pieces[0]
            n0 = ct_s.layout.node_bounds()[0][0]
            local = piece.epod_node - n0
            local = local.where((local >= 0)
                                & (local < piece.node_valid.shape[0]),
                                local.new_full((), -1))
            pb = _batch(stack_batches(unify_batches(pbs)).to("cuda"), 0)
            cases = _term_cases("mesh_shard", piece.replace(
                epod_node=local.contiguous()), pb)
        del leg
    cpu_thread.join(600.0)
    check("leg" in cpu_out, "parity.mesh: the CPU leg did not finish")
    cpu = cpu_out["leg"]
    check(same(single, cpu), "parity.mesh: the card's single-device drain "
                             "differs from the CPU's")
    return {"nodes": len(nodes), "pods": len(pods), "P": MESH_P,
            "B": MESH_B, "N": int(ct.node_valid.shape[0]),
            "placed": single["fill"],
            "rounds": [int(r) for r in single["rounds"]],
            "single_ms": single["ms"], "cpu_ms": cpu["ms"],
            "meshes": legs, "bit_equal": True,
            "seconds": time.perf_counter() - t_phase}, cases


def mesh_single_leg(node_dicts, pod_dicts, device=None):
    """The mesh phase's pods through a single-device Scheduler on the card
    (``make_scheduler``: no API server), with the connected runner's
    configuration, warm drain and pops (the whole queue first, pops of
    2 x 512), its nodes in the runner's order -> ({pod name: node},
    seconds)."""
    from kubernetes_tpu_torch.api.types import Node, Pod
    t0 = time.perf_counter()
    cfg = sched_config(batch_size=CONNECTED_BATCH,
                       max_drain_batches=CONNECTED_DRAIN_BATCHES)
    pods = [Pod.from_dict(d) for d in pod_dicts]
    # the nodes in the order the runner's informer lists them (the
    # store's, by name): a node's row, and so its tie-break identity, is
    # its place in that order
    nodes = sorted(node_dicts, key=lambda d: d["metadata"]["name"])
    sched, log = make_scheduler(cfg, [Node.from_dict(d) for d in nodes],
                                device=device)
    try:
        pop = CONNECTED_BATCH * CONNECTED_DRAIN_BATCHES
        check(sched.warm_drain(pods, slot_headroom=len(pods) + pop),
              "mesh: the single-device leg's warm_drain did not arm")
        for p in pods:
            sched.queue.add(p)
        for _ in range(4 * len(pods) // pop + 8):
            sched.run_once(wait=0.01)
            if not sched._pending and not sched.queue.stats()["active"]:
                break
        sched._resolve_pending()
        sched.wait_for_bindings()
    finally:
        sched.close()
    placed = {key.split("/", 1)[1]: node for key, node, _t in log}
    check(len(placed) == len(pods), f"mesh: the single-device leg bound "
                                    f"{len(placed)} of {len(pods)} pods")
    return placed, time.perf_counter() - t0


def mesh_phase(node_dicts, pod_dicts, smi="", device=None, card="cuda:0"):
    """mesh: Connected/10000Pods5000Nodes's workload at its first
    MESH_PODS pods (the cut scheduler.eager takes), through the connected
    runner with its scheduler given a (1,2) mesh of logical shards of this
    card (``Scheduler.set_mesh``), its loop started once the informer has
    queued every pod; beside it the same pods through a single-device
    Scheduler with the same pops (``mesh_single_leg``, cut for time: no
    second API server). Gates: the mesh active (its device count 2, the
    breaker at "mesh"), every pod bound, the same placements as the
    single-device leg, and connected_run's gates (0 violations,
    divergences, loop errors; the sentinel judges the second drain).
    Pods/s is reported, not gated: logical shards share one card.
    -> summary."""
    t0 = time.perf_counter()
    pods = pod_dicts[:MESH_PODS]
    placed0, single_s = mesh_single_leg(node_dicts, pods, device=device)
    m = logical_mesh(MESH_CONNECTED, card=card)
    meshed, runner = connected_phase(node_dicts, pods, smi=smi, mesh=m,
                                     device=device,
                                     queued_first=True,
                                     parity_every=MESH_PARITY_EVERY)
    del runner
    check(meshed["mesh_active"] and meshed["mesh_devices"] == 2,
          f"mesh: the mesh was not active ({meshed['mesh']}, "
          f"{meshed['mesh_devices']} devices)")
    placed = meshed.pop("placements")
    differ = sorted(k for k in placed0 if placed.get(k) != placed0[k])
    check(len(placed) == len(placed0) == len(pods) and not differ,
          f"mesh: {len(differ)} pods placed elsewhere than single-device "
          f"({differ[:5]})")
    keep = ("pods", "bound", "window_s", "pods_per_s", "attempt_p50_s",
            "attempt_p99_s", "ctx_stats", "breaker", "loop_errors",
            "oracle_pods", "launches", "audit", "sentinel", "warm_drain_s")
    return {"shape": list(MESH_CONNECTED), **{k: meshed[k] for k in keep},
            "mesh": meshed["mesh"], "mesh_devices": meshed["mesh_devices"],
            "logical_shards": True, "same_placements": True,
            "single_leg_s": single_s, "seconds": time.perf_counter() - t0}


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


def graph_counts_hold(graphs: dict, rounds) -> bool:
    """The round graphs' locked counters over one captured drain after its
    warm-up read what the loop did: no capture, and a replay and a read of
    the progress flag for each chunk of K rounds, ceil(rounds / K) a batch
    (no batch hits the round limit here)."""
    k = graphs["K"]
    want = sum(-(-int(r) // k) for r in rounds)
    return (graphs["captures"] == 0
            and graphs["replays"] == graphs["host_reads"] == want)


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


class WarmBoots:
    """The warm phase's three boots of a scheduler, each in a child process
    (``python3 chip_smoke.py --warm-boot DIR``), one after another on one
    empty temporary ``aotCacheDir``: cold (count_pn is built, the ladder
    captures), warm (nothing built, the same fingerprint, the canary
    sample judged with 0 divergences), and after one byte of the cached
    library is flipped (swept and counted at boot, built again: the
    damaged library is never loaded). They run on a thread of this process
    while it runs the parity checks, which time nothing; ``join`` waits
    for them before the timed paths, ``stop`` kills a boot still running
    and removes the directory."""

    LEGS = ("cold", "warm", "flipped")

    def __init__(self, seconds_limit=300.0):
        import tempfile
        self.seconds_limit = seconds_limit
        self.root = tempfile.mkdtemp(prefix="warm-", dir=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "build"))
        self.cache_dir = os.path.join(self.root, "aot")
        self.boots = {}
        self.error = None
        self.wall_s = None
        self._proc = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, name="warm-boots",
                                        daemon=True)

    def start(self) -> "WarmBoots":
        self._thread.start()
        return self

    def _run(self) -> None:
        t_all = time.perf_counter()
        try:
            for leg in self.LEGS:
                if leg == "flipped":
                    lib = os.path.join(self.cache_dir, "entries",
                                       self.boots["warm"]["entries"][0])
                    blob = bytearray(open(lib, "rb").read())
                    blob[len(blob) // 2] ^= 0xFF
                    with open(lib, "wb") as f:
                        f.write(bytes(blob))
                if self._stopped.is_set():
                    return
                t0 = time.perf_counter()
                self._proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--warm-boot", self.cache_dir],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                try:
                    out, err = self._proc.communicate(
                        timeout=self.seconds_limit)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    self._proc.communicate()
                    raise PhaseFailed(f"warm: the {leg} boot took more "
                                      f"than {self.seconds_limit} s")
                check(self._proc.returncode == 0,
                      f"warm: the {leg} boot failed: {err[-2000:]}")
                self.boots[leg] = json.loads(out.strip().splitlines()[-1])
                self.boots[leg]["process_s"] = time.perf_counter() - t0
        except Exception as e:  # raised by join, in the main thread
            self.error = e
        finally:
            self.wall_s = time.perf_counter() - t_all

    def join(self, timeout=None) -> dict:
        """Wait for the three boots. -> their reports (raises a boot's
        failure)."""
        self._thread.join(self.seconds_limit * len(self.LEGS)
                          if timeout is None else timeout)
        check(not self._thread.is_alive(), "warm: the boots did not end")
        if self.error is not None:
            raise self.error
        return self.boots

    def stop(self) -> None:
        import shutil
        self._stopped.set()
        proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.kill()
        if self._thread.is_alive():
            self._thread.join(30.0)
        shutil.rmtree(self.root, ignore_errors=True)


def warm_phase(warm_boots: WarmBoots) -> dict:
    """Warm start: the gates on the three boots of ``warm_boots`` (see
    ``WarmBoots``), then the fingerprint's wholesale invalidation on a
    changed build flag, in this process (the flags are restored and the
    cache disarmed after it). -> the report."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.sched.aotcache import (AotExecutableCache,
                                                     cache_knobs)
    boots = warm_boots.join()
    cache_dir = warm_boots.cache_dir
    try:
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
                "boots_wall_s": warm_boots.wall_s,
                "boots_beside": "the parity checks",
                "fingerprint_equal": True,
                "flags_changed": {"boot": boot,
                                  "invalidations": stale.invalidations}}
    finally:
        warm_boots.stop()


# past this many seconds the script prints every thread's stack and exits
# 1, inside the 1200 s the card's check allows: a hang names its place
DEADLINE_S = 1170.0


# this process's collector: a young collection every 50000 net
# allocations (Python's default is 700) and an older one every 20 of the
# younger. At the defaults the collector held this process for 14% of
# the script's seconds (PERF.md §6), re-traversing each phase's informer
# caches and encodings; every other process of the script keeps Python's
# defaults
GC_THRESHOLDS = (50_000, 20, 20)


def main() -> int:
    import faulthandler
    import signal
    import torch
    gc.set_threshold(*GC_THRESHOLDS)
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
    # the build counter moves under its lock: one a library built
    check(kernels.BUILDS == sum(b["built"] for b in built.values()),
          f"build: BUILDS reads {kernels.BUILDS} for "
          f"{sum(b['built'] for b in built.values())} libraries built")

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
    # ROADMAP B2: _domain_counts' two branches at 8192 and 16384 nodes
    emit({"phase": "domain_counts", **domain_counts_phase()})

    # the warm phase's three boots and SchedulerKill (a scheduler child on
    # the card SIGKILLed mid-churn, restarted warm from the kernel cache)
    # run in child processes beside the parity checks, which time nothing;
    # they end before the timed paths
    warm_boots = WarmBoots().start()
    atexit.register(warm_boots.stop)
    kill = SchedulerKill(smi=smi).start()
    # ClusterUp (ktpu-up init and join, children on the card) beside them
    cluster_up = ClusterUp(smi=smi).start()

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
    # out-of-tree tensor plugins inside the rounds: card captured, card
    # eager and CPU (its count_pn launches are counted over the legs)
    plugin_parity = plugin_parity_phase()
    emit({"phase": "parity.plugins", **plugin_parity})
    # the resident drain split over meshes of logical shards of the card
    mesh_parity, mesh_cases = mesh_parity_phase()
    emit({"phase": "parity.mesh", **mesh_parity})
    mesh_rows = kernels_phase(mesh_cases)
    del mesh_cases
    emit({"phase": "kernels.mesh", "rows": mesh_rows})

    launches = {}   # kernel -> {path: launches}

    warm_boots.join()
    emit({"phase": "chaos.kill", **kill.join()})
    del kill
    cluster_sum = cluster_up.join()
    emit({"phase": "cluster", **cluster_sum})
    del cluster_up
    settle_heap()
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
    settle_heap()

    s_nodes, s_pods, s_profiled = sched_workload()
    sched_sum, sched, s_churn, _placed = scheduler_phase(s_nodes, s_pods,
                                                         smi=smi)
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
    # the same cell with two out-of-tree tensor plugins in the rounds
    plug_sum, sched, p_churn = plugins_phase(s_nodes, s_pods, smi=smi,
                                             plain=sched_sum)
    for name, n in plug_sum["launches"].items():
        launches.setdefault(name, {})["plugins"] = n
    emit({"phase": "plugins", **plug_sum})
    plug_rows = kernels_phase(scheduler_count_cases(sched, s_pods,
                                                    prefix="plugins"))
    emit({"phase": "kernels.plugins", "rows": plug_rows})
    emit({"phase": "profile.plugins",
          **profile_scheduler_phase(sched, p_churn, s_profiled,
                                    plug_sum["pops"])})
    sched.close()
    del sched
    settle_heap()

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
    settle_heap()
    # the connected runner with its scheduler on a (1,2) mesh
    mesh_sum = mesh_phase(c_nodes, c_pods, smi=smi)
    emit({"phase": "mesh", **mesh_sum})
    settle_heap()

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
    settle_heap()
    fleet_sum = fleet_phase(smi=smi)
    emit({"phase": "fleet", **fleet_sum})
    check(not fleet_sum["failures"],
          f"fleet: {fleet_sum['failures']}")
    # DRA: SchedulingWithResourceClaimTemplate/5000pods_500nodes (its pods
    # carry no topology term: count_pn's 0 is recorded)
    t0 = time.perf_counter()
    dra_sum = dra_phase(smi=smi)
    emit({"phase": "dra", **dra_sum, "seconds": time.perf_counter() - t0})
    # the entry point operators drive: ktpu against a runner on the card
    ktpu_sum = ktpu_phase()
    emit({"phase": "ktpu", **ktpu_sum})
    # the rest of store/: ExplainAB (explainer and flight recorder off,
    # then on), then the same ConnectedChurn behind the secured planes and
    # behind the three-node front door
    xab_sum = explainab_phase(smi=smi)
    emit({"phase": "explainab", **xab_sum})
    sec_sum = secured_phase(smi=smi, pods=SECURED_PODS)
    emit({"phase": "secured", **sec_sum})
    fd_sum = frontdoor_phase(smi=smi, pods=FRONTDOOR_PODS)
    emit({"phase": "frontdoor", **fd_sum})
    # the controller manager and its controllers: clusterloader2's load
    # test on 100 nodes, the pods the Deployments create bound on the card
    # (they carry no topology term: count_pn's 0 is recorded)
    ctrl_sum = controllers_phase(smi=smi)
    emit({"phase": "controllers", **ctrl_sum})
    settle_heap()
    # the chaos harness: ChaosChurnQueued (faults on the runner's
    # transport, the device seams and the loop's threads; the breaker's
    # walk to the oracle and its restore onto the captured rounds)
    chaos_sum = chaos_phase(smi=smi)
    emit({"phase": "chaos", **chaos_sum})
    # the scenario time machine: builtin:smoke replayed through the runner
    scen_sum = scenario_phase(smi=smi)
    emit({"phase": "scenario", **scen_sum})
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
    sched_eager, sched, _churn, _placed = scheduler_phase(
        s_nodes, s_pods[:SCHED_EAGER], smi=smi, capture=False)
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
    # warm start: the gates on the three boots made beside the parity
    # checks, and a changed build flag
    emit({"phase": "warm", **warm_phase(warm_boots)})

    for path, summary in (("preemption", pre_sum),
                          ("connected_preemption", cpre_sum),
                          ("explain", expl_sum), ("extender", ext_sum),
                          ("slice", slice_sum), ("autoscaler", auto_sum),
                          ("defrag", defrag_sum), ("planner", loop_sum),
                          ("fleet.drain", fdrain_sum), ("fleet", fleet_sum),
                          ("parity.dra", dra_parity), ("dra", dra_sum),
                          ("parity.plugins", plugin_parity),
                          ("ktpu", ktpu_sum), ("explainab", xab_sum),
                          ("secured", sec_sum), ("frontdoor", fd_sum),
                          ("controllers", ctrl_sum), ("chaos", chaos_sum),
                          ("scenario", scen_sum), ("cluster", cluster_sum),
                          ("mesh", mesh_sum)):
        for name, n in summary["launches"].items():
            launches.setdefault(name, {})[path] = n

    # one entry per kernel, at the resident shape where the kernel runs
    # there (the headline shape, fixed from call to call), else at the
    # shape of the path with its most launches among those whose rows are
    # taken from the path's own context (scheduler, plugins, connected,
    # explain, extender, slice, fleet.drain); launches summed over every
    # path; every row of the kernels phases was held bit-equal to the
    # plain version
    rows_by_path = {"resident": resident_rows, "scheduler": sched_rows,
                    "plugins": plug_rows,
                    "connected": conn_rows, "explain": expl_rows,
                    "extender": ext_rows, "slice": slice_rows,
                    "fleet.drain": fleet_rows}
    table = []
    for name, by_path in launches.items():
        top = ("resident" if by_path.get("resident") else
               max(rows_by_path, key=lambda path: by_path.get(path, 0)))
        row = dict(next(r for r in rows_by_path[top]
                        if r["name"].startswith(name + "[")))
        row.update(name=name, launches=sum(by_path.values()),
                   launches_by_path=by_path, ms=row.pop("kernel_ms"),
                   shape_of=top,
                   shapes_checked=[r["name"] for r in
                                   rows + drain_rows + resident_rows
                                   + sched_rows + plug_rows + conn_rows
                                   + expl_rows
                                   + ext_rows + slice_rows + fleet_rows
                                   if r["name"].startswith(name + "[")])
        table.append(row)
    # count_pn on the mesh path: a shard's shape (its node slice, the
    # existing pods remapped to it), the launches of the mesh phase's
    # scheduler (every shard's)
    row = dict(mesh_rows[0])
    row.update(name="count_pn.mesh_shard",
               launches=mesh_sum["launches"].get("count_pn", 0),
               launches_by_path={"mesh": mesh_sum["launches"].get(
                   "count_pn", 0)},
               ms=row.pop("kernel_ms"), shape_of="mesh",
               shapes_checked=[r["name"] for r in mesh_rows])
    check(row["launches"] > 0, "mesh: count_pn was never launched")
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
