"""Component configuration — the KubeSchedulerConfiguration analog.

Reference: ``staging/src/k8s.io/kube-scheduler/config/v1/types.go``
(``KubeSchedulerConfiguration``, ``KubeSchedulerProfile``, ``Plugins``) and
``pkg/scheduler/apis/config/`` (internal + defaults + validation).

Profiles gate the whole behavior: each profile names a scheduler, the plugin
sets it enables/disables, per-plugin weights, and the scoring strategy. The
TPU batch knobs live here too (batch size, gang rounds) — they replace the
reference's ``parallelism`` / ``percentageOfNodesToScore`` (kept as accepted
compat fields; the TPU path always scores all nodes).

The PyTorch port of ``kubernetes_tpu/config/types.py``. PyYAML is imported
by ``from_yaml`` only: the port's other entry points run without it.

A ``meshShape`` is validated as the reference validates it; the scheduler
installs that device mesh (parallel/mesh.py) when the devices can meet it,
and otherwise runs single-device with a warning, as the reference does.
The explainer is on by default and the parity sentinel
samples every 16th drain, as in the reference. ``aotCacheDir`` arms the
durable cache of the port's one persistent artifact, the ``nvcc``-built
kernel libraries (``sched/aotcache.py``; ``KTPU_AOT_CACHE`` overrides it).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from kubernetes_tpu_torch.ops.filters import FILTERS
from kubernetes_tpu_torch.ops.scores import DEFAULT_WEIGHTS
# the one parser of the mesh-shape wire forms lives with the mesh
from kubernetes_tpu_torch.parallel.mesh import parse_mesh_shape  # noqa: F401

DEFAULT_SCHEDULER_NAME = "default-scheduler"

ALL_FILTER_PLUGINS = tuple(FILTERS) + ("PodTopologySpread", "InterPodAffinity")
ALL_SCORE_PLUGINS = tuple(DEFAULT_WEIGHTS)
FIT_STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")


def _plugin_args(plugin_config, name: str) -> dict:
    """Args for one plugin from either pluginConfig wire shape: the
    reference's list of ``{name, args}`` entries, or a plain
    ``{PluginName: args}`` map."""
    if isinstance(plugin_config, list):
        for entry in plugin_config:
            if isinstance(entry, dict) and entry.get("name") == name:
                return entry.get("args") or {}
        return {}
    if isinstance(plugin_config, dict):
        return plugin_config.get(name) or {}
    return {}


@dataclass
class Profile:
    """KubeSchedulerProfile analog."""

    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    disabled_filters: list[str] = field(default_factory=list)
    score_weights: dict[str, float] = field(default_factory=dict)  # override/disable(0)
    fit_strategy: str = "LeastAllocated"
    percentage_of_nodes_to_score: int = 0  # compat; TPU path scores all nodes
    # out-of-tree plugin names enabled for this profile (sched/framework.py
    # Registry); None = every registered plugin, [] = none
    out_of_tree: Optional[list] = None
    # NodeAffinityArgs.addedAffinity (reference: pkg/scheduler/framework/
    # plugins/nodeaffinity/node_affinity.go): a NodeAffinity applied to
    # EVERY pod scheduled by this profile, in ADDITION to the pod's own —
    # required terms AND, preferred terms appended. Wire shape: the
    # core/v1 NodeAffinity dict under pluginConfig.NodeAffinity.addedAffinity.
    added_affinity: Optional[dict] = None

    def apply_added_affinity(self, pods: list) -> list:
        """Pods with this profile's addedAffinity folded into their node
        affinity terms (no-op without addedAffinity). Applied scheduler-side
        before encoding, so the tensor AND oracle paths see one merged
        affinity and stay in parity by construction. The NodeAffinity dict
        is parsed once per profile, not per pod (this sits on the per-cycle
        encode path)."""
        if not self.added_affinity:
            return pods
        from kubernetes_tpu_torch.api.types import (NodeAffinity,
                                              with_added_node_affinity)
        parsed = self.__dict__.get("_added_parsed")
        if parsed is None:
            parsed = NodeAffinity.from_dict(self.added_affinity)
            self.__dict__["_added_parsed"] = parsed
        return [with_added_node_affinity(p, parsed) for p in pods]

    @property
    def enabled_filters(self) -> Optional[set]:
        if not self.disabled_filters:
            return None
        return {f for f in ALL_FILTER_PLUGINS if f not in self.disabled_filters}

    def weights(self) -> dict[str, float]:
        w = dict(DEFAULT_WEIGHTS)
        w.update(self.score_weights)
        return w

    @classmethod
    def from_dict(cls, d: dict) -> "Profile":
        return cls(
            scheduler_name=d.get("schedulerName", DEFAULT_SCHEDULER_NAME),
            disabled_filters=list(d.get("disabledFilters") or []),
            score_weights={k: float(v) for k, v in (d.get("scoreWeights") or {}).items()},
            fit_strategy=d.get("fitStrategy", "LeastAllocated"),
            percentage_of_nodes_to_score=int(d.get("percentageOfNodesToScore", 0)),
            out_of_tree=(list(d["outOfTree"])
                         if d.get("outOfTree") is not None else None),
            added_affinity=(_plugin_args(d.get("pluginConfig"),
                                         "NodeAffinity")
                            .get("addedAffinity")
                            or d.get("addedAffinity")),
        )


@dataclass
class SchedulerConfiguration:
    profiles: list[Profile] = field(default_factory=lambda: [Profile()])
    # scheduler-extender webhooks (kube-scheduler/config/v1 Extender);
    # sched/extender.py calls them during every scheduling cycle
    extenders: list = field(default_factory=list)  # list[ExtenderConfig]
    batch_size: int = 256          # pods per gang step (pop_batch max)
    # Deep-backlog drain: when one pop yields more than batch_size pods the
    # loop fuses up to this many batches into ONE device program (lax.scan,
    # models/gang.py gang_drain) — one dispatch + one readback for the whole
    # backlog instead of a ~100ms round trip per batch on remote TPUs.
    max_drain_batches: int = 8
    # Dispatch-pipeline depth: how many fused drains may be in flight on the
    # device at once (sched/scheduler.py). Depth 1 reproduces the old
    # one-deep software pipeline (resolve k blocks dispatch k+1); depth N
    # lets dispatch of drain k+1..k+N overlap resolve of drain k, hiding
    # host-side apply/bind work behind device execution. jax dispatch is
    # asynchronous, so deeper pipelines cost HBM for queued programs only.
    pipeline_depth: int = 2
    # Fused fold: churn patches ride the drain dispatch as a third input of
    # the resident device program (models/gang.py drain_step) instead of a
    # separate blocking apply_ctx_patch dispatch — and fold-SAFE churn
    # (encode/patch.py entries_fold_safe) no longer drains the dispatch
    # pipeline first. False restores the PR3-era patch-then-dispatch path
    # (the parity tests diff the two). KTPU_FUSED_FOLD=0 overrides.
    fused_fold: bool = True
    # Pre-sharded double-buffered batch staging (sched/staging.py): batch
    # K+1's pod stack uploads to pre-sharded device buffers on a background
    # thread while batch K runs; dispatch swaps buffers instead of paying a
    # device_put. False restores the inline staging path (the A/B the
    # staging parity tests diff). KTPU_STAGE_ARENA=0 overrides.
    staging_arena: bool = True
    # Device-mesh shape (pods_axis, nodes_axis) for the live scheduling
    # path: cluster tensors shard over "nodes", pod batches over "pods",
    # and the drain/preemption programs run on every shard with explicit
    # collectives (parallel/mesh.py). None = single-device (default; tier-1
    # CPU runs are unchanged). YAML ``meshShape: [1, 2]`` or ``"1x2"``; the
    # KTPU_MESH env var overrides at scheduler construction.
    mesh_shape: Optional[tuple] = None
    max_gang_rounds: int = 64
    seed: int = 0
    backoff_initial_s: float = 1.0
    backoff_max_s: float = 10.0
    assume_ttl_s: float = 30.0
    client_qps: float = 0.0        # 0 = uncapped (reference default: 50)
    bind_workers: int = 16         # binding-cycle pool size (goroutine analog)
    parallelism: int = 16          # compat field; unused on TPU
    leader_elect: bool = False
    # ---- self-healing knobs (sched/resilience.py) ------------------------
    # Device circuit breaker: this many CONSECUTIVE device-program failures
    # degrade one level (mesh -> single-device -> pure-numpy oracle); after
    # the cooldown one cycle half-open-probes the better level back.
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    # Bind/status writes: extra in-request retries (full-jitter backoff)
    # before a transient API failure falls through to the requeue path.
    bind_retries: int = 2
    bind_retry_backoff_s: float = 0.05
    # Thread watchdog: sweep cadence, and how stale a busy thread's
    # heartbeat may grow before it counts as stalled (generous default —
    # a first-touch XLA compile can legitimately run minutes; a stalled
    # verdict only SIGNALS the term to stop, the restart waits for the
    # thread to actually exit).
    watchdog_interval_s: float = 2.0
    watchdog_stall_s: float = 600.0
    # ---- continuous auditing (kubernetes_tpu/audit/) ---------------------
    # Invariant auditor sweep cadence: every sweep takes a resourceVersion-
    # consistent apiserver list + scheduler-cache view and checks the
    # correctness invariants (no overcommit, no double-bind, gang
    # atomicity, nomination consistency, cache/ctx parity).
    audit_interval_s: float = 30.0
    # Fail-fast: a confirmed violation RAISES (tests/benches) instead of
    # only counting + writing a repro bundle (production default).
    audit_fail_fast: bool = False
    # Device-parity sentinel: every Kth drain_step dispatch
    # is re-checked against the numpy oracle off the hot path; a refuted
    # answer stops the scheduling loop with a ParityError. 0 disables.
    parity_sample_every: int = 16
    # ---- explainable scheduling (sched/explainer.py) ---------------------
    # Decision-provenance explainer: a background thread re-runs the static
    # filter stack in per-filter-output mode over each cycle's
    # unschedulable pods, producing upstream-style FailedScheduling
    # messages, the scheduler-explanations ConfigMap (ktpu why), and
    # scheduler_unschedulable_reasons_total. Zero dispatches added to the
    # drain cycle.
    explainer_enabled: bool = True
    # ---- durable kernel cache (sched/aotcache.py) --------------------------
    # Directory for the persisted nvcc-built kernel libraries: a restarted
    # scheduler loads them instead of building. The directory is
    # fingerprint-guarded (torch/CUDA/driver/card/nvcc + config knobs) and
    # checksum-scanned at boot; any damaged entry degrades to a counted
    # rebuild. None = disabled (the default). YAML ``aotCacheDir``; the
    # KTPU_AOT_CACHE env var overrides ("0"/"off" disables).
    aot_cache_dir: Optional[str] = None
    # Size bound for the cache directory; the least recently used entries
    # rotate out past it (counted under
    # scheduler_aot_cache_invalidations_total).
    aot_cache_max_mb: int = 512

    def profile_for(self, scheduler_name: str) -> Optional[Profile]:
        for p in self.profiles:
            if p.scheduler_name == scheduler_name:
                return p
        return None

    @classmethod
    def from_dict(cls, d: dict) -> "SchedulerConfiguration":
        cfg = cls()
        if d.get("profiles"):
            cfg.profiles = [Profile.from_dict(p) for p in d["profiles"]]
        if d.get("extenders"):
            from kubernetes_tpu_torch.sched.extender import ExtenderConfig
            cfg.extenders = [ExtenderConfig.from_dict(e) for e in d["extenders"]]
        for yaml_key, attr in [
            ("batchSize", "batch_size"), ("maxGangRounds", "max_gang_rounds"),
            ("maxDrainBatches", "max_drain_batches"),
            ("pipelineDepth", "pipeline_depth"),
            ("fusedFold", "fused_fold"),
            ("stagingArena", "staging_arena"),
            ("seed", "seed"), ("backoffInitialSeconds", "backoff_initial_s"),
            ("backoffMaxSeconds", "backoff_max_s"), ("assumeTTLSeconds", "assume_ttl_s"),
            ("clientQPS", "client_qps"), ("parallelism", "parallelism"),
            ("bindWorkers", "bind_workers"),
            ("leaderElect", "leader_elect"),
            ("breakerFailureThreshold", "breaker_threshold"),
            ("breakerCooldownSeconds", "breaker_cooldown_s"),
            ("bindRetries", "bind_retries"),
            ("bindRetryBackoffSeconds", "bind_retry_backoff_s"),
            ("watchdogIntervalSeconds", "watchdog_interval_s"),
            ("watchdogStallSeconds", "watchdog_stall_s"),
            ("auditIntervalSeconds", "audit_interval_s"),
            ("auditFailFast", "audit_fail_fast"),
            ("paritySampleEvery", "parity_sample_every"),
            ("explainerEnabled", "explainer_enabled"),
            ("aotCacheMaxMB", "aot_cache_max_mb"),
        ]:
            if yaml_key in d:
                setattr(cfg, attr, type(getattr(cfg, attr))(d[yaml_key]))
        if "aotCacheDir" in d:
            # Optional[str]: the generic type-cast list above would turn
            # None into the string "None"
            v = d["aotCacheDir"]
            cfg.aot_cache_dir = str(v) if v else None
        if "meshShape" in d:
            try:
                cfg.mesh_shape = parse_mesh_shape(d["meshShape"])
            except (ValueError, TypeError) as e:
                raise ValidationError(f"bad meshShape: {e}")
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "SchedulerConfiguration":
        import yaml
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})


class ValidationError(ValueError):
    pass


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue A item {item}")


def validate(cfg: SchedulerConfiguration):
    """pkg/scheduler/apis/config/validation analog: fail fast on bad config."""
    if not cfg.profiles:
        raise ValidationError("at least one profile required")
    seen = set()
    for p in cfg.profiles:
        if not p.scheduler_name:
            raise ValidationError("profile schedulerName must be non-empty")
        if p.scheduler_name in seen:
            raise ValidationError(f"duplicate profile {p.scheduler_name!r}")
        seen.add(p.scheduler_name)
        if p.fit_strategy not in FIT_STRATEGIES:
            raise ValidationError(f"unknown fitStrategy {p.fit_strategy!r}")
        for name in p.disabled_filters:
            if name not in ALL_FILTER_PLUGINS:
                raise ValidationError(f"unknown filter plugin {name!r}")
        for name, w in p.score_weights.items():
            if name not in ALL_SCORE_PLUGINS:
                raise ValidationError(f"unknown score plugin {name!r}")
            if w < 0:
                raise ValidationError(f"negative weight for {name!r}")
        if not 0 <= p.percentage_of_nodes_to_score <= 100:
            raise ValidationError("percentageOfNodesToScore must be in [0,100]")
    if cfg.batch_size < 1:
        raise ValidationError("batchSize must be >= 1")
    if cfg.max_gang_rounds < 1:
        raise ValidationError("maxGangRounds must be >= 1")
    if cfg.max_drain_batches < 1:
        raise ValidationError("maxDrainBatches must be >= 1")
    if cfg.pipeline_depth < 1:
        raise ValidationError("pipelineDepth must be >= 1")
    if cfg.bind_workers < 1:
        raise ValidationError("bindWorkers must be >= 1")
    if cfg.breaker_threshold < 1:
        raise ValidationError("breakerFailureThreshold must be >= 1")
    if cfg.breaker_cooldown_s < 0:
        raise ValidationError("breakerCooldownSeconds must be >= 0")
    if cfg.bind_retries < 0:
        raise ValidationError("bindRetries must be >= 0")
    if cfg.bind_retry_backoff_s < 0:
        raise ValidationError("bindRetryBackoffSeconds must be >= 0")
    if cfg.watchdog_interval_s <= 0:
        raise ValidationError("watchdogIntervalSeconds must be > 0")
    if cfg.watchdog_stall_s <= 0:
        raise ValidationError("watchdogStallSeconds must be > 0")
    if cfg.audit_interval_s <= 0:
        raise ValidationError("auditIntervalSeconds must be > 0")
    if cfg.parity_sample_every < 0:
        raise ValidationError("paritySampleEvery must be >= 0 (0 = off)")
    if cfg.aot_cache_max_mb < 1:
        raise ValidationError("aotCacheMaxMB must be >= 1")
    if cfg.mesh_shape is not None:
        if len(cfg.mesh_shape) != 2:
            raise ValidationError(
                f"meshShape must be (pods, nodes), got {cfg.mesh_shape}")
        pods_axis, nodes_axis = cfg.mesh_shape
        for ax in (pods_axis, nodes_axis):
            # every tensor bucket is a power of two (encode/dictionary.py
            # next_bucket), so power-of-two axes always divide evenly and
            # shards stay layout-uniform
            if ax < 1 or ax & (ax - 1):
                raise ValidationError(
                    f"meshShape axes must be powers of two, got {cfg.mesh_shape}")
        if cfg.batch_size % pods_axis:
            raise ValidationError(
                f"batchSize ({cfg.batch_size}) must be divisible by the "
                f"meshShape pods axis ({pods_axis}) so pod padding shards "
                "evenly")
