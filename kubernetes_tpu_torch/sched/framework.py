"""Framework extension points — out-of-tree plugins without forking.

Reference: ``pkg/scheduler/framework/`` (``Registry`` in runtime/registry.go,
the ``Plugin`` interfaces in interface.go, ``NewFramework``'s out-of-tree
registry merge in scheduler.go). Upstream extension points map here as:

  Filter / Score        TensorPlugin — functions of torch ops over the
                        encoded (ClusterTensors, PodBatch) that run INSIDE
                        every gang round (models/schedule_step.evaluate),
                        and so inside the rounds' captured CUDA graphs on
                        the card: a filter returns a [P,N] mask ANDed into
                        feasibility, a score returns raw [P,N] merged
                        through the shared normalize/weight pipeline. You
                        extend the device program, not a Go callback chain.
  Permit / PreBind /    LifecyclePlugin — host-side hooks on the binding
  PostBind / Unreserve  cycle (waiting-pod gate, pre-bind side effects with
                        rollback, post-bind notification), exactly where
                        volume binding and DRA allocation already sit.

Profiles opt in by plugin name (``Profile.out_of_tree``); unlisted profiles
run every registered plugin, mirroring the default-enablement of
out-of-tree registries compiled into upstream schedulers.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

_LOG = logging.getLogger(__name__)

# permit verdicts (framework.Code)
ALLOW, DENY, WAIT = "allow", "deny", "wait"


@dataclass(frozen=True)
class TensorPlugin:
    """A Filter and/or Score extension compiled into the device program.

    ``filter_fn(ct, pb, topo_keys) -> bool [P,N]`` — False vetoes the node.
    ``score_fn(ct, pb, topo_keys) -> float32 [P,N]`` raw scores, merged via
    ``normalize`` ("minmax" | "default" | "default_reverse") and ``weight``
    like any in-tree score plugin. ``ct``/``pb`` hold torch tensors on the
    batch's device (the card, or the CPU when the caller asked for it), and
    the result must lie on that device.

    The functions must be CAPTURABLE: on the card each chunk of gang rounds
    is recorded once as a CUDA graph and replayed (models/graphs.py), so a
    plugin may use torch ops only — no host read (``.item()``, ``.cpu()``,
    ``.tolist()``, ``int()``/``bool()`` of a tensor, a Python branch on a
    tensor's value) and no new pinned memory. Such a read fails the capture
    with a ``GraphError``, which stops the scheduler (sched/faults.is_fatal)
    and never hands the batch to the oracle. Shapes (``.shape``) are static
    and may steer Python code. The plugin itself is part of every graph key,
    so two profiles with different plugin sets never share a graph.
    """

    name: str
    filter_fn: Optional[Callable] = None
    score_fn: Optional[Callable] = None
    normalize: str = "minmax"
    weight: float = 1.0


@dataclass(frozen=True)
class LifecyclePlugin:
    """Host-side binding-cycle hooks.

    ``permit(pod, node_name) -> "allow" | "deny" | ("wait", seconds)``
    ``pre_bind(pod, node_name) -> bool`` — False aborts the bind.
    ``post_bind(pod, node_name)`` — notification after a successful bind.
    ``unreserve(pod, node_name)`` — rollback when the cycle fails after
    this plugin's pre_bind succeeded (or permit allowed).
    """

    name: str
    permit: Optional[Callable] = None
    pre_bind: Optional[Callable] = None
    post_bind: Optional[Callable] = None
    unreserve: Optional[Callable] = None


class Registry:
    """Out-of-tree plugin registry (runtime.Registry analog)."""

    def __init__(self):
        self._tensor: dict[str, TensorPlugin] = {}
        self._lifecycle: dict[str, LifecyclePlugin] = {}
        self._lock = threading.Lock()

    def register(self, plugin) -> "Registry":
        with self._lock:
            if isinstance(plugin, TensorPlugin):
                from kubernetes_tpu_torch.config.types import (
                    ALL_FILTER_PLUGINS,
                    ALL_SCORE_PLUGINS,
                )
                if (plugin.name in ALL_FILTER_PLUGINS
                        or plugin.name in ALL_SCORE_PLUGINS):
                    # an in-tree name would silently shadow or double-count
                    # in the shared weight map (combined_score keys by name)
                    raise ValueError(
                        f"{plugin.name!r} is an in-tree plugin name")
                if plugin.name in self._tensor:
                    raise ValueError(f"tensor plugin {plugin.name!r} already "
                                     "registered")
                self._tensor[plugin.name] = plugin
            elif isinstance(plugin, LifecyclePlugin):
                if plugin.name in self._lifecycle:
                    raise ValueError(f"lifecycle plugin {plugin.name!r} "
                                     "already registered")
                self._lifecycle[plugin.name] = plugin
            else:
                raise TypeError(f"unknown plugin type {type(plugin)!r}")
        return self

    def tensor_plugins(self, enabled: Optional[set] = None) -> tuple:
        """-> the static tuple the rounds take (order-stable by name)."""
        with self._lock:
            return tuple(p for n, p in sorted(self._tensor.items())
                         if enabled is None or n in enabled)

    def lifecycle_plugins(self, enabled: Optional[set] = None) -> tuple:
        with self._lock:
            return tuple(p for n, p in sorted(self._lifecycle.items())
                         if enabled is None or n in enabled)


def run_permit(plugins: tuple, pod, node_name: str,
               max_wait_s: float = 30.0) -> tuple[bool, list]:
    """Permit phase: every plugin must allow. "wait" polls the plugin until
    it answers allow/deny or the timeout lapses (WaitingPod analog, polled
    rather than callback-driven). -> (ok, plugins that ALLOWED — they join
    the unreserve rollback set if the cycle fails later)."""
    allowed: list = []
    for p in plugins:
        if p.permit is None:
            continue
        deadline = time.time() + max_wait_s
        while True:
            verdict = p.permit(pod, node_name)
            if isinstance(verdict, tuple) and verdict and verdict[0] == WAIT:
                wait_s = float(verdict[1]) if len(verdict) > 1 else 0.1
                if time.time() + wait_s > deadline:
                    return False, allowed  # timed-out waits reject (upstream)
                time.sleep(min(wait_s, max(deadline - time.time(), 0)))
                continue
            if verdict == WAIT:
                if time.time() >= deadline:
                    return False, allowed
                time.sleep(0.05)
                continue
            if verdict != ALLOW:
                return False, allowed
            allowed.append(p)
            break
    return True, allowed


def run_pre_bind(plugins: tuple, pod, node_name: str) -> tuple[bool, list]:
    """-> (ok, plugins whose pre_bind succeeded — for unreserve rollback)."""
    done: list = []
    for p in plugins:
        if p.pre_bind is None:
            continue
        try:
            ok = bool(p.pre_bind(pod, node_name))
        except Exception:
            _LOG.exception("preBind plugin %r failed; aborting bind",
                           getattr(p, 'name', p))
            ok = False
        if not ok:
            return False, done
        done.append(p)
    return True, done


def run_unreserve(plugins: list, pod, node_name: str) -> None:
    for p in reversed(plugins):
        if p.unreserve is not None:
            try:
                p.unreserve(pod, node_name)
            except Exception:
                # best-effort rollback chain: later plugins still unwind
                _LOG.exception("unreserve plugin %r failed",
                               getattr(p, 'name', p))


def run_post_bind(plugins: tuple, pod, node_name: str) -> None:
    for p in plugins:
        if p.post_bind is not None:
            try:
                p.post_bind(pod, node_name)
            except Exception:
                # informational hook: the bind already landed
                _LOG.exception("postBind plugin %r failed",
                               getattr(p, 'name', p))
