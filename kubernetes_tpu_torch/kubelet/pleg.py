"""PLEG — pod lifecycle event generator.

Reference: ``pkg/kubelet/pleg/generic.go`` (``GenericPLEG.Relist``: poll the
runtime, diff per-container states against the last relist, emit
ContainerStarted/ContainerDied/... events that wake the sync loop).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

from kubernetes_tpu_torch.kubelet.runtime import ContainerRuntime

CONTAINER_STARTED = "ContainerStarted"
CONTAINER_DIED = "ContainerDied"
SANDBOX_REMOVED = "SandboxRemoved"


@dataclass
class PodLifecycleEvent:
    pod_uid: str
    type: str
    container: str = ""


class GenericPLEG:
    def __init__(self, runtime: ContainerRuntime, relist_period: float = 0.2):
        self.runtime = runtime
        self.relist_period = relist_period
        self.events: "queue.Queue[PodLifecycleEvent]" = queue.Queue()
        self._last: dict[str, dict[str, str]] = {}  # uid -> {container: state}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.relist_period):
            self.relist()

    def relist(self):
        current: dict[str, dict[str, str]] = {}
        for sb in self.runtime.list_sandboxes():
            current[sb.pod_uid] = {c.name: c.state for c in sb.containers.values()}
        for uid, containers in current.items():
            old = self._last.get(uid, {})
            for name, state in containers.items():
                if old.get(name) != state:
                    ev_type = (CONTAINER_STARTED if state == "RUNNING"
                               else CONTAINER_DIED if state == "EXITED" else None)
                    if ev_type:
                        self.events.put(PodLifecycleEvent(uid, ev_type, name))
        for uid in self._last:
            if uid not in current:
                self.events.put(PodLifecycleEvent(uid, SANDBOX_REMOVED))
        self._last = current
