"""Container runtime interface + hollow implementation.

Reference: the CRI gRPC surface in
``staging/src/k8s.io/cri-api/pkg/apis/runtime/v1/api.proto`` (RunPodSandbox /
CreateContainer / StartContainer / StopPodSandbox / ListPodSandbox ...) as
consumed by ``pkg/kubelet/kuberuntime/kuberuntime_manager.go``. The hollow
runtime is the kubemark stand-in (``pkg/kubemark/hollow_kubelet.go``): real
kubelet logic over mocked containers, so thousands of nodes fit in one
process.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

# container states (runtimeapi.ContainerState)
CREATED, RUNNING, EXITED = "CREATED", "RUNNING", "EXITED"


@dataclass
class ContainerStatus:
    name: str
    state: str = CREATED
    exit_code: int = 0
    started_at: float = 0.0
    finished_at: float = 0.0
    restart_count: int = 0
    # hollow health signal probed by kubelet/prober.py (the exec/http probe
    # handler analog): tests flip it via FakeRuntime.set_health
    healthy: bool = True


@dataclass
class PodSandboxStatus:
    pod_uid: str
    name: str
    namespace: str
    ip: str = ""
    created_at: float = field(default_factory=time.time)
    containers: dict[str, ContainerStatus] = field(default_factory=dict)


class ContainerRuntime:
    """The kubelet-facing runtime surface (CRI analog)."""

    def run_pod_sandbox(self, pod_uid: str, name: str, namespace: str) -> PodSandboxStatus:
        raise NotImplementedError

    def stop_pod_sandbox(self, pod_uid: str) -> None:
        raise NotImplementedError

    def create_container(self, pod_uid: str, name: str, image: str) -> None:
        raise NotImplementedError

    def start_container(self, pod_uid: str, name: str) -> None:
        raise NotImplementedError

    def list_sandboxes(self) -> list[PodSandboxStatus]:
        raise NotImplementedError

    def get_sandbox(self, pod_uid: str) -> Optional[PodSandboxStatus]:
        raise NotImplementedError

    def stop_container(self, pod_uid: str, name: str, exit_code: int = 137) -> None:
        raise NotImplementedError

    def probe(self, pod_uid: str, name: str) -> bool:
        """Execute the probe handler against a container (exec/http analog).
        Default: RUNNING and healthy."""
        sb = self.get_sandbox(pod_uid)
        c = sb.containers.get(name) if sb else None
        return c is not None and c.state == RUNNING and c.healthy


class FakeRuntime(ContainerRuntime):
    """Hollow runtime: containers are dicts; ``exit_after`` seconds (if set)
    flips RUNNING containers to EXITED(code 0) to simulate workloads
    completing — the knob batch/Job end-to-end tests turn.

    ``start_latency`` models image pull + container start cost; sandbox IPs
    come from the injected allocator (kubelet hands one in per node).
    """

    def __init__(self, exit_after: Optional[float] = None,
                 start_latency: float = 0.0,
                 ip_alloc=None):
        self.exit_after = exit_after
        self.start_latency = start_latency
        self._ip_alloc = ip_alloc or (lambda: "10.88.0.1")
        self._lock = threading.Lock()
        self._sandboxes: dict[str, PodSandboxStatus] = {}
        self._logs: dict[tuple, list[str]] = {}

    def run_pod_sandbox(self, pod_uid, name, namespace):
        if self.start_latency:
            time.sleep(self.start_latency)
        with self._lock:
            sb = self._sandboxes.get(pod_uid)
            if sb is None:
                sb = PodSandboxStatus(pod_uid, name, namespace, ip=self._ip_alloc())
                self._sandboxes[pod_uid] = sb
            return sb

    MAX_LOG_LINES = 200  # per container; restart loops must not grow RAM

    def stop_pod_sandbox(self, pod_uid):
        with self._lock:
            sb = self._sandboxes.pop(pod_uid, None)
            if sb is not None:
                for c in sb.containers.values():
                    if c.state == RUNNING:
                        c.state = EXITED
                        c.exit_code = 137  # SIGKILL
                        c.finished_at = time.time()
                # the sandbox is gone: its log files go with it (a hollow
                # fleet under pod churn would otherwise leak every uid ever
                # run)
                for k in [k for k in self._logs if k[0] == pod_uid]:
                    del self._logs[k]

    def create_container(self, pod_uid, name, image):
        if self.start_latency:
            time.sleep(self.start_latency)
        with self._lock:
            sb = self._sandboxes[pod_uid]
            cur = sb.containers.get(name)
            restart = cur.restart_count + 1 if cur is not None else 0
            sb.containers[name] = ContainerStatus(name, restart_count=restart)

    def start_container(self, pod_uid, name):
        with self._lock:
            c = self._sandboxes[pod_uid].containers[name]
            c.state = RUNNING
            c.started_at = time.time()
            lines = self._logs.setdefault((pod_uid, name), [])
            lines.append(
                f"{time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())} "
                f"container {name} started (restart {c.restart_count})")
            del lines[:-self.MAX_LOG_LINES]

    # ---- kubelet API surface (logs / exec) -------------------------------

    def logs(self, pod_uid, name) -> list[str]:
        """Container log lines (CRI ReopenContainerLog/log-file analog:
        the hollow runtime records lifecycle lines; tests and ktpu logs
        read them through the kubelet server)."""
        with self._lock:
            return list(self._logs.get((pod_uid, name), []))

    def append_log(self, pod_uid, name, line: str) -> None:
        with self._lock:
            lines = self._logs.setdefault((pod_uid, name), [])
            lines.append(line)
            del lines[:-self.MAX_LOG_LINES]

    def exec(self, pod_uid, name, command: list[str]) -> tuple[int, str]:
        """Synchronous exec (CRI ExecSync analog): the hollow container
        answers a tiny shell — enough for kubectl-exec-shaped round trips."""
        with self._lock:
            sb = self._sandboxes.get(pod_uid)
            c = sb.containers.get(name) if sb else None
            if c is None or c.state != RUNNING:
                return 1, "container not running"
        if not command:
            return 1, "no command"
        if command[0] == "echo":
            return 0, " ".join(command[1:]) + "\n"
        if command[0] == "hostname":
            return 0, f"{pod_uid[:8]}\n"
        if command[0] == "true":
            return 0, ""
        return 127, f"{command[0]}: command not found\n"

    def stop_container(self, pod_uid, name, exit_code: int = 137):
        with self._lock:
            sb = self._sandboxes.get(pod_uid)
            c = sb.containers.get(name) if sb else None
            if c is not None and c.state == RUNNING:
                c.state = EXITED
                c.exit_code = exit_code
                c.finished_at = time.time()

    def set_health(self, pod_uid, name, healthy: bool):
        """Test hook: flip the hollow probe signal for a container."""
        with self._lock:
            sb = self._sandboxes.get(pod_uid)
            if sb is not None and name in sb.containers:
                sb.containers[name].healthy = healthy

    def _tick_locked(self):
        if self.exit_after is None:
            return
        now = time.time()
        for sb in self._sandboxes.values():
            for c in sb.containers.values():
                if c.state == RUNNING and now - c.started_at >= self.exit_after:
                    c.state = EXITED
                    c.exit_code = 0
                    c.finished_at = now

    def list_sandboxes(self):
        with self._lock:
            self._tick_locked()
            return list(self._sandboxes.values())

    def get_sandbox(self, pod_uid):
        with self._lock:
            self._tick_locked()
            return self._sandboxes.get(pod_uid)
