"""Kubelet — the node agent: sync loop, pod workers, PLEG, status, heartbeat.

Reference: ``pkg/kubelet/kubelet.go`` (``Kubelet.Run`` -> ``syncLoop`` ->
``syncLoopIteration`` selecting over config/PLEG channels; ``SyncPod``
computing container actions via ``kuberuntime_manager.go``), node status in
``pkg/kubelet/kubelet_node_status.go`` (register + heartbeat Ready
condition), status manager in ``pkg/kubelet/status/status_manager.go``
(PATCH pod status on change).

``HollowNode`` (bottom) is the kubemark analog: a full kubelet over
``FakeRuntime``, cheap enough to run hundreds per process.

The PyTorch port of ``kubernetes_tpu/kubelet/kubelet.py``. Unlike the
reference's, a kubelet whose Node carries a ``spec.podCIDR`` (nodeipam,
read at each heartbeat) hands out pod IPs from it, so the kubelets of two
processes (``ktpu-up init`` and ``join``) never share an address.
"""

from __future__ import annotations

import ipaddress
import itertools
import logging
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.client.clientset import ApiError

_LOG = logging.getLogger(__name__)
from kubernetes_tpu_torch.client.informer import SharedInformer
from kubernetes_tpu_torch.kubelet.pleg import GenericPLEG
from kubernetes_tpu_torch.kubelet.pod_workers import PodWorkers
from kubernetes_tpu_torch.kubelet.prober import ProbeManager
from kubernetes_tpu_torch.kubelet.resources import AllocatableAdmitter, CPUManager
from kubernetes_tpu_torch.kubelet.runtime import (
    EXITED,
    RUNNING,
    ContainerRuntime,
    FakeRuntime,
)
from kubernetes_tpu_torch.kubelet.volumemanager import VolumeManager

_node_ip_counter = itertools.count(1)


class Kubelet:
    def __init__(self, client, node_name: str,
                 runtime: Optional[ContainerRuntime] = None,
                 allocatable: Optional[dict] = None,
                 labels: Optional[dict] = None,
                 taints: Optional[list] = None,
                 heartbeat_period: float = 2.0,
                 register_node: bool = True):
        self.client = client
        self.node_name = node_name
        self.node_idx = next(_node_ip_counter)
        self._pod_ip_seq = itertools.count(2)
        # the node's spec.podCIDR once nodeipam assigned it (read at each
        # heartbeat): pod IPs come from it then, as host-local IPAM's do
        self.pod_cidr: Optional[str] = None
        self.runtime = runtime if runtime is not None else FakeRuntime(
            ip_alloc=self._next_pod_ip)
        self.allocatable = allocatable or {"cpu": "8", "memory": "16Gi",
                                           "pods": "110"}
        self.labels = labels or {}
        # --register-with-taints: emitted at registration (and heartbeat
        # re-registration) so node-group templates with taints provision
        # nodes matching what the autoscaler simulation evaluated
        self.taints = [dict(t) for t in (taints or [])]
        # deprovisioned (autoscaler scale-down): a dead kubelet must never
        # heartbeat or re-register — heartbeat_once's 404-heal path would
        # otherwise resurrect the just-deleted Node as a Ready zombie
        self.dead = False
        self.heartbeat_period = heartbeat_period
        self.register_node = register_node
        self.pleg = GenericPLEG(self.runtime)
        self.workers = PodWorkers(self._sync_pod)
        self.prober = ProbeManager(self.runtime, self._on_liveness_failure,
                                   self._on_readiness_change)
        self.volumes = VolumeManager()
        self.admitter = AllocatableAdmitter(self.allocatable)
        from kubernetes_tpu_torch.api.resource import canonical
        self.cpu_manager = CPUManager(max(1, canonical(
            "cpu", str(self.allocatable.get("cpu", "1"))) // 1000))
        # cm/ managers beyond cpu: device plugins, NUMA memory, topology
        # alignment (pkg/kubelet/cm/{devicemanager,memorymanager,
        # topologymanager}); single-NUMA default mirrors small nodes,
        # tests reconfigure via the attributes
        from kubernetes_tpu_torch.kubelet.managers import (
            DeviceManager, MemoryManager, TopologyManager)
        mem_mib = canonical(
            "memory", str(self.allocatable.get("memory", "1Gi"))) >> 20
        self.device_manager = DeviceManager()
        self.memory_manager = MemoryManager([int(mem_mib)])
        self.topology_manager = TopologyManager(num_numa=1)
        self.topology_manager.add_provider(self.device_manager)
        self.topology_manager.add_provider(self.memory_manager)
        self._informer: Optional[SharedInformer] = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._pods_lock = threading.Lock()
        self._pods: dict[str, dict] = {}  # uid -> latest pod object
        self._admitted: dict[str, dict] = {}  # uid -> pod as admitted
        self._rejected: dict[str, str] = {}   # uid -> rejection reason
        from kubernetes_tpu_torch.utils.events import EventRecorder
        self.recorder = EventRecorder(client, f"kubelet/{node_name}")
        self.server = None  # KubeletServer once start(serve=True) runs
        # optional status transport override: sink(ns, name, status) — the
        # kubemark fleet batches hundreds of kubelets' status PATCHes into
        # bulk POSTs through this (kubelet/kubemark.py _StatusBatcher);
        # None = direct per-pod update_status as upstream
        self.status_sink = None
        # same pattern for the node's own liveness traffic: when set,
        # heartbeat_once/_renew_lease enqueue into the fleet batchers
        # (sink(node_name, status_patch) / sink(node_name)) instead of
        # paying their own GET+PUT round trips — the kubelet keeps its
        # loop and cadence, only the transport is batched
        self.heartbeat_sink = None
        self.lease_sink = None

    def _next_pod_ip(self) -> str:
        """The next pod IP: from the node's podCIDR where nodeipam assigned
        one (the reference always counts from a process-global node index,
        so the kubelets of two processes hand out the same addresses), else
        from that index."""
        n = next(self._pod_ip_seq)
        cidr = self.pod_cidr
        if cidr:
            net = ipaddress.ip_network(cidr, strict=False)
            if n < net.num_addresses - 1:
                return str(net.network_address + n)
        return f"10.{self.node_idx % 200 + 10}.{n // 250}.{n % 250}"

    # ---- node registration + heartbeat ----------------------------------

    def _node_object(self) -> dict:
        status = {
            "allocatable": dict(self.allocatable),
            "capacity": dict(self.allocatable),
            "conditions": [self._ready_condition()],
        }
        self._apply_endpoint_status(status)
        spec: dict = {}
        if self.taints:
            spec["taints"] = [dict(t) for t in self.taints]
        return {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": self.node_name, "labels": dict(self.labels)},
            "spec": spec,
            "status": status,
        }

    def _uid_of(self, ns: str, name: str):
        """pod-manager name lookup for the kubelet API server."""
        with self._pods_lock:
            for uid, p in self._pods.items():
                md = p.get("metadata") or {}
                if (md.get("namespace", "default") == ns
                        and md.get("name", "") == name):
                    return uid
        return None

    def _apply_endpoint_status(self, status: dict) -> None:
        """The apiserver proxies log/exec/portforward subresources here
        (node.status.daemonEndpoints.kubeletEndpoint upstream). Shared by
        registration and the heartbeat so a restarted kubelet's fresh port
        always reaches the Node."""
        if self.server is not None:
            status["addresses"] = [{"type": "InternalIP",
                                    "address": "127.0.0.1"}]
            status["daemonEndpoints"] = {
                "kubeletEndpoint": {"Port": self.server.port}}

    def _ready_condition(self) -> dict:
        return {"type": "Ready", "status": "True",
                "reason": "KubeletReady",
                "lastHeartbeatTime": time.time()}

    def _register(self):
        if self.dead:
            return
        try:
            self.client.nodes().create(self._node_object())
        except ApiError as e:
            if e.code != 409:
                raise  # exists: adopt + heartbeat

    def heartbeat_payload(self) -> dict:
        """The status patch one heartbeat asserts: a fresh Ready condition
        plus the kubelet endpoint (nodes/-/status merges conditions by
        type server-side, so this is exactly what the read-modify-write
        singleton path produced)."""
        status: dict = {"conditions": [self._ready_condition()]}
        self._apply_endpoint_status(status)
        return status

    def heartbeat_once(self):
        """One heartbeat: refresh the Ready condition AND re-assert the
        kubelet endpoint (a restarted kubelet binds a fresh port; the old
        daemonEndpoints on the adopted Node would 502 every logs/exec proxy
        until corrected). Re-registers if the Node vanished. Routed through
        ``heartbeat_sink`` when set (the kubemark fleet batcher bulk-POSTs
        the whole fleet's refreshes and re-registers per-item 404s); the
        sink path defers the span to the batcher's bulk flush."""
        if self.dead:
            return
        if self.heartbeat_sink is not None:
            self.heartbeat_sink(self.node_name, self.heartbeat_payload())
            return
        from kubernetes_tpu_torch.utils.tracing import TRACER
        with TRACER.span("kubelet/heartbeat"):
            self._heartbeat_inner()

    def _heartbeat_inner(self):
        try:
            node = self.client.nodes().get(self.node_name)
            self.pod_cidr = ((node.get("spec") or {}).get("podCIDR")
                             or self.pod_cidr)
            st = node.setdefault("status", {})
            conds = [c for c in st.get("conditions") or []
                     if c.get("type") != "Ready"]
            st["conditions"] = conds + [self._ready_condition()]
            self._apply_endpoint_status(st)
            self.client.nodes().update_status(node)
        except ApiError:
            # node vanished (or update raced a delete): re-create it —
            # even register_node=False kubelets (fleet-registered, e.g.
            # kubemark) heal their own Node here, as the old per-fleet
            # heartbeat did
            try:
                self._register()
            except ApiError:
                pass

    def _renew_lease(self):
        """The kubelet's cheap heartbeat (pkg/kubelet/nodelease): a Lease in
        kube-node-lease renewed every period — node-lifecycle treats a
        fresh renewTime as liveness even when the status heartbeat lags
        (status updates are 5-minutely upstream; leases are the signal).
        Never raises: a throttled/conflicted renewal (APF 429, rv race) is
        simply dropped until the next period — surfacing it would be
        misread as the node having vanished (heartbeat_once re-registers on
        ApiError) or kill a kubemark driver thread."""
        if self.lease_sink is not None:
            if not self.dead:
                self.lease_sink(self.node_name)
            return
        leases = self.client.leases("kube-node-lease")
        try:
            try:
                lease = leases.get(self.node_name)
                lease.setdefault("spec", {})["renewTime"] = time.time()
                leases.update(lease)
            except ApiError as e:
                if e.code != 404:
                    return
                leases.create({
                    "kind": "Lease",
                    "metadata": {"name": self.node_name,
                                 "namespace": "kube-node-lease"},
                    "spec": {"holderIdentity": self.node_name,
                             "leaseDurationSeconds": 40,
                             "renewTime": time.time()}})
        except ApiError:
            return

    def _heartbeat_loop(self):
        while not self._stop.wait(self.heartbeat_period):
            self.heartbeat_once()
            self._renew_lease()

    # ---- syncLoop --------------------------------------------------------

    def start(self, wait_sync: float = 10.0, serve: bool = True,
              static_pod_path: Optional[str] = None,
              static_poll_s: float = 1.0):
        self._static_pod_path = static_pod_path
        self._static_poll_s = static_poll_s
        self._static: dict[str, tuple] = {}  # uid -> (name, digest)
        self._static_mirror_pending: set[str] = set()
        # mirror RESYNC cadence (see _sync_static_pods): event-driven
        # recreation backstopped by a periodic existence/hash check
        self._static_resync_s = max(static_poll_s * 5, 0.5)
        self._static_next_resync = 0.0
        if serve:
            from kubernetes_tpu_torch.kubelet.server import KubeletServer
            self.server = KubeletServer(self.runtime, self._uid_of,
                                        self.node_name)
        if self.register_node:
            self._register()
        # managers first: informer handlers fire during cache sync and
        # _sync_pod's mount gate needs the reconciler already running
        self.pleg.start()
        self.prober.start()
        self.volumes.start()
        self._informer = SharedInformer(
            self.client.resource("pods", None),
            field_selector=f"spec.nodeName={self.node_name}")
        self._informer.add_event_handler(self._on_pod_event)
        self._informer.start()
        self._informer.wait_for_cache_sync(wait_sync)
        loops = [self._heartbeat_loop, self._pleg_loop]
        if static_pod_path:
            loops.append(self._static_pod_loop)
        for target in loops:
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    # ---- static pods (the FILE pod source of syncLoop) -------------------

    def _static_pod_loop(self):
        """The kubelet's file source (``pkg/kubelet/config/file.go``): pod
        manifests in --pod-manifest-path run WITHOUT the apiserver —
        static pods. Each gets a MIRROR POD posted to the API (read-only
        reflection so kubectl sees it; ``pkg/kubelet/pod/mirror_client.go``)
        named <manifest-name>-<node>. Removing the file stops the pod and
        deletes the mirror; editing it restarts the pod with the new spec;
        deleting the MIRROR through the API never touches the pod (the
        file is the source of truth) — the mirror is recreated."""
        while not self._stop.wait(self._static_poll_s):
            try:
                self._sync_static_pods()
            except Exception:
                _LOG.exception("static-pod sync failed; retrying next poll")

    def _sync_static_pods(self):
        import json as _json
        import os
        path = self._static_pod_path
        seen: dict[str, dict] = {}
        for fn in sorted(os.listdir(path)) if os.path.isdir(path) else []:
            if not fn.endswith((".json", ".yaml", ".yml")):
                continue
            try:
                with open(os.path.join(path, fn)) as f:
                    if fn.endswith(".json"):
                        manifest = _json.load(f)
                    else:
                        import yaml
                        manifest = yaml.safe_load(f)
            except Exception:  # ktpu-lint: disable=KTL002 -- torn/invalid manifest file: skip until it parses (writer may be mid-write)
                continue  # torn/invalid file: skip until it parses
            if not isinstance(manifest, dict) or                     manifest.get("kind") != "Pod":
                continue
            md = manifest.setdefault("metadata", {})
            name = f"{md.get('name', fn.split('.')[0])}-{self.node_name}"
            uid = f"static-{name}"
            digest = _json.dumps(manifest, sort_keys=True)
            seen[uid] = (manifest, name, digest)
        # (re)start static pods: new manifests AND edited ones (file.go
        # re-syncs on content change)
        for uid, (manifest, name, digest) in seen.items():
            prior = self._static.get(uid)
            if prior is not None and prior[1] == digest:
                continue
            pod = _json.loads(_json.dumps(manifest))
            md = pod.setdefault("metadata", {})
            md["name"] = name
            md["uid"] = uid
            md.setdefault("annotations", {})[
                "kubernetes.io/config.source"] = "file"
            pod.setdefault("spec", {})["nodeName"] = self.node_name
            self._static[uid] = (name, digest)
            self._static_mirror_pending.add(uid)
            with self._pods_lock:
                self._pods[uid] = pod
            self.workers.update_pod(uid, pod)
        # mirrors: create (and RE-create after API-side deletion, a
        # transient failure, or a manifest EDIT) until the API copy carries
        # the current manifest hash (mirror_client.go deletes and recreates
        # on hash change — kubernetes.io/config.hash)
        for uid in list(self._static_mirror_pending):
            if uid not in seen:
                self._static_mirror_pending.discard(uid)
                continue
            with self._pods_lock:
                pod = self._pods.get(uid)
            if pod is None:
                continue
            digest = self._static[uid][1]
            mirror = _json.loads(_json.dumps(pod))
            ann = mirror["metadata"].setdefault("annotations", {})
            ann["kubernetes.io/config.mirror"] = uid
            ann["kubernetes.io/config.hash"] = digest
            ns = (pod.get("metadata") or {}).get("namespace",
                                                 "default") or "default"
            name = (pod.get("metadata") or {}).get("name", "")
            try:
                self.client.pods(ns).create(mirror)
                self._static_mirror_pending.discard(uid)
            except ApiError as e:
                if e.code != 409:
                    continue  # transient: retry next poll
                # a mirror exists: current hash -> done; stale hash (the
                # manifest was edited) -> delete it, recreate next poll
                try:
                    cur = self.client.pods(ns).get(name)
                    cur_hash = ((cur.get("metadata") or {})
                                .get("annotations") or {}).get(
                        "kubernetes.io/config.hash")
                    if cur_hash == digest:
                        self._static_mirror_pending.discard(uid)
                    else:
                        self.client.pods(ns).delete(name)
                except ApiError:
                    pass  # retry next poll
        # RESYNC BACKSTOP: mirror recreation is normally event-driven (the
        # informer's DELETED event re-arms _static_mirror_pending above),
        # but a watch gap — a relist racing the deletion, or handler
        # starvation under full-suite load — can swallow that event, and
        # then NOTHING would ever recreate the mirror (the source of the
        # test_static_pod_survives_mirror_deletion flake). Periodically
        # verify each settled mirror exists and carries the current
        # manifest hash; re-arm the pending set when it does not.
        now = time.monotonic()
        if seen and now >= self._static_next_resync:
            self._static_next_resync = now + self._static_resync_s
            for uid, (manifest, name, digest) in seen.items():
                if uid in self._static_mirror_pending \
                        or uid not in self._static:
                    continue
                ns = ((manifest.get("metadata") or {})
                      .get("namespace", "default") or "default")
                try:
                    cur = self.client.pods(ns).get(name)
                except ApiError as e:
                    if e.code == 404:
                        self._static_mirror_pending.add(uid)
                    continue
                except Exception:  # ktpu-lint: disable=KTL002 -- transient transport error probing a mirror pod; the next resync sweep retries
                    continue  # transient transport error: next sweep
                cur_hash = ((cur.get("metadata") or {})
                            .get("annotations") or {}).get(
                    "kubernetes.io/config.hash")
                if cur_hash != digest:
                    self._static_mirror_pending.add(uid)
        # stop static pods whose manifest vanished
        for uid in [u for u in self._static if u not in seen]:
            name, _digest = self._static.pop(uid)
            self._static_mirror_pending.discard(uid)
            with self._pods_lock:
                pod = self._pods.pop(uid, None)
            self.workers.update_pod(uid, None)
            if pod is not None:
                try:
                    self.client.pods((pod.get("metadata") or {})
                                     .get("namespace", "default")
                                     or "default").delete(name)
                except ApiError:
                    pass

    def stop(self):
        self._stop.set()
        if self.server is not None:
            self.server.stop()
        self.pleg.stop()
        self.workers.stop()
        self.prober.stop()
        self.volumes.stop()
        if self._informer is not None:
            self._informer.stop()

    # ---- probe callbacks -------------------------------------------------

    def _on_liveness_failure(self, pod_uid: str, container: str):
        """prober: liveness/startup exhausted its failureThreshold — kill the
        container; the next SyncPod applies the restart policy."""
        with self._pods_lock:
            failing = self._pods.get(pod_uid)
        if failing is not None:
            self.recorder.event(failing, "Warning", "Unhealthy",
                                f"container {container} failed its probe; killing")
        self.runtime.stop_container(pod_uid, container, exit_code=137)
        with self._pods_lock:
            pod = self._pods.get(pod_uid)
        if pod is not None:
            self.workers.update_pod(pod_uid, pod)

    def _on_readiness_change(self, pod_uid: str):
        with self._pods_lock:
            pod = self._pods.get(pod_uid)
        if pod is not None:
            self.workers.update_pod(pod_uid, pod)

    def _on_pod_event(self, type_, obj, old):
        uid = (obj.get("metadata") or {}).get("uid", "")
        if not uid:
            return
        if uid in getattr(self, "_static", {}):
            # a FILE-sourced pod: API events (someone deleting the mirror)
            # never affect it — mirror_client recreates the reflection
            if type_ == "DELETED":
                self._static_mirror_pending.add(uid)
            return
        if type_ == "DELETED":
            with self._pods_lock:
                self._pods.pop(uid, None)
            self.workers.update_pod(uid, None)
        else:
            with self._pods_lock:
                self._pods[uid] = obj
            self.workers.update_pod(uid, obj)

    def _pleg_loop(self):
        """syncLoopIteration's plegCh arm: container events re-sync the pod."""
        while not self._stop.is_set():
            try:
                ev = self.pleg.events.get(timeout=0.2)
            except Exception:  # ktpu-lint: disable=KTL002 -- queue.Empty timeout is the idle tick of the PLEG relist loop
                continue
            with self._pods_lock:
                pod = self._pods.get(ev.pod_uid)
            if pod is not None:
                self.workers.update_pod(ev.pod_uid, pod)

    # ---- SyncPod (computePodActions analog) ------------------------------

    def _sync_pod(self, uid: str, pod: Optional[dict]) -> None:
        if pod is None:
            self._teardown(uid)
            return
        md = pod.get("metadata") or {}
        spec = pod.get("spec") or {}
        phase = (pod.get("status") or {}).get("phase", "Pending")
        if phase in ("Succeeded", "Failed"):
            self._teardown(uid, keep_admitted=uid in self._rejected)
            return
        # node-side admission (lifecycle.PredicateAdmitHandler): allocatable
        # fit + exclusive-cpu availability; rejection marks the pod Failed
        if uid in self._rejected:
            # re-assert in case the Failed status write was lost
            self._fail_pod(pod, self._rejected[uid])
            return
        if uid not in self._admitted:
            ok, reason = self.admitter.admit(pod)
            affinity = None
            if ok:
                # topology gate BEFORE allocation (TopologyAffinityError)
                ok, reason, affinity = self.topology_manager.admit(pod)
                if not ok:
                    self.admitter.release(uid)
            if ok:
                try:
                    self.cpu_manager.allocate(pod)
                    self.device_manager.allocate(pod, affinity=affinity)
                    self.memory_manager.allocate(pod, affinity=affinity)
                except RuntimeError:
                    self.admitter.release(uid)
                    self.cpu_manager.release(uid)
                    self.device_manager.release(uid)
                    self.memory_manager.release(uid)
                    ok, reason = False, "UnexpectedAdmissionError"
            if not ok:
                self._rejected[uid] = reason
                self._fail_pod(pod, reason)
                return
            self._admitted[uid] = pod
            self.volumes.add_pod(pod)
            self.prober.add_pod(pod)
        sb = self.runtime.get_sandbox(uid)
        if sb is None:
            # WaitForAttachAndMount gates the sandbox (volume_manager.go)
            if not self.volumes.wait_for_attach_and_mount(pod):
                # nothing else will re-sync a sandbox-less pod (no PLEG
                # events yet): schedule the retry ourselves
                threading.Timer(0.5, self.workers.update_pod,
                                args=(uid, pod)).start()
                return
            sb = self.runtime.run_pod_sandbox(uid, md.get("name", ""),
                                              md.get("namespace", "default"))
        restart_policy = spec.get("restartPolicy", "Always")
        for c in spec.get("containers") or [{"name": "c"}]:
            name = c.get("name", "c")
            cs = sb.containers.get(name)
            if cs is None:
                self.runtime.create_container(uid, name, c.get("image", ""))
                self.runtime.start_container(uid, name)
                self.prober.container_restarted(uid, name)
            elif cs.state == EXITED:
                restart = (restart_policy == "Always"
                           or (restart_policy == "OnFailure" and cs.exit_code != 0))
                if restart:
                    self.runtime.create_container(uid, name, c.get("image", ""))
                    self.runtime.start_container(uid, name)
                    self.prober.container_restarted(uid, name)
        self._update_status(pod, self.runtime.get_sandbox(uid))

    def _teardown(self, uid: str, keep_admitted: bool = False) -> None:
        self.runtime.stop_pod_sandbox(uid)
        self.prober.remove_pod(uid)
        if not keep_admitted:
            self._rejected.pop(uid, None)
            admitted = self._admitted.pop(uid, None)
            if admitted is not None:
                self.volumes.remove_pod(admitted)
            self.admitter.release(uid)
            self.cpu_manager.release(uid)
            self.device_manager.release(uid)
            self.memory_manager.release(uid)

    def _fail_pod(self, pod: dict, reason: str) -> None:
        self.recorder.event(pod, "Warning", reason,
                            f"Pod was rejected by node {self.node_name}")
        md = pod.get("metadata") or {}
        status = {**(pod.get("status") or {}),
                  "phase": "Failed", "reason": reason,
                  "message": f"Pod was rejected: {reason}"}
        try:
            self.client.pods(md.get("namespace", "default")).update_status(
                {**pod, "status": status})
        except ApiError:
            pass

    # ---- status manager --------------------------------------------------

    def _compute_phase(self, pod: dict, sb) -> str:
        """getPhase (pkg/kubelet/kubelet_pods.go): all-succeeded -> Succeeded,
        any-failed-and-no-restart -> Failed, any running -> Running."""
        spec = pod.get("spec") or {}
        restart_policy = spec.get("restartPolicy", "Always")
        want = [c.get("name", "c") for c in spec.get("containers") or [{"name": "c"}]]
        states = [sb.containers.get(n) for n in want] if sb else []
        if not states or any(s is None for s in states):
            return "Pending"
        if all(s.state == EXITED for s in states):
            if all(s.exit_code == 0 for s in states):
                if restart_policy != "Always":
                    return "Succeeded"
            elif restart_policy == "Never":
                return "Failed"
        if any(s.state == RUNNING for s in states):
            return "Running"
        return "Pending"

    def _update_status(self, pod: dict, sb) -> None:
        phase = self._compute_phase(pod, sb)
        # Ready = running AND every readiness/startup probe reports ready
        # (status_manager consults the prober's results cache)
        ready = phase == "Running" and self.prober.pod_ready(pod)
        running = ready
        status = {
            "phase": phase,
            "hostIP": f"192.168.0.{self.node_idx % 250}",
            "podIP": sb.ip if sb else "",
            "startTime": sb.created_at if sb else None,
            "conditions": [
                {"type": "PodScheduled", "status": "True"},
                {"type": "Ready", "status": "True" if running else "False"},
                {"type": "ContainersReady", "status": "True" if running else "False"},
            ],
        }
        cur = pod.get("status") or {}
        if (cur.get("phase") == status["phase"]
                and cur.get("podIP") == status["podIP"]
                and Pod.from_dict(pod).status.is_ready() == running):
            return  # no material change; skip the write (status manager dedup)
        md = pod["metadata"]
        ns = md.get("namespace", "default")
        if self.status_sink is not None:
            # batched transport (kubemark): the batcher coalesces and bulk-
            # POSTs; per-pod dedup above still bounds the write volume
            self.status_sink(ns, md.get("name", ""), status)
            return
        from kubernetes_tpu_torch.utils.tracing import TRACER
        try:
            with TRACER.span("kubelet/status_patch"):
                self.client.pods(ns).update_status({**pod, "status": status})
        except ApiError:
            pass  # next sync retries


class HollowNode:
    """kubemark analog: Kubelet over FakeRuntime with configurable container
    behavior. ``exit_after`` makes workloads finish (Job testing)."""

    def __init__(self, client, node_name: str,
                 exit_after: Optional[float] = None,
                 start_latency: float = 0.0, **kubelet_kw):
        self.kubelet = Kubelet(client, node_name, **kubelet_kw)
        # swap in a runtime wired to this kubelet's IP allocator; every
        # runtime-bound manager must be rebuilt against it
        self.kubelet.runtime = FakeRuntime(exit_after=exit_after,
                                           start_latency=start_latency,
                                           ip_alloc=self.kubelet._next_pod_ip)
        self.kubelet.pleg = GenericPLEG(self.kubelet.runtime)
        self.kubelet.prober = ProbeManager(
            self.kubelet.runtime, self.kubelet._on_liveness_failure,
            self.kubelet._on_readiness_change)

    def start(self, **kw):
        self.kubelet.start(**kw)
        return self

    def stop(self):
        self.kubelet.stop()
