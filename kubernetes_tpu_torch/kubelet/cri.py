"""CRI over gRPC — the kubelet <-> container-runtime process boundary.

Reference: ``staging/src/k8s.io/cri-api/pkg/apis/runtime/v1/api.proto``
(RuntimeService: RunPodSandbox / StopPodSandbox / CreateContainer /
StartContainer / StopContainer / ListPodSandbox / PodSandboxStatus /
ExecSync; ImageService: PullImage / ListImages) consumed by
``pkg/kubelet/kuberuntime/kuberuntime_manager.go`` over gRPC to
containerd/CRI-O. Payloads here are msgpack maps over real gRPC/HTTP2
(the sidecar's codec pattern) instead of protobuf-generated classes —
the process boundary and call surface are the architecture under test.

``CRIServer`` exports any in-process ``ContainerRuntime`` (FakeRuntime =
the containerd stand-in, kubemark-style); ``RemoteRuntime`` implements the
kubelet-facing ``ContainerRuntime`` interface by calling it, so a kubelet
constructed with ``KubeletRunner(runtime=RemoteRuntime(addr))`` drives its
containers across the same seam the reference does.

msgpack and grpc are imported where a message is packed or a server or
channel is made, so the module imports without either.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent import futures
from typing import Optional

from kubernetes_tpu_torch.kubelet.runtime import (
    ContainerRuntime,
    ContainerStatus,
    PodSandboxStatus,
)

_LOG = logging.getLogger(__name__)

SERVICE = "runtime.v1.RuntimeService"
METHODS = ("Version", "RunPodSandbox", "StopPodSandbox", "CreateContainer",
           "StartContainer", "StopContainer", "ListPodSandbox",
           "PodSandboxStatus", "ExecSync", "PullImage", "ListImages",
           "SetHealth")


def _pack(o) -> bytes:
    import msgpack
    return msgpack.packb(o)


def _unpack(b: bytes):
    import msgpack
    return msgpack.unpackb(b)


def _sandbox_wire(sb: PodSandboxStatus) -> dict:
    return {
        "pod_uid": sb.pod_uid, "name": sb.name, "namespace": sb.namespace,
        "ip": sb.ip, "created_at": sb.created_at,
        "containers": [
            {"name": c.name, "state": c.state, "exit_code": c.exit_code,
             "started_at": c.started_at, "finished_at": c.finished_at,
             "restart_count": c.restart_count, "healthy": c.healthy}
            for c in sb.containers.values()],
    }


def _sandbox_from_wire(d: dict) -> PodSandboxStatus:
    sb = PodSandboxStatus(d["pod_uid"], d["name"], d["namespace"],
                          ip=d.get("ip", ""),
                          created_at=d.get("created_at", 0.0))
    for c in d.get("containers", []):
        sb.containers[c["name"]] = ContainerStatus(
            c["name"], state=c["state"], exit_code=c["exit_code"],
            started_at=c["started_at"], finished_at=c["finished_at"],
            restart_count=c["restart_count"], healthy=c.get("healthy", True))
    return sb


class CRIServer:
    """gRPC server fronting an in-process ContainerRuntime (the containerd
    stand-in). Also serves the ImageService essentials (image pulls are
    recorded so tests can assert PullImage traffic)."""

    def __init__(self, runtime: ContainerRuntime, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 8):
        import grpc
        self.runtime = runtime
        self.images: list[str] = []
        self._img_lock = threading.Lock()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers((self._handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.address = f"{host}:{self.port}"

    def _dispatch(self, method: str, req: dict) -> dict:
        rt = self.runtime
        try:
            if method == "Version":
                return {"runtime_name": "ktpu-hollow",
                        "runtime_api_version": "v1"}
            if method == "RunPodSandbox":
                sb = rt.run_pod_sandbox(req["pod_uid"], req["name"],
                                        req["namespace"])
                return {"sandbox": _sandbox_wire(sb)}
            if method == "StopPodSandbox":
                rt.stop_pod_sandbox(req["pod_uid"])
                return {}
            if method == "CreateContainer":
                rt.create_container(req["pod_uid"], req["name"],
                                    req.get("image", ""))
                return {}
            if method == "StartContainer":
                rt.start_container(req["pod_uid"], req["name"])
                return {}
            if method == "StopContainer":
                rt.stop_container(req["pod_uid"], req["name"],
                                  exit_code=req.get("exit_code", 137))
                return {}
            if method == "ListPodSandbox":
                return {"sandboxes": [_sandbox_wire(s)
                                      for s in rt.list_sandboxes()]}
            if method == "PodSandboxStatus":
                sb = rt.get_sandbox(req["pod_uid"])
                return {"sandbox": None if sb is None else _sandbox_wire(sb)}
            if method == "ExecSync":
                # the probe transport: exit 0 = healthy (exec probes)
                ok = rt.probe(req["pod_uid"], req["name"])
                return {"exit_code": 0 if ok else 1}
            if method == "PullImage":
                with self._img_lock:
                    if req.get("image") and req["image"] not in self.images:
                        self.images.append(req["image"])
                return {"image_ref": req.get("image", "")}
            if method == "ListImages":
                with self._img_lock:
                    return {"images": list(self.images)}
            if method == "SetHealth":  # test hook (hollow runtime only)
                set_health = getattr(rt, "set_health", None)
                if set_health is not None:
                    set_health(req["pod_uid"], req["name"], req["healthy"])
                return {}
            return {"error": f"unknown method {method!r}"}
        except KeyError as e:
            return {"error": f"unknown sandbox/container: {e}"}
        except Exception as e:
            _LOG.exception("CRI %s failed", method)
            return {"error": str(e)}

    def _handler(self):
        import grpc
        server = self

        def unary(method):
            def call(req, ctx):
                return server._dispatch(method, req)
            return grpc.unary_unary_rpc_method_handler(
                call, request_deserializer=_unpack,
                response_serializer=_pack)

        return grpc.method_handlers_generic_handler(
            SERVICE, {m: unary(m) for m in METHODS})

    def start(self) -> "CRIServer":
        self._server.start()
        return self

    def stop(self, grace: float = 1.0):
        self._server.stop(grace).wait()


class RemoteRuntime(ContainerRuntime):
    """The kubelet's side of the CRI seam: every runtime call is a gRPC
    round trip to the CRI server, exactly like kuberuntime_manager ->
    containerd. Raises RuntimeError on server-side errors."""

    def __init__(self, address: str, timeout_s: float = 10.0):
        import grpc
        self._chan = grpc.insecure_channel(address)
        self._timeout = timeout_s
        self._call = {
            m: self._chan.unary_unary(
                f"/{SERVICE}/{m}", request_serializer=_pack,
                response_deserializer=_unpack, _registered_method=False)
            for m in METHODS
        }

    def _req(self, method: str, **kw) -> dict:
        out = self._call[method](kw, timeout=self._timeout)
        if out.get("error"):
            raise RuntimeError(f"CRI {method}: {out['error']}")
        return out

    def run_pod_sandbox(self, pod_uid, name, namespace):
        out = self._req("RunPodSandbox", pod_uid=pod_uid, name=name,
                        namespace=namespace)
        return _sandbox_from_wire(out["sandbox"])

    def stop_pod_sandbox(self, pod_uid):
        self._req("StopPodSandbox", pod_uid=pod_uid)

    def create_container(self, pod_uid, name, image=""):
        self._req("PullImage", image=image)  # kubelet pulls before create
        self._req("CreateContainer", pod_uid=pod_uid, name=name, image=image)

    def start_container(self, pod_uid, name):
        self._req("StartContainer", pod_uid=pod_uid, name=name)

    def stop_container(self, pod_uid, name, exit_code: int = 137):
        self._req("StopContainer", pod_uid=pod_uid, name=name,
                  exit_code=exit_code)

    def list_sandboxes(self):
        return [_sandbox_from_wire(d)
                for d in self._req("ListPodSandbox")["sandboxes"]]

    def get_sandbox(self, pod_uid):
        d = self._req("PodSandboxStatus", pod_uid=pod_uid)["sandbox"]
        return None if d is None else _sandbox_from_wire(d)

    def probe(self, pod_uid, name) -> bool:
        try:
            return self._req("ExecSync", pod_uid=pod_uid,
                             name=name)["exit_code"] == 0
        except Exception:  # ktpu-lint: disable=KTL002 -- exec-probe failure = unhealthy verdict; the probe result is the signal, prober handles transitions
            return False

    def set_health(self, pod_uid, name, healthy: bool):
        self._req("SetHealth", pod_uid=pod_uid, name=name, healthy=healthy)

    def close(self):
        self._chan.close()
