"""CSI over gRPC — the kubelet <-> storage-driver process boundary.

Reference: the CSI spec's Node/Identity services as the kubelet consumes
them (``pkg/volume/csi/csi_client.go`` -> the driver's unix socket):
Identity.GetPluginInfo, Node.NodeStageVolume (device -> global mount),
Node.NodePublishVolume (global -> pod mount), NodeUnpublish/NodeUnstage.
Payloads are msgpack maps over real gRPC (the repo's codec pattern); the
call surface and stage->publish ordering are the architecture under test.

``CSIDriverServer`` is a hollow driver recording its mounts (the
csi-driver-host-path analog); ``CSIVolumePlugin`` is the kubelet side the
VolumeManager drives for CSI-backed volumes.

msgpack and grpc are imported where a message is packed or a server or
channel is made, so the module imports without either.
"""

from __future__ import annotations

import logging
import threading
from concurrent import futures
from typing import Optional

_LOG = logging.getLogger(__name__)

SERVICE = "csi.v1.Node"
METHODS = ("GetPluginInfo", "NodeGetCapabilities", "NodeStageVolume",
           "NodeUnstageVolume", "NodePublishVolume", "NodeUnpublishVolume")


def _pack(o) -> bytes:
    import msgpack
    return msgpack.packb(o)


def _unpack(b: bytes):
    import msgpack
    return msgpack.unpackb(b)


class CSIDriverServer:
    """Hollow CSI driver: records staged/published volumes like the
    host-path test driver. State is inspectable for tests (.staged,
    .published: volume_id -> path)."""

    def __init__(self, driver_name: str = "hollow.csi.ktpu",
                 host: str = "127.0.0.1", port: int = 0):
        import grpc
        self.driver_name = driver_name
        self._lock = threading.Lock()
        self.staged: dict[str, str] = {}
        self.published: dict[str, str] = {}  # "volid/poduid" -> target path
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((self._handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.address = f"{host}:{self.port}"

    def _dispatch(self, method: str, req: dict) -> dict:
        try:
            with self._lock:
                if method == "GetPluginInfo":
                    return {"name": self.driver_name,
                            "vendor_version": "v1"}
                if method == "NodeGetCapabilities":
                    return {"capabilities": ["STAGE_UNSTAGE_VOLUME"]}
                if method == "NodeStageVolume":
                    self.staged[req["volume_id"]] = req["staging_path"]
                    return {}
                if method == "NodeUnstageVolume":
                    self.staged.pop(req["volume_id"], None)
                    return {}
                if method == "NodePublishVolume":
                    if req["volume_id"] not in self.staged:
                        return {"error": "FailedPrecondition: volume not "
                                         "staged"}
                    key = f"{req['volume_id']}/{req.get('pod_uid', '')}"
                    self.published[key] = req["target_path"]
                    return {}
                if method == "NodeUnpublishVolume":
                    key = f"{req['volume_id']}/{req.get('pod_uid', '')}"
                    self.published.pop(key, None)
                    return {}
                return {"error": f"unknown method {method!r}"}
        except KeyError as e:
            return {"error": f"missing field {e}"}
        except Exception as e:
            _LOG.exception("CSI %s failed", method)
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

    def start(self) -> "CSIDriverServer":
        self._server.start()
        return self

    def stop(self, grace: float = 1.0):
        self._server.stop(grace).wait()


class CSIVolumePlugin:
    """Kubelet-side CSI client: stage once per volume per node, publish
    once per (volume, pod) — the csi_attacher/csi_mounter split."""

    def __init__(self, address: str, node_name: str = "node",
                 timeout_s: float = 10.0):
        import grpc
        self._chan = grpc.insecure_channel(address)
        self._timeout = timeout_s
        self.node_name = node_name
        self._call = {
            m: self._chan.unary_unary(
                f"/{SERVICE}/{m}", request_serializer=_pack,
                response_deserializer=_unpack, _registered_method=False)
            for m in METHODS
        }
        self._lock = threading.Lock()
        self._staged: set[str] = set()

    def _req(self, method: str, **kw) -> dict:
        out = self._call[method](kw, timeout=self._timeout)
        if out.get("error"):
            raise RuntimeError(f"CSI {method}: {out['error']}")
        return out

    def plugin_info(self) -> dict:
        return self._req("GetPluginInfo")

    def mount(self, volume_id: str, pod_uid: str) -> None:
        """stage (idempotent per node) then publish for the pod. A publish
        failure right after a FRESH stage rolls the stage back — otherwise
        a pod removed before any successful retry would leak the driver's
        global mount forever (nothing else would ever unstage it)."""
        freshly_staged = False
        with self._lock:
            if volume_id not in self._staged:
                self._req("NodeStageVolume", volume_id=volume_id,
                          staging_path=f"/var/lib/kubelet/plugins/"
                                       f"{self.node_name}/{volume_id}")
                self._staged.add(volume_id)
                freshly_staged = True
        try:
            self._req("NodePublishVolume", volume_id=volume_id,
                      pod_uid=pod_uid,
                      target_path=f"/var/lib/kubelet/pods/{pod_uid}/"
                                  f"volumes/{volume_id}")
        except Exception:
            if freshly_staged:
                with self._lock:
                    try:
                        self._req("NodeUnstageVolume", volume_id=volume_id)
                    except Exception:
                        _LOG.exception("unstage rollback of %s failed",
                                       volume_id)
                    self._staged.discard(volume_id)
            raise

    def unmount(self, volume_id: str, pod_uid: str,
                last_pod: bool = False) -> None:
        self._req("NodeUnpublishVolume", volume_id=volume_id,
                  pod_uid=pod_uid)
        if last_pod:
            with self._lock:
                if volume_id in self._staged:
                    self._req("NodeUnstageVolume", volume_id=volume_id)
                    self._staged.discard(volume_id)

    def close(self):
        self._chan.close()
