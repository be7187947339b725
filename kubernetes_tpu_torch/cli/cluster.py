"""Cluster bootstrap — the kubeadm analog.

Reference: ``cmd/kubeadm`` (init/join phases standing up the control plane
and joining nodes). Here a "cluster" is one process: ``init`` boots the
API server (optionally durable + authenticated), the controller manager,
and the TPU scheduler; ``join`` attaches hollow kubelets to a running
server. ``LocalCluster`` is the library form the CLI wraps — tests and
demos boot a full cluster in a few lines:

    from kubernetes_tpu_torch.cli.cluster import LocalCluster
    with LocalCluster(nodes=3) as c:
        c.client.pods().create({...})

CLI:
    ktpu-up init [--nodes N] [--data-dir DIR] [--auth] [--port P]
                 [--device cpu]
    ktpu-up join --server URL [--nodes N] [--name-prefix worker]
    python -m kubernetes_tpu_torch.cli.cluster ...

The PyTorch port of ``kubernetes_tpu/cli/cluster.py``. The scheduler runs
on ``device``: the card unless the caller asks for the CPU
(``LocalCluster(device="cpu")``, ``ktpu-up init --device cpu``), as every
runner of the port. ``init`` prints that device on a line before
``control plane up:``. ``join`` imports no torch (only the scheduler
does), so it starts in a second where ``init`` takes the card's.
"""

from __future__ import annotations

import argparse
import secrets as _secrets
import signal
import sys
import threading
from typing import Optional

from kubernetes_tpu_torch.client.clientset import HTTPClient
from kubernetes_tpu_torch.controllers import ControllerManager
from kubernetes_tpu_torch.kubelet import HollowNode
from kubernetes_tpu_torch.store.apiserver import APIServer


class LocalCluster:
    """Control plane + N hollow nodes in-process (kubeadm init + joins).

    Nothing runs until ``start()`` — constructing is side-effect free, and
    a failure mid-start tears down whatever came up.
    """

    def __init__(self, nodes: int = 3, data_dir: Optional[str] = None,
                 auth: bool = False, port: int = 0,
                 node_allocatable: Optional[dict] = None,
                 exit_after: Optional[float] = None,
                 scheduler_cfg=None, registry=None, device=None):
        self._cfg = dict(nodes=nodes, data_dir=data_dir, auth=auth, port=port)
        self._device = device
        self._alloc = node_allocatable  # None = Kubelet's own default
        self._exit_after = exit_after
        self._scheduler_cfg = scheduler_cfg
        self._registry = registry
        self.server: Optional[APIServer] = None
        self.client: Optional[HTTPClient] = None
        self.runner = None   # sched/runner.SchedulerRunner
        self.manager: Optional[ControllerManager] = None
        self.kubelets: list[HollowNode] = []
        self.admin_token: Optional[str] = None

    def start(self) -> "LocalCluster":
        try:
            self.server = APIServer(port=self._cfg["port"],
                                    data_dir=self._cfg["data_dir"])
            token = None
            if self._cfg["auth"]:
                # mint a bootstrap superuser credential (kubeadm's
                # admin.conf): system:masters bypasses RBAC entirely, so
                # the in-process components can do their jobs
                self.server.enable_auth()
                token = "ktpu-admin-" + _secrets.token_hex(16)
                self.server.authenticator.add(
                    token, ("system:admin", ("system:masters",)))
                self.admin_token = token
            self.server.enable_admission()
            self.server.start()
            self.client = HTTPClient(self.server.url, token=token)
            # the scheduler alone imports torch: join does without it
            from kubernetes_tpu_torch.sched.runner import SchedulerRunner
            self.runner = SchedulerRunner(self.client, cfg=self._scheduler_cfg,
                                          registry=self._registry,
                                          device=self._device)
            from kubernetes_tpu_torch.controllers.manager import (
                CLOUD_CONTROLLERS, DEFAULT_CONTROLLERS)
            # cluster-up runs the cloud loops too: this IS the cloud here
            # (nodeipam carves podCIDRs, route flips NetworkUnavailable,
            # service-lb hands out ingress IPs)
            self.manager = ControllerManager(
                self.client,
                controllers=DEFAULT_CONTROLLERS + CLOUD_CONTROLLERS)
            self.runner.start()
            self.manager.start()
            for i in range(self._cfg["nodes"]):
                self.add_node(f"node-{i}")
        except Exception:
            self.stop()
            raise
        return self

    def add_node(self, name: str) -> HollowNode:
        """The `join` phase: register + run one hollow kubelet."""
        kw = {} if self._alloc is None else {"allocatable": dict(self._alloc)}
        node = HollowNode(self.client, name, exit_after=self._exit_after, **kw)
        node.start()
        self.kubelets.append(node)
        return node

    def stop(self) -> None:
        for k in self.kubelets:
            k.stop()
        self.kubelets = []
        if self.manager is not None:
            self.manager.stop()
        if self.runner is not None:
            self.runner.stop()
        if self.server is not None:
            self.server.stop()

    def __enter__(self) -> "LocalCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def join(server_url: str, n: int = 1, name_prefix: str = "worker",
         allocatable: Optional[dict] = None,
         token: Optional[str] = None) -> list[HollowNode]:
    """Attach hollow kubelets to an already-running server."""
    client = HTTPClient(server_url, token=token)
    nodes = []
    for i in range(n):
        kw = {} if allocatable is None else {"allocatable": dict(allocatable)}
        node = HollowNode(client, f"{name_prefix}-{i}", **kw)
        node.start()
        nodes.append(node)
    return nodes


def _device_line(device) -> str:
    """``cuda:0 NVIDIA H100 80GB HBM3`` for a card, ``cpu`` for the CPU."""
    import torch
    if device.type != "cuda":
        return str(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return f"cuda:{index} {torch.cuda.get_device_name(index)}"


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(prog="ktpu-up")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_init = sub.add_parser("init", help="boot control plane + hollow nodes")
    p_init.add_argument("--nodes", type=int, default=3)
    p_init.add_argument("--data-dir", default=None,
                        help="durable store directory (restarts keep state)")
    p_init.add_argument("--auth", action="store_true",
                        help="enable authn/RBAC/audit chain")
    p_init.add_argument("--port", type=int, default=0)
    p_init.add_argument("--device", default=None,
                        help="where the scheduler runs (default: the "
                        "CUDA card; 'cpu' runs it on the CPU)")
    p_join = sub.add_parser("join", help="attach hollow nodes to a server")
    p_join.add_argument("--server", required=True)
    p_join.add_argument("--nodes", type=int, default=1)
    p_join.add_argument("--name-prefix", default="worker")
    p_join.add_argument("--token", default=None,
                        help="bearer token (required against --auth servers)")
    args = ap.parse_args(argv)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())

    if args.cmd == "init":
        cluster = LocalCluster(nodes=args.nodes, data_dir=args.data_dir,
                               auth=args.auth, port=args.port,
                               device=args.device).start()
        out.write(f"device: {_device_line(cluster.runner.scheduler.device)}"
                  "\n")
        out.write(f"control plane up: {cluster.server.url}\n")
        if cluster.admin_token:
            out.write(f"admin token: {cluster.admin_token}\n")
        out.write(f"nodes: {[k.kubelet.node_name for k in cluster.kubelets]}\n")
        out.flush()
        stop.wait()
        cluster.stop()
    else:
        nodes = join(args.server, n=args.nodes, name_prefix=args.name_prefix,
                     token=args.token)
        out.write(f"joined: {[n.kubelet.node_name for n in nodes]}\n")
        out.flush()
        stop.wait()
        for n in nodes:
            n.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
