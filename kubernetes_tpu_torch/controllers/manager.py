"""Controller manager — run all controllers off one informer factory.

Reference: ``cmd/kube-controller-manager/app/controllermanager.go``
(``NewControllerDescriptors`` + ``StartControllers`` sharing a
SharedInformerFactory; active-passive via leader election).

The PyTorch port's copy of ``kubernetes_tpu/controllers/manager.py``. Every
loop is host code; the card comes in only through the scheduler that binds
the pods these controllers create.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.client.leaderelection import LeaderElectionConfig, LeaderElector
from kubernetes_tpu_torch.controllers.cronjob import CronJobController
from kubernetes_tpu_torch.controllers.daemonset import DaemonSetController
from kubernetes_tpu_torch.controllers.deployment import DeploymentController
from kubernetes_tpu_torch.controllers.disruption import DisruptionController
from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.controllers.endpointslice import EndpointSliceController
from kubernetes_tpu_torch.controllers.endpointslicemirroring import (
    EndpointSliceMirroringController)
from kubernetes_tpu_torch.controllers.garbagecollector import GarbageCollector
from kubernetes_tpu_torch.controllers.hpa import HorizontalPodAutoscalerController
from kubernetes_tpu_torch.controllers.job import JobController
from kubernetes_tpu_torch.controllers.namespace import NamespaceController
from kubernetes_tpu_torch.controllers.nodelifecycle import NodeLifecycleController
from kubernetes_tpu_torch.controllers.pvbinder import PersistentVolumeController
from kubernetes_tpu_torch.controllers.podgc import PodGCController
from kubernetes_tpu_torch.controllers.replicaset import (
    ReplicaSetController,
    ReplicationControllerController,
)
from kubernetes_tpu_torch.controllers.resourceclaim import ResourceClaimController
from kubernetes_tpu_torch.controllers.serviceaccount import (
    ServiceAccountController,
    TokenController,
)
from kubernetes_tpu_torch.controllers.certificates import CSRSigningController
from kubernetes_tpu_torch.controllers.clusterroleaggregation import (
    ClusterRoleAggregationController,
)
from kubernetes_tpu_torch.controllers.resourcequota import ResourceQuotaController
from kubernetes_tpu_torch.controllers.statefulset import StatefulSetController
from kubernetes_tpu_torch.controllers.attachdetach import AttachDetachController
from kubernetes_tpu_torch.controllers.ephemeral import EphemeralVolumeController
from kubernetes_tpu_torch.controllers.nodeipam import NodeIpamController
from kubernetes_tpu_torch.controllers.csrlifecycle import (CSRApprovingController,
                                                     CSRCleanerController)
from kubernetes_tpu_torch.controllers.rootca import RootCAPublisher
from kubernetes_tpu_torch.controllers.volumeprotection import (
    PVCProtectionController, PVProtectionController)
from kubernetes_tpu_torch.controllers.route import RouteController
from kubernetes_tpu_torch.controllers.servicelb import ServiceLBController
from kubernetes_tpu_torch.controllers.ttl import TTLController
from kubernetes_tpu_torch.controllers.ttlafterfinished import TTLAfterFinishedController

_LOG = logging.getLogger(__name__)

DEFAULT_CONTROLLERS = ("deployment", "replicaset", "job", "daemonset",
                       "statefulset", "endpoints", "endpointslice",
                       "nodelifecycle", "pvbinder", "disruption", "cronjob",
                       "ttlafterfinished", "horizontalpodautoscaler",
                       "namespace", "serviceaccount", "serviceaccount-token",
                       "resourceclaim", "replicationcontroller", "podgc",
                       "resourcequota", "ttl", "clusterroleaggregation",
                       "csrsigning", "ephemeral", "attachdetach",
                       "root-ca-cert-publisher", "endpointslicemirroring",
                       "pvc-protection", "pv-protection", "csrapproving",
                       "csrcleaner")
# Cloud-provider loops (upstream: cloud-controller-manager / kcm flags):
# opt-in by name — "nodeipam" needs --cluster-cidr semantics, "route" and
# "service-lb" a cloud. cli/cluster.py enables them for cluster-up.
CLOUD_CONTROLLERS = ("nodeipam", "route", "service-lb")


class ControllerManager:
    def __init__(self, client, controllers=DEFAULT_CONTROLLERS,
                 leader_elect: bool = False,
                 identity: str = "kube-controller-manager",
                 resync_period: float = 10.0,
                 gc_enabled: bool = True):
        self.client = client
        if hasattr(client, "default_user_agent"):
            client.default_user_agent("kube-controller-manager")
        self.factory = InformerFactory(client)
        self.resync_period = resync_period
        ctors = {
            "deployment": DeploymentController,
            "replicaset": ReplicaSetController,
            "replicationcontroller": ReplicationControllerController,
            "podgc": PodGCController,
            "job": JobController,
            "daemonset": DaemonSetController,
            "statefulset": StatefulSetController,
            "endpoints": EndpointsController,
            "nodelifecycle": NodeLifecycleController,
            "pvbinder": PersistentVolumeController,
            "disruption": DisruptionController,
            "cronjob": CronJobController,
            "ttlafterfinished": TTLAfterFinishedController,
            "horizontalpodautoscaler": HorizontalPodAutoscalerController,
            "namespace": NamespaceController,
            "endpointslice": EndpointSliceController,
            "serviceaccount": ServiceAccountController,
            "resourceclaim": ResourceClaimController,
            "serviceaccount-token": TokenController,
            "resourcequota": ResourceQuotaController,
            "ttl": TTLController,
            "clusterroleaggregation": ClusterRoleAggregationController,
            "csrsigning": CSRSigningController,
            "attachdetach": AttachDetachController,
            "nodeipam": NodeIpamController,
            "ephemeral": EphemeralVolumeController,
            "root-ca-cert-publisher": RootCAPublisher,
            "endpointslicemirroring": EndpointSliceMirroringController,
            "pvc-protection": PVCProtectionController,
            "pv-protection": PVProtectionController,
            "csrapproving": CSRApprovingController,
            "csrcleaner": CSRCleanerController,
            "service-lb": ServiceLBController,
            "route": RouteController,
        }
        from kubernetes_tpu_torch.controllers.certificates import HAVE_CRYPTOGRAPHY
        if not HAVE_CRYPTOGRAPHY:
            # X.509-backed loops need the optional ``cryptography`` package;
            # run the rest of the manager rather than refusing to start
            # (upstream kcm likewise runs with individual loops disabled)
            needs_x509 = {"csrsigning", "root-ca-cert-publisher"}
            dropped = [n for n in controllers if n in needs_x509]
            if dropped:
                _LOG.warning("cryptography not installed; disabling "
                             "controllers: %s", ", ".join(dropped))
            controllers = [n for n in controllers if n not in needs_x509]
        self.controllers = [ctors[n](client) for n in controllers]
        self.gc = GarbageCollector(client) if gc_enabled else None
        self.leader_elect = leader_elect
        self.identity = identity
        self._stop = threading.Event()
        self._resync_thread: Optional[threading.Thread] = None
        self._started = False

    def start(self, wait_sync: float = 10.0):
        for c in self.controllers:
            c.register(self.factory)
        if self.gc is not None:
            self.gc.register(self.factory)
        self.factory.start_all()
        self.factory.wait_for_cache_sync(wait_sync)
        if self.leader_elect:
            elector = LeaderElector(self.client.leases(), LeaderElectionConfig(
                lock_name="kube-controller-manager", identity=self.identity,
                on_started_leading=self._start_controllers,
                on_stopped_leading=self._noop))
            threading.Thread(target=elector.run, args=(self._stop,),
                             daemon=True).start()
        else:
            self._start_controllers()
        return self

    def _noop(self):
        pass

    def _start_controllers(self):
        if self._started:
            return
        self._started = True
        for c in self.controllers:
            c.start()
        self._resync_thread = threading.Thread(target=self._resync_loop, daemon=True)
        self._resync_thread.start()

    def _resync_loop(self):
        """Periodic full re-enqueue (informer resync analog) + GC sweep —
        converges anything a missed/raced event left behind."""
        while not self._stop.wait(self.resync_period):
            for c in self.controllers:
                inf = getattr(c, f"{_informer_attr(c)}", None)
                if inf is not None:
                    for key in inf.store.keys():
                        c.queue.add(key)
            if self.gc is not None:
                try:
                    self.gc.sweep()
                except Exception:
                    _LOG.exception("garbage-collector sweep failed; "
                                   "retrying next interval")

    def stop(self):
        self._stop.set()
        for c in self.controllers:
            c.stop()
        self.factory.stop_all()


def _informer_attr(c) -> str:
    return {
        "deployment": "dep_informer",
        "replicaset": "rs_informer",
        "replicationcontroller": "rs_informer",
        "job": "job_informer",
        "daemonset": "ds_informer",
        "statefulset": "ss_informer",
        "endpoints": "svc_informer",
        "endpointslice": "svc_informer",
        "nodelifecycle": "node_informer",
        "pvbinder": "pvc_informer",
        "cronjob": "cj_informer",
        "ttlafterfinished": "job_informer",
        "horizontalpodautoscaler": "hpa_informer",
        "disruption": "pdb_informer",
        "serviceaccount": "ns_informer",
        "serviceaccount-token": "sa_informer",
        "resourceclaim": "pod_informer",
    }.get(c.name, "")
