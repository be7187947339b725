"""Controllers — reconcile loops over the API (SURVEY §2.3).

Each controller is the informer + workqueue + ``sync(key)`` pattern from
``pkg/controller/``; ``ControllerManager`` is the kube-controller-manager
analog wiring them over one shared informer factory.

The PyTorch port's copy of ``kubernetes_tpu/controllers/``: every module of
the reference, the manager included, as host code.
"""

from kubernetes_tpu_torch.controllers.base import Controller, active_pods, controller_of
from kubernetes_tpu_torch.controllers.cronjob import CronJobController
from kubernetes_tpu_torch.controllers.daemonset import DaemonSetController
from kubernetes_tpu_torch.controllers.deployment import DeploymentController
from kubernetes_tpu_torch.controllers.disruption import DisruptionController
from kubernetes_tpu_torch.controllers.endpoints import EndpointsController
from kubernetes_tpu_torch.controllers.endpointslice import EndpointSliceController
from kubernetes_tpu_torch.controllers.garbagecollector import GarbageCollector
from kubernetes_tpu_torch.controllers.hpa import HorizontalPodAutoscalerController
from kubernetes_tpu_torch.controllers.job import JobController
from kubernetes_tpu_torch.controllers.manager import ControllerManager
from kubernetes_tpu_torch.controllers.namespace import NamespaceController
from kubernetes_tpu_torch.controllers.nodelifecycle import NodeLifecycleController
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
from kubernetes_tpu_torch.controllers.statefulset import StatefulSetController
from kubernetes_tpu_torch.controllers.ttlafterfinished import TTLAfterFinishedController

__all__ = [
    "Controller", "ControllerManager", "CronJobController",
    "DaemonSetController", "DeploymentController", "DisruptionController",
    "EndpointsController", "EndpointSliceController", "GarbageCollector",
    "HorizontalPodAutoscalerController", "JobController",
    "NamespaceController", "NodeLifecycleController", "PodGCController",
    "ReplicaSetController", "ReplicationControllerController",
    "ResourceClaimController",
    "ServiceAccountController", "StatefulSetController",
    "TTLAfterFinishedController", "TokenController", "active_pods",
    "controller_of",
]
