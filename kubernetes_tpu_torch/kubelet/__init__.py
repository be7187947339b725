"""Kubelet — node agent (SURVEY §2.4): sync loop, pod workers, PLEG,
probes, volume manager, resource/QoS managers, status manager, heartbeat,
hollow-node (kubemark) mode."""

from kubernetes_tpu_torch.kubelet.kubelet import HollowNode, Kubelet
from kubernetes_tpu_torch.kubelet.pleg import GenericPLEG, PodLifecycleEvent
from kubernetes_tpu_torch.kubelet.pod_workers import PodWorkers
from kubernetes_tpu_torch.kubelet.prober import ProbeManager
from kubernetes_tpu_torch.kubelet.resources import (
    AllocatableAdmitter,
    CPUManager,
    pod_qos,
)
from kubernetes_tpu_torch.kubelet.runtime import ContainerRuntime, FakeRuntime
from kubernetes_tpu_torch.kubelet.volumemanager import VolumeManager

__all__ = ["AllocatableAdmitter", "CPUManager", "ContainerRuntime",
           "FakeRuntime", "GenericPLEG", "HollowNode", "Kubelet",
           "PodLifecycleEvent", "PodWorkers", "ProbeManager",
           "VolumeManager", "pod_qos"]
