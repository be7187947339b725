"""Cluster Autoscaler — tensor-simulated node-group scale-up/scale-down.

Reference: the out-of-tree ``kubernetes/autoscaler`` ClusterAutoscaler
(``cloudprovider.NodeGroup``, ``simulator/``, ``expander/``, the
``ScaleUp``/``ScaleDown`` loops in ``core/``). The core question — "would
the pending pods fit on a hypothetical new node from group g?" — is the
same filter pipeline this repo already vectorizes, so all K candidate
expansions evaluate as ONE batched ``run_filters`` call over a
hypothetical-node overlay instead of K sequential binpacking passes.

The PyTorch port of ``kubernetes_tpu/autoscaler``: the filter calls run
on the card (``device=None``) unless the caller passes ``device="cpu"``.
"""

from kubernetes_tpu_torch.autoscaler.autoscaler import (
    STATUS_CONFIGMAP,
    ClusterAutoscaler,
)
from kubernetes_tpu_torch.autoscaler.expander import EXPANDERS
from kubernetes_tpu_torch.autoscaler.nodegroup import (
    NODE_GROUP_LABEL,
    HollowNodeGroupProvider,
    NodeGroup,
    NodeGroupProvider,
    StaticNodeGroupProvider,
    load_node_group,
)
from kubernetes_tpu_torch.autoscaler.simulator import (
    ScaleDownPlan,
    ScaleUpOption,
    simulate_scale_down,
    simulate_scale_up,
)

__all__ = [
    "ClusterAutoscaler",
    "EXPANDERS",
    "HollowNodeGroupProvider",
    "NODE_GROUP_LABEL",
    "NodeGroup",
    "NodeGroupProvider",
    "STATUS_CONFIGMAP",
    "ScaleDownPlan",
    "ScaleUpOption",
    "StaticNodeGroupProvider",
    "load_node_group",
    "simulate_scale_down",
    "simulate_scale_up",
]
