"""Dynamic Resource Allocation (DRA) — device claims as scheduling inputs.

Reference: ``pkg/scheduler/framework/plugins/dynamicresources/`` with the
structured-parameters model (resource.k8s.io/v1): ``ResourceSlice`` publishes
each node's device inventory, ``DeviceClass`` names a class of devices,
``ResourceClaim`` requests devices (``spec.devices.requests[]`` with
``deviceClassName`` + ``count``), pods reference claims via
``spec.resourceClaims``, and the scheduler allocates devices during the
scheduling cycle, recording the result in ``claim.status.allocation``.

Design: instead of a bespoke allocator plugin, device classes ride the
EXISTING resource axis as synthetic resources named ``dra:<class>`` — a
node's slice inventory extends its allocatable vector and a pod's claim
demands extend its request vector. The fit filter, the gang batcher's
capacity-contention acceptance, and preemption then all handle devices with
zero new tensor code, which is exactly the property the reference's
NodeResources machinery lacks and its DRA plugin re-implements host-side.
The claim OBJECTS keep full API semantics: allocation is written on bind
(``SchedulerRunner``), ``reservedFor`` tracks the consumer, and the claim
controller releases allocations when consumers disappear.

Simplifications (documented, not silent): devices within a class are
fungible (counts, not per-device attributes/selectors), and a claim has a
single consumer (``reservedFor`` of one — the common template-per-pod
shape).

The PyTorch port's copy of ``kubernetes_tpu/sched/dra.py``: host code only,
the same catalog and patches; the tensors it widens live in the port's
encoder (encode/snapshot.py, encode/patch.py). One difference: the
informer thread writes the catalog's dicts (``SchedulerCache
.update_dra_object``) while the scheduling thread encodes from them, so
every walk over a dict here walks a copy of its values. The reference
walks the dicts themselves, and a claim created during an encode stops
that encode with "dictionary changed size during iteration".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.api.types import Pod

DRA_PREFIX = "dra:"


@dataclass
class DraCatalog:
    """Indexed view of the resource.k8s.io objects (informer-fed)."""

    # (namespace, name) -> ResourceClaim dict
    claims: dict[tuple, dict] = field(default_factory=dict)
    # name -> DeviceClass dict
    classes: dict[str, dict] = field(default_factory=dict)
    # name -> ResourceSlice dict
    slices: dict[str, dict] = field(default_factory=dict)

    @classmethod
    def from_lists(cls, claims=(), classes=(), slices=()) -> "DraCatalog":
        cat = cls()
        for c in claims:
            md = c.get("metadata") or {}
            cat.claims[(md.get("namespace", "default"), md.get("name", ""))] = c
        for c in classes:
            cat.classes[(c.get("metadata") or {}).get("name", "")] = c
        for s in slices:
            cat.slices[(s.get("metadata") or {}).get("name", "")] = s
        return cat

    # ---- claim-side resolution ------------------------------------------

    def pod_claims(self, pod: Pod) -> list[dict]:
        """Resolve the pod's referenced ResourceClaim objects (template
        references resolve to the generated per-pod claim named
        ``<pod>-<ref name>`` — the resourceclaim controller's convention)."""
        out = []
        ns = pod.metadata.namespace
        for ref in pod.spec.resource_claims:
            name = ref.get("resourceClaimName") or (
                f"{pod.metadata.name}-{ref.get('name', '')}"
                if ref.get("resourceClaimTemplateName") else "")
            claim = self.claims.get((ns, name))
            if claim is not None:
                out.append(claim)
        return out

    @staticmethod
    def claim_demands(claim: dict) -> dict[str, int]:
        """class name -> device count requested by the claim."""
        out: dict[str, int] = {}
        devices = ((claim.get("spec") or {}).get("devices") or {})
        for req in devices.get("requests") or []:
            cls_name = req.get("deviceClassName", "")
            if not cls_name:
                continue
            out[cls_name] = out.get(cls_name, 0) + int(req.get("count", 1))
        return out

    def pod_claims_ready(self, pod: Pod) -> bool:
        """Every referenced claim resolves to an existing ResourceClaim.
        A pod whose template-generated claim hasn't been created yet must be
        held unschedulable (dynamicresources PreFilter returns Unschedulable)
        — NOT scheduled with its device demand silently dropped."""
        ns = pod.metadata.namespace
        for ref in pod.spec.resource_claims:
            name = ref.get("resourceClaimName") or (
                f"{pod.metadata.name}-{ref.get('name', '')}"
                if ref.get("resourceClaimTemplateName") else "")
            if not name or (ns, name) not in self.claims:
                return False
        return True

    def pod_demands(self, pod: Pod) -> dict[str, int]:
        """Synthetic request vector extension: ``dra:<class>`` -> count."""
        out: dict[str, int] = {}
        for claim in self.pod_claims(pod):
            for cls_name, n in self.claim_demands(claim).items():
                key = DRA_PREFIX + cls_name
                out[key] = out.get(key, 0) + n
        return out

    @staticmethod
    def claim_slice_shape(claim: dict) -> Optional[tuple]:
        """A SLICE-SHAPED claim: ``spec.devices.requests[].sliceShape``
        ("2x2x4") asks for a contiguous ICI sub-slice instead of count
        fungible devices — the claims-bridge half of topology/ (the label
        route is kubernetes-tpu.io/slice-shape). First parseable shape
        wins; a claim may carry ordinary count requests besides it."""
        from kubernetes_tpu_torch.topology.slicing import parse_shape
        devices = ((claim.get("spec") or {}).get("devices") or {})
        for req in devices.get("requests") or []:
            shape = parse_shape(req.get("sliceShape"))
            if shape is not None:
                return shape
        return None

    def pod_slice_shape(self, pod: Pod) -> Optional[tuple]:
        """The slice shape requested by any of the pod's claims (routes
        the pod into the carver exactly like the slice-shape label)."""
        for claim in self.pod_claims(pod):
            shape = self.claim_slice_shape(claim)
            if shape is not None:
                return shape
        return None

    def pod_allocated_node(self, pod: Pod) -> Optional[str]:
        """If any referenced claim is already allocated, the pod is pinned
        to that node (the allocation's node selector)."""
        for claim in self.pod_claims(pod):
            alloc = ((claim.get("status") or {}).get("allocation")) or {}
            node = alloc.get("nodeName", "")
            if node:
                return node
        return None

    # ---- node-side resolution -------------------------------------------

    def node_capacity(self, node_name: str) -> dict[str, int]:
        """``dra:<class>`` -> total devices this node publishes via slices."""
        out: dict[str, int] = {}
        for s in list(self.slices.values()):
            spec = s.get("spec") or {}
            if spec.get("nodeName", "") != node_name:
                continue
            for dev in spec.get("devices") or []:
                cls_name = dev.get("deviceClassName", "")
                if not cls_name:
                    continue
                count = int(dev.get("count", 1))
                key = DRA_PREFIX + cls_name
                out[key] = out.get(key, 0) + count
        return out

    def node_topology(self, node_name: str) -> Optional[tuple]:
        """(x, y, z) published by the node's ResourceSlice device
        attributes (``topology-x/y/z`` ints — topology/slicing.TOPO_ATTRS),
        the inventory-side mirror of the node labels. First device carrying
        all three axes wins."""
        from kubernetes_tpu_torch.topology.slicing import TOPO_ATTRS
        for s in list(self.slices.values()):
            spec = s.get("spec") or {}
            if spec.get("nodeName", "") != node_name:
                continue
            for dev in spec.get("devices") or []:
                attrs = dev.get("attributes") or {}
                try:
                    coord = tuple(int(attrs[a].get("int")
                                      if isinstance(attrs[a], dict)
                                      else attrs[a]) for a in TOPO_ATTRS)
                except (KeyError, TypeError, ValueError):
                    continue
                if all(c >= 0 for c in coord):
                    return coord
        return None

    def class_names(self) -> set[str]:
        """Every device class referenced by any slice or claim (defines
        which synthetic resources exist this snapshot)."""
        names: set[str] = set()
        for s in list(self.slices.values()):
            for dev in ((s.get("spec") or {}).get("devices")) or []:
                if dev.get("deviceClassName"):
                    names.add(dev["deviceClassName"])
        for c in list(self.claims.values()):
            names.update(self.claim_demands(c))
        return names


def allocation_patch(claim: dict, node_name: str, pod: Pod,
                     coords: Optional[tuple] = None,
                     shape: Optional[tuple] = None) -> dict:
    """The claim object with allocation + reservedFor recorded (what the
    scheduler writes in PreBind — dynamicresources.go bindClaim). For a
    carved slice member the allocation also records WHERE in the torus the
    pod landed (``topology.coordinates``) and the gang's requested shape —
    the provenance the audit invariant and operators read back."""
    out = dict(claim)
    status = dict(claim.get("status") or {})
    allocation: dict = {"nodeName": node_name}
    if coords is not None:
        from kubernetes_tpu_torch.topology.slicing import shape_str
        topo: dict = {"coordinates": list(coords)}
        if shape is not None:
            topo["sliceShape"] = shape_str(shape)
        allocation["topology"] = topo
    status["allocation"] = allocation
    status["reservedFor"] = [{"resource": "pods",
                              "name": pod.metadata.name,
                              "uid": pod.metadata.uid}]
    out["status"] = status
    return out


def release_patch(claim: dict) -> dict:
    """The claim with its allocation dropped (deallocate — the claim
    controller applies this when the consuming pod is gone)."""
    out = dict(claim)
    status = dict(claim.get("status") or {})
    status.pop("allocation", None)
    status.pop("reservedFor", None)
    out["status"] = status
    return out
