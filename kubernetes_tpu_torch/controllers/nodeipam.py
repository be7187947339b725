"""Node IPAM controller — pod CIDR allocation per node.

Reference: ``pkg/controller/nodeipam/node_ipam_controller.go`` with the
RangeAllocator (``ipam/range_allocator.go``): the cluster CIDR (e.g.
``10.244.0.0/16``) is carved into fixed-size per-node subnets
(``--node-cidr-mask-size``, default /24); every node without
``spec.podCIDR`` gets the next free subnet, releases happen on node
delete, and CIDRs already present on nodes (e.g. after a controller
restart) are re-reserved from the informer cache before any allocation.
"""

from __future__ import annotations

import ipaddress
import threading

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller


class CidrSet:
    """The RangeAllocator's cidrset: index-addressed fixed-size subnets of
    the cluster CIDR (``ipam/cidrset/cidr_set.go``)."""

    def __init__(self, cluster_cidr: str, node_mask_size: int):
        self.net = ipaddress.ip_network(cluster_cidr)
        if node_mask_size < self.net.prefixlen:
            raise ValueError("node mask must be narrower than the cluster "
                             "CIDR")
        self.node_mask_size = node_mask_size
        self.max = 1 << (node_mask_size - self.net.prefixlen)
        self._used: set[int] = set()
        self._next = 0
        self._lock = threading.Lock()

    def cidr_at(self, index: int) -> str:
        base = int(self.net.network_address) \
            + (index << (self.net.max_prefixlen - self.node_mask_size))
        return f"{ipaddress.ip_address(base)}/{self.node_mask_size}"

    def index_of(self, cidr: str) -> int:
        net = ipaddress.ip_network(cidr)
        return (int(net.network_address) - int(self.net.network_address)) \
            >> (self.net.max_prefixlen - self.node_mask_size)

    def occupy(self, cidr: str) -> None:
        try:
            i = self.index_of(cidr)
        except ValueError:
            return
        if 0 <= i < self.max:
            with self._lock:
                self._used.add(i)

    def allocate(self) -> str:
        """Next free subnet (round-robin from the last allocation, like the
        upstream cidrset's nextCandidate scan)."""
        with self._lock:
            for off in range(self.max):
                i = (self._next + off) % self.max
                if i not in self._used:
                    self._used.add(i)
                    self._next = (i + 1) % self.max
                    return self.cidr_at(i)
        raise RuntimeError("cluster CIDR exhausted")

    def release(self, cidr: str) -> None:
        try:
            i = self.index_of(cidr)
        except ValueError:
            return
        with self._lock:
            self._used.discard(i)


class NodeIpamController(Controller):
    name = "nodeipam"
    workers = 1

    def __init__(self, client, cluster_cidr: str = "10.244.0.0/16",
                 node_mask_size: int = 24):
        super().__init__(client)
        self.cidrs = CidrSet(cluster_cidr, node_mask_size)
        self._assigned: dict[str, str] = {}  # node name -> cidr

    def register(self, factory: InformerFactory) -> None:
        self.node_informer = factory.informer("nodes", None)
        # Restart safety, both wiring orders: in the normal flow (register
        # before factory.start_all) the informer replays every existing
        # node as an ADDED event during cache sync, and _on_node occupies
        # its podCIDR before any worker allocates. If this controller is
        # ever registered against an ALREADY-synced shared informer (no
        # replay), the store scan below provides the same guarantee.
        for n in self.node_informer.store.list():
            self._reserve_existing(n)
        self.node_informer.add_event_handler(self._on_node)

    def _reserve_existing(self, node: dict) -> None:
        cidr = (node.get("spec") or {}).get("podCIDR", "")
        if cidr:
            self.cidrs.occupy(cidr)
            self._assigned[(node.get("metadata") or {})
                           .get("name", "")] = cidr

    def _on_node(self, type_, obj, old) -> None:
        name = (obj.get("metadata") or {}).get("name", "")
        if type_ == "DELETED":
            cidr = self._assigned.pop(name, None) \
                or (obj.get("spec") or {}).get("podCIDR", "")
            if cidr:
                self.cidrs.release(cidr)
            return
        self._reserve_existing(obj)
        self.enqueue(obj)

    def sync(self, key: str) -> None:
        res = self.client.resource("nodes", None)
        try:
            node = res.get(key)
        except ApiError as e:
            if e.code == 404:
                return
            raise
        spec = node.setdefault("spec", {})
        if spec.get("podCIDR"):
            return
        cidr = self.cidrs.allocate()
        spec["podCIDR"] = cidr
        spec["podCIDRs"] = [cidr]
        try:
            res.update(node)
            self._assigned[key] = cidr
        except ApiError as e:
            # lost the race or the node vanished: return the subnet
            self.cidrs.release(cidr)
            if e.code not in (404, 409):
                raise
