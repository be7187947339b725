"""Service LoadBalancer controller — cloud LB provisioning, played local.

Reference: ``staging/src/k8s.io/cloud-provider/controllers/service``
(``EnsureLoadBalancer``/``EnsureLoadBalancerDeleted`` against the cloud
API): Services of type LoadBalancer get an external ingress IP in
``status.loadBalancer.ingress`` once the cloud provisions one; switching
the type away releases it. The "cloud" here is an in-process IP pool,
the same stance as pvbinder playing the external provisioner.
"""

from __future__ import annotations

import ipaddress
import threading

from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, split_key


class _LbPool:
    """The cloud's LB address pool."""

    def __init__(self, cidr: str = "203.0.113.0/24"):
        self.net = ipaddress.ip_network(cidr)
        self._used: dict[str, str] = {}  # service key -> ip
        self._lock = threading.Lock()

    def ensure(self, key: str) -> str:
        with self._lock:
            ip = self._used.get(key)
            if ip:
                return ip
            taken = set(self._used.values())
            for host in self.net.hosts():
                if str(host) not in taken:
                    self._used[key] = str(host)
                    return str(host)
        raise RuntimeError("LB pool exhausted")

    def release(self, key: str) -> None:
        with self._lock:
            self._used.pop(key, None)


class ServiceLBController(Controller):
    name = "service-lb"
    workers = 1

    def __init__(self, client, pool: _LbPool | None = None):
        super().__init__(client)
        self.pool = pool or _LbPool()

    def register(self, factory: InformerFactory) -> None:
        self.svc_informer = factory.informer("services", None)
        self.svc_informer.add_event_handler(self.handler())

    def sync(self, key: str) -> None:
        import copy
        ns, name = split_key(key)
        cached = self.svc_informer.store.get(key)
        res = self.client.resource("services", ns)
        if cached is None:
            self.pool.release(key)
            return
        # never mutate the informer's cached object: a failed status write
        # would poison the cache and make every retry early-return
        svc = copy.deepcopy(cached)
        spec = svc.get("spec") or {}
        status = svc.setdefault("status", {})
        lb = status.setdefault("loadBalancer", {})
        if spec.get("type") != "LoadBalancer":
            # type changed away: the cloud LB is torn down
            if lb.get("ingress"):
                self.pool.release(key)
                lb.pop("ingress", None)
                self._update_status(res, svc)
            return
        ip = self.pool.ensure(key)
        if lb.get("ingress") == [{"ip": ip}]:
            return
        lb["ingress"] = [{"ip": ip}]
        self._update_status(res, svc)

    @staticmethod
    def _update_status(res, svc: dict) -> None:
        try:
            res.update_status(svc)
        except ApiError as e:
            if e.code not in (404, 409):
                raise
