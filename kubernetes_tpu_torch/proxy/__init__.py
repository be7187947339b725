"""kube-proxy — Service VIP dataplane (SURVEY §2.4).

The PyTorch port of ``kubernetes_tpu/proxy``: ``Proxier`` (the iptables
shape), ``NftablesProxier`` and ``IpvsProxier`` over the port's
``client/informer.InformerFactory``. Host code: it programs tables of
dicts, not the machine, and puts nothing on the device.
"""

from kubernetes_tpu_torch.proxy.proxier import Proxier, ServicePortInfo

__all__ = ["Proxier", "ServicePortInfo"]
