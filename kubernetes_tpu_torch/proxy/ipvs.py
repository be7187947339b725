"""kube-proxy IPVS backend — virtual-server table renderer.

Reference: ``pkg/proxy/ipvs/proxier.go``: instead of per-service iptables
chains, every service port becomes an IPVS VIRTUAL SERVER (``ipvsadm -A -t
vip:port -s rr``) with one REAL SERVER per endpoint (``-a -t vip:port -r
ip:port -m``), all service VIPs bound to a ``kube-ipvs0`` dummy interface,
and a handful of ipset-driven iptables rules for masquerade — O(1) rule
count in services where iptables is O(n).

Rendered as the ``ipvsadm-restore`` / ``ipvsadm -Sn`` save format plus the
dummy-interface address list; ``RestoredIpvsRules`` parses it back into a
DNAT decision table so render drift is caught by the same cross-backend
round-trip tests the iptables and nftables renderers run under.
"""

from __future__ import annotations

from kubernetes_tpu_torch.proxy.proxier import Proxier


class IpvsProxier(Proxier):
    """Same watch/sync machinery and resolve() dataplane; the kernel-facing
    render is the IPVS virtual/real-server table."""

    def sync_ipvs_text(self) -> str:
        """``ipvsadm -Sn`` save format: -A adds a virtual server (with the
        scheduler, rr unless sessionAffinity pins via source hashing),
        -a adds each real server in masquerade mode (-m). Endpoint-less
        services keep their virtual server with NO real servers — the
        kernel then refuses connections, the IPVS analog of the REJECT
        rule."""
        with self._lock:
            services = sorted(self._services.items())
        lines: list[str] = []
        vips: set[str] = set()
        for (_ns, _name, _pname), spi in services:
            proto_flag = "-t" if spi.protocol.upper() == "TCP" else "-u"
            sched = "sh" if spi.session_affinity else "rr"
            vs = f"{spi.cluster_ip}:{spi.port}"
            vips.add(spi.cluster_ip)
            persist = " -p 10800" if spi.session_affinity else ""
            lines.append(f"-A {proto_flag} {vs} -s {sched}{persist}")
            for ep in spi.endpoints:
                lines.append(f"-a {proto_flag} {vs} -r {ep} -m -w 1")
            if spi.node_port:
                nvs = f"0.0.0.0:{spi.node_port}"
                lines.append(f"-A {proto_flag} {nvs} -s {sched}{persist}")
                for ep in spi.endpoints:
                    lines.append(f"-a {proto_flag} {nvs} -r {ep} -m -w 1")
        # the dummy interface carrying every service VIP (ipvs proxier
        # binds them to kube-ipvs0 so local traffic hits IPVS)
        dev = [f"ip addr add {vip}/32 dev kube-ipvs0"
               for vip in sorted(vips)]
        return "\n".join(dev + lines) + "\n"


class RestoredIpvsRules:
    """Parse the save-format text back into a DNAT decision table (the
    round-trip contract shared with RestoredRules / RestoredNftRules)."""

    def __init__(self, text: str):
        # (vip, port, proto) -> [real servers]; "0.0.0.0" rows = nodePorts
        self.servers: dict[tuple, list[str]] = {}
        for raw in text.splitlines():
            toks = raw.split()
            if not toks or toks[0] == "ip":
                continue
            proto = "tcp" if "-t" in toks else "udp"
            vs = toks[toks.index("-t" if "-t" in toks else "-u") + 1]
            vip, _, port = vs.rpartition(":")
            key = (vip, int(port), proto)
            if toks[0] == "-A":
                self.servers.setdefault(key, [])
            elif toks[0] == "-a" and "-r" in toks:
                self.servers.setdefault(key, []).append(
                    toks[toks.index("-r") + 1])

    def backends(self, vip: str, port: int, proto: str = "tcp") -> list[str]:
        key = (vip, int(port), proto)
        if key in self.servers:
            return list(self.servers[key])
        # nodePort dispatch: any local address matches the 0.0.0.0 row
        return list(self.servers.get(("0.0.0.0", int(port), proto), []))
