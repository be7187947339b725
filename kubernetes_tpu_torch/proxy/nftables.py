"""kube-proxy nftables backend — the successor dataplane renderer.

Reference: ``pkg/proxy/nftables/proxier.go`` (upstream's default-capable
backend since v1.31): one ``table ip kube-proxy`` owning verdict maps and
per-service chains —

- ``service-ips``        ipv4 . proto . port : verdict map dispatching
                         cluster IPs to ``goto service-<chain>``
- ``service-nodeports``  proto . port : verdict map for nodePorts
- ``no-endpoint-services`` REJECT verdicts for endpoint-less services
- ``service-<hash>``     ``numgen random mod N vmap`` spreading to
                         ``endpoint-<hash>`` chains
- ``endpoint-<hash>``    hairpin masquerade mark + ``dnat to ip:port``

Chain names carry upstream's readable suffix
(``service-<HASH8>-<ns>/<name>/<proto>/<port>``). The rendered document is
an ``nft -f`` payload; ``RestoredNftRules`` parses it back into a DNAT
decision table so render drift against the semantic table is caught the
same way the iptables backend's round-trip does.
"""

from __future__ import annotations

import base64
import hashlib

from kubernetes_tpu_torch.proxy.proxier import Proxier, ServicePortInfo


def _hash8(*parts: str) -> str:
    digest = hashlib.sha256("".join(parts).encode()).digest()
    return base64.b32encode(digest).decode()[:8]


def _svc_chain(sp_name: str, proto: str, port: int) -> str:
    # service-<hash>-<ns>/<name>/<proto>/<port> (upstream servicePortChainName)
    return (f"service-{_hash8(sp_name, proto)}-"
            f"{sp_name.replace(':', '/')}/{proto}/{port}")


def _ep_chain(sp_name: str, proto: str, endpoint: str) -> str:
    ip = endpoint.rsplit(":", 1)[0]
    return (f"endpoint-{_hash8(sp_name, proto, endpoint)}-"
            f"{ip}/{sp_name.replace(':', '/')}")


class NftablesProxier(Proxier):
    """Same watch/sync machinery and resolve() dataplane as the iptables
    backend; only the kernel-facing render differs."""

    def sync_nft_text(self) -> str:
        """The full ``nft -f`` payload ``syncProxyRules`` would write."""
        with self._lock:
            services = sorted(self._services.items())
        svc_ip_elems: list[str] = []
        nodeport_elems: list[str] = []
        noep_elems: list[str] = []
        chains: list[str] = []
        for (ns, name, pname), spi in services:
            sp_name = f"{ns}/{name}" + (f":{pname}" if pname else "")
            proto = spi.protocol.lower()
            if not spi.endpoints:
                noep_elems.append(
                    f"{spi.cluster_ip} . {proto} . {spi.port} : "
                    f"goto reject-chain")
                continue
            chain = _svc_chain(sp_name, proto, spi.port)
            svc_ip_elems.append(
                f"{spi.cluster_ip} . {proto} . {spi.port} : goto {chain}")
            if spi.node_port:
                nodeport_elems.append(
                    f"{proto} . {spi.node_port} : goto {chain}")
            n = len(spi.endpoints)
            arms = ", ".join(
                f"{i} : goto {_ep_chain(sp_name, proto, ep)}"
                for i, ep in enumerate(spi.endpoints))
            chains.append(
                f"\tchain {chain} {{\n"
                f"\t\tnumgen random mod {n} vmap {{ {arms} }}\n"
                f"\t}}")
            for ep in spi.endpoints:
                ip = ep.rsplit(":", 1)[0]
                chains.append(
                    f"\tchain {_ep_chain(sp_name, proto, ep)} {{\n"
                    f"\t\tip saddr {ip} jump mark-for-masquerade\n"
                    f"\t\tmeta l4proto {proto} dnat to {ep}\n"
                    f"\t}}")

        def _map(name: str, keytype: str, elems: list[str]) -> str:
            body = (";\n\t\telements = { " + ",\n\t\t\t".join(elems) + " }"
                    if elems else "")
            return (f"\tmap {name} {{\n"
                    f"\t\ttype {keytype} : verdict{body}\n"
                    f"\t}}")

        parts = [
            "table ip kube-proxy {",
            '\tcomment "rules for kube-proxy"',
            "\tchain mark-for-masquerade {",
            "\t\tmeta mark set meta mark or 0x4000",
            "\t}",
            "\tchain masquerading {",
            "\t\ttype nat hook postrouting priority srcnat; policy accept;",
            "\t\tmeta mark & 0x4000 == 0 return",
            "\t\tmeta mark set meta mark xor 0x4000 masquerade",
            "\t}",
            "\tchain services {",
            "\t\ttype nat hook prerouting priority dnat; policy accept;",
            "\t\tip daddr . meta l4proto . th dport vmap "
            "@no-endpoint-services",
            "\t\tip daddr . meta l4proto . th dport vmap @service-ips",
            "\t\tfib daddr type local meta l4proto . th dport vmap "
            "@service-nodeports",
            "\t}",
            "\tchain reject-chain {",
            "\t\treject",
            "\t}",
            _map("service-ips", "ipv4_addr . inet_proto . inet_service",
                 svc_ip_elems),
            _map("service-nodeports", "inet_proto . inet_service",
                 nodeport_elems),
            _map("no-endpoint-services",
                 "ipv4_addr . inet_proto . inet_service", noep_elems),
        ] + chains + ["}"]
        return "\n".join(parts) + "\n"


class RestoredNftRules:
    """Parse an ``nft -f`` payload back into a DNAT decision table — the
    round-trip proof that the rendered ruleset is semantically complete
    (same contract as proxier.RestoredRules for iptables)."""

    def __init__(self, text: str):
        self.dispatch: dict[tuple, str] = {}   # (vip, port, proto) -> chain
        self.nodeports: dict[tuple, str] = {}  # (port, proto) -> chain
        self.rejects: set[tuple] = set()
        self.chains: dict[str, list[str]] = {}
        cur: str | None = None
        mode: str | None = None
        for raw in text.splitlines():
            line = raw.strip()
            if line.startswith("chain "):
                cur = line.split()[1]
                self.chains[cur] = []
                mode = "chain"
            elif line.startswith("map "):
                mode = line.split()[1]
            elif line == "}":
                cur = mode = None
            elif mode == "chain" and cur is not None and line:
                self.chains[cur].append(line)
            elif line.startswith("type "):
                continue  # the map's key-type declaration, not an element
            elif mode and mode != "chain" and ":" in line and "." in line:
                for elem in line.replace("elements = {", "").replace(
                        "}", "").split(","):
                    elem = elem.strip().rstrip(";")
                    if ":" not in elem or "." not in elem:
                        continue
                    key, _, verdict = elem.partition(" : ")
                    fields = [f.strip() for f in key.split(" . ")]
                    # removeprefix, not replace: chain names embed the
                    # user-controlled ns/name, which may contain "goto"
                    target = verdict.strip().removeprefix("goto").strip()
                    if mode == "service-ips":
                        vip, proto, port = fields
                        self.dispatch[(vip, int(port), proto)] = target
                    elif mode == "service-nodeports":
                        proto, port = fields
                        self.nodeports[(int(port), proto)] = target
                    elif mode == "no-endpoint-services":
                        vip, proto, port = fields
                        self.rejects.add((vip, int(port), proto))

    def backends(self, vip: str, port: int, proto: str = "tcp") -> list[str]:
        if (vip, port, proto) in self.rejects:
            return []
        chain = self.dispatch.get((vip, port, proto)) \
            or self.nodeports.get((port, proto))
        if chain is None:
            return []
        out: list[str] = []
        for rule in self.chains.get(chain, []):
            if "vmap" not in rule:
                continue
            arms = rule[rule.index("{") + 1:rule.rindex("}")]
            for arm in arms.split(","):
                target = arm.split(":", 1)[1].strip() \
                    .removeprefix("goto").strip()
                for ep_rule in self.chains.get(target, []):
                    if "dnat to" in ep_rule:
                        out.append(ep_rule.rsplit("dnat to", 1)[1].strip())
        return out
