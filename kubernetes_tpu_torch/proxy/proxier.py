"""kube-proxy — Service VIPs programmed from Service + Endpoints watches.

Reference: ``pkg/proxy/iptables/proxier.go`` (``Proxier.syncProxyRules``: a
full-state rule rebuild debounced behind change trackers), with
``pkg/proxy/servicechangetracker.go`` / ``endpointschangetracker.go``
feeding it. The kernel-rule surface here is a data-plane table: chains
KUBE-SERVICES -> KUBE-SVC-<id> -> KUBE-SEP-<id> represented as dicts, plus a
``resolve()`` that performs the DNAT a packet would take — tests and the CLI
exercise the same table the kernel would.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Optional

from kubernetes_tpu_torch.client.informer import InformerFactory


@dataclass
class ServicePortInfo:
    namespace: str
    name: str
    port_name: str
    cluster_ip: str
    port: int
    protocol: str = "TCP"
    node_port: int = 0
    session_affinity: bool = False
    endpoints: list[str] = field(default_factory=list)  # "ip:port"


class Proxier:
    """Full-state sync on any Service/Endpoints change (rate-limited by the
    informer thread itself; upstream debounces with a bounded-frequency
    runner — sync here is cheap enough to run per event)."""

    def __init__(self, client, node_name: str = ""):
        self.client = client
        self.node_name = node_name
        self.factory = InformerFactory(client)
        self._lock = threading.Lock()
        # (ns, svc_name, port_name) -> ServicePortInfo
        self._services: dict[tuple, ServicePortInfo] = {}
        self._affinity: dict[tuple, str] = {}  # (client_ip, vip, port) -> endpoint
        self.sync_count = 0

    # ---- wiring ----------------------------------------------------------

    def start(self, wait_sync: float = 10.0):
        self.svc_informer = self.factory.informer("services", None)
        self.ep_informer = self.factory.informer("endpoints", None)
        self.svc_informer.add_event_handler(lambda *a: self.sync())
        self.ep_informer.add_event_handler(lambda *a: self.sync())
        self.factory.start_all()
        self.factory.wait_for_cache_sync(wait_sync)
        self.sync()
        return self

    def stop(self):
        self.factory.stop_all()

    # ---- syncProxyRules --------------------------------------------------

    def sync(self) -> None:
        eps_by_svc: dict[tuple, dict] = {}
        for ep in self.ep_informer.store.list():
            md = ep.get("metadata") or {}
            eps_by_svc[(md.get("namespace", ""), md.get("name", ""))] = ep
        table: dict[tuple, ServicePortInfo] = {}
        for svc in self.svc_informer.store.list():
            md = svc.get("metadata") or {}
            spec = svc.get("spec") or {}
            cluster_ip = spec.get("clusterIP", "")
            if not cluster_ip or cluster_ip == "None":
                continue  # headless: no VIP rules
            ns, name = md.get("namespace", ""), md.get("name", "")
            ep = eps_by_svc.get((ns, name), {})
            affinity = (spec.get("sessionAffinity") == "ClientIP")
            for sp in spec.get("ports") or []:
                pname = sp.get("name", "")
                backends: list[str] = []
                for subset in ep.get("subsets") or []:
                    # match the endpoints port to this service port by name
                    # (unnamed single-port services match everything)
                    target = None
                    for epp in subset.get("ports") or []:
                        if not pname or epp.get("name", "") == pname:
                            target = int(epp.get("port", 0))
                            break
                    if target is None:
                        continue
                    for a in subset.get("addresses") or []:
                        backends.append(f"{a['ip']}:{target}")
                table[(ns, name, pname)] = ServicePortInfo(
                    namespace=ns, name=name, port_name=pname,
                    cluster_ip=cluster_ip, port=int(sp.get("port", 0)),
                    protocol=sp.get("protocol", "TCP"),
                    node_port=int(sp.get("nodePort", 0) or 0),
                    session_affinity=affinity,
                    endpoints=sorted(backends))
        with self._lock:
            self._services = table
            live = {(spi.cluster_ip, spi.port) for spi in table.values()}
            self._affinity = {k: v for k, v in self._affinity.items()
                              if (k[1], k[2]) in live}
            self.sync_count += 1

    # ---- the data plane --------------------------------------------------

    def resolve(self, vip: str, port: int,
                client_ip: str = "",
                rng: Optional[random.Random] = None) -> Optional[str]:
        """DNAT decision for a packet to vip:port -> "backend_ip:port" or
        None (REJECT, the no-endpoints rule). Random pick mirrors the
        iptables statistic-mode-random chain; ClientIP affinity mirrors
        recent-module pinning."""
        rng = rng or random
        with self._lock:
            spi = next((s for s in self._services.values()
                        if (s.cluster_ip == vip or (s.node_port and s.node_port == port))
                        and (s.port == port or s.node_port == port)), None)
            if spi is None or not spi.endpoints:
                return None
            key = (client_ip, vip, port)
            if spi.session_affinity and client_ip:
                pinned = self._affinity.get(key)
                if pinned in spi.endpoints:
                    return pinned
            choice = spi.endpoints[rng.randrange(len(spi.endpoints))]
            if spi.session_affinity and client_ip:
                self._affinity[key] = choice
            return choice

    def rules(self) -> list[str]:
        """Back-compat view: the -A lines of sync_proxy_rules_text()."""
        return [ln for ln in self.sync_proxy_rules_text().splitlines()
                if ln.startswith("-A")]

    def sync_proxy_rules_text(self) -> str:
        """The FULL iptables-restore payload ``syncProxyRules`` writes: one
        ``*nat`` table with chain declarations, the masquerade plumbing
        (KUBE-POSTROUTING / KUBE-MARK-MASQ with the 0x4000 mark), per
        service-port KUBE-SVC-<hash> chains dispatched from KUBE-SERVICES,
        per-endpoint KUBE-SEP-<hash> chains (hairpin masquerade + DNAT),
        statistic-mode-random load spreading, REJECTs for endpoint-less
        services, a trailing KUBE-NODEPORTS dispatch, and COMMIT.

        Chain names hash exactly like upstream
        (``pkg/proxy/iptables/proxier.go`` ``portProtoHash``/
        ``servicePortEndpointChainName``: base32(sha256(...))[:16]), so the
        rendered document is byte-comparable with a real kube-proxy's
        iptables-save for the same cluster state."""
        with self._lock:
            services = sorted(self._services.items())
        decls = [":KUBE-SERVICES - [0:0]", ":KUBE-NODEPORTS - [0:0]",
                 ":KUBE-POSTROUTING - [0:0]", ":KUBE-MARK-MASQ - [0:0]"]
        rules: list[str] = [
            '-A KUBE-POSTROUTING -m mark ! --mark 0x4000/0x4000 -j RETURN',
            '-A KUBE-POSTROUTING -j MASQUERADE',
            '-A KUBE-MARK-MASQ -j MARK --set-xmark 0x4000/0x4000',
        ]
        nodeports: list[str] = []
        for (ns, name, pname), spi in services:
            sp_name = f"{ns}/{name}" + (f":{pname}" if pname else "")
            proto = spi.protocol.lower()
            comment = f'-m comment --comment "{sp_name} cluster IP"'
            if not spi.endpoints:
                rules.append(
                    f'-A KUBE-SERVICES {comment} -p {proto} -m {proto} '
                    f'-d {spi.cluster_ip}/32 --dport {spi.port} -j REJECT')
                continue
            svc_chain = _svc_chain(sp_name, spi.protocol)
            decls.append(f":{svc_chain} - [0:0]")
            rules.append(
                f'-A KUBE-SERVICES {comment} -p {proto} -m {proto} '
                f'-d {spi.cluster_ip}/32 --dport {spi.port} -j {svc_chain}')
            if spi.node_port:
                nodeports.append(
                    f'-A KUBE-NODEPORTS -p {proto} -m {proto} '
                    f'--dport {spi.node_port} -j {svc_chain}')
            n = len(spi.endpoints)
            for i, ep in enumerate(spi.endpoints):
                sep_chain = _sep_chain(sp_name, spi.protocol, ep)
                decls.append(f":{sep_chain} - [0:0]")
                prob = (f' -m statistic --mode random --probability '
                        f'{1 / (n - i):.10f}' if i < n - 1 else '')
                rules.append(
                    f'-A {svc_chain} -m comment --comment "{sp_name}"'
                    f'{prob} -j {sep_chain}')
                ip = ep.rsplit(":", 1)[0]
                rules.append(  # hairpin: a backend reaching its own VIP
                    f'-A {sep_chain} -m comment --comment "{sp_name}" '
                    f'-s {ip}/32 -j KUBE-MARK-MASQ')
                rules.append(
                    f'-A {sep_chain} -m comment --comment "{sp_name}" '
                    f'-p {proto} -m {proto} -j DNAT --to-destination {ep}')
        rules.append('-A KUBE-SERVICES -m addrtype --dst-type LOCAL '
                     '-j KUBE-NODEPORTS')
        rules += nodeports
        return "\n".join(["*nat"] + decls + rules + ["COMMIT", ""])

    def service_table(self) -> dict[tuple, ServicePortInfo]:
        with self._lock:
            return dict(self._services)


def _hash16(*parts: str) -> str:
    """base32(sha256(join))[:16] — upstream's portProtoHash shape."""
    import base64
    import hashlib
    digest = hashlib.sha256("".join(parts).encode()).digest()
    return base64.b32encode(digest).decode()[:16]


def _svc_chain(sp_name: str, protocol: str) -> str:
    return "KUBE-SVC-" + _hash16(sp_name, protocol.lower())


def _sep_chain(sp_name: str, protocol: str, endpoint: str) -> str:
    return "KUBE-SEP-" + _hash16(sp_name, protocol.lower(), endpoint)


class RestoredRules:
    """Parse an iptables-restore payload back into a DNAT decision table —
    the round-trip proof that the rendered text is semantically complete:
    a packet resolved through the PARSED rules must reach the same backend
    set as the live Proxier's resolve()."""

    def __init__(self, text: str):
        self.chains: dict[str, list[str]] = {}
        self.dispatch: dict[tuple, str] = {}   # (vip, port, proto) -> chain
        self.nodeports: dict[tuple, str] = {}  # (port, proto) -> chain
        self.rejects: set[tuple] = set()
        for line in text.splitlines():
            if line.startswith(":"):
                self.chains[line[1:].split()[0]] = []
            elif line.startswith("-A "):
                chain, rest = line[3:].split(" ", 1)
                self.chains.setdefault(chain, []).append(rest)
        for rule in self.chains.get("KUBE-SERVICES", []):
            toks = rule.split()
            if "-d" not in toks or "--dport" not in toks:
                continue
            vip = toks[toks.index("-d") + 1].split("/")[0]
            port = int(toks[toks.index("--dport") + 1])
            proto = toks[toks.index("-p") + 1]
            target = toks[toks.index("-j") + 1]
            if target == "REJECT":
                self.rejects.add((vip, port, proto))
            else:
                self.dispatch[(vip, port, proto)] = target
        for rule in self.chains.get("KUBE-NODEPORTS", []):
            toks = rule.split()
            if "--dport" in toks:
                self.nodeports[(int(toks[toks.index("--dport") + 1]),
                                toks[toks.index("-p") + 1])] = \
                    toks[toks.index("-j") + 1]

    def backends(self, vip: str, port: int, proto: str = "tcp") -> list[str]:
        """Every DNAT destination reachable for vip:port ([] = REJECT).
        REJECT rules sit in KUBE-SERVICES BEFORE the trailing nodePort
        dispatch, so a rejected clusterIP must not fall through to another
        service's nodePort chain."""
        if (vip, port, proto) in self.rejects:
            return []
        chain = self.dispatch.get((vip, port, proto)) \
            or self.nodeports.get((port, proto))
        if chain is None:
            return []
        out = []
        for rule in self.chains.get(chain, []):
            toks = rule.split()
            if "-j" not in toks:
                continue
            target = toks[toks.index("-j") + 1]
            if target.startswith("KUBE-SEP-"):
                for sep_rule in self.chains.get(target, []):
                    st = sep_rule.split()
                    if "--to-destination" in st:
                        out.append(st[st.index("--to-destination") + 1])
        return out
