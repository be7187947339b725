"""Pod Security admission — the baseline/restricted standards enforcer.

Reference: ``staging/src/k8s.io/pod-security-admission`` (default-on since
v1.25): namespaces opt into a policy LEVEL via the
``pod-security.kubernetes.io/enforce`` label (``privileged`` — anything
goes; ``baseline`` — no known privilege escalations; ``restricted`` —
hardened best practice), and pod CREATE/UPDATE in that namespace is
checked against the level's controls. ``warn``/``audit`` modes exist
upstream; enforce is the behavior clients observe and what this
implements, with each violated control named in the rejection message
exactly like upstream's aggregated deny.

Controls implemented (the standards' core):
  baseline    host namespaces (hostNetwork/hostPID/hostIPC), privileged
              containers, hostPath volumes, hostPorts, added capabilities
              beyond the baseline allowlist
  restricted  baseline PLUS: runAsNonRoot, allowPrivilegeEscalation=false
              required, capabilities must drop ALL, seccompProfile of
              RuntimeDefault/Localhost, no root runAsUser=0
"""

from __future__ import annotations

ENFORCE_LABEL = "pod-security.kubernetes.io/enforce"

# capabilities baseline tolerates being ADDED (the standards' list)
_BASELINE_CAPS = {
    "AUDIT_WRITE", "CHOWN", "DAC_OVERRIDE", "FOWNER", "FSETID", "KILL",
    "MKNOD", "NET_BIND_SERVICE", "SETFCAP", "SETGID", "SETPCAP", "SETUID",
    "SYS_CHROOT",
}


def _containers(spec: dict):
    return ((spec.get("initContainers") or [])
            + (spec.get("containers") or [])
            + (spec.get("ephemeralContainers") or []))


def _baseline_violations(spec: dict) -> list[str]:
    out = []
    for field in ("hostNetwork", "hostPID", "hostIPC"):
        if spec.get(field):
            out.append(f"host namespaces ({field}=true)")
    for vol in spec.get("volumes") or []:
        if "hostPath" in vol:
            out.append(f"hostPath volume {vol.get('name', '')!r}")
    for c in _containers(spec):
        name = c.get("name", "")
        sc = c.get("securityContext") or {}
        if sc.get("privileged"):
            out.append(f"privileged container {name!r}")
        for port in c.get("ports") or []:
            if port.get("hostPort"):
                out.append(f"hostPort {port['hostPort']} "
                           f"(container {name!r})")
        added = set((sc.get("capabilities") or {}).get("add") or [])
        bad = added - _BASELINE_CAPS
        if bad:
            out.append(f"non-default capabilities {sorted(bad)} "
                       f"(container {name!r})")
    return out


def _restricted_violations(spec: dict) -> list[str]:
    out = _baseline_violations(spec)
    pod_sc = spec.get("securityContext") or {}
    for c in _containers(spec):
        name = c.get("name", "")
        sc = c.get("securityContext") or {}

        def eff(field):
            v = sc.get(field)
            return v if v is not None else pod_sc.get(field)

        if eff("allowPrivilegeEscalation") is not False:
            out.append("allowPrivilegeEscalation != false "
                       f"(container {name!r})")
        if not eff("runAsNonRoot"):
            out.append(f"runAsNonRoot != true (container {name!r})")
        if eff("runAsUser") == 0:
            out.append(f"runAsUser=0 (container {name!r})")
        drops = set((sc.get("capabilities") or {}).get("drop") or [])
        if "ALL" not in drops:
            out.append(f'capabilities must drop "ALL" '
                       f"(container {name!r})")
        seccomp = (eff("seccompProfile") or {}).get("type")
        if seccomp not in ("RuntimeDefault", "Localhost"):
            out.append("seccompProfile must be RuntimeDefault or "
                       f"Localhost (container {name!r})")
    return out


def check_pod(level: str, pod: dict) -> list[str]:
    """Violated controls for a pod at a policy level ([] = admitted)."""
    spec = pod.get("spec") or {}
    if level == "restricted":
        return _restricted_violations(spec)
    if level == "baseline":
        return _baseline_violations(spec)
    return []  # privileged / unlabeled


def pod_security(store):
    """Validating admission plugin: enforce the namespace's labeled level
    on pod writes (subresource-less — status heartbeats are exempt, as
    upstream exempts updates that don't touch the pod spec)."""
    def admit(verb: str, kind: str, obj: dict, sub=None):
        if kind != "Pod" or verb not in ("CREATE", "UPDATE") or sub:
            return None
        md = obj.get("metadata") or {}
        ns_name = md.get("namespace", "default")
        if verb == "UPDATE":
            # upstream exempts updates that leave the pod spec unchanged
            # (metadata-only writes — labels, finalizer removal during
            # graceful deletion — must not wedge existing workloads after
            # a namespace tightens its level)
            try:
                cur = store.get("Pod", ns_name, md.get("name", ""))
                if (cur.get("spec") or {}) == (obj.get("spec") or {}):
                    return None
            except Exception:  # ktpu-lint: disable=KTL002 -- cache probe only; falls through to the authoritative store read below
                pass
        try:
            ns = store.get("Namespace", "", ns_name)
        except Exception:  # ktpu-lint: disable=KTL002 -- unlabeled/unknown namespace admits as privileged — upstream PodSecurity's default for unlabeled namespaces
            return None  # unlabeled/unknown namespace: privileged
        level = ((ns.get("metadata") or {}).get("labels") or {}) \
            .get(ENFORCE_LABEL, "privileged")
        violations = check_pod(level, obj)
        if violations:
            from kubernetes_tpu_torch.store.apiserver import AdmissionError
            name = (obj.get("metadata") or {}).get("name", "")
            raise AdmissionError(
                f"pods {name!r} is forbidden: violates PodSecurity "
                f"{level!r}: " + "; ".join(violations))
        return None

    admit.__name__ = "pod_security"
    admit.wants_subresource = True
    return admit
