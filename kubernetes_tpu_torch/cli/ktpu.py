"""ktpu — the kubectl analog, on the port.

The port's copy of ``kubernetes_tpu/cli/ktpu.py`` (reference shape:
``staging/src/k8s.io/kubectl/pkg/cmd/``; argparse stands in for cobra). It
talks to any apiserver over the port's ``HTTPClient``, and reads the
ConfigMaps that the port's runner, explainer, flight recorder, auditor,
planners, fleet scheduler and autoscaler publish. Its output is the
reference's, text for text, for the same objects.

Usage:
  ktpu --server http://127.0.0.1:8001 get pods [-n NS] [-o json|yaml|wide]
  ktpu apply -f manifest.json            # create-or-update; JSON or YAML
  ktpu delete pod NAME | ktpu delete -f manifest.json
  ktpu describe pod NAME
  ktpu scale deployment NAME --replicas N
  ktpu cordon NODE / ktpu uncordon NODE
  ktpu drain NODE
  ktpu status [-o json] / why POD / trace dump / audit status
  ktpu deschedule run [--dry-run] | status
  ktpu logs POD / exec POD -- CMD... / attach POD
  ktpu port-forward POD LOCAL[:REMOTE] [--one-shot]
  python -m kubernetes_tpu_torch.cli.ktpu ...

Ported: ``get``, ``apply`` (a JSON manifest needs no PyYAML; YAML imports
it when read; ``--server-side`` goes through the client's ``apply``),
``delete``,
``describe``, ``scale``, ``cordon``/``uncordon``, ``drain``, ``top``,
``label``/``annotate``, ``api-resources``, ``wait``, ``rollout``,
``status``, ``why``, ``trace dump``, ``audit status``, ``autoscale
status``, ``deschedule run|status``. ``deschedule run`` runs one cycle of
the port's ``Descheduler`` on the card (``--device cpu`` runs it on the
CPU).

``certificate approve|deny`` sets a CertificateSigningRequest's condition
(``controllers/certificates.py``).

``logs``, ``exec``, ``attach`` and ``port-forward`` go through the
apiserver's pod ``log``, ``exec`` and ``portforward`` subresources to the
pod's kubelet (``kubelet/server.py``).

``scenario generate|record|describe`` are file operations and need no
server; ``scenario replay`` drives a trace through the apiserver at
``--server`` (``scenario/driver.py``).

``lint`` runs the port's static analyzer (``analysis/``) over this
package against its committed baseline, and needs no server.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from kubernetes_tpu_torch.client.clientset import ApiError, HTTPClient
from kubernetes_tpu_torch.kubelet.kubemark import FLEET_CONFIGMAP
from kubernetes_tpu_torch.scenario.driver import SCENARIO_CONFIGMAP
from kubernetes_tpu_torch.store.apiserver import ALL_RESOURCES, KIND_TO_PLURAL

# singular/short aliases -> plural (kubectl's RESTMapper shortcuts)
ALIASES = {
    "po": "pods", "pod": "pods",
    "no": "nodes", "node": "nodes",
    "svc": "services", "service": "services",
    "ep": "endpoints",
    "deploy": "deployments", "deployment": "deployments",
    "rs": "replicasets", "replicaset": "replicasets",
    "sts": "statefulsets", "statefulset": "statefulsets",
    "ds": "daemonsets", "daemonset": "daemonsets",
    "job": "jobs",
    "cm": "configmaps", "configmap": "configmaps",
    "ns": "namespaces", "namespace": "namespaces",
    "lease": "leases",
}


def resolve_plural(res: str, client: Optional[HTTPClient] = None) -> str:
    res = res.lower()
    plural = ALIASES.get(res, res)
    if plural in ALL_RESOURCES:
        return plural
    # maybe a custom resource: sweep the server's CRDs (RESTMapper reload)
    if client is not None:
        try:
            client.discover_custom()
        except ApiError:
            pass
        if client.custom_lookup(plural) is not None:
            return plural
    raise SystemExit(f"error: unknown resource type {res!r}")


def _kind_info(client: HTTPClient, plural: str):
    """-> (kind, namespaced) for built-in or discovered custom resources."""
    reg = ALL_RESOURCES.get(plural) or client.custom_lookup(plural)
    return reg[0], reg[1]


def kind_to_plural(client: HTTPClient, kind: str) -> Optional[str]:
    plural = KIND_TO_PLURAL.get(kind)
    if plural is not None:
        return plural
    try:
        client.discover_custom()
    except ApiError:
        return None
    return client.custom_kind_to_plural(kind)


def obj_age(obj: dict) -> str:
    ts = (obj.get("metadata") or {}).get("creationTimestamp")
    if not ts:
        return "<unknown>"
    secs = max(0, int(time.time() - float(ts)))
    for unit, div in (("d", 86400), ("h", 3600), ("m", 60)):
        if secs >= div:
            return f"{secs // div}{unit}"
    return f"{secs}s"


# ---------------------------------------------------------------- printers

def _pod_row(o: dict, wide: bool) -> list[str]:
    st = o.get("status") or {}
    ready = sum(1 for c in st.get("conditions") or []
                if c.get("type") == "Ready" and c.get("status") == "True")
    total = len((o.get("spec") or {}).get("containers") or []) or 1
    row = [o["metadata"]["name"], f"{ready}/{1 if total == 0 else total}",
           st.get("phase", "Unknown"), obj_age(o)]
    if wide:
        row += [st.get("podIP", "<none>"),
                (o.get("spec") or {}).get("nodeName", "<none>")]
    return row


def _node_row(o: dict, wide: bool) -> list[str]:
    conds = (o.get("status") or {}).get("conditions") or []
    ready = any(c.get("type") == "Ready" and c.get("status") == "True"
                for c in conds)
    status = "Ready" if ready else "NotReady"
    if (o.get("spec") or {}).get("unschedulable"):
        status += ",SchedulingDisabled"
    return [o["metadata"]["name"], status, obj_age(o)]


def _workload_row(o: dict, wide: bool) -> list[str]:
    spec_n = (o.get("spec") or {}).get("replicas", 1)
    st = o.get("status") or {}
    return [o["metadata"]["name"],
            f"{st.get('readyReplicas', 0)}/{spec_n}",
            str(st.get("updatedReplicas", st.get("replicas", 0))),
            obj_age(o)]


def _svc_row(o: dict, wide: bool) -> list[str]:
    spec = o.get("spec") or {}
    ports = ",".join(f"{p.get('port')}/{p.get('protocol', 'TCP')}"
                     for p in spec.get("ports") or [])
    return [o["metadata"]["name"], spec.get("type", "ClusterIP"),
            spec.get("clusterIP", "<none>"), ports or "<none>", obj_age(o)]


def _default_row(o: dict, wide: bool) -> list[str]:
    return [o["metadata"]["name"], obj_age(o)]


PRINTERS = {
    "pods": (["NAME", "READY", "STATUS", "AGE"],
             ["NAME", "READY", "STATUS", "AGE", "IP", "NODE"], _pod_row),
    "nodes": (["NAME", "STATUS", "AGE"], ["NAME", "STATUS", "AGE"], _node_row),
    "services": (["NAME", "TYPE", "CLUSTER-IP", "PORT(S)", "AGE"],
                 ["NAME", "TYPE", "CLUSTER-IP", "PORT(S)", "AGE"], _svc_row),
    "deployments": (["NAME", "READY", "UP-TO-DATE", "AGE"],
                    ["NAME", "READY", "UP-TO-DATE", "AGE"], _workload_row),
    "replicasets": (["NAME", "READY", "CURRENT", "AGE"],
                    ["NAME", "READY", "CURRENT", "AGE"], _workload_row),
    "statefulsets": (["NAME", "READY", "CURRENT", "AGE"],
                     ["NAME", "READY", "CURRENT", "AGE"], _workload_row),
}


def print_table(plural: str, items: list[dict], out, wide: bool = False):
    headers, wide_headers, row_fn = PRINTERS.get(
        plural, (["NAME", "AGE"], ["NAME", "AGE"], _default_row))
    headers = wide_headers if wide else headers
    rows = [row_fn(o, wide) for o in items]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    out.write("  ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip() + "\n")
    for r in rows:
        out.write("  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip() + "\n")


# --------------------------------------------------------------- commands

def load_manifests(path: str) -> list[dict]:
    """The documents of a manifest: a JSON object is read without PyYAML;
    anything else as multi-document YAML (of which JSON is a subset)."""
    text = sys.stdin.read() if path == "-" else open(path).read()
    try:
        doc = json.loads(text)
    except ValueError:
        import yaml
        return [d for d in yaml.safe_load_all(text) if d]
    return [doc] if doc else []


def cmd_get(client: HTTPClient, args, out) -> int:
    plural = resolve_plural(args.resource, client)
    _, namespaced = _kind_info(client, plural)
    ns = None if args.all_namespaces else (args.namespace if namespaced else None)
    res = client.resource(plural, ns)
    if args.name:
        items = [res.get(args.name)]
    else:
        items = res.list(label_selector=args.selector)
    if args.output == "json":
        out.write(json.dumps(items[0] if args.name else
                             {"kind": "List", "items": items}, indent=2) + "\n")
    elif args.output == "yaml":
        import yaml
        yaml.safe_dump(items[0] if args.name else {"kind": "List", "items": items},
                       out, sort_keys=False)
    else:
        print_table(plural, items, out, wide=args.output == "wide")
    return 0


def cmd_apply(client: HTTPClient, args, out) -> int:
    rc = 0
    for doc in load_manifests(args.filename):
        kind = doc.get("kind", "")
        plural = kind_to_plural(client, kind)
        if plural is None:
            out.write(f"error: unknown kind {kind!r}\n")
            rc = 1
            continue
        _, namespaced = _kind_info(client, plural)
        md = doc.setdefault("metadata", {})
        ns = md.get("namespace", args.namespace) if namespaced else None
        if namespaced:
            md.setdefault("namespace", ns)
        res = client.resource(plural, ns)
        name = md.get("name", "")
        if getattr(args, "server_side", False):
            # kubectl apply --server-side: the server owns the merge via
            # managedFields (store/apply.py); conflicts 409 unless forced
            try:
                res.apply(doc, field_manager=args.field_manager,
                          force=args.force_conflicts)
                out.write(f"{plural[:-1]}/{name} serverside-applied\n")
            except ApiError as e:
                out.write(f"error: {e}\n")
                rc = 1
            continue
        try:
            current = res.get(name)
        except ApiError as e:
            if e.code != 404:
                raise
            res.create(doc)
            out.write(f"{plural[:-1]}/{name} created\n")
            continue
        # apply = server-side merge of desired onto live (fieldmanager
        # analog: desired spec/labels/annotations win; status/identity kept)
        merged = dict(current)
        for k, v in doc.items():
            if k in ("status",):
                continue
            if k == "metadata":
                m = dict(current.get("metadata") or {})
                for mk in ("labels", "annotations"):
                    if mk in v:
                        m[mk] = v[mk]
                merged["metadata"] = m
            else:
                merged[k] = v
        res.update(merged)
        out.write(f"{plural[:-1]}/{name} configured\n")
    return rc


def cmd_delete(client: HTTPClient, args, out) -> int:
    targets: list[tuple[str, Optional[str], str]] = []
    if args.filename:
        for doc in load_manifests(args.filename):
            plural = kind_to_plural(client, doc.get("kind", ""))
            if plural is None:
                continue
            _, namespaced = _kind_info(client, plural)
            md = doc.get("metadata") or {}
            targets.append((plural,
                            md.get("namespace", args.namespace) if namespaced else None,
                            md.get("name", "")))
    else:
        plural = resolve_plural(args.resource, client)
        _, namespaced = _kind_info(client, plural)
        targets.append((plural, args.namespace if namespaced else None, args.name))
    policy = {"foreground": "Foreground",
              "orphan": "Orphan"}.get(getattr(args, "cascade", "background"))
    for plural, ns, name in targets:
        try:
            client.resource(plural, ns).delete(
                name, propagation_policy=policy)
            out.write(f"{plural[:-1]}/{name} deleted\n")
        except ApiError as e:
            if e.code != 404:
                raise
            out.write(f"{plural[:-1]}/{name} not found\n")
    return 0


def cmd_describe(client: HTTPClient, args, out) -> int:
    plural = resolve_plural(args.resource, client)
    _, namespaced = _kind_info(client, plural)
    obj = client.resource(plural, args.namespace if namespaced else None).get(args.name)
    md = obj.get("metadata") or {}
    out.write(f"Name:         {md.get('name')}\n")
    if namespaced:
        out.write(f"Namespace:    {md.get('namespace')}\n")
    out.write(f"UID:          {md.get('uid')}\n")
    if md.get("labels"):
        out.write("Labels:       " + ",".join(f"{k}={v}" for k, v in
                                              sorted(md["labels"].items())) + "\n")
    if plural == "pods":
        spec, st = obj.get("spec") or {}, obj.get("status") or {}
        out.write(f"Node:         {spec.get('nodeName', '<none>')}\n")
        out.write(f"Status:       {st.get('phase', 'Unknown')}\n")
        out.write(f"IP:           {st.get('podIP', '<none>')}\n")
        out.write("Containers:\n")
        for c in spec.get("containers") or []:
            out.write(f"  {c.get('name')}:\n    Image: {c.get('image', '<none>')}\n")
            reqs = (c.get("resources") or {}).get("requests") or {}
            if reqs:
                out.write("    Requests: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(reqs.items())) + "\n")
        if st.get("conditions"):
            out.write("Conditions:\n")
            for c in st["conditions"]:
                out.write(f"  {c.get('type')}: {c.get('status')}\n")
        from kubernetes_tpu_torch.utils.events import events_for
        evs = events_for(client, md.get("namespace", "default"),
                         md.get("name", ""), uid=md.get("uid"))
        if evs:
            out.write("Events:\n")
            for e in evs:
                count = e.get("count", 1)
                suffix = f" (x{count})" if count > 1 else ""
                out.write(f"  {e.get('type')}  {e.get('reason')}  "
                          f"{e.get('message')}{suffix}\n")
    else:
        import yaml
        out.write("Spec:\n")
        yaml.safe_dump(obj.get("spec") or {}, out, sort_keys=False, indent=2)
        out.write("Status:\n")
        yaml.safe_dump(obj.get("status") or {}, out, sort_keys=False, indent=2)
    return 0


def cmd_scale(client: HTTPClient, args, out) -> int:
    """kubectl scale via the /scale subresource (ScaleREST) — the same
    interface HPA drives, touching only spec.replicas."""
    plural = resolve_plural(args.resource, client)
    res = client.resource(plural, args.namespace)
    try:
        res.update_scale(args.name, args.replicas)
    except ApiError as e:
        if e.code != 404:
            raise
        # kinds without a scale subresource (CRDs): plain spec update
        obj = res.get(args.name)
        obj.setdefault("spec", {})["replicas"] = args.replicas
        res.update(obj)
    out.write(f"{plural[:-1]}/{args.name} scaled\n")
    return 0


def _set_unschedulable(client: HTTPClient, name: str, flag: bool, out) -> int:
    node = client.nodes().get(name)
    node.setdefault("spec", {})["unschedulable"] = flag
    client.nodes().update(node)
    out.write(f"node/{name} {'cordoned' if flag else 'uncordoned'}\n")
    return 0


def cmd_drain(client: HTTPClient, args, out) -> int:
    _set_unschedulable(client, args.name, True, out)
    for p in client.resource("pods", None).list(
            field_selector=f"spec.nodeName={args.name}"):
        md = p["metadata"]
        # daemon pods are not drained (kubectl drain --ignore-daemonsets)
        refs = md.get("ownerReferences") or []
        if any(r.get("kind") == "DaemonSet" for r in refs):
            continue
        client.pods(md.get("namespace", "default")).evict(md["name"])
        out.write(f"pod/{md['name']} evicted\n")
    return 0


def cmd_logs(client: HTTPClient, args, out) -> int:
    """kubectl logs analog: apiserver -> kubelet containerLogs proxy."""
    out.write(client.pod_logs(args.namespace, args.name,
                              container=args.container or ""))
    return 0


def cmd_exec(client: HTTPClient, args, out) -> int:
    """kubectl exec analog (ExecSync shape: command in, output + code)."""
    res = client.pod_exec(args.namespace, args.name, args.command,
                          container=args.container or "")
    out.write(res.get("output", ""))
    return int(res.get("exit_code", 1))


def cmd_port_forward(client: HTTPClient, args, out) -> int:
    """kubectl port-forward analog: local listener -> apiserver
    portforward subresource -> kubelet -> container app, raw TCP spliced
    end to end. Serves until interrupted (or ``--one-shot`` for one
    connection, which tests use)."""
    import socket as _socket
    import threading
    from urllib.parse import urlsplit
    local = int(args.ports.split(":")[0])
    parts = urlsplit(args.server)
    api = (parts.hostname, parts.port or 80)
    path = (f"/api/v1/namespaces/{args.namespace}/pods/"
            f"{args.name}/portforward")

    auth = (f"Authorization: Bearer {args.token}\r\n"
            if getattr(args, "token", None) else "")

    def handle(conn):
        from kubernetes_tpu_torch.kubelet.server import upgrade_and_splice
        with conn:
            upgrade_and_splice(conn, api, path, extra_headers=auth)

    srv = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", local))
    srv.listen(4)
    bound = srv.getsockname()[1]
    out.write(f"Forwarding from 127.0.0.1:{bound} -> pod {args.name}\n")
    try:
        while True:
            conn, _ = srv.accept()
            if args.one_shot:
                handle(conn)
                return 0
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()
    except KeyboardInterrupt:
        return 0
    finally:
        srv.close()


def cmd_top(client: HTTPClient, args, out) -> int:
    """kubectl top analog from the scheduler's resource view: per-node
    requested/allocatable (nodes) or per-pod requests (pods). Upstream
    reads metrics-server usage; the hollow runtime has no real usage, so
    requests — the quantity every scheduling decision is made on — are
    the faithful figure here."""
    from kubernetes_tpu_torch.api.resource import canonical
    pods = client.resource("pods", None).list()
    if args.resource == "pods":
        out.write(f"{'NAMESPACE':<16}{'NAME':<32}{'CPU':>10}{'MEMORY':>12}\n")
        for p in pods:
            md = p.get("metadata") or {}
            if args.namespace not in ("", md.get("namespace", "default")) \
                    and not args.all_namespaces:
                continue
            cpu = mem = 0
            for c in (p.get("spec") or {}).get("containers") or []:
                req = (c.get("resources") or {}).get("requests") or {}
                cpu += canonical("cpu", str(req.get("cpu", "0")))
                mem += canonical("memory", str(req.get("memory", "0")))
            out.write(f"{md.get('namespace', 'default'):<16}"
                      f"{md.get('name', ''):<32}"
                      f"{cpu}m{'':>4}{mem >> 20}Mi\n")
        return 0
    nodes = client.nodes().list()
    by_node: dict = {}
    for p in pods:
        nn = (p.get("spec") or {}).get("nodeName", "")
        if not nn:
            continue
        cpu = mem = 0
        for c in (p.get("spec") or {}).get("containers") or []:
            req = (c.get("resources") or {}).get("requests") or {}
            cpu += canonical("cpu", str(req.get("cpu", "0")))
            mem += canonical("memory", str(req.get("memory", "0")))
        acc = by_node.setdefault(nn, [0, 0])
        acc[0] += cpu
        acc[1] += mem
    out.write(f"{'NAME':<24}{'CPU(req)':>12}{'CPU%':>7}"
              f"{'MEM(req)':>12}{'MEM%':>7}\n")
    for n in nodes:
        name = (n.get("metadata") or {}).get("name", "")
        alloc = (n.get("status") or {}).get("allocatable") or {}
        acpu = canonical("cpu", str(alloc.get("cpu", "0"))) or 1
        amem = canonical("memory", str(alloc.get("memory", "0"))) or 1
        cpu, mem = by_node.get(name, [0, 0])
        out.write(f"{name:<24}{cpu}m{'':>6}{100 * cpu // acpu:>5}%"
                  f"{mem >> 20}Mi{'':>6}{100 * mem // amem:>5}%\n")
    return 0


def _kv_edits(pairs: list) -> tuple[dict, list]:
    """['k=v', 'gone-'] -> ({k: v}, [gone]) — kubectl label/annotate
    syntax (trailing '-' removes)."""
    sets, removes = {}, []
    for p in pairs:
        if p.endswith("-") and "=" not in p:
            removes.append(p[:-1])
        elif "=" in p:
            k, _, v = p.partition("=")
            sets[k] = v
        else:
            raise SystemExit(f"invalid pair {p!r} (want k=v or k-)")
    return sets, removes


def cmd_label(client: HTTPClient, args, out, field: str = "labels") -> int:
    """kubectl label/annotate: read-modify-write with the rv precondition
    (--overwrite required to change an existing key, like kubectl)."""
    plural = resolve_plural(args.resource, client)
    res = client.resource(plural, args.namespace)
    obj = res.get(args.name)
    sets, removes = _kv_edits(args.pairs)
    md = obj.setdefault("metadata", {})
    cur = md.setdefault(field, {})
    if not args.overwrite:
        clashes = [k for k, v in sets.items()
                   if k in cur and cur[k] != v]
        if clashes:
            out.write(f"error: {clashes[0]!r} already has a value; "
                      "use --overwrite\n")
            return 1
    cur.update(sets)
    for k in removes:
        cur.pop(k, None)
    res.update(obj)
    kind, _ns = _kind_info(client, plural)
    verb = "labeled" if field == "labels" else "annotated"
    out.write(f"{kind.lower()}/{args.name} {verb}\n")
    return 0


def cmd_wait(client: HTTPClient, args, out) -> int:
    """kubectl wait --for=condition=X / --for=delete / --for=jsonpath-free
    phase matching, polling until the condition holds or --timeout."""
    import time as _time
    plural = resolve_plural(args.resource, client)
    res = client.resource(plural, args.namespace)
    kind_lower = _kind_info(client, plural)[0].lower()
    want = args.wait_for
    if want != "delete" and not want.startswith(("condition=", "phase=")):
        out.write(f"error: unsupported --for {want!r} "
                  "(want condition=Type[=Status], phase=X, or delete)\n")
        return 2
    deadline = _time.time() + args.timeout
    while _time.time() < deadline:
        try:
            obj = res.get(args.name)
        except ApiError as e:
            if e.code == 404:
                if want == "delete":
                    out.write(f"{kind_lower}/{args.name} condition met\n")
                    return 0
                _time.sleep(args.poll)
                continue
            raise
        if want == "delete":
            _time.sleep(args.poll)
            continue
        if want.startswith("condition="):
            parts = want[len("condition="):].split("=", 1)
            ctype = parts[0]
            cstatus = parts[1] if len(parts) > 1 else "True"
            conds = (obj.get("status") or {}).get("conditions") or []
            if any(c.get("type", "").lower() == ctype.lower()
                   and str(c.get("status", "")).lower() == cstatus.lower()
                   for c in conds):
                out.write(f"{kind_lower}/{args.name} condition met\n")
                return 0
        elif want.startswith("phase="):
            if (obj.get("status") or {}).get("phase", "").lower() \
                    == want[len("phase="):].lower():
                out.write(f"{kind_lower}/{args.name} condition met\n")
                return 0
        _time.sleep(args.poll)
    out.write(f"error: timed out waiting for {want} on "
              f"{kind_lower}/{args.name}\n")
    return 1


def cmd_api_resources(client: HTTPClient, args, out) -> int:
    """kubectl api-resources: the serving table, CRDs included."""
    out.write(f"{'NAME':<36}{'KIND':<34}{'NAMESPACED':<10}\n")
    rows = sorted(ALL_RESOURCES.items())
    try:
        client.discover_custom()
        custom = getattr(client, "_custom", {}) or {}
        rows += sorted((p, info) for p, info in custom.items()
                       if p not in ALL_RESOURCES)
    except Exception:  # ktpu-lint: disable=KTL002 -- CLI api-resources augmentation: CRD listing is absent on older servers; the builtin table still prints
        pass
    for plural, info in rows:
        kind, namespaced = info[0], info[1]
        out.write(f"{plural:<36}{kind:<34}"
                  f"{str(bool(namespaced)).lower():<10}\n")
    return 0


def _fleet_line(fleet: dict) -> str:
    """One-line hollow-fleet summary from the fleet status ConfigMap."""
    hb = fleet.get("heartbeat") or {}
    le = fleet.get("lease") or {}
    return (f"Fleet:         {fleet.get('nodes', 0)} hollow nodes, "
            f"{fleet.get('shards', '?')} batcher shards — "
            f"heartbeats {hb.get('itemsPerS', 0)}/s "
            f"(batch {hb.get('lastBatch', 0)}), "
            f"leases {le.get('itemsPerS', 0)}/s "
            f"(batch {le.get('lastBatch', 0)})\n")


def _fleet_sched_line(fs: dict) -> str:
    """One-line fleet-scheduler summary (sched/fleet.py FleetRunner's
    per-tenant fairness ConfigMap): tenants, per-tenant pending/bound and
    the batch-slot share each got from the shared drain pipeline."""
    tenants = fs.get("tenant") or {}
    parts = []
    for t in sorted(tenants, key=lambda s: (len(s), s)):
        d = tenants[t] or {}
        parts.append(f"t{t} {d.get('bound', 0)} bound/"
                     f"{d.get('pending', 0)} pending/"
                     f"share {d.get('batchShare', 0)}")
    return (f"Fleet sched:   {fs.get('tenants', 0)} tenants, one warm "
            f"program — " + ("; ".join(parts) if parts else "no tenants")
            + "\n")


def _durability_line(dur: dict) -> str:
    """One-line apiserver durability summary (data_dir mode): WAL growth
    since the last snapshot fold, snapshot age, what the last restore
    cost, and the readyz verdict."""
    import time as _time
    snap_ts = dur.get("lastSnapshotTime")
    age = (f"{max(0.0, _time.time() - float(snap_ts)):.0f}s ago"
           if snap_ts else "never")
    replay = dur.get("replayMs")
    torn = dur.get("tornTailsDropped") or 0
    return (f"Durability:    WAL {dur.get('walEntriesSinceSnapshot', 0)} "
            f"entries since snapshot ({age}), last replay "
            f"{replay if replay is not None else '?'}ms"
            f" ({dur.get('walEntriesReplayed', 0)} entries"
            + (f", {torn} torn tail dropped" if torn else "")
            + f"), readyz {'ok' if dur.get('ready') else 'NOT READY'}\n")


def _disruption_line(dis: dict) -> str:
    """One-line node-lifecycle disruption-mode summary."""
    mode = dis.get("mode", "Normal")
    frac = dis.get("unreadyFraction", 0.0)
    extra = ""
    if mode != "Normal":
        extra = (" — EVICTIONS "
                 + ("HALTED" if dis.get("evictionsHalted")
                    else "at secondary rate"))
    return (f"Disruption:    {mode} "
            f"({frac:.0%} of {dis.get('nodes', 0)} nodes unready; "
            f"engaged {dis.get('engagedCount', 0)}x, "
            f"evictions {dis.get('evictions', 0)}, "
            f"deferred {dis.get('evictionsDeferred', 0)}, "
            f"taints suppressed {dis.get('taintsSuppressed', 0)})"
            f"{extra}\n")


def _aot_cache_line(ac: dict) -> str:
    """One-line durable compile-cache summary (sched/aotcache.py stats):
    what's on disk, how this boot used it, and whether anything had to be
    swept or recompiled."""
    if not ac.get("enabled"):
        return "Compile cache: off (no aotCacheDir configured)\n"
    if ac.get("error"):
        return f"Compile cache: on — {ac['error']}\n"
    mb = (ac.get("bytes") or 0) / 1e6
    boot_ms = ac.get("bootLoadMs")
    return (f"Compile cache: {ac.get('entries', 0)} entries "
            f"({mb:.1f} MB) — boot loaded {ac.get('bootEntries', 0)} in "
            f"{boot_ms if boot_ms is not None else '?'}ms, "
            f"hits {ac.get('hits', 0)}, misses {ac.get('misses', 0)}, "
            f"errors {ac.get('errors', 0)}, "
            f"invalidations {ac.get('invalidations', 0)}\n")


def _topology_line(topo: dict) -> str:
    """One-line slice-carving summary (scheduler.topology_status): the ICI
    grid extent, per-requested-shape carveability + fragmentation, and the
    carve counters."""
    shapes = topo.get("shapes") or {}
    parts = []
    for s, cov in sorted(shapes.items()):
        frag = cov.get("fragmentationPct")
        parts.append(f"{s}: {cov.get('origins', 0)} carveable"
                     + (f", {frag}% fragmented" if frag is not None else ""))
    carves = topo.get("carves") or {}
    return (f"Topology:      {topo.get('grid', '?')} grid "
            f"({topo.get('nodes', 0)} nodes, "
            f"{topo.get('freeCells', 0)} free cells)"
            + (" — " + "; ".join(parts) if parts else "")
            + (f" — carves {carves.get('carved', 0)} ok / "
               f"{carves.get('failed', 0)} failed / "
               f"{carves.get('slicePreempts', 0)} slice-preempts"
               if carves else "")
            + "\n")


def _frontdoor_line(fd: dict) -> str:
    """One-line read-replica serving-plane summary (the front-door
    publisher's ConfigMap): who leads, how many replicas serve reads,
    watcher spread, worst replay lag, and slow-consumer drops."""
    nodes = fd.get("nodes") or []
    reachable = sum(1 for n in nodes if n.get("reachable"))
    return (f"Front door:    leader {fd.get('leader') or '<unknown>'} + "
            f"{fd.get('replicas', '0')} read replicas "
            f"({reachable}/{len(nodes)} reachable) — "
            f"{fd.get('watchersTotal', '0')} watchers over "
            f"{fd.get('shardsPerKind', '0')} shards/kind, "
            f"max replay lag {fd.get('maxReplayLagMs', '0')}ms, "
            f"drops {fd.get('dropsTotal', '0')}\n")


def _scenario_line(sc: dict) -> str:
    """One-line scenario-driver digest from the
    ``kubernetes-tpu-scenario-status`` ConfigMap."""
    return (f"Scenario:      {sc.get('trace', '<unnamed>')} "
            f"{sc.get('state', '?')}"
            + (f" (phase {sc['phase']})" if sc.get("phase") else "")
            + f" — {sc.get('eventsDispatched', 0)}/"
              f"{sc.get('eventsTotal', 0)} events, "
              f"{sc.get('podsBound', 0)}/{sc.get('podsResident', 0)} "
              f"bound, skew max {sc.get('skewMaxMs', 0)}ms, "
              f"speed {sc.get('speed', 1.0)}x\n")


def _planner_line(pl: dict) -> str:
    """One-line background-planner digest from the
    ``kubernetes-tpu-planner-status`` ConfigMap: per-planner overlay
    hit/decline counts plus the steady-window compile total."""
    planners = pl.get("planners") or {}
    parts = []
    for name in ("autoscaler", "descheduler", "gangDefrag"):
        p = planners.get(name) or {}
        parts.append(f"{name} {p.get('hits', 0)}/{p.get('declines', 0)}")
    interval = pl.get("intervalSeconds")
    return (f"Planners:      {pl.get('cycles', 0)} cycles"
            + (f" @ {interval}s" if interval is not None else "")
            + f" — hits/declines: {', '.join(parts)} — "
              f"steady compiles {pl.get('steadyCompiles', 0)}\n")


def cmd_status(client: HTTPClient, args, out) -> int:
    """ktpu status: the connected scheduler's published deployment shape
    (the ``kubernetes-tpu-scheduler-status`` ConfigMap) — most importantly
    the active device mesh the drain/dispatch path runs under."""
    from kubernetes_tpu_torch.controllers.nodelifecycle import (
        NODELIFECYCLE_CONFIGMAP)
    from kubernetes_tpu_torch.sched.runner import STATUS_CONFIGMAP
    from kubernetes_tpu_torch.store.apiserver import APISERVER_CONFIGMAP

    def _aux_cm(name: str, key: str):
        # sibling status ConfigMaps (fleet / apiserver durability /
        # nodelifecycle disruption); absent when that component isn't
        # running against this apiserver
        try:
            cm_ = client.resource("configmaps", args.namespace).get(name)
            return json.loads((cm_.get("data") or {}).get(key, "{}")
                              or "{}")
        except ApiError as e:
            if e.code != 404:
                raise
            return None

    def _frontdoor_cm():
        # the front-door ConfigMap is flat str->str (scalar summary keys
        # + a JSON "nodes" list), published to kube-system by default
        from kubernetes_tpu_torch.store.frontdoor import (FRONTDOOR_CONFIGMAP,
                                                          FRONTDOOR_NAMESPACE)
        for ns_ in dict.fromkeys((FRONTDOOR_NAMESPACE, args.namespace)):
            try:
                cm_ = client.resource("configmaps",
                                      ns_).get(FRONTDOOR_CONFIGMAP)
            except ApiError as e:
                if e.code != 404:
                    raise
                continue
            data = dict(cm_.get("data") or {})
            try:
                data["nodes"] = json.loads(data.get("nodes", "[]") or "[]")
            except json.JSONDecodeError:
                data["nodes"] = []
            return data
        return None

    from kubernetes_tpu_torch.sched.bgplanner import PLANNER_CONFIGMAP
    from kubernetes_tpu_torch.sched.fleet import FLEET_SCHED_CONFIGMAP
    fleet = _aux_cm(FLEET_CONFIGMAP, "fleet")
    fleet_sched = _aux_cm(FLEET_SCHED_CONFIGMAP, "fleetSched")
    durability = _aux_cm(APISERVER_CONFIGMAP, "durability")
    disruption = _aux_cm(NODELIFECYCLE_CONFIGMAP, "disruption")
    scenario = _aux_cm(SCENARIO_CONFIGMAP, "scenario")
    planner = _aux_cm(PLANNER_CONFIGMAP, "status")
    frontdoor = _frontdoor_cm()
    try:
        cm = client.resource("configmaps", args.namespace).get(
            STATUS_CONFIGMAP)
    except ApiError as e:
        if e.code != 404:
            raise
        aux = {k: v for k, v in (("fleet", fleet),
                                 ("fleetSched", fleet_sched),
                                 ("durability", durability),
                                 ("disruption", disruption),
                                 ("scenario", scenario),
                                 ("planner", planner),
                                 ("frontdoor", frontdoor))
               if v is not None}
        if aux:
            # a fleet/durable-apiserver/lifecycle-controller without a
            # scheduler is still worth reporting
            if args.output == "json":
                out.write(json.dumps(aux) + "\n")
            else:
                if frontdoor is not None:
                    out.write(_frontdoor_line(frontdoor))
                if durability is not None:
                    out.write(_durability_line(durability))
                if disruption is not None:
                    out.write(_disruption_line(disruption))
                if fleet is not None:
                    out.write(_fleet_line(fleet))
                if fleet_sched is not None:
                    out.write(_fleet_sched_line(fleet_sched))
                if scenario is not None:
                    out.write(_scenario_line(scenario))
                if planner is not None:
                    out.write(_planner_line(planner))
            return 0
        out.write("error: no scheduler status published "
                  f"(configmap {STATUS_CONFIGMAP!r} not found in "
                  f"{args.namespace!r})\n")
        return 1
    data = cm.get("data") or {}
    if args.output == "json":
        st = json.loads(data.get("status", "{}") or "{}")
        if fleet is not None:
            st["fleet"] = fleet
        if fleet_sched is not None:
            st["fleetSched"] = fleet_sched
        if durability is not None:
            st["durability"] = durability
        if disruption is not None:
            st["disruption"] = disruption
        if scenario is not None:
            st["scenario"] = scenario
        if planner is not None:
            st["planner"] = planner
        if frontdoor is not None:
            st["frontdoor"] = frontdoor
        out.write(json.dumps(st) + "\n")
        return 0
    st = json.loads(data.get("status", "{}") or "{}")
    mesh = st.get("mesh")
    if mesh:
        shape = mesh.get("shape") or {}
        dims = "x".join(str(shape[a]) for a in ("pods", "nodes")
                        if a in shape) or "?"
        out.write(f"Mesh:          {dims} ({mesh.get('devices', '?')} "
                  "devices, pods x nodes)\n")
        out.write(f"Device ids:    {mesh.get('deviceIds')}\n")
    else:
        out.write("Mesh:          off (single-device)\n")
    out.write(f"Identity:      {st.get('identity', '<unknown>')}\n")
    out.write(f"Batch size:    {st.get('batchSize', '?')}\n")
    out.write(f"Drain batches: {st.get('maxDrainBatches', '?')}\n")
    inflight = st.get("pipelineInflight")
    out.write(f"Pipeline:      {st.get('pipelineDepth', '?')} deep"
              + (f" ({inflight} in flight)" if inflight is not None else "")
              + "\n")
    ctx = st.get("ctx")
    if ctx is not None:
        fused = st.get("fusedFold")
        reasons = ", ".join(f"{k}={v}" for k, v in
                            sorted((ctx.get("reasons") or {}).items()))
        out.write(f"Resident ctx:  folds {ctx.get('folds', 0)}, "
                  f"patches {ctx.get('patches', 0)}, "
                  f"rebuilds {ctx.get('rebuilds', 0)}"
                  + (f" ({reasons})" if reasons else "")
                  + (f" — fused fold {'on' if fused else 'off'}"
                     if fused is not None else "")
                  + "\n")
    staging = st.get("staging")
    if staging is not None:
        mb = (staging.get("bytesStaged") or 0) / 1e6
        out.write(f"Staging:       arena "
                  f"{'on' if staging.get('enabled') else 'off'} — "
                  f"{staging.get('swaps', 0)} swaps, "
                  f"{staging.get('fallbacks', 0)} fallbacks, "
                  f"{mb:.1f} MB pre-staged\n")
    out.write(f"Profiles:      {', '.join(st.get('profiles') or [])}\n")
    pending = st.get("pending")
    if pending is not None:
        out.write(f"Pending pods:  active {pending.get('active', 0)}, "
                  f"backoff {pending.get('backoff', 0)}, "
                  f"unschedulable {pending.get('unschedulable', 0)}\n")
    e2e = st.get("e2e")
    if e2e and e2e.get("count"):
        out.write(f"E2E latency:   p50 {e2e.get('p50Seconds')}s, "
                  f"p99 {e2e.get('p99Seconds')}s "
                  f"({e2e.get('count')} pods)\n")
    explain = st.get("explain")
    if explain is not None:
        out.write(f"Explainer:     {explain.get('podsExplained', 0)} pods "
                  f"explained ({explain.get('entries', 0)} live, "
                  f"skipped {explain.get('skipped', 0)}, "
                  f"errors {explain.get('errors', 0)}) — ktpu why <pod>\n")
    flight = st.get("flight")
    if flight is not None:
        out.write(f"Flight rec:    "
                  f"{'on' if flight.get('enabled') else 'off'} "
                  f"({flight.get('pods', 0)} pod timelines, "
                  f"dropped {flight.get('droppedPods', 0)}) — "
                  "ktpu trace dump\n")
    aot = st.get("aotCache")
    if aot is not None:
        out.write(_aot_cache_line(aot))
    topo = st.get("topology")
    if topo is not None:
        out.write(_topology_line(topo))
    if frontdoor is not None:
        out.write(_frontdoor_line(frontdoor))
    if durability is not None:
        out.write(_durability_line(durability))
    if disruption is not None:
        out.write(_disruption_line(disruption))
    if fleet is not None:
        out.write(_fleet_line(fleet))
    if fleet_sched is not None:
        out.write(_fleet_sched_line(fleet_sched))
    if scenario is not None:
        out.write(_scenario_line(scenario))
    if planner is not None:
        out.write(_planner_line(planner))
    res = st.get("resilience")
    if res:
        degraded = (res.get("degradedIndex") or 0) > 0
        out.write(f"Degraded:      "
                  f"{res.get('degradedMode') if degraded else 'no'} "
                  f"(breaker trips: {res.get('breakerTrips', 0)}, "
                  f"restores: {res.get('breakerRestores', 0)})\n")
        out.write(f"Watchdog:      "
                  f"{res.get('watchdogRestarts', 0)} restarts\n")
        out.write(f"Last relist:   "
                  f"{res.get('lastRelist') or 'never'} "
                  f"(relists: {res.get('watchRelists', 0)})\n")
    return 0


def cmd_why(client: HTTPClient, args, out) -> int:
    """ktpu why <pod>: per-pod decision provenance. A bound pod reports
    its node (+ the Scheduled event); a pending pod gets the explainer's
    per-filter reject breakdown from the ``scheduler-explanations``
    ConfigMap — the upstream-style "0/N nodes are available: ..." verdict
    with the node count each filter rejected."""
    from kubernetes_tpu_torch.sched.runner import EXPLAIN_CONFIGMAP
    key = f"{args.namespace}/{args.name}"
    pod = None
    try:
        pod = client.pods(args.namespace).get(args.name)
    except ApiError as e:
        if e.code != 404:
            raise
    if pod is not None and (pod.get("spec") or {}).get("nodeName"):
        node = pod["spec"]["nodeName"]
        if args.output == "json":
            out.write(json.dumps({"pod": key, "scheduled": True,
                                  "node": node}) + "\n")
            return 0
        out.write(f"pod {key}: scheduled to {node}\n")
        from kubernetes_tpu_torch.utils.events import events_for
        for e in events_for(client, args.namespace, args.name,
                            uid=(pod.get("metadata") or {}).get("uid")):
            if e.get("reason") == "Scheduled":
                out.write(f"  {e.get('message')}\n")
        return 0
    # the ConfigMap lives in the RUNNER's status namespace, not the pod's:
    # try the pod's namespace first (single-namespace deployments), then
    # the runner default — explanations are keyed ns/name, so a pod from
    # any namespace resolves once the right ConfigMap is found
    explanation = None
    for cm_ns in dict.fromkeys((args.namespace, "default")):
        try:
            cm = client.resource("configmaps", cm_ns).get(EXPLAIN_CONFIGMAP)
        except ApiError as e:
            if e.code != 404:
                raise
            continue
        explanation = json.loads(
            (cm.get("data") or {}).get("explanations", "{}")).get(key)
        if explanation is not None:
            break
    if pod is None and explanation is None:
        out.write(f"error: pod {key} not found\n")
        return 1
    if explanation is None:
        out.write(f"pod {key}: pending, no explanation recorded yet "
                  "(the explainer publishes after the pod's first failed "
                  "cycle; is explainerEnabled on?)\n")
        return 1
    if args.output == "json":
        out.write(json.dumps({"pod": key, "scheduled": False,
                              **explanation}, indent=1) + "\n")
        return 0
    out.write(f"pod {key}: unschedulable ({explanation.get('mode')} "
              f"verdict at {explanation.get('ts')})\n")
    out.write(f"  {explanation.get('message')}\n")
    filters = explanation.get("filters") or {}
    for f, c in sorted(filters.items(), key=lambda kv: -kv[1]):
        out.write(f"    {f}: {c} node(s)\n")
    if explanation.get("feasibleNow"):
        out.write(f"  note: {explanation['feasibleNow']} node(s) were "
                  "feasible when re-judged — retry may succeed\n")
    return 0


def cmd_scenario(client, args, out) -> int:
    """ktpu scenario generate|record|replay|describe: the cluster time
    machine. generate/record/describe are local file operations (no
    apiserver — main() dispatches them before building a client); replay
    drives the trace against the connected apiserver/scheduler stack."""
    from kubernetes_tpu_torch.scenario import (BUILTINS, ScenarioDriver,
                                               Trace, TraceFormatError,
                                               builtin_trace,
                                               trace_from_bundle,
                                               trace_from_wal)

    def _resolve(spec: str) -> Trace:
        if spec.startswith("builtin:"):
            return builtin_trace(spec[len("builtin:"):], seed=args.seed)
        if spec in BUILTINS:  # bare builtin name is unambiguous enough
            return builtin_trace(spec, seed=args.seed)
        return Trace.load(spec)

    try:
        if args.action == "generate":
            if not args.target:
                out.write("error: generate needs a builtin name "
                          f"(catalog: {', '.join(sorted(BUILTINS))})\n")
                return 1
            trace = _resolve(args.target)
            path = args.out_path or f"{trace.manifest.name}.trace.jsonl"
            trace.save(path)
            out.write(f"wrote {len(trace)} events to {path}\n")
            out.write(json.dumps(trace.describe(), indent=1) + "\n")
            return 0
        if args.action == "record":
            if bool(args.from_wal) == bool(args.from_bundle):
                out.write("error: record needs exactly one of "
                          "--from-wal WAL.jsonl / "
                          "--from-bundle BUNDLE.json\n")
                return 1
            if args.from_wal:
                trace = trace_from_wal(args.from_wal,
                                       chaos_seed=args.chaos_seed)
            else:
                trace = trace_from_bundle(args.from_bundle)
            path = args.out_path or f"{trace.manifest.name}.trace.jsonl"
            trace.save(path)
            out.write(f"captured {len(trace)} events to {path}\n")
            out.write(json.dumps(trace.describe(), indent=1) + "\n")
            return 0
        if args.action == "describe":
            if not args.target:
                out.write("error: describe needs a trace path or "
                          "builtin:<name>\n")
                return 1
            out.write(json.dumps(_resolve(args.target).describe(),
                                 indent=1) + "\n")
            return 0
        # replay: the live path — client is a real HTTPClient here
        if not args.target:
            out.write("error: replay needs a trace path or "
                      "builtin:<name>\n")
            return 1
        trace = _resolve(args.target)
        driver = ScenarioDriver(client, trace, speed=args.speed,
                                status_namespace=args.namespace,
                                bind_timeout_s=args.bind_timeout)
        result = driver.run()
        out.write(json.dumps(result, indent=1) + "\n")
        return 0 if result["completed"] else 1
    except (TraceFormatError, KeyError, OSError) as e:
        out.write(f"error: {e}\n")
        return 1


def cmd_trace(client: HTTPClient, args, out) -> int:
    """ktpu trace dump: the scheduler's flight-recorder export (batch
    spans + per-pod lifecycle tracks) as Chrome trace-event JSON — load
    the output in https://ui.perfetto.dev or chrome://tracing."""
    from kubernetes_tpu_torch.sched.runner import TRACE_CONFIGMAP
    from kubernetes_tpu_torch.utils.tracing import validate_chrome_trace
    try:
        cm = client.resource("configmaps", args.namespace).get(
            TRACE_CONFIGMAP)
    except ApiError as e:
        if e.code != 404:
            raise
        out.write("error: no trace published "
                  f"(configmap {TRACE_CONFIGMAP!r} not found in "
                  f"{args.namespace!r})\n")
        return 1
    raw = (cm.get("data") or {}).get("trace", "")
    try:
        doc = json.loads(raw or "{}")
    except ValueError:
        out.write("error: published trace is not valid JSON\n")
        return 1
    problems = validate_chrome_trace(doc)
    if problems:
        out.write("error: published trace fails the Chrome trace-event "
                  f"schema: {problems[0]} (+{len(problems) - 1} more)\n")
        return 1
    if args.output_file:
        with open(args.output_file, "w") as f:
            f.write(raw)
        out.write(f"wrote {len(doc.get('traceEvents', []))} events to "
                  f"{args.output_file} (load in ui.perfetto.dev)\n")
    else:
        out.write(raw + "\n")
    return 0


def cmd_audit(client: HTTPClient, args, out) -> int:
    """ktpu audit status: the continuous invariant auditor's published
    state (the ``audit`` block of the scheduler status ConfigMap) —
    invariants checked, confirmed violations, repro-bundle locations, and
    the device-parity sentinel's sample/divergence counters."""
    from kubernetes_tpu_torch.sched.runner import STATUS_CONFIGMAP
    try:
        cm = client.resource("configmaps", args.namespace).get(
            STATUS_CONFIGMAP)
    except ApiError as e:
        if e.code != 404:
            raise
        out.write("error: no scheduler status published "
                  f"(configmap {STATUS_CONFIGMAP!r} not found in "
                  f"{args.namespace!r})\n")
        return 1
    st = json.loads((cm.get("data") or {}).get("status", "{}") or "{}")
    audit = st.get("audit")
    if audit is None:
        out.write("error: scheduler status carries no audit block "
                  "(older scheduler?)\n")
        return 1
    if args.output == "json":
        out.write(json.dumps(audit, indent=1) + "\n")
        return 0
    out.write(f"Sweeps:        {audit.get('sweeps', 0)} "
              f"(every {audit.get('intervalSeconds', '?')}s, "
              f"last: {audit.get('lastSweep') or 'never'})\n")
    out.write(f"Fail-fast:     "
              f"{'on' if audit.get('failFast') else 'off'}"
              f"{' — TRIPPED' if audit.get('failed') else ''}\n")
    n = audit.get("violations", 0)
    out.write(f"Violations:    {n}\n")
    for inv, c in sorted((audit.get("byInvariant") or {}).items()):
        out.write(f"  {inv}: {c}\n")
    out.write(f"Bundles:       {audit.get('bundleDir')}\n")
    for b in audit.get("bundles") or []:
        out.write(f"  {b}\n")
    par = audit.get("parity")
    if par:
        samples = par.get("samples") or {}
        out.write(f"Parity:        every {par.get('every')}th dispatch "
                  f"(drain samples: {samples.get('drain', 0)}, "
                  f"wave: {samples.get('wave', 0)}, "
                  f"skipped: {par.get('skipped', 0)})\n")
        out.write(f"Divergences:   {par.get('divergences', 0)}\n")
        last = par.get("lastDivergence")
        if last:
            out.write(f"  last: {last.get('site')} at level "
                      f"{last.get('level')} -> {last.get('mode')} "
                      f"(bundle: {last.get('bundle')})\n")
    else:
        out.write("Parity:        off\n")
    return 0


def cmd_autoscale(client: HTTPClient, args, out) -> int:
    """ktpu autoscale status: the cluster-autoscaler's published status
    (the ``cluster-autoscaler-status`` ConfigMap, same surface as the
    reference autoscaler's kube-system ConfigMap)."""
    from kubernetes_tpu_torch.autoscaler import STATUS_CONFIGMAP
    try:
        cm = client.resource("configmaps", args.namespace).get(
            STATUS_CONFIGMAP)
    except ApiError as e:
        if e.code != 404:
            raise
        out.write("error: no autoscaler status published "
                  f"(configmap {STATUS_CONFIGMAP!r} not found in "
                  f"{args.namespace!r})\n")
        return 1
    data = cm.get("data") or {}
    if args.output == "json":
        out.write(data.get("status", "{}") + "\n")
        return 0
    st = json.loads(data.get("status", "{}") or "{}")
    out.write(f"Last probe:   {data.get('lastProbeTime', '<unknown>')}\n")
    out.write(f"Expander:     {st.get('expander', '<unknown>')}\n")
    groups = st.get("groups") or {}
    if groups:
        out.write(f"{'GROUP':<24}{'SIZE':>6}{'MIN':>6}{'MAX':>6}  STATE\n")
        for name in sorted(groups):
            g = groups[name]
            state = ("backoff" if g.get("backoff")
                     else "cooldown" if g.get("cooldown") else "ready")
            out.write(f"{name:<24}{g.get('size', 0):>6}"
                      f"{g.get('minSize', 0):>6}{g.get('maxSize', 0):>6}"
                      f"  {state}\n")
    for verb, key in (("scale-up", "lastScaleUp"),
                      ("scale-down", "lastScaleDown")):
        ev = st.get(key)
        if ev:
            what = ",".join(ev.get("nodes", [])) or ev.get("node", "")
            out.write(f"Last {verb}: group={ev.get('group')} "
                      f"nodes={what} at={ev.get('at')}\n")
    return 0


def cmd_deschedule(client: HTTPClient, args, out) -> int:
    """ktpu deschedule run|status: drive one descheduler cycle in-process
    (run; its planner runs on ``args.device``, None = the card) or read the
    loop's published ``descheduler-status`` ConfigMap (status) — same
    surface split as ``autoscale status``."""
    from kubernetes_tpu_torch.descheduler import (
        STATUS_CONFIGMAP as DESCHED_CM,
        Descheduler,
        DeschedulerConfiguration,
    )
    if args.action == "run":
        cfg = (DeschedulerConfiguration.from_yaml(args.policy)
               if args.policy else DeschedulerConfiguration())
        if args.max_evictions is not None:
            cfg.max_evictions_per_cycle = args.max_evictions
        summary = Descheduler(client, cfg, device=args.device).run_once(
            dry_run=args.dry_run)
        if args.output == "json":
            out.write(json.dumps(summary, indent=1) + "\n")
            return 0
        verb = "would evict" if args.dry_run else "evicted"
        for s in summary["planned"]:
            out.write(f"{s['strategy']}: {s['set']} -> "
                      f"{s['evictions']} eviction(s)\n")
            for key, target in s["moves"]:
                out.write(f"  {key} -> {target}\n")
        for g in summary["gangs"]:
            state = ("fits without evictions" if g["fitsWithoutEvictions"]
                     else f"{g['evictions']} eviction(s) via {g['set']}"
                     if g["set"] else "no feasible consolidation")
            out.write(f"gang {g['gang']}: {state}\n")
        for name, why in sorted(summary["blocked"].items()):
            out.write(f"blocked {name}: {why}\n")
        if args.dry_run:
            # planned totals include gang-defrag victims, matching what a
            # wet run's `evicted` list would contain for the same plan
            n = (sum(s["evictions"] for s in summary["planned"])
                 + sum(g["evictions"] for g in summary["gangs"]))
        else:
            n = len(summary.get("evicted", []))
        out.write(f"{verb} {n} pod(s)\n")
        return 0
    # status
    try:
        cm = client.resource("configmaps", args.namespace).get(DESCHED_CM)
    except ApiError as e:
        if e.code != 404:
            raise
        out.write("error: no descheduler status published "
                  f"(configmap {DESCHED_CM!r} not found in "
                  f"{args.namespace!r})\n")
        return 1
    data = cm.get("data") or {}
    if args.output == "json":
        out.write(data.get("status", "{}") + "\n")
        return 0
    st = json.loads(data.get("status", "{}") or "{}")
    out.write(f"Last probe:   {data.get('lastProbeTime', '<unknown>')}\n")
    out.write(f"Strategies:   {', '.join(st.get('strategies') or [])}\n")
    out.write(f"Gang defrag:  "
              f"{'on' if st.get('gangDefrag') else 'off'}\n")
    out.write(f"Max/cycle:    {st.get('maxEvictionsPerCycle')}\n")
    last = st.get("lastCycle") or {}
    if last:
        out.write(f"Last cycle:   planned={last.get('planned', 0)} "
                  f"evicted={last.get('evicted', 0)} at={last.get('at')}\n")
    loop = st.get("lastLoop") or {}
    for name, why in sorted((loop.get("blocked") or {}).items()):
        out.write(f"  blocked {name}: {why}\n")
    return 0


REVISION_ANNOTATION = "deployment.kubernetes.io/revision"


def cmd_rollout(client: HTTPClient, args, out) -> int:
    """kubectl rollout status|history|undo|restart for Deployments
    (kubectl/pkg/cmd/rollout; revisions ride the ReplicaSet revision
    annotation exactly like upstream)."""
    deps = client.resource("deployments", args.namespace)
    dep = deps.get(args.name)
    spec = dep.get("spec") or {}
    status = dep.get("status") or {}
    if args.action == "status":
        want = int(spec.get("replicas", 1))
        updated = int(status.get("updatedReplicas", 0) or 0)
        avail = int(status.get("availableReplicas",
                               status.get("readyReplicas", 0)) or 0)
        if updated >= want and avail >= want:
            out.write(f'deployment "{args.name}" successfully rolled out\n')
            return 0
        out.write(f"Waiting for deployment \"{args.name}\" rollout: "
                  f"{updated} of {want} updated, {avail} available\n")
        return 1
    rss = [rs for rs in client.resource("replicasets",
                                        args.namespace).list()
           if any(ref.get("kind") == "Deployment"
                  and ref.get("name") == args.name
                  for ref in (rs.get("metadata") or {})
                  .get("ownerReferences") or [])]
    rss.sort(key=lambda rs: int(((rs.get("metadata") or {})
                                 .get("annotations") or {})
                                .get(REVISION_ANNOTATION, "0") or 0))
    if args.action == "history":
        out.write(f"deployment.apps/{args.name}\nREVISION\n")
        for rs in rss:
            rev = ((rs.get("metadata") or {}).get("annotations") or {}) \
                .get(REVISION_ANNOTATION, "?")
            out.write(f"{rev}\n")
        return 0
    if args.action == "undo":
        if len(rss) < 2:
            out.write("error: no rollout history found\n")
            return 1
        prev = rss[-2]  # previous revision's template
        dep["spec"]["template"] = (prev.get("spec") or {}).get("template")
        deps.update(dep)
        out.write(f"deployment.apps/{args.name} rolled back\n")
        return 0
    if args.action == "restart":
        import datetime
        tmpl = dep["spec"].setdefault("template", {})
        md = tmpl.setdefault("metadata", {})
        md.setdefault("annotations", {})[
            "kubectl.kubernetes.io/restartedAt"] = \
            datetime.datetime.now(datetime.timezone.utc).isoformat()
        deps.update(dep)
        out.write(f"deployment.apps/{args.name} restarted\n")
        return 0
    return 2


# ------------------------------------------------------------------- main

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ktpu", description=__doc__.split("\n")[0])
    ap.add_argument("--server", "-s", default="http://127.0.0.1:8001")
    ap.add_argument("--token", default=None,
                    help="bearer token (rest.Config.BearerToken analog)")
    ap.add_argument("--namespace", "-n", default="default")
    ap.add_argument("--device", default=None,
                    help="where in-process device work runs (deschedule "
                    "run): the CUDA card by default, or cpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("get")
    g.add_argument("resource")
    g.add_argument("name", nargs="?", default="")
    g.add_argument("-o", "--output", choices=["table", "wide", "json", "yaml"],
                   default="table")
    g.add_argument("-l", "--selector", default=None)
    g.add_argument("-A", "--all-namespaces", action="store_true")

    a = sub.add_parser("apply")
    a.add_argument("-f", "--filename", required=True)
    a.add_argument("--server-side", action="store_true",
                   help="server-side apply (managedFields field ownership)")
    a.add_argument("--field-manager", default="ktpu")
    a.add_argument("--force-conflicts", action="store_true")

    d = sub.add_parser("delete")
    d.add_argument("resource", nargs="?", default="")
    d.add_argument("name", nargs="?", default="")
    d.add_argument("-f", "--filename", default=None)
    d.add_argument("--cascade", default="background",
                   choices=["background", "foreground", "orphan"],
                   help="DeleteOptions.propagationPolicy")

    de = sub.add_parser("describe")
    de.add_argument("resource")
    de.add_argument("name")

    cert = sub.add_parser("certificate")
    cert.add_argument("action", choices=["approve", "deny"])
    cert.add_argument("name")

    sc = sub.add_parser("scale")
    sc.add_argument("resource")
    sc.add_argument("name")
    sc.add_argument("--replicas", type=int, required=True)

    for nm in ("cordon", "uncordon", "drain"):
        c = sub.add_parser(nm)
        c.add_argument("name")

    lg = sub.add_parser("logs")
    lg.add_argument("name")
    lg.add_argument("-c", "--container", default=None)

    ex = sub.add_parser("exec")
    ex.add_argument("name")
    ex.add_argument("-c", "--container", default=None)
    ex.add_argument("command", nargs=argparse.REMAINDER,
                    help="-- cmd args...")

    pf = sub.add_parser("port-forward")
    pf.add_argument("name")
    pf.add_argument("ports", help="local[:remote]")
    pf.add_argument("--one-shot", action="store_true",
                    help="serve a single connection then exit")

    for nm in ("label", "annotate"):
        lb = sub.add_parser(nm)
        lb.add_argument("resource")
        lb.add_argument("name")
        lb.add_argument("pairs", nargs="+", help="k=v ... or k- to remove")
        lb.add_argument("--overwrite", action="store_true")

    sub.add_parser("api-resources")

    wt = sub.add_parser("wait")
    wt.add_argument("resource")
    wt.add_argument("name")
    wt.add_argument("--for", dest="wait_for", required=True,
                    help="condition=Type[=Status] | phase=X | delete")
    wt.add_argument("--timeout", type=float, default=30.0)
    wt.add_argument("--poll", type=float, default=0.2)

    at = sub.add_parser("attach")  # kubectl attach ~ exec without command
    at.add_argument("name")
    at.add_argument("-c", "--container", default=None)

    tp = sub.add_parser("top")
    tp.add_argument("resource", choices=["nodes", "pods"])
    tp.add_argument("-A", "--all-namespaces", action="store_true")

    ro = sub.add_parser("rollout")
    ro.add_argument("action",
                    choices=["status", "history", "undo", "restart"])
    ro.add_argument("kind_name", help="deployment/<name>")

    st = sub.add_parser("status")
    st.add_argument("-o", "--output", choices=["table", "json"],
                    default="table")

    asc = sub.add_parser("autoscale")
    asc.add_argument("action", choices=["status"])
    asc.add_argument("-o", "--output", choices=["table", "json"],
                     default="table")

    au = sub.add_parser("audit")
    au.add_argument("action", choices=["status"])
    au.add_argument("-o", "--output", choices=["table", "json"],
                    default="table")

    wy = sub.add_parser("why", help="explain a pod's scheduling verdict")
    wy.add_argument("name")
    wy.add_argument("-o", "--output", choices=["table", "json"],
                    default="table")

    tr = sub.add_parser("trace")
    tr.add_argument("action", choices=["dump"])
    tr.add_argument("-o", "--output-file", default=None,
                    help="write the Chrome trace-event JSON here "
                    "(default: stdout)")

    lt = sub.add_parser(
        "lint", help="project-native static analysis (ktpu-lint)")
    lt.add_argument("lint_paths", nargs="*")
    lt.add_argument("--baseline", default=None)
    lt.add_argument("--write-baseline", action="store_true")
    lt.add_argument("--no-baseline", action="store_true")
    lt.add_argument("--json", action="store_true", dest="lint_json")
    lt.add_argument("--rule", action="append", default=None)

    sn = sub.add_parser(
        "scenario", help="cluster time machine: generate, record, "
        "replay, and describe production-shaped traces")
    sn.add_argument("action",
                    choices=["generate", "record", "replay", "describe"])
    sn.add_argument("target", nargs="?", default=None,
                    help="builtin:<name> (or bare builtin name) or a "
                    ".trace.jsonl path")
    sn.add_argument("--seed", type=int, default=0,
                    help="generator seed (builtins only)")
    sn.add_argument("--out", dest="out_path", default=None,
                    help="output trace path "
                    "(default <name>.trace.jsonl)")
    sn.add_argument("--speed", type=float, default=1.0,
                    help="replay time warp (2 = twice as fast; "
                    "0 = as fast as possible)")
    sn.add_argument("--bind-timeout", type=float, default=120.0,
                    help="replay: seconds to wait for resident pods "
                    "to bind")
    sn.add_argument("--from-wal", dest="from_wal", default=None,
                    help="record: capture from a durable store's "
                    "wal.jsonl")
    sn.add_argument("--from-bundle", dest="from_bundle", default=None,
                    help="record: convert an audit repro bundle JSON")
    sn.add_argument("--chaos-seed", dest="chaos_seed", type=int,
                    default=None,
                    help="record --from-wal: arm this fault-schedule "
                    "seed in the captured manifest")

    ds = sub.add_parser("deschedule")
    ds.add_argument("action", choices=["run", "status"])
    ds.add_argument("--policy", default=None,
                    help="DeschedulerConfiguration YAML (profiles/knobs)")
    ds.add_argument("--dry-run", action="store_true",
                    help="plan and print, evict nothing")
    ds.add_argument("--max-evictions", type=int, default=None)
    ds.add_argument("-o", "--output", choices=["table", "json"],
                    default="table")
    return ap


def cmd_certificate(client, args, out) -> int:
    from kubernetes_tpu_torch.controllers.certificates import (approve_csr,
                                                               deny_csr)
    fn = approve_csr if args.action == "approve" else deny_csr
    fn(client, args.name)
    verb = "approved" if args.action == "approve" else "denied"
    out.write(f"certificatesigningrequest/{args.name} {verb}\n")
    return 0


def main(argv=None, out=None) -> int:
    """Run one ktpu command; -> its exit code."""
    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    if args.cmd == "lint":  # no apiserver involved: dispatch before client
        from kubernetes_tpu_torch.analysis.cli import main as lint_main
        lint_argv = list(args.lint_paths)
        if args.baseline:
            lint_argv += ["--baseline", args.baseline]
        if args.write_baseline:
            lint_argv.append("--write-baseline")
        if args.no_baseline:
            lint_argv.append("--no-baseline")
        if args.lint_json:
            lint_argv.append("--json")
        for r in args.rule or ():
            lint_argv += ["--rule", r]
        return lint_main(lint_argv, out=out)
    if args.cmd == "scenario" and args.action != "replay":
        # generate/record/describe are pure file operations: dispatch
        # before the client so they work with no apiserver running
        return cmd_scenario(None, args, out)
    client = HTTPClient(args.server, token=args.token,
                        user_agent="ktpu")
    commands = {
        "get": cmd_get, "apply": cmd_apply, "delete": cmd_delete,
        "describe": cmd_describe, "scale": cmd_scale,
        "cordon": lambda c, a, o: _set_unschedulable(c, a.name, True, o),
        "uncordon": lambda c, a, o: _set_unschedulable(c, a.name, False, o),
        "drain": cmd_drain, "top": cmd_top,
        "label": lambda c, a, o: cmd_label(c, a, o, field="labels"),
        "annotate": lambda c, a, o: cmd_label(c, a, o, field="annotations"),
        "api-resources": cmd_api_resources, "wait": cmd_wait,
        "rollout": cmd_rollout, "status": cmd_status,
        "autoscale": cmd_autoscale, "audit": cmd_audit, "why": cmd_why,
        "trace": cmd_trace, "scenario": cmd_scenario,
        "deschedule": cmd_deschedule,
        "certificate": cmd_certificate, "logs": cmd_logs,
        # the hollow runtime has no live stdout stream: attach shows the
        # container's logs, its closest observable analog
        "attach": cmd_logs, "exec": cmd_exec,
        "port-forward": cmd_port_forward}
    if args.cmd == "rollout":
        args.name = args.kind_name.split("/", 1)[-1]
    elif args.cmd == "exec":
        args.command = [c for c in args.command if c != "--"]
    elif args.cmd == "port-forward":
        args.server = client.base
    try:
        return commands[args.cmd](client, args, out)
    except ApiError as e:
        out.write(f"Error from server ({e.reason or e.code}): {e}\n")
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
