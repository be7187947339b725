"""Server-side apply — field ownership, merge, and conflicts.

Reference: ``staging/src/k8s.io/apimachinery/pkg/util/managedfields`` +
structured-merge-diff: every object carries ``metadata.managedFields``
(one entry per field manager: operation Apply/Update + a fieldsV1 trie of
owned paths). Apply semantics implemented here:

- The applied configuration's field set is extracted as a path trie
  (fieldsV1 wire shape: ``{"f:spec": {"f:replicas": {}}}``).
- Fields in the apply take the desired values.
- Fields the SAME manager owned before but omitted now are REMOVED —
  reconcile-by-absence, the property client-side apply cannot give.
- Fields owned by ANOTHER manager with a different live value conflict:
  HTTP 409 listing the owners, unless ``force=true`` transfers ownership
  (kubectl's --force-conflicts).

Field paths are tuples of key segments end to end (mirroring fieldsV1's
per-segment ``f:<key>`` keys), so map keys containing dots — ConfigMap
data keys like ``config.yaml``, label keys like
``topology.kubernetes.io/zone`` — merge correctly.

Simplification vs the reference (documented): lists are ATOMIC — owning a
list owns it whole (upstream's granular listType=map merge keys are a
schema-driven refinement of the same ownership model).
"""

from __future__ import annotations

from typing import Optional

from ..utils.clock import rfc3339_now

# metadata identity fields the server owns; never part of apply ownership
_SERVER_META = {"resourceVersion", "uid", "creationTimestamp",
                "generation", "managedFields"}

Path = tuple  # tuple[str, ...] — one element per map key segment


def path_str(path: Path) -> str:
    """Human-readable dotted rendering for error messages only (segments
    containing '.' are quoted so the rendering stays unambiguous)."""
    return ".".join(f'"{p}"' if "." in p else p for p in path)


class ApplyConflict(Exception):
    def __init__(self, conflicts: list[tuple[Path, str]]):
        self.conflicts = conflicts  # [(path, owning manager)]
        owners = ", ".join(f"{path_str(p)} (owned by {m!r})"
                           for p, m in conflicts)
        super().__init__(f"Apply failed with {len(conflicts)} conflict(s): "
                         f"{owners}")


# ---------------------------------------------------------------- field sets

def field_set(obj, prefix: Path = ()) -> set[Path]:
    """Leaf paths of an applied configuration, as segment tuples.
    Lists are atomic: the path stops at the list itself."""
    out: set[Path] = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            if prefix == ("metadata",) and k in _SERVER_META:
                continue
            p = prefix + (k,)
            if isinstance(v, dict) and v:
                out |= field_set(v, p)
            else:
                out.add(p)
    return out


def to_fields_v1(paths: set[Path]) -> dict:
    """Segment-tuple paths -> the fieldsV1 trie wire shape
    ({"f:spec": {"f:replicas": {}}}). One trie key per segment, so dotted
    segments round-trip losslessly."""
    root: dict = {}
    for path in sorted(paths):
        node = root
        for part in path:
            node = node.setdefault(f"f:{part}", {})
    return root


def from_fields_v1(trie: dict, prefix: Path = ()) -> set[Path]:
    out: set[Path] = set()
    for k, v in (trie or {}).items():
        name = k[2:] if k.startswith("f:") else k
        p = prefix + (name,)
        if v:
            out |= from_fields_v1(v, p)
        else:
            out.add(p)
    return out


def _get(obj: dict, path: Path):
    node = obj
    for part in path:
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _set(obj: dict, path: Path, value) -> None:
    node = obj
    for part in path[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = node[part] = {}
        node = nxt
    node[path[-1]] = value


def _remove(obj: dict, path: Path) -> None:
    node = obj
    for part in path[:-1]:
        node = node.get(part)
        if not isinstance(node, dict):
            return
    node.pop(path[-1], None)
    # prune now-empty parents (structured-merge-diff does the same)
    if len(path) > 1:
        parent_path = path[:-1]
        if _get(obj, parent_path) == {}:
            _remove(obj, parent_path)


# ------------------------------------------------------------------- managed

def _owners(live: dict) -> dict[str, set[Path]]:
    """manager name -> owned path set, from live managedFields."""
    out: dict[str, set[Path]] = {}
    for entry in (live.get("metadata") or {}).get("managedFields") or []:
        out.setdefault(entry.get("manager", ""), set()).update(
            from_fields_v1(entry.get("fieldsV1") or {}))
    return out


def _write_managed(obj: dict, owners: dict[str, set[Path]],
                   ops: dict[str, str]) -> None:
    md = obj.setdefault("metadata", {})
    entries = []
    for manager in sorted(owners):
        paths = owners[manager]
        if not paths:
            continue
        entries.append({
            "manager": manager,
            "operation": ops.get(manager, "Update"),
            "apiVersion": "v1",
            "time": rfc3339_now(),
            "fieldsType": "FieldsV1",
            "fieldsV1": to_fields_v1(paths),
        })
    if entries:
        md["managedFields"] = entries
    else:
        md.pop("managedFields", None)


def server_side_apply(live: Optional[dict], desired: dict, manager: str,
                      force: bool = False) -> dict:
    """-> the merged object (live untouched). Raises ApplyConflict."""
    import copy
    applied = field_set(desired)
    if live is None:
        out = copy.deepcopy(desired)
        _write_managed(out, {manager: applied}, {manager: "Apply"})
        return out

    owners = _owners(live)
    ops = {m: "Apply" if m == manager else "Update" for m in owners}
    ops[manager] = "Apply"
    conflicts: list[tuple[Path, str]] = []
    for path in sorted(applied):
        for other, owned in owners.items():
            if other == manager or path not in owned:
                continue
            if _get(live, path) != _get(desired, path):
                if force:
                    owned.discard(path)
                else:
                    conflicts.append((path, other))
    if conflicts:
        raise ApplyConflict(conflicts)

    out = copy.deepcopy(live)
    # reconcile-by-absence: paths this manager owned but no longer applies
    for path in sorted(owners.get(manager, set()) - applied, reverse=True):
        # another manager co-owning the path keeps it alive
        if any(path in owned for m, owned in owners.items() if m != manager):
            continue
        _remove(out, path)
    for path in applied:
        _set(out, path, copy.deepcopy(_get(desired, path)))
    # this manager now owns exactly what it applied; same-value paths other
    # managers also own stay CO-owned (upstream: force transfers only the
    # conflicting fields, which the conflict loop already discarded)
    owners[manager] = set(applied)
    _write_managed(out, owners, ops)
    return out
