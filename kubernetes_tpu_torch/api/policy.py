"""PodDisruptionBudget arithmetic (policy/v1).

Reference: ``pkg/controller/disruption/disruption.go`` (``getExpectedScale``,
``countHealthyPods``, status update) and the eviction REST's budget check
(``pkg/registry/core/pod/storage/eviction.go``). Pure functions shared by the
apiserver's eviction subresource and the disruption controller.
"""

from __future__ import annotations

import math
from typing import Optional

from kubernetes_tpu_torch.api.selectors import label_selector_matches
from kubernetes_tpu_torch.api.types import LabelSelector


def _matches(selector: Optional[dict], labels: dict) -> bool:
    """policy/v1 semantics: a nil selector matches nothing; an EMPTY ({})
    selector matches every pod in the namespace. Delegates to the shared
    selector evaluator the workload controllers use."""
    return label_selector_matches(LabelSelector.from_dict(selector), labels)


def _parse_maybe_percent(v, total: int) -> int:
    if isinstance(v, str) and v.endswith("%"):
        return math.ceil(total * int(v[:-1]) / 100.0)
    return int(v)


def pod_healthy(pod: dict) -> bool:
    """Running + Ready (countHealthyPods)."""
    st = pod.get("status") or {}
    if st.get("phase") not in (None, "Running", "Pending"):
        return False
    if not (pod.get("spec") or {}).get("nodeName"):
        return False
    conds = st.get("conditions") or []
    ready = next((c for c in conds if c.get("type") == "Ready"), None)
    # pods without an explicit Ready condition count as healthy once bound
    # (our hollow kubelet does not always post conditions)
    return ready is None or ready.get("status") == "True"


def compute_pdb_status(pdb: dict, pods: list[dict]) -> dict:
    """-> the PDB .status fields (disruption.go updatePdbStatus)."""
    sel = (pdb.get("spec") or {}).get("selector")
    matching = [p for p in pods
                if _matches(sel, (p.get("metadata") or {}).get("labels") or {})]
    expected = len(matching)
    healthy = sum(1 for p in matching if pod_healthy(p))
    spec = pdb.get("spec") or {}
    if "minAvailable" in spec:
        desired = _parse_maybe_percent(spec["minAvailable"], expected)
    elif "maxUnavailable" in spec:
        desired = expected - _parse_maybe_percent(spec["maxUnavailable"],
                                                  expected)
    else:
        desired = 0
    return {
        "expectedPods": expected,
        "currentHealthy": healthy,
        "desiredHealthy": max(desired, 0),
        "disruptionsAllowed": max(healthy - max(desired, 0), 0),
    }


def disruptions_allowed_for(pod: dict, pdbs: list[dict],
                            all_pods: list[dict]) -> tuple[int, Optional[dict]]:
    """Min disruptionsAllowed across PDBs covering ``pod`` (live-computed).
    -> (allowed, governing_pdb|None). No covering PDB -> (unbounded, None)."""
    labels = (pod.get("metadata") or {}).get("labels") or {}
    ns = (pod.get("metadata") or {}).get("namespace", "")
    best = None
    governing = None
    for pdb in pdbs:
        if (pdb.get("metadata") or {}).get("namespace", "") != ns:
            continue
        if not _matches((pdb.get("spec") or {}).get("selector"), labels):
            continue
        allowed = compute_pdb_status(
            pdb, [p for p in all_pods
                  if (p.get("metadata") or {}).get("namespace", "") == ns]
        )["disruptionsAllowed"]
        if best is None or allowed < best:
            best, governing = allowed, pdb
    return (best if best is not None else 1 << 30), governing


def pdb_budgets(pdbs: Optional[list[dict]], pod_dicts: Optional[list[dict]],
                ) -> list[tuple[dict, str, str, int]]:
    """-> one (pdb, namespace, name, disruptionsAllowed) per PDB, with
    ``disruptionsAllowed`` live-computed against the namespace's pods.
    Compute ONCE, then charge per approved eviction — every consumer that
    gates multiple evictions against one budget (the descheduler planner's
    ledger, the gang-defrag candidate screen) must share this arithmetic,
    or N victims against a budget with one disruption left each see
    "1 remaining" and all pass."""
    out = []
    for pdb in (pdbs or []):
        pmd = pdb.get("metadata") or {}
        pns = pmd.get("namespace", "")
        ns_pods = [p for p in (pod_dicts or [])
                   if (p.get("metadata") or {}).get("namespace", "") == pns]
        allowed = compute_pdb_status(pdb, ns_pods)["disruptionsAllowed"]
        out.append((pdb, pns, pmd.get("name", ""), allowed))
    return out


def list_pdbs(client) -> list[dict]:
    """Every PDB in the cluster, or [] when the store has no such resource
    (older servers, bare DirectClient fixtures) — disruption math degrades
    to "no budgets" rather than taking the caller's loop down. Shared by
    the autoscaler's scale-down proof and the descheduler's planner."""
    try:
        return list(client.resource("poddisruptionbudgets", None).list())
    except Exception:  # ktpu-lint: disable=KTL002 -- PDB listing is advisory budget input; an unreachable apiserver degrades to no-budget for this pass, the caller's next pass retries
        return []
