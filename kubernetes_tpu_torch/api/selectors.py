"""Label / node-selector matching semantics (host-side oracle path).

Reference: ``staging/src/k8s.io/apimachinery/pkg/labels/selector.go``
(``Requirement.Matches``) and
``staging/src/k8s.io/component-helpers/scheduling/corev1/nodeaffinity``
(``MatchNodeSelectorTerms``). The tensor encoder (encode/snapshot.py) compiles
the same semantics to int-set tables; keep the two in lock-step — parity tests
diff them directly.

Operator semantics (labels lib):
  In           key exists and value in set
  NotIn        key absent OR value not in set
  Exists       key present
  DoesNotExist key absent
  Gt / Lt      key present, integer-parsed value strictly greater/less
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
    LabelSelector,
    NodeSelectorTerm,
    Requirement,
)


def requirement_matches(req: Requirement, labels: dict[str, str]) -> bool:
    present = req.key in labels
    value = labels.get(req.key)
    if req.operator == OP_IN:
        return present and value in req.values
    if req.operator == OP_NOT_IN:
        return (not present) or value not in req.values
    if req.operator == OP_EXISTS:
        return present
    if req.operator == OP_DOES_NOT_EXIST:
        return not present
    if req.operator in (OP_GT, OP_LT):
        if not present or not req.values:
            return False
        try:
            lhs, rhs = int(value), int(req.values[0])
        except (TypeError, ValueError):
            return False
        return lhs > rhs if req.operator == OP_GT else lhs < rhs
    raise ValueError(f"unknown operator {req.operator!r}")


def node_selector_term_matches(term: NodeSelectorTerm, labels: dict[str, str],
                               fields: Optional[dict[str, str]] = None) -> bool:
    """A term with no expressions and no fields matches nothing (reference:
    nodeaffinity lazy errs). matchFields evaluate against node fields
    (metadata.name), matchExpressions against labels; both must hold."""
    if not term.match_expressions and not term.match_fields:
        return False
    return (all(requirement_matches(e, labels) for e in term.match_expressions)
            and all(requirement_matches(e, fields or {}) for e in term.match_fields))


def node_selector_matches(terms: list[NodeSelectorTerm], labels: dict[str, str],
                          fields: Optional[dict[str, str]] = None) -> bool:
    """OR over terms; an empty term list matches nothing."""
    return any(node_selector_term_matches(t, labels, fields) for t in terms)


def node_fields(node_name: str) -> dict[str, str]:
    """The node field set visible to matchFields."""
    return {"metadata.name": node_name}


def label_selector_matches(selector: Optional[LabelSelector], labels: dict[str, str]) -> bool:
    """nil selector matches nothing; empty selector matches everything."""
    if selector is None:
        return False
    return all(requirement_matches(r, labels) for r in selector.requirements())


def compile_list_selector(label_selector: Optional[str] = None,
                          field_selector: Optional[str] = None):
    """Wire-string list/watch filtering: ``labelSelector=k=v,k2=v2`` equality
    pairs and ``fieldSelector=spec.nodeName=x`` dotted-path equality.

    Single source of truth shared by the apiserver's list handler, the
    DirectClient, and the informer's watch-side rematching — the three must
    agree or list-time and watch-time filtering diverge (an object matched at
    list never deletes, or vice versa). Returns None when unfiltered.
    """
    if not label_selector and not field_selector:
        return None

    # Parse once here; the predicate runs per object per list/watch event.
    label_pairs = [tuple(p.split("=", 1))
                   for p in (label_selector or "").split(",") if "=" in p]
    field_pairs = [(k.split("."), v) for k, v in
                   (tuple(p.split("=", 1))
                    for p in (field_selector or "").split(",") if "=" in p)]

    def match(obj: dict) -> bool:
        if label_pairs:
            labels = (obj.get("metadata") or {}).get("labels") or {}
            for k, v in label_pairs:
                if labels.get(k) != v:
                    return False
        for path, v in field_pairs:
            cur = obj
            for part in path:
                cur = (cur or {}).get(part)
                if cur is None:
                    break
            if (cur or "") != v:
                return False
        return True

    return match
