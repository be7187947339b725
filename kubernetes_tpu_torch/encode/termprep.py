"""Host-side term preprocessing shared by the oracle and the tensor encoder.

This is the analog of the reference's PreFilter-time term normalization
(``pkg/scheduler/framework/types.go`` ``newAffinityTerm`` /
``podtopologyspread/common.go`` ``buildDefaultConstraints``):

- ``matchLabelKeys`` / ``mismatchLabelKeys`` merge the term-owning pod's
  label values into the term's label selector as In / NotIn requirements
  (MatchLabelKeysInPodAffinity, MatchLabelKeysInPodTopologySpread). Keys the
  owning pod doesn't carry are skipped, matching upstream.
- ``namespaces`` + ``namespaceSelector`` resolve to a concrete namespace-name
  set against a snapshot of Namespace labels
  (``mergeAffinityTermNamespacesIfNotEmpty``): both unset means "the owning
  pod's own namespace"; a non-nil selector ORs its matches with the explicit
  list, and the EMPTY selector {} matches every namespace.

Keeping this in one place guarantees the serial oracle and the TPU encoder
agree on the *effective* terms — the tensor path then only has to implement
integer-set matching.
"""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.selectors import label_selector_matches
from kubernetes_tpu_torch.api.types import (
    OP_IN,
    OP_NOT_IN,
    LabelSelector,
    PodAffinityTerm,
    Requirement,
    TopologySpreadConstraint,
)


def effective_label_selector(
        selector: Optional[LabelSelector],
        match_label_keys: list[str],
        mismatch_label_keys: list[str],
        owner_labels: dict[str, str]) -> Optional[LabelSelector]:
    """Merge (mis)matchLabelKeys into ``selector`` using the term-owning
    pod's labels. A nil selector stays nil (it matches nothing; upstream
    validation forbids matchLabelKeys without a selector anyway)."""
    if selector is None or not (match_label_keys or mismatch_label_keys):
        return selector
    extra = []
    for k in match_label_keys:
        if k in owner_labels:
            extra.append(Requirement(k, OP_IN, [owner_labels[k]]))
    for k in mismatch_label_keys:
        if k in owner_labels:
            extra.append(Requirement(k, OP_NOT_IN, [owner_labels[k]]))
    if not extra:
        return selector
    return LabelSelector(
        match_labels=dict(selector.match_labels),
        match_expressions=list(selector.match_expressions) + extra,
    )


def affinity_term_selector(term: PodAffinityTerm,
                           owner_labels: dict[str, str]) -> Optional[LabelSelector]:
    """The term's effective selector after matchLabelKeys merging."""
    return effective_label_selector(
        term.label_selector, term.match_label_keys,
        term.mismatch_label_keys, owner_labels)


def spread_selector(sc: TopologySpreadConstraint,
                    pod_labels: dict[str, str]) -> Optional[LabelSelector]:
    """The constraint's effective selector after matchLabelKeys merging."""
    return effective_label_selector(
        sc.label_selector, sc.match_label_keys, [], pod_labels)


def resolve_term_namespaces(
        term: PodAffinityTerm, own_ns: str,
        namespace_labels: dict[str, dict[str, str]]) -> Optional[frozenset]:
    """Concrete namespace-name set a term applies to, or None meaning "the
    owning pod's own namespace" (the implicit default).

    ``namespace_labels`` maps namespace name -> its labels (the
    GetNamespaceLabelsSnapshot analog). The owning pod's namespace is always
    resolvable even if absent from the map.

    Fleet isolation: when the owning namespace carries the
    ``kubernetes-tpu.io/tenant`` label, a namespaceSelector only matches
    namespaces of the SAME tenant — affinity terms must never couple one
    tenant's pods to a sibling's, no matter how its namespace labels look.
    Untenanted owners keep the pre-fleet behavior exactly.
    """
    if not term.namespaces and term.namespace_selector is None:
        return None
    # local import: snapshot.py imports this module at load time
    from kubernetes_tpu_torch.encode.snapshot import TENANT_LABEL
    own_tenant = (namespace_labels.get(own_ns) or {}).get(TENANT_LABEL)
    names = set(term.namespaces)
    sel = term.namespace_selector
    if sel is not None:
        for ns, labels in namespace_labels.items():
            if own_tenant is not None \
                    and (labels or {}).get(TENANT_LABEL) != own_tenant:
                continue  # tenant-scoped: selectors never cross tenants
            if label_selector_matches(sel, labels or {}):
                names.add(ns)
        # A namespace_labels snapshot that doesn't know own_ns would silently
        # drop self-namespace matches; resolve it explicitly against empty
        # labels (only an empty or purely negative selector can match).
        if own_ns not in namespace_labels and label_selector_matches(sel, {}):
            names.add(own_ns)
    return frozenset(names)
