"""Tensor evaluation of compiled selector expressions.

The PyTorch port of ``kubernetes_tpu/ops/exprs.py``. A whole batch of
compiled expressions evaluates against all nodes (or all existing pods) as
one broadcasted integer compare.

Operator codes (encode/snapshot.py OPC): In=0 NotIn=1 Exists=2 DoesNotExist=3
Gt=4 Lt=5. Label semantics mirror api/selectors.py exactly.
"""

from __future__ import annotations

import math

import torch


def gather_values(labels, key):
    """labels [M,K] int32, key [...] int32 -> value ids [M, ...] (-1 absent).

    Out-of-range or negative key ids (keys interned after this tensor was
    built, or pad) read as absent.
    """
    K = labels.shape[1]
    safe = key.clamp(0, max(K - 1, 0)).long()
    v = labels[:, safe]  # [M, ...]
    bad = (key < 0) | (key >= K)
    return torch.where(bad[None, ...], -1, v)


def eval_exprs(v, op, vals, expr_valid, num=None, value_num=None):
    """Evaluate expressions against gathered values.

    v          [M, ...]      gathered label value id per target object
    op         [...]         operator code
    vals       [..., V]      value-id set (-1 pad)
    expr_valid [...]         real (non-pad) expression
    num        [...]         numeric rhs for Gt/Lt (optional)
    value_num  [VTAB] f32    numeric parse of interned values (optional)

    Returns match [M, ...] bool with pad expressions neutral (True).
    """
    present = v >= 0
    # [M, ..., V]: guard pad ids so (-1 == -1) never matches.
    in_set = torch.any((v[..., None] == vals[None, ...]) & (vals[None, ...] >= 0),
                       dim=-1)
    o = op[None, ...]
    match = torch.zeros_like(present)
    match = torch.where(o == 0, present & in_set, match)           # In
    match = torch.where(o == 1, ~present | ~in_set, match)         # NotIn
    match = torch.where(o == 2, present, match)                    # Exists
    match = torch.where(o == 3, ~present, match)                   # DoesNotExist
    if num is not None and value_num is not None:
        VT = value_num.shape[0]
        vn = value_num[v.clamp(0, max(VT - 1, 0)).long()]
        vn = torch.where(present & (v < VT), vn, math.nan)
        match = torch.where(o == 4, vn > num[None, ...], match)    # Gt
        match = torch.where(o == 5, vn < num[None, ...], match)    # Lt
    return match | ~expr_valid[None, ...]


def eval_term_set(ts, node_labels, value_num):
    """TermSet (required/preferred node-selector terms) against nodes.

    Returns term_match [N, P, T] bool — per-term hit (pad terms False).
    OR/weighted-sum over T is the caller's job.
    """
    v = gather_values(node_labels, ts.key)                       # [N,P,T,X]
    m = eval_exprs(v, ts.op, ts.vals, ts.expr_valid, ts.num, value_num)
    term_ok = torch.all(m, dim=-1)                               # [N,P,T]
    # A term with zero expressions matches nothing (reference: nodeaffinity).
    nonempty = torch.any(ts.expr_valid, dim=-1)                  # [P,T]
    return term_ok & nonempty[None, ...] & ts.term_valid[None, ...]


def eval_selector_set(ss, labels):
    """SelectorSet (label selectors) against objects with ``labels`` [M,K].

    Returns match [M, ...] bool. Valid selector with zero exprs matches all
    (empty selector); invalid (nil) selectors match nothing.
    """
    v = gather_values(labels, ss.key)                            # [M,...,X]
    m = eval_exprs(v, ss.op, ss.vals, ss.expr_valid)
    return torch.all(m, dim=-1) & ss.valid[None, ...]
