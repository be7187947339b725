"""Carry an encoding of the JAX package across to the port.

The port has no weights: its state is the encoded cluster, the pod batches
and the churn patches the drain applies. ``from_reference`` takes the
reference package's ``ClusterTensors`` or ``PodBatch`` flattened to a
nested dict of numpy arrays (one entry per dataclass field, a nested dict
for each selector or term set) and returns the port's container with every
field on ``device``; a stacked PodBatch (a leading B axis on every field)
carries the same way. ``patch_to`` moves a compiled churn patch (numpy
arrays by key, as ``encode/patch.py`` and the reference's ``compile_patch``
emit it) to a device. The caller does the flattening, so this module never
imports the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubernetes_tpu_torch.encode.snapshot import (
    ClusterTensors,
    PodBatch,
    SelectorSet,
    TermSet,
)

_CONTAINERS = (ClusterTensors, PodBatch, TermSet, SelectorSet)


def _container_for(tree: dict):
    names = set(tree)
    for cls in _CONTAINERS:
        if names == {f.name for f in dataclasses.fields(cls)}:
            return cls
    raise ValueError(f"no container has the fields {sorted(names)}")


def _build(tree: dict):
    cls = _container_for(tree)
    return cls(**{k: _build(v) if isinstance(v, dict) else np.asarray(v)
                  for k, v in tree.items()})


def from_reference(tree: dict, device):
    """Nested dict of numpy arrays -> ClusterTensors or PodBatch on ``device``."""
    return _build(tree).to(device)


def patch_to(patch: dict, device) -> dict:
    """A compiled churn patch (numpy arrays by key, or tensors a staging
    call already moved) -> tensors on ``device``, one copy per key that is
    not there yet (a patch is a few KB)."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v)).to(device))
            for k, v in patch.items()}
