"""``lexsort`` for torch, which has none."""

from __future__ import annotations

import torch


def lexsort(keys):
    """Indices that sort by ``keys[-1]``, ties by ``keys[-2]``, and so on:
    the order of ``jnp.lexsort`` / ``np.lexsort``. Built from stable argsort
    passes, least significant key first."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order
