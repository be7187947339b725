"""Per-resource integer scaling shared by the tensor path AND the oracle.

Resource amounts must fit int32 tensors exactly (float32 loses integers above
2^24, so raw bytes are out). Each resource gets a canonical tensor unit:

  cpu                milli-cores (already canonical, scale 1)
  memory / storage   Mi (2^20 bytes)  -> int32 caps at 2 PiB per node
  hugepages-*        Mi
  pods / extended    count (scale 1)

Requests round UP and allocatable rounds DOWN, so scaling never admits a pod
the byte-exact reference would reject. The oracle (sched/oracle.py) uses these
same scaled units — feasibility parity with the tensor path is therefore exact,
and divergence from the byte-exact reference is bounded to <1Mi per resource in
the conservative direction.
"""

from __future__ import annotations

MI = 1 << 20

_MI_SCALED_PREFIXES = ("hugepages-",)
_MI_SCALED = {"memory", "ephemeral-storage", "storage"}

# Nodes in the reference always publish a "pods" allocatable (default 110).
# Test fixtures often omit it; treat absence as unlimited.
UNLIMITED = (1 << 31) - 1


def resource_scale(resource: str) -> int:
    if resource in _MI_SCALED or resource.startswith(_MI_SCALED_PREFIXES):
        return MI
    return 1


def scale_request(resource: str, canonical_amount: int) -> int:
    """Canonical (milli/bytes/count) -> tensor units, rounding up."""
    s = resource_scale(resource)
    return -(-int(canonical_amount) // s)


def scale_allocatable(resource: str, canonical_amount: int) -> int:
    """Canonical -> tensor units, rounding down (conservative)."""
    return int(canonical_amount) // resource_scale(resource)
