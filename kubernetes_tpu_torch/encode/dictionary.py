"""String interning tables — the bridge from k8s's stringly-typed objects to
dense integer tensors.

The reference matches label strings at scheduling time (labels.Selector over
map[string]string). The TPU path cannot; instead every label key, label value,
namespace, image name, etc. is interned once at encode time and all tensor
comparisons are integer equality. ``-1`` is the universal "absent" id.
"""

from __future__ import annotations

import math


class StringTable:
    """Monotone intern table: str -> dense int id (0-based); -1 = absent."""

    def __init__(self, initial: list[str] | None = None):
        self._ids: dict[str, int] = {}
        self._strs: list[str] = []
        for s in initial or []:
            self.intern(s)

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strs)
            self._ids[s] = i
            self._strs.append(s)
        return i

    def get(self, s: str) -> int:
        """Lookup without growing; -1 if unknown."""
        return self._ids.get(s, -1)

    def lookup(self, i: int) -> str:
        return self._strs[i]

    def __len__(self) -> int:
        return len(self._strs)

    def __contains__(self, s: str) -> bool:
        return s in self._ids

    def strings(self) -> list[str]:
        return list(self._strs)

    def numeric_values(self) -> list[float]:
        """Integer-parse of each interned string (labels Gt/Lt compare ints);
        NaN for non-numeric values, which makes the comparison false."""
        out = []
        for s in self._strs:
            try:
                out.append(float(int(s)))
            except (TypeError, ValueError):
                out.append(math.nan)
        return out


def next_bucket(n: int, minimum: int = 0) -> int:
    """Round a dimension up to the next power of two (static-shape bucketing:
    limits XLA recompiles as the cluster grows). 0 stays 0 — empty reductions
    are valid and free."""
    n = max(n, minimum)
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()
