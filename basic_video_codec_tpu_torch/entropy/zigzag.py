"""Zigzag scan order over square blocks.

Diagonal ``s`` visits ``(i, s-i)`` for ``i`` ascending when ``s`` is even and
``(s-i, i)`` when ``s`` is odd.  The permutation is computed once per block
size; the host coder and the device bit pricing both gather with it.
"""

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def zigzag_indices(n: int) -> np.ndarray:
    """Flat gather indices: ``block.ravel()[zigzag_indices(n)]`` is the scan."""
    order = []
    for s in range(2 * n - 1):
        for i in range(s + 1):
            if s % 2 == 0:
                r, c = i, s - i
            else:
                r, c = s - i, i
            if r < n and c < n:
                order.append(r * n + c)
    return np.asarray(order, dtype=np.int64)
