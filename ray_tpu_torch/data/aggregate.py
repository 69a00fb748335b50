"""Aggregation functions for groupby/global aggregation.

Reference: ``python/ray/data/aggregate.py`` — ``AggregateFn`` with
init/accumulate/merge/finalize; built-ins Count/Sum/Min/Max/Mean/Std.
Implemented here over Arrow compute on whole blocks (vectorized per block,
merged across blocks).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import pyarrow.compute as pc


class AggregateFn:
    def __init__(self, name: str,
                 block_acc: Callable,  # (arrow table) -> partial
                 merge: Callable,  # (partial, partial) -> partial
                 finalize: Callable = lambda a: a):
        self.name = name
        self.block_acc = block_acc
        self.merge = merge
        self.finalize = finalize


class Count(AggregateFn):
    def __init__(self):
        super().__init__("count()", lambda t: t.num_rows, lambda a, b: a + b)


class Sum(AggregateFn):
    def __init__(self, on: str):
        super().__init__(f"sum({on})",
                         lambda t: pc.sum(t.column(on)).as_py() or 0,
                         lambda a, b: a + b)


class Min(AggregateFn):
    def __init__(self, on: str):
        super().__init__(f"min({on})",
                         lambda t: pc.min(t.column(on)).as_py(),
                         lambda a, b: min(x for x in (a, b) if x is not None)
                         if (a is not None or b is not None) else None)


class Max(AggregateFn):
    def __init__(self, on: str):
        super().__init__(f"max({on})",
                         lambda t: pc.max(t.column(on)).as_py(),
                         lambda a, b: max(x for x in (a, b) if x is not None)
                         if (a is not None or b is not None) else None)


class Mean(AggregateFn):
    def __init__(self, on: str):
        def acc(t):
            s = pc.sum(t.column(on)).as_py() or 0
            return (s, t.num_rows)
        super().__init__(f"mean({on})", acc,
                         lambda a, b: (a[0] + b[0], a[1] + b[1]),
                         lambda a: a[0] / a[1] if a[1] else None)


class Std(AggregateFn):
    """Welford-style mergeable variance (ddof=1, matching the reference)."""

    def __init__(self, on: str, ddof: int = 1):
        def acc(t):
            arr = t.column(on).to_numpy(zero_copy_only=False).astype(np.float64)
            n = len(arr)
            if n == 0:
                return (0, 0.0, 0.0)
            m = float(arr.mean())
            m2 = float(((arr - m) ** 2).sum())
            return (n, m, m2)

        def merge(a, b):
            na, ma, m2a = a
            nb, mb, m2b = b
            if na == 0:
                return b
            if nb == 0:
                return a
            n = na + nb
            delta = mb - ma
            m = ma + delta * nb / n
            m2 = m2a + m2b + delta * delta * na * nb / n
            return (n, m, m2)

        def fin(a):
            n, _, m2 = a
            if n - ddof <= 0:
                return None
            return float(np.sqrt(m2 / (n - ddof)))

        super().__init__(f"std({on})", acc, merge, fin)


class AbsMax(AggregateFn):
    def __init__(self, on: str):
        super().__init__(f"abs_max({on})",
                         lambda t: pc.max(pc.abs(t.column(on))).as_py(),
                         lambda a, b: max(x for x in (a, b) if x is not None)
                         if (a is not None or b is not None) else None)
