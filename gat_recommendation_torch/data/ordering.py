"""Row orders that pandas gives, reproduced on numpy arrays.

The pipeline's files are byte for byte those of the JAX package, whose
stages order rows with pandas: ``sort_values`` on one column (numpy's
quicksort, not stable) and ``value_counts``. Where keys tie, the bytes
depend on the order these calls give, so the port makes the same numpy
calls on the same arrays.
"""

from __future__ import annotations

import numpy as np


def pandas_argsort(values: np.ndarray, ascending: bool = True) -> np.ndarray:
    """The row order of pandas' default ``sort_values`` on one column without
    NaN: numpy's quicksort (not stable), descending by sorting the reversed
    array and reversing the result (``pandas.core.sorting.nargsort``). Rows
    with equal keys come out in the order that call gives."""
    values = np.asarray(values)
    if ascending:
        return np.argsort(values, kind="quicksort")
    idx = np.arange(len(values))[::-1]
    return idx[values[::-1].argsort(kind="quicksort")][::-1]


def value_counts(values: np.ndarray) -> dict:
    """{value: count} in the order of pandas' ``value_counts``: count
    descending, from the values in the order of their first appearance."""
    uniq, first, counts = np.unique(values, return_index=True, return_counts=True)
    by_first = np.argsort(first, kind="stable")
    uniq, counts = uniq[by_first], counts[by_first]
    order = pandas_argsort(counts, ascending=False)
    return {k: int(c) for k, c in zip(uniq[order].tolist(), counts[order].tolist())}
