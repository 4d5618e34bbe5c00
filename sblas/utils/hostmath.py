"""Host-side math primitives used by loaders and the partition planner.

Equivalents of the reference's hand-rolled helpers in utility.h:
where the reference wrote scalar C loops we use vectorized numpy.  Provided
for API parity and for the partitioner; device-side reductions/scans are
XLA's job (jnp.cumsum etc.), not these.
"""

from __future__ import annotations

import numpy as np


def rand0to1(rng: np.random.RandomState) -> float:
    """Uniform [0,1) scalar (reference utility.h:197 `rand0to1`)."""
    return float(rng.random_sample())


def sort_key_value(keys: np.ndarray, values: np.ndarray):
    """Stable key-value sort (reference utility.h:208-237 quicksort pair).

    Returns sorted copies; stability is an improvement over the reference's
    unstable quicksort (keeps duplicate-coordinate file order deterministic).
    """
    order = np.argsort(keys, kind="stable")
    return keys[order], values[order]


def lexsort2(secondary: np.ndarray, primary: np.ndarray) -> np.ndarray:
    """`np.lexsort((secondary, primary))` via ONE composite-key stable
    argsort when the key fits int64 (measured 6.0 -> 1.5 s at 12M
    elements on this host — one radix pass instead of two).  Identical
    order to lexsort (stable, primary-major).  Requires non-negative
    integer inputs; falls back to lexsort for huge id ranges."""
    if len(primary):
        W = np.int64(int(secondary.max()) + 1)
        if int(primary.max()) < 2**62 // int(W):
            return np.argsort(primary * W + secondary, kind="stable")
    return np.lexsort((secondary, primary))


def segmented_sum(values: np.ndarray, flags: np.ndarray) -> np.ndarray:
    """Flag-based segmented sum (reference utility.h:249-262).

    `flags[i] != 0` marks the first element of a segment.  Returns, at each
    segment head, the sum of that segment (other positions zero), matching the
    reference's in-place convention.
    """
    values = np.asarray(values)
    flags = np.asarray(flags) != 0
    if len(values) == 0:
        return values.copy()
    seg_id = np.cumsum(flags) - 1
    n_seg = int(seg_id[-1]) + 1 if len(seg_id) else 0
    sums = np.bincount(seg_id, weights=values, minlength=max(n_seg, 0))
    out = np.zeros_like(values)
    out[np.flatnonzero(flags)] = sums.astype(values.dtype)
    return out


def reduce_sum(values: np.ndarray):
    """Total reduction (reference utility.h:265-272)."""
    return np.asarray(values).sum()


def exclusive_scan(values: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum, returned (not in-place like utility.h:276-288)."""
    out = np.zeros_like(np.asarray(values))
    np.cumsum(values[:-1], out=out[1:]) if len(values) > 1 else None
    return out


def find_row_of_nnz(row_ptr: np.ndarray, nnz_idx) -> np.ndarray:
    """Row index containing nnz position(s) `nnz_idx` in a CSR row_ptr.

    Vectorized binary-search replacement for the reference's linear scan
    `csr_findRowIdxUsingNnzIdx` (utility.h:292-300).  For nnz_idx in
    [row_ptr[r], row_ptr[r+1]) returns r.
    """
    return np.searchsorted(row_ptr, np.asarray(nnz_idx), side="right") - 1
