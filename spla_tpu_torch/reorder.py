"""Host-side vertex relabelling (counterpart of ``spla_tpu/reorder.py``).

Dealing vertices heavy-first round-robin across buckets gives every bucket
an equal share of the degree mass.  ``parallel.shard_csr_by_rows_balanced``
deals rows across the contiguous row blocks of the 1-D partition, which
equalises the stored entries a rank holds.  ``deal_permutation`` deals
over (segment, 128-lane) buckets, the TPU cell layout's classes; it is kept
because it is the same rule and the tests hold both against the JAX
package.  ``spla_tpu.reorder.spmv_relabel`` serves only the TPU's cell
padding and has no counterpart here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["deal_permutation", "relabel_degree_sorted"]


def deal_permutation(deg: np.ndarray, n: int, seg: int):
    """Heavy-first round-robin assignment over (segment, lane) buckets.

    Returns ``(old_of_new, new_of_old)`` int32 permutations such that the
    k-th heaviest vertex lands in bucket ``k % (n_segments * 128)``
    (segment-major, lane-minor) at depth ``k // n_buckets``.  ``seg`` is the
    id-space segment size, a positive multiple of 128."""
    if seg <= 0 or seg % 128:
        raise ValueError(f"seg must be a positive multiple of 128, got {seg}")
    order = np.argsort(-np.asarray(deg, np.int64), kind="stable")
    ns = (n + seg - 1) // seg
    nb = ns * 128
    k = np.arange(ns * seg, dtype=np.int64)
    b = k % nb
    tid = (b // 128) * seg + (k // nb) * 128 + (b % 128)
    tid = tid[tid < n]  # skip padded slots, keeping the deal order
    return _permutations(order, tid, n)


def relabel_degree_sorted(rows, cols, m, n_shards: int, mloc: int):
    """Row permutation equalising the stored entries of the 1-D block-row
    partition: the k-th heaviest row goes to shard ``k % n_shards``, local
    slot ``k // n_shards`` (slots past m are dropped, which keeps the map a
    bijection of the live ids).  Returns ``(old_of_new, new_of_old)``."""
    deg = np.bincount(np.asarray(rows), minlength=m)
    order = np.argsort(-deg.astype(np.int64), kind="stable")
    k = np.arange(n_shards * mloc, dtype=np.int64)
    tid = (k % n_shards) * mloc + k // n_shards
    tid = tid[tid < m]
    return _permutations(order, tid, m)


def _permutations(order, tid, n):
    if tid.size != n:
        raise ValueError(f"the deal covers {tid.size} of {n} ids")
    old_of_new = np.empty(n, np.int32)
    old_of_new[tid] = order
    new_of_old = np.empty(n, np.int32)
    new_of_old[order] = tid
    return old_of_new, new_of_old
