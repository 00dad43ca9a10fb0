"""Seeded numpy graph generators of the JAX package's benchmarks and tools.

* ``build_graph`` — ``bench.py:37``: the headline SpMV graph;
* ``random_graph`` — ``bench_suite.py:24``: the symmetric traversal graph;
* ``hub_graph`` — uniform rows plus a few rows longer than any stage of
  kernel 7 or any warp's comfortable share of kernel 1;
* ``powerlaw_graph`` — ``tools/ab_spmv.py:65-72``: zipf(2.1) out-degrees.

``build_graph``, ``hub_graph`` and ``powerlaw_graph`` return
``(indptr, rows, cols, vals)`` with rows sorted and duplicate (row, col)
pairs kept as separate entries; ``random_graph`` returns a scipy CSR matrix.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["build_graph", "random_graph", "hub_graph", "powerlaw_graph", "indptr_of"]

HUB_ROWS, HUB_LEN = 3, 1 << 17


def indptr_of(rows, n):
    """int32 CSR row pointers of sorted row ids."""
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr.astype(np.int32)


def build_graph(n, deg, seed=0):
    """bench.py:37: uniform random rows and columns, rows sorted."""
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = np.sort(rng.integers(0, n, nnz, dtype=np.int32))
    cols = rng.integers(0, n, nnz, dtype=np.int32)
    vals = rng.random(nnz, dtype=np.float32)
    return indptr_of(rows, n), rows, cols, vals


def random_graph(n, deg, seed=0):
    """bench_suite.py:24: symmetric, no self loops, duplicates summed, data 1."""
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    a = sp.coo_matrix((np.ones(2 * r.size, np.float32),
                       (np.concatenate([r, c]), np.concatenate([c, r]))), shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.data[:] = 1.0
    return a


def hub_graph(n, seed=3, hub_rows=HUB_ROWS, hub_len=HUB_LEN):
    """Uniform rows of 4 entries plus ``hub_rows`` rows of ``hub_len`` entries."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n, 4 * n),
                           np.repeat(np.linspace(0, n - 1, hub_rows).astype(np.int64), hub_len)])
    rows = np.sort(rows).astype(np.int32)
    cols = rng.integers(0, n, rows.size, dtype=np.int32)
    vals = rng.random(rows.size, dtype=np.float32)
    return indptr_of(rows, n), rows, cols, vals


def powerlaw_graph(n, deg, seed=0):
    """tools/ab_spmv.py:65-72: row i holds min(zipf(2.1) * deg // 2, n // 4)
    uniform random columns."""
    rng = np.random.default_rng(seed)
    degs = np.minimum(rng.zipf(2.1, n) * deg // 2, n // 4)
    rows = np.repeat(np.arange(n, dtype=np.int32), degs).astype(np.int32)
    cols = rng.integers(0, n, rows.size, dtype=np.int32)
    vals = rng.random(rows.size, dtype=np.float32)
    return indptr_of(rows, n), rows, cols, vals
