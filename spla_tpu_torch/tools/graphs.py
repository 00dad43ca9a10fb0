"""Seeded numpy graph generators of the JAX package's benchmarks and tools.

* ``build_graph`` — ``bench.py:37``: the headline SpMV graph;
* ``random_graph`` — ``bench_suite.py:24``: the symmetric traversal graph;
* ``hub_graph`` — uniform rows plus a few rows longer than any stage of
  kernel 7 or any warp's comfortable share of kernel 1;
* ``powerlaw_graph`` — ``tools/ab_spmv.py:65-72``: zipf(2.1) out-degrees;
* ``road_grid``, ``road_graphs`` — ``bench_suite.py:226-253,269-319,323-334``:
  the Morton-ordered road grids of the road cells;
* ``path_graph``, ``barbell_graph`` — graphs whose traversal rounds hold one
  vertex each, or change between one vertex and most of a random block;
* ``skewed_graph`` — ``bench_suite.py:441-448``: the skewed_* cells'
  directed graph of zipf(2.1) out-degrees, the class that the skew gate
  sends to the level loop;
* ``hub_spgemm`` — the SpGEMM-T hub graph: short rows plus a few rows far
  longer than a mask row or a B row that one warp walks, and a mask that
  reaches them;
* ``spgemm_bins`` — A and B whose product A @ B has rows in each of
  kernel 9's three bins (``kernels.spgemm.mxm_plan``);
* ``uniform_csr``, ``kron_csr`` — symmetric uniform and Graph500 Kronecker
  graphs made on a device with torch (no host copy), for sizes that scipy
  takes minutes to build: the triangle-count graphs of kernel 4.

``build_graph``, ``hub_graph`` and ``powerlaw_graph`` return
``(indptr, rows, cols, vals)`` with rows sorted and duplicate (row, col)
pairs kept as separate entries; ``uniform_csr`` and ``kron_csr`` a
``CsrMatrix``; the others return scipy CSR matrices (``hub_spgemm`` and
``spgemm_bins`` two).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..containers import CsrMatrix

__all__ = ["build_graph", "random_graph", "hub_graph", "powerlaw_graph", "indptr_of", "morton",
           "road_edges", "road_grid", "road_graphs", "path_graph", "barbell_graph", "skewed_graph",
           "hub_spgemm", "spgemm_bins", "uniform_csr", "kron_csr"]

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


def morton(x, y):
    """bench_suite.py:229: interleave the bits of x and y (< 2^16)."""
    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v
    return (spread(x) | (spread(y) << 1)).astype(np.int64)


def road_edges(side):
    """Both directions of every edge of the side x side grid, Morton ids
    (bench_suite.py:239-249), as int32 (rows, cols)."""
    xs, ys = np.meshgrid(np.arange(side, dtype=np.int64), np.arange(side, dtype=np.int64),
                         indexing="ij")
    rows_l, cols_l = [], []
    for dx, dy in ((1, 0), (0, 1)):
        xs2, ys2 = xs[: side - dx, : side - dy], ys[: side - dx, : side - dy]
        a = morton(xs2.ravel(), ys2.ravel())
        b = morton((xs2 + dx).ravel(), (ys2 + dy).ravel())
        rows_l += [a, b]
        cols_l += [b, a]
    return np.concatenate(rows_l).astype(np.int32), np.concatenate(cols_l).astype(np.int32)


def road_grid(side):
    """The Morton-ordered side x side grid, data 1 (bench_suite.py:226-253;
    side 3072 is road_big_bfs_gteps's graph, :269-319).  A side that is not
    a power of two leaves gaps among the Morton ids: their ranks close them
    (bench_suite.py:306-310)."""
    rr, cc = road_edges(side)
    ids = np.unique(rr)
    rr, cc = np.searchsorted(ids, rr).astype(np.int32), np.searchsorted(ids, cc).astype(np.int32)
    n = side * side
    return sp.csr_matrix((np.ones(rr.size, np.float32), (rr, cc)), shape=(n, n))


def road_graphs(side_bfs, side_sssp, seed=9):
    """bench_suite.py:226-253 and 323-334: ``road_grid(side_bfs)`` for BFS,
    and its side-``side_sssp`` corner (a power of two, so its Morton ids
    come first and keep their ranks) with weights uniform(0.1, 1.0) from
    ``seed``, drawn in ``road_edges`` order as bench_suite draws them,
    symmetrized by maximum, for SSSP."""
    rr, cc = road_edges(side_bfs)
    nrs = side_sssp * side_sssp
    sel = (rr < nrs) & (cc < nrs)
    w = sp.csr_matrix((np.random.default_rng(seed).uniform(0.1, 1.0, int(sel.sum())).astype(
        np.float32), (rr[sel], cc[sel])), shape=(nrs, nrs))
    return road_grid(side_bfs), w.maximum(w.T).tocsr()


def _symmetric(u, v, n, rng):
    """Both directions of the undirected edges (u, v), one weight
    uniform(0.1, 1.0) an edge."""
    w = rng.uniform(0.1, 1.0, u.size).astype(np.float32)
    return sp.csr_matrix((np.concatenate([w, w]), (np.concatenate([u, v]), np.concatenate([v, u]))),
                         shape=(n, n))


def path_graph(n, seed=0):
    """The path 0 - 1 - ... - (n - 1), both directions, weights
    uniform(0.1, 1.0) from ``seed``: from vertex 0 every BFS level and every
    SSSP round holds one vertex."""
    i = np.arange(n - 1)
    return _symmetric(i, i + 1, n, np.random.default_rng(seed))


def barbell_graph(path_len, block_n, block_deg, blocks=2, seed=0):
    """``blocks + 1`` paths of ``path_len`` vertices with a block between
    each two: path, block, path, ..., path, where a block is
    ``random_graph(block_n, block_deg)`` entered and left at its two
    vertices of highest degree.  Both directions, weights uniform(0.1, 1.0)
    from ``seed``.  From vertex 0 a traversal's rounds hold one vertex on
    the first path and up to most of a block inside it, so their width
    changes both ways ``blocks`` times."""
    us, vs = [], []
    start, last = 0, None  # the next free id; the vertex the next part hangs from
    for b in range(blocks + 1):
        p = np.arange(start, start + path_len)
        if last is not None:
            us.append(np.array([last]))
            vs.append(p[:1])
        us.append(p[:-1])
        vs.append(p[1:])
        last, start = p[-1], start + path_len
        if b == blocks:
            break
        g = random_graph(block_n, block_deg, seed=seed + 1 + b).tocoo()
        up = g.row < g.col
        us.append(g.row[up] + start)
        vs.append(g.col[up] + start)
        order = np.argsort(np.bincount(g.row, minlength=block_n), kind="stable")
        us.append(np.array([last]))
        vs.append(np.array([start + order[-1]]))
        last, start = start + order[-2], start + block_n
    return _symmetric(np.concatenate(us), np.concatenate(vs), start, np.random.default_rng(seed))


def skewed_graph(n=1 << 18, seed=7):
    """bench_suite.py:441-448: row i holds min(zipf(2.1) * 8, n // 4)
    uniform random columns, values uniform in [0, 1), float32; a repeated
    (row, column) keeps its last value, as ``csr_from_entries`` does."""
    rng = np.random.default_rng(seed)
    degs = np.minimum(rng.zipf(2.1, n) * 8, n // 4).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int32), degs)
    cols = rng.integers(0, n, rows.size, dtype=np.int32)
    vals = rng.random(rows.size, np.float32)
    key = rows.astype(np.int64) * n + cols
    order = np.argsort(key, kind="stable")
    last = order[np.r_[key[order][1:] != key[order][:-1], True]]
    return sp.csr_matrix((vals[last], (rows[last], cols[last])), shape=(n, n))


def hub_spgemm(n, seed=4, hub_len=1 << 16):
    """``(a, mask)``: rows of 8 random columns plus HUB_ROWS rows of
    ``hub_len`` drawn columns (duplicates summed, data 1, rows sorted), and
    a mask holding 2^16 random entries, 200 in each hub's row, 600 in the
    hubs' columns and the entries between hubs."""
    rng = np.random.default_rng(seed)
    hubs = np.linspace(0, n - 1, HUB_ROWS).astype(np.int64)
    rows = np.concatenate([rng.integers(0, n, 8 * n), np.repeat(hubs, hub_len)])
    cols = rng.integers(0, n, rows.size)
    a = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.data[:] = 1
    k = 1 << 16
    mr = np.concatenate([rng.integers(0, n, k), np.repeat(hubs, 200), rng.integers(0, n, 600),
                         np.repeat(hubs, HUB_ROWS)])
    mc = np.concatenate([rng.integers(0, n, k), rng.integers(0, n, 600), np.repeat(hubs, 200),
                         np.tile(hubs, HUB_ROWS)])
    mask = sp.coo_matrix((np.ones(mr.size, np.float32), (mr, mc)), shape=(n, n)).tocsr()
    mask.sum_duplicates()
    return a, mask


def spgemm_bins(n=2000, seed=40):
    """``(a, b)``, n x n, values uniform in [0.5, 1.5) (f32; rows sorted,
    duplicates summed): b's rows hold 4 random columns on average, 40 of
    them 300 draws; a's rows 4 random columns (A @ B's small rows), rows 9,
    21 and 33 have 60, 200 and 500 columns (medium rows for n >= 400) and
    rows 7 and 11 every column (large rows: all of b's products), row 13
    half of them."""
    rng = np.random.default_rng(seed)
    heavy = {7: n, 11: n, 13: n // 2, 9: 60, 21: 200, 33: 500}
    rows = np.concatenate([rng.integers(0, n, 4 * n), *(np.full(min(k, n), r) for r, k in heavy.items())])
    cols = np.concatenate([rng.integers(0, n, 4 * n),
                           *(rng.choice(n, min(k, n), replace=False) for k in heavy.values())])
    b_rows = np.concatenate([rng.integers(0, n, 4 * n), np.repeat(rng.integers(0, n, 40), 300)])
    b_cols = rng.integers(0, n, b_rows.size)
    out = []
    for r, c in ((rows, cols), (b_rows, b_cols)):
        m = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n)).tocsr()
        m.sum_duplicates()
        m.data = rng.uniform(0.5, 1.5, m.nnz).astype(np.float32)
        out.append(m)
    return tuple(out)


def _symmetric_csr(n, r, c):
    """The CSR of the int64 edges (r, c) both ways, self-loops and duplicates
    dropped, int32 ones, columns sorted, on their device."""
    dev = r.device
    keep = r != c
    r, c = r[keep], c[keep]
    keys = torch.unique(torch.cat([r * n + c, c * n + r]))
    del r, c, keep
    rows, cols = (keys // n).to(torch.int32), (keys % n).to(torch.int32)
    del keys
    nnz = rows.numel()
    indptr = torch.searchsorted(rows, torch.arange(n + 1, dtype=torch.int32, device=dev)).to(torch.int32)
    return CsrMatrix(shape=(n, n), indptr=indptr, cols=cols, values=torch.ones(nnz, dtype=torch.int32, device=dev),
                     row_ids=rows, nnz=torch.tensor(nnz, dtype=torch.int32, device=dev),
                     fill=torch.tensor(0, dtype=torch.int32, device=dev))


def uniform_csr(n, deg, device, seed=41):
    """A symmetric uniform random graph of about ``deg`` entries a row (n deg
    / 2 drawn edges), made on ``device``: GAP's urand at n = 2^24, deg 32."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    r = torch.randint(0, n, (n * deg // 2,), generator=g, device=device)
    c = torch.randint(0, n, r.shape, generator=g, device=device)
    return _symmetric_csr(n, r, c)


def kron_csr(scale, device, edge_factor=16, seed=43):
    """Graph500's Kronecker graph (A 0.57, B 0.19, C 0.19, no relabel) at
    ``scale``, made symmetric on ``device``: hubs of thousands of entries at
    the lowest vertex ids."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m = edge_factor << scale
    r = torch.zeros(m, dtype=torch.long, device=device)
    c = torch.zeros(m, dtype=torch.long, device=device)
    for _ in range(scale):
        u = torch.rand(m, generator=g, device=device)
        r = 2 * r + (u >= 0.76).long()  # C 0.19 and D 0.05: the lower half
        c = 2 * c + (((u >= 0.57) & (u < 0.76)) | (u >= 0.95)).long()  # B and D: the right half
    return _symmetric_csr(1 << scale, r, c)
