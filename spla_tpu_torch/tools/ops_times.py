"""The op layer (``ops.v_*``, ``ops.m_*``, ``ops.kron``, ``ops.bsr_*``: plain
PyTorch, no kernel of their own) at the sizes of ``chip_smoke.py``'s ``ops``
slice, which builds its inputs and calls with this module; one JSON line
an op.

* A: ``graphs.build_graph(2**21, 16)``'s entries (``bench.py:37``) with
  rows sorted by column and duplicate (row, column) pairs summed, at its
  capacity of 33,554,432; Aᵀ = ``m_transpose(A)``; the longest row and
  column;
* kron's operands: ``random_graph(2**11, 16, seed=7)`` and B, 1,024 x 1,024
  with 1,024 entries (n = 2^21);
* sparse vectors u, v of 2^17 entries at n = 2^21, dense d (a third of it
  at the fill, 0) and d2; values in [0.5, 1.5);
* a band of half-width 64 at n = 2^17 in 128-tiles, x and X of 64 columns.

Each op's time a call (CUDA events, 5 calls after one), the bytes and f32
operations its function needs (``work``: inputs' stored data read once,
outputs written once) and one call under ``torch.profiler``: its wall, the
device's busy time, the idle share and the device time and count of each
kernel by name (``mxm_times.profiled``).

Usage::

    python -m spla_tpu_torch.tools.ops_times
"""

from __future__ import annotations

import json

import numpy as np
import scipy.sparse as sp
import torch

from .. import formats as F, op, ops as O
from ..containers import DenseVec
from .graphs import build_graph, random_graph
from .mxm_times import cuda_ms, profiled
from .resident_levels import card

N, DEG = 1 << 21, 16  # bench.py:37
N_VEC_NNZ = 1 << 17
N_KRON, DEG_KRON, SEED_KRON, N_KRON_B = 1 << 11, 16, 7, 1024
N_BAND, HALF_BAND, BLOCK, SPMM_COLS = 1 << 17, 64, 128, 64


def build_inputs(device, graph=None) -> dict:
    """The inputs on ``device`` (``graph``: ``build_graph(N, DEG)``'s
    ``(indptr, rows, cols, vals)`` if the caller has it), with their scipy
    and numpy forms for the oracles: ``A``/``A_sp``, ``row``, ``col``,
    ``KronA``/``KronA_sp``, ``KronB``/``KronB_sp``, ``Vec`` (u, v, d, d2, x,
    X) / ``Vec_np``, ``Band``/``Band_sp``.  ``At`` and ``band`` are left to
    the caller: they are op results (``m_transpose``, ``bsr_from_csr_host``)."""
    _, rows, cols, vals = graph if graph is not None else build_graph(N, DEG)
    a = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
    a.sum_duplicates()
    I = {"A_sp": a, "A": F.csr_from_scipy(a, capacity=rows.size, device=device),
         "row": int(np.argmax(np.diff(a.indptr))), "col": int(np.argmax(np.bincount(a.indices, minlength=N)))}
    rng = np.random.default_rng(31)
    ka = random_graph(N_KRON, DEG_KRON, seed=SEED_KRON)
    flat = rng.choice(N_KRON_B * N_KRON_B, N_KRON_B, replace=False)
    kb = sp.csr_matrix((rng.uniform(0.5, 1.5, N_KRON_B).astype(np.float32),
                        (flat // N_KRON_B, flat % N_KRON_B)), shape=(N_KRON_B, N_KRON_B))
    I.update(KronA_sp=ka, KronB_sp=kb, KronA=F.csr_from_scipy(ka, device=device),
             KronB=F.csr_from_scipy(kb, device=device))
    V = {"iu": rng.choice(N, N_VEC_NNZ, replace=False), "iv": rng.choice(N, N_VEC_NNZ, replace=False),
         "vu": rng.uniform(0.5, 1.5, N_VEC_NNZ).astype(np.float32),
         "vv": rng.uniform(0.5, 1.5, N_VEC_NNZ).astype(np.float32),
         "d": np.where(rng.random(N) < 1 / 3, 0, rng.uniform(0.5, 1.5, N)).astype(np.float32),
         "d2": rng.uniform(0.5, 1.5, N).astype(np.float32),
         "x": rng.uniform(0.5, 1.5, N_BAND).astype(np.float32),
         "X": rng.uniform(0.5, 1.5, (N_BAND, SPMM_COLS)).astype(np.float32)}
    zero = torch.zeros((), device=device)
    I["Vec_np"] = V
    I["Vec"] = {"u": F.sparse_vec_from_entries(N, V["iu"], V["vu"], dtype=np.float32, device=device),
                "v": F.sparse_vec_from_entries(N, V["iv"], V["vv"], dtype=np.float32, device=device),
                "d": DenseVec(torch.from_numpy(V["d"]).to(device), zero),
                "d2": DenseVec(torch.from_numpy(V["d2"]).to(device), zero),
                "x": torch.from_numpy(V["x"]).to(device), "X": torch.from_numpy(V["X"]).to(device)}
    offs = np.arange(-HALF_BAND, HALF_BAND + 1)
    br = np.repeat(np.arange(N_BAND), offs.size)
    bc = br + np.tile(offs, N_BAND)
    keep = (bc >= 0) & (bc < N_BAND)
    band = sp.csr_matrix((rng.uniform(0.5, 1.5, int(keep.sum())).astype(np.float32), (br[keep], bc[keep])),
                         shape=(N_BAND, N_BAND))
    I.update(Band_sp=band, Band=F.csr_from_scipy(band, device=device))
    return I


def calls(I) -> dict:
    """The calls by name: the matrix ops on A and Aᵀ, the kron, the vector
    chain (``v_eadd`` also sparse with dense, ``v_eadd_fdb``, ``v_reduce``
    and ``v_count_mf`` also dense) and the BSR products."""
    A, At, V, band = I["A"], I["At"], I["Vec"], I["band"]
    u, v, d, d2 = V["u"], V["v"], V["d"], V["d2"]
    return {
        "m_transpose": lambda: O.m_transpose(A, op.IDENTITY_FLOAT),
        "m_eadd": lambda: O.m_eadd(A, At, op.PLUS_FLOAT),
        "m_emult": lambda: O.m_emult(A, At, op.MIN_FLOAT),
        "m_reduce_by_row": lambda: O.m_reduce_by_row(A, op.PLUS_FLOAT, 0.0),
        "m_reduce_by_column": lambda: O.m_reduce_by_column(A, op.PLUS_FLOAT, 0.0),
        "m_extract_row": lambda: O.m_extract_row(A, I["row"], op.IDENTITY_FLOAT),
        "m_extract_column": lambda: O.m_extract_column(A, I["col"], op.IDENTITY_FLOAT),
        "kron": lambda: O.kron(I["KronA"], I["KronB"], op.MULT_FLOAT),
        "v_eadd": lambda: O.v_eadd(u, v, op.PLUS_FLOAT),
        "v_eadd sparse-dense": lambda: O.v_eadd(u, d, op.MIN_FLOAT),
        "v_emult": lambda: O.v_emult(u, v, op.MULT_FLOAT),
        "v_map": lambda: O.v_map(u, op.AINV_FLOAT),
        "v_assign_masked": lambda: O.v_assign_masked(d, u, 0.25, op.SECOND_FLOAT, op.GTZERO_FLOAT),
        "v_eadd_fdb": lambda: O.v_eadd_fdb(d, v, op.MIN_FLOAT),
        "v_eadd_fdb dense": lambda: O.v_eadd_fdb(d, d2, op.MIN_FLOAT),
        "v_reduce": lambda: O.v_reduce(0.0, u, op.PLUS_FLOAT),
        "v_reduce dense": lambda: O.v_reduce(0.0, d, op.PLUS_FLOAT),
        "v_count_mf": lambda: O.v_count_mf(u),
        "v_count_mf dense": lambda: O.v_count_mf(d),
        "bsr_spmv": lambda: O.bsr_spmv(band, V["x"]),
        "bsr_spmm": lambda: O.bsr_spmm(band, V["X"]),
    }


def work(I, R) -> dict:
    """``(bytes, f32 operations)`` of each call's function, given its results
    ``R``: its inputs' stored data read once and its outputs written once (a
    CSR: row pointers, columns and values, and an output's row ids; a
    vector: indices and values, or n slots); the BSR products' operations."""
    A, At, V, b = I["A"], I["At"], I["Vec"], I["band"]
    nnz, nu, nv = int(A.nnz), int(V["u"].nnz), int(V["v"].nnz)

    def csr_in(M):
        return 4 * (M.shape[0] + 1) + 8 * int(M.nnz)

    def csr_out(M):
        return csr_in(M) + 4 * int(M.nnz)

    E, bs = int(b.nnzb), b.block
    tiles = 4 * E * bs * bs + 4 * E + 4 * (b.block_shape[0] + 1)
    row, col = R["m_extract_row"], R["m_extract_column"]
    return {
        "m_transpose": (csr_in(A) + csr_out(R["m_transpose"]), 0),
        "m_eadd": (csr_in(A) + csr_in(At) + csr_out(R["m_eadd"]), 0),
        "m_emult": (csr_in(A) + csr_in(At) + csr_out(R["m_emult"]), 0),
        "m_reduce_by_row": (4 * (N + 1) + 4 * nnz + 4 * N, 0),
        "m_reduce_by_column": (8 * nnz + 4 * N, 0),
        "m_extract_row": (8 + 8 * int(row.nnz) + 8 * row.capacity, 0),
        "m_extract_column": (4 * (N + 1) + 8 * int(col.nnz) + 8 * col.capacity, 0),
        "kron": (csr_in(I["KronA"]) + csr_in(I["KronB"]) + csr_out(R["kron"]), 0),
        "v_eadd": (8 * (nu + nv) + 8 * R["v_eadd"].capacity, 0),
        "v_eadd sparse-dense": (8 * nu + 4 * N + 8 * R["v_eadd sparse-dense"].capacity, 0),
        "v_emult": (8 * (nu + nv) + 8 * R["v_emult"].capacity, 0),
        "v_map": (4 * nu + 4 * V["u"].capacity, 0),
        "v_assign_masked": (8 * N + 8 * nu, 0),
        "v_eadd_fdb": (8 * N + 8 * nv + 8 * V["v"].capacity, 0),
        "v_eadd_fdb dense": (16 * N, 0),
        "v_reduce": (4 * nu + 4, 0),
        "v_reduce dense": (4 * N + 4, 0),
        "v_count_mf": (8, 0),
        "v_count_mf dense": (4 * N + 4, 0),
        "bsr_spmv": (tiles + 8 * N_BAND, 2 * E * bs * bs),
        "bsr_spmm": (tiles + 8 * N_BAND * SPMM_COLS, 2 * E * bs * bs * SPMM_COLS),
    }


def library(I) -> dict:
    """``{op: (label, call)}``: one PyTorch call computing the same function
    (cuSPARSE behind it), for ``m_transpose``, ``m_eadd`` PLUS and ``bsr_spmm``."""
    def csr_tensor(M):
        k = int(M.nnz)
        return torch.sparse_csr_tensor(M.indptr, M.cols[:k], M.values[:k], size=M.shape)

    L, LT, b = csr_tensor(I["A"]), csr_tensor(I["At"]), I["band"]
    Lb = torch.sparse_bsr_tensor(b.indptr, b.cols[:int(b.nnzb)], b.blocks[:int(b.nnzb)], size=b.shape)
    return {"m_transpose": ("to_sparse_csc()", lambda: L.to_sparse_csc()),
            "m_eadd": ("A + B (CSR)", lambda: L + LT),
            "bsr_spmm": ("sparse_bsr_tensor @ X", lambda: Lb @ I["Vec"]["X"])}


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("ops_times times the op layer on a CUDA device; there is none")
    device = torch.device("cuda")
    smi = card()
    I = build_inputs(device)
    I["At"] = O.m_transpose(I["A"], op.IDENTITY_FLOAT)
    I["band"] = F.bsr_from_csr_host(I["Band"], block=BLOCK)
    fns = calls(I)
    R = {name: fn() for name, fn in fns.items()}
    for name, (nbytes, flops) in work(I, R).items():
        print(json.dumps({"op": name, "ms": cuda_ms(fns[name], 5), "bytes": nbytes, "f32_operations": flops,
                          "profiled": profiled(fns[name]), "card": smi}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
