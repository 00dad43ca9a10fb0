"""Kernel 6: a whole BFS or SSSP in one cooperative launch (``csrc/resident.cu``),
and its plain versions.

Replaces ``spla_tpu/pallas/spmv.py`` ``_resident_call`` (:2659) as reached
through ``bfs_resident`` (:2709) and ``sssp_resident`` (:2716).  The CUDA
source's header says what bounds the kernel and how it is laid out.

For a square ``A`` (CSR(A), the push orientation: a frontier vertex i
reaches the columns j of row i) and a ``source``:

* ``bfs_resident`` returns the int32 depths (source 1, unreachable 0);
* ``sssp_resident`` returns the f32 distances (unreachable +inf) of
  Bellman-Ford where only the vertices whose distance fell in the last round
  relax in the next (``src/algorithm.cpp:158-229``).

Both also return ``stats``, an int32 tensor ``[rounds, capped]`` on the
tensors' device: the rounds run (BFS: the deepest level) and 1 when the cap
of ``n + 2`` rounds stopped a non-empty queue (a negative cycle).  Nothing
is read on the host: the caller reads ``stats`` once per run.  The plain
versions walk the same queue in torch, synchronously, and read its length on
the host every round; for SSSP their round count may exceed the kernel's,
whose rounds see decreases made earlier in the same round.
"""

from __future__ import annotations

import ctypes

import torch

from ..containers import CsrMatrix
from . import LAUNCHES
from .build import check, load_library
from .spmv import _on_cpu, _require_cuda
from .traversal import _frontier_entries

__all__ = ["bfs_resident", "bfs_resident_plain", "sssp_resident", "sssp_resident_plain",
           "resident_blocks"]

MAX_VERTICES = 2**31 - 4  # round + 1 <= n + 3 must fit an int32 stamp


def _stats(rounds: int, capped: bool, device) -> torch.Tensor:
    return torch.tensor([rounds, int(capped)], dtype=torch.int32, device=device)


def bfs_resident_plain(A: CsrMatrix, source: int):
    """The level-synchronous queue BFS in torch: ``(v, stats)``."""
    n = A.shape[0]
    device = A.cols.device
    v = torch.zeros(n, dtype=torch.int32, device=device)
    v[source] = 1
    queue = torch.tensor([source], dtype=torch.int32, device=device)
    rounds = 0
    while queue.numel() > 0 and rounds < n + 2:
        rounds += 1
        _, e = _frontier_entries(A, queue)
        j = A.cols[e].long()
        j = torch.unique(j[v[j] == 0])
        v[j] = rounds + 1
        queue = j.to(torch.int32)
    return v, _stats(rounds, queue.numel() > 0, device)


def sssp_resident_plain(A: CsrMatrix, source: int):
    """Synchronous Bellman-Ford over the queue of decreased vertices in
    torch: ``(d, stats)``.  ``A`` holds f32 weights."""
    n = A.shape[0]
    device = A.values.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    d = inf.expand(n).clone()
    d[source] = 0.0
    queue = torch.tensor([source], dtype=torch.int32, device=device)
    rounds = 0
    while queue.numel() > 0 and rounds < n + 2:
        rounds += 1
        src, e = _frontier_entries(A, queue)
        hits = inf.expand(n).clone().scatter_reduce(0, A.cols[e].long(), d[src] + A.values[e],
                                                    "amin")
        new_d = torch.minimum(d, hits)
        queue = torch.nonzero(new_d < d).flatten().to(torch.int32)
        d = new_d
    return d, _stats(rounds, queue.numel() > 0, device)


def _check_square(what, A: CsrMatrix, source: int) -> int:
    n, m = A.shape
    if n != m:
        raise ValueError(f"{what}: needs a square matrix, got {A.shape}")
    if not 0 <= source < n:
        raise ValueError(f"{what}: source {source} outside [0, {n})")
    if n > MAX_VERTICES:
        raise ValueError(f"{what}: {n} vertices exceed int32 queues")
    _require_cuda(what, A, {}, {})
    return n


def _scratch(n: int, device):
    queues = torch.empty(2 * n, dtype=torch.int32, device=device)
    counters = torch.zeros(3, dtype=torch.int32, device=device)
    stats = torch.empty(2, dtype=torch.int32, device=device)
    return queues, counters, stats


def bfs_resident(A: CsrMatrix, source: int):
    """Kernel 6, BFS: ``(v, stats)`` as in the module docstring."""
    if _on_cpu(A.cols):
        return bfs_resident_plain(A, source)
    what = "bfs_resident"
    n = _check_square(what, A, source)
    device = A.cols.device
    v = torch.zeros(n, dtype=torch.int32, device=device)
    queues, counters, stats = _scratch(n, device)
    rc = load_library().spla_bfs_resident(
        n, source, A.indptr.data_ptr(), A.cols.data_ptr(), v.data_ptr(), queues.data_ptr(),
        counters.data_ptr(), stats.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    check(rc, what)
    LAUNCHES["bfs_resident"] += 1
    return v, stats


def sssp_resident(A: CsrMatrix, source: int):
    """Kernel 6, SSSP (MIN over PLUS, f32): ``(d, stats)``.  The weights
    must be finite: the caller routes other graphs to the level loop."""
    if _on_cpu(A.values):
        return sssp_resident_plain(A, source)
    what = "sssp_resident"
    n = _check_square(what, A, source)
    if A.values.dtype != torch.float32:
        raise TypeError(f"{what}: needs f32 weights, got {A.values.dtype}")
    device = A.values.device
    d = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    stamps = torch.zeros(n, dtype=torch.int32, device=device)
    queues, counters, stats = _scratch(n, device)
    rc = load_library().spla_sssp_resident(
        n, source, A.indptr.data_ptr(), A.cols.data_ptr(), A.values.data_ptr(), d.data_ptr(),
        stamps.data_ptr(), queues.data_ptr(), counters.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    check(rc, what)
    LAUNCHES["sssp_resident"] += 1
    return d, stats


def resident_blocks(kind: str) -> int:
    """CTAs in one launch of kernel 6 on the current CUDA device (the
    occupancy limit times the SM count)."""
    blocks = ctypes.c_int(0)
    check(load_library().spla_resident_blocks(int(kind == "sssp"), ctypes.addressof(blocks)),
          f"{kind}_resident grid")
    return blocks.value
