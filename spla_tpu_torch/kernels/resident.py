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

Both also return ``stats``, an int32 tensor ``[rounds, capped, wide]`` on
the tensors' device: the rounds run (BFS: the deepest level), 1 when the
cap of ``n + 2`` rounds stopped a non-empty queue (a negative cycle), and
the rounds whose queue held more than ``resident_plan(A).wide_above``
vertices, which the kernel runs on the whole grid rather than on its lead
cluster.  Nothing is read on the host but the plan, once per matrix: the
caller reads ``stats`` once per run.  The plain versions walk the same
queue in torch, synchronously, and read its length on the host every round;
for SSSP their round count may exceed the kernel's, whose rounds see
decreases made earlier in the same round.

``_launch_bfs`` and ``_launch_sssp`` launch the kernel with T given as an
argument: they are the entry for the card tests and for
``tools/resident_levels.py --every-round-wide``, which run it with T = 0.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..containers import CsrMatrix
from ..formats import derived
from ..op import MIN_FLOAT
from ..utils.segments import segment_fold
from . import LAUNCHES
from .build import check, load_library
from .spmv import _on_cpu, _require_cuda, team_size
from .traversal import _frontier_entries

__all__ = ["bfs_resident", "bfs_resident_plain", "sssp_resident", "sssp_resident_plain",
           "ResidentPlan", "resident_plan", "resident_grid", "CTA_THREADS", "LEAD_CTAS"]

MAX_VERTICES = 2**31 - 4  # round + 1 <= n + 3 must fit an int32 stamp
CTA_THREADS = 1024  # kept equal to csrc/resident.cu kResidentThreads
LEAD_CTAS = 8  # kept equal to kLeadCtas: the lead cluster, which walks the narrow rounds


@dataclass(frozen=True)
class ResidentPlan:
    """Kernel 6's shape for one ``indptr``: ``team`` lanes G walk each queued
    vertex (kernel 1's rule, ``spmv.team_size``, from the mean out-degree),
    and a round whose queue holds more than ``wide_above`` vertices (T, the
    lead cluster's teams: ``LEAD_CTAS * CTA_THREADS // team``) runs on the
    whole grid."""

    team: int
    wide_above: int


def resident_plan(A: CsrMatrix) -> ResidentPlan:
    """The plan of A's ``indptr``, a fact of the indptr tensor; its entry
    count is read on the host once, at the first call."""
    return derived(resident_plan, (A.indptr,), lambda: _resident_plan(A))


def _resident_plan(A: CsrMatrix) -> ResidentPlan:
    team = team_size(int(A.indptr[-1]), A.shape[0])
    return ResidentPlan(team, LEAD_CTAS * CTA_THREADS // team)


def _stats(rounds: int, capped: bool, wide: int, device) -> torch.Tensor:
    return torch.tensor([rounds, int(capped), wide], dtype=torch.int32, device=device)


def bfs_resident_plain(A: CsrMatrix, source: int):
    """The level-synchronous queue BFS in torch: ``(v, stats)``."""
    n = A.shape[0]
    device = A.cols.device
    wide_above = resident_plan(A).wide_above
    v = torch.zeros(n, dtype=torch.int32, device=device)
    v[source] = 1
    queue = torch.tensor([source], dtype=torch.int32, device=device)
    rounds = wide = 0
    while queue.numel() > 0 and rounds < n + 2:
        rounds += 1
        wide += queue.numel() > wide_above
        _, e = _frontier_entries(A, queue)
        j = A.cols[e].long()
        j = torch.unique(j[v[j] == 0])
        v[j] = rounds + 1
        queue = j.to(torch.int32)
    return v, _stats(rounds, queue.numel() > 0, wide, device)


def sssp_resident_plain(A: CsrMatrix, source: int):
    """Synchronous Bellman-Ford over the queue of decreased vertices in
    torch: ``(d, stats)``.  ``A`` holds f32 weights."""
    n = A.shape[0]
    device = A.values.device
    wide_above = resident_plan(A).wide_above
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    d = inf.expand(n).clone()
    d[source] = 0.0
    queue = torch.tensor([source], dtype=torch.int32, device=device)
    rounds = wide = 0
    while queue.numel() > 0 and rounds < n + 2:
        rounds += 1
        wide += queue.numel() > wide_above
        src, e = _frontier_entries(A, queue)
        hits, _ = segment_fold(d[src] + A.values[e], A.cols[e], torch.ones_like(e, dtype=torch.bool), n,
                               MIN_FLOAT, inf, sorted_ids=False)
        new_d = MIN_FLOAT(d, hits)
        queue = torch.nonzero(new_d < d).flatten().to(torch.int32)
        d = new_d
    return d, _stats(rounds, queue.numel() > 0, wide, device)


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
    """The two queues; the three tails and the epoch word, zero; stats."""
    queues = torch.empty(2 * n, dtype=torch.int32, device=device)
    counters = torch.zeros(4, dtype=torch.int32, device=device)
    stats = torch.empty(3, dtype=torch.int32, device=device)
    return queues, counters, stats


def _launch_bfs(A: CsrMatrix, source: int, wide_above: int):
    what = "bfs_resident"
    n = _check_square(what, A, source)
    device = A.cols.device
    team = resident_plan(A).team
    v = torch.zeros(n, dtype=torch.int32, device=device)
    queues, counters, stats = _scratch(n, device)
    rc = load_library().spla_bfs_resident(
        n, source, team.bit_length() - 1, wide_above, A.indptr.data_ptr(), A.cols.data_ptr(),
        v.data_ptr(), queues.data_ptr(), counters.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    check(rc, what)
    LAUNCHES["bfs_resident"] += 1
    return v, stats


def _launch_sssp(A: CsrMatrix, source: int, wide_above: int):
    what = "sssp_resident"
    n = _check_square(what, A, source)
    if A.values.dtype != torch.float32:
        raise TypeError(f"{what}: needs f32 weights, got {A.values.dtype}")
    device = A.values.device
    team = resident_plan(A).team
    d = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    stamps = torch.zeros(n, dtype=torch.int32, device=device)
    queues, counters, stats = _scratch(n, device)
    rc = load_library().spla_sssp_resident(
        n, source, team.bit_length() - 1, wide_above, A.indptr.data_ptr(), A.cols.data_ptr(),
        A.values.data_ptr(), d.data_ptr(), stamps.data_ptr(), queues.data_ptr(),
        counters.data_ptr(), stats.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    check(rc, what)
    LAUNCHES["sssp_resident"] += 1
    return d, stats


def bfs_resident(A: CsrMatrix, source: int):
    """Kernel 6, BFS: ``(v, stats)`` as in the module docstring."""
    if _on_cpu(A.cols):
        return bfs_resident_plain(A, source)
    return _launch_bfs(A, source, resident_plan(A).wide_above)


def sssp_resident(A: CsrMatrix, source: int):
    """Kernel 6, SSSP (MIN over PLUS, f32): ``(d, stats)``.  The weights
    must be finite: the caller routes other graphs to the level loop."""
    if _on_cpu(A.values):
        return sssp_resident_plain(A, source)
    return _launch_sssp(A, source, resident_plan(A).wide_above)


def resident_grid(kind: str, team: int) -> tuple[int, int, int]:
    """``(ctas, cluster, registers)`` of kernel 6's ``kind`` ("bfs" or
    "sssp") instance for teams of ``team`` lanes on the current CUDA device:
    the CTAs of one launch (whole clusters at the occupancy limit), the
    lead cluster's CTAs and the registers a thread."""
    out = [ctypes.c_int(0) for _ in range(3)]
    check(load_library().spla_resident_grid(int(kind == "sssp"), team.bit_length() - 1,
                                            *(ctypes.addressof(o) for o in out)),
          f"{kind}_resident grid")
    return tuple(o.value for o in out)
