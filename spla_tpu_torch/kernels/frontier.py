"""The BFS / SSSP level loop's state, allocated once a run (``csrc/frontier.cuh``).

A level reads the current frontier list and writes the next one.  The two
lists are double-buffered; beside each listed vertex lies ``eoff``, the
out-degrees in CSR(A) (the push matrix) of the vertices listed before it,
so that a push can cut the list's edges into equal pieces.  A list's size
is one int64 word, ``(k << 32) | E``: k vertices, E edges.  Three words
rotate: level L's list is counted in word L % 3, it fills word (L + 1) % 3,
and zeroes word (L + 2) % 3 for the level after, which the host read at
level L - 1; so no level launches anything to clear a count, and the loop
reads one word a level.

The state also holds the loop's dense vectors (BFS: ``v`` and ``front``;
SSSP: ``v`` and ``changed``) and the scratch of the kernels: the visited
bitmap of BFS's push levels (a bit a vertex: visited or in the frontier),
SSSP's ``hits`` (+inf between levels), its touched list and the touched
list's two counts (a push level P fills count P % 2 and zeroes the other),
and the pull levels' outputs.  Kernels 2 (``traversal``: the push levels)
and 3 (``level_update``: the pull levels' update) keep all of it right in
place, so either kind of level can follow either.  On CPU tensors the plain
versions keep the lists, their offsets, the words and the dense vectors,
and no kernel scratch is made.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..containers import CsrMatrix

__all__ = ["LevelState", "bfs_state", "sssp_state", "degree_offsets", "read_count", "write_next_plain"]


@dataclass
class LevelState:
    A: CsrMatrix  # CSR(A), the push matrix (f32 values for SSSP)
    n: int
    lists: torch.Tensor  # int32 [2, n]
    eoff: torch.Tensor  # int32 [2, n]
    words: torch.Tensor  # int64 [3]: (k << 32) | E
    v: torch.Tensor  # BFS: int32 depths; SSSP: f32 distances
    mask: torch.Tensor  # bool [n]: BFS's front, SSSP's changed
    pull_out: torch.Tensor  # the pull level's result: BFS bool hits, SSSP f32
    row_sel: torch.Tensor | None = None  # BFS: bool [n], v == 0 on a pull level
    vis: torch.Tensor | None = None  # BFS on CUDA: int32 [ceil(n / 32)]
    hits: torch.Tensor | None = None  # SSSP on CUDA: f32 [n], +inf between levels
    touched: torch.Tensor | None = None  # SSSP on CUDA: int32 [n]
    tcount: torch.Tensor | None = None  # SSSP on CUDA: int32 [2]
    ptr: dict | None = None  # CUDA: the data pointers the launches take, read once
    level: int = 0  # L: the level that runs next
    pushes: int = 0  # SSSP: push levels run
    k: int = 1  # the current list's vertices
    edges: int = 0  # and their edges
    walked: int = 0  # the edges of the list the last level walked (each read sets it)


def degree_offsets(indptr: torch.Tensor, lst: torch.Tensor):
    """``(eoff, E)``: the out-degrees of ``lst``'s vertices listed before
    each one (int32), and their sum."""
    f = lst.long()
    ip = indptr.long()
    deg = ip[f + 1] - ip[f]
    csum = torch.cumsum(deg, 0)
    total = int(csum[-1]) if csum.numel() else 0
    return (csum - deg).to(torch.int32), total


def _new(A: CsrMatrix, source: int, v, mask, pull_out) -> LevelState:
    n = A.shape[0]
    device = v.device
    if A.shape != (n, n):
        raise ValueError(f"the level loop needs a square matrix, got {tuple(A.shape)}")
    if device.type == "cuda":
        if A.indptr.dtype != torch.int32 or A.cols.dtype != torch.int32:
            raise TypeError("the level loop's kernels need int32 CSR indices")
        if A.indptr.device != device or not (A.indptr.is_contiguous() and A.cols.is_contiguous()
                                             and A.values.is_contiguous()):
            raise ValueError(f"the push matrix must be contiguous and on {device}")
        if A.cols.shape[0] >= 2**31:
            raise ValueError("a list's edges must fit the low 31 bits of its size word")
    lists = torch.empty(2, n, dtype=torch.int32, device=device)
    eoff = torch.empty(2, n, dtype=torch.int32, device=device)
    lists[0, 0] = source
    eoff[0, 0] = 0
    words = torch.zeros(3, dtype=torch.int64, device=device)
    ip = A.indptr
    words[0:1] = (ip[source + 1:source + 2] - ip[source:source + 1]).long() + (1 << 32)
    mask[source] = True
    return LevelState(A, n, lists, eoff, words, v, mask, pull_out)


def bfs_state(A: CsrMatrix, source: int) -> LevelState:
    """A BFS run's state from ``source``: depths 0, the frontier {source}."""
    n = A.shape[0]
    device = A.indptr.device
    S = _new(A, source, torch.zeros(n, dtype=torch.int32, device=device),
             torch.zeros(n, dtype=torch.bool, device=device),
             torch.empty(n, dtype=torch.bool, device=device))
    S.row_sel = torch.empty(n, dtype=torch.bool, device=device)
    if device.type == "cuda":
        S.vis = torch.zeros((n + 31) // 32, dtype=torch.int32, device=device)
        bit = 1 << (source % 32)
        S.vis[source // 32] = bit - (1 << 32) if bit >= 1 << 31 else bit
    return _pointers(S)


def sssp_state(A: CsrMatrix, source: int) -> LevelState:
    """An SSSP run's state from ``source``: distances +inf but 0 at the
    source, which is the changed set."""
    n = A.shape[0]
    device = A.indptr.device
    v = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    v[source] = 0.0
    S = _new(A, source, v, torch.zeros(n, dtype=torch.bool, device=device),
             torch.empty(n, dtype=torch.float32, device=device))
    if device.type == "cuda":
        S.hits = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
        S.touched = torch.empty(n, dtype=torch.int32, device=device)
        S.tcount = torch.zeros(2, dtype=torch.int32, device=device)
    return _pointers(S)


def _pointers(S: LevelState) -> LevelState:
    """The kernels' data pointers, read once a run (CUDA only)."""
    if S.v.device.type == "cuda":
        named = {"lists": S.lists, "eoff": S.eoff, "words": S.words, "v": S.v, "mask": S.mask,
                 "indptr": S.A.indptr, "cols": S.A.cols, "values": S.A.values, "vis": S.vis,
                 "hits": S.hits, "touched": S.touched, "tcount": S.tcount}
        S.ptr = {k: t.data_ptr() for k, t in named.items() if t is not None}
    return S


def read_count(S: LevelState) -> int:
    """The loop's host read: the size word of the list the last level
    wrote; returns its vertex count.  The first read (after level 0) takes
    word 0 in the same copy: the source's list, which level 1 is the one
    to clear, so that ``S.walked`` holds the source's degree."""
    if S.level == 1:
        first, word = S.words[:2].tolist()
        S.walked = first & 0xFFFFFFFF
    else:
        word = int(S.words[S.level % 3])
        S.walked = S.edges
    S.k, S.edges = word >> 32, word & 0xFFFFFFFF
    return S.k


def write_next_plain(S: LevelState, new) -> None:
    """The plain versions' append: the vertices where ``new``, in order,
    become level L's next list, with their degree offsets and size word;
    the word after is zeroed; the level advances."""
    L = S.level
    nxt = torch.nonzero(new).flatten().to(torch.int32)
    k = nxt.shape[0]
    eoff, total = degree_offsets(S.A.indptr, nxt)
    S.lists[(L + 1) % 2, :k] = nxt
    S.eoff[(L + 1) % 2, :k] = eoff
    S.words[(L + 1) % 3] = (k << 32) | total
    S.words[(L + 2) % 3] = 0
    S.level = L + 1
