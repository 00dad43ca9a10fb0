"""Kernel 3: the BFS / SSSP level update with frontier compaction (``csrc/level_update.cu``).

Replaces ``spla_tpu/pallas/spmv.py`` ``_level_update`` (:2789) and its
callers ``bfs_level_update`` / ``sssp_level_update`` and the chunk-sparse
``bfs_level_update_auto`` / ``sssp_level_update_auto`` (:2925, :2858), in
one pass over the state:

* BFS:  ``v' = front ? depth : v``;  ``front' = hits and v' == 0``;
* SSSP: ``v' = min(v, hits)``;  ``changed = v' < v``.

Both also write the count and the compacted index list of the new frontier
(or changed set); the SSSP feedback vector of the reference, ``changed ?
v' : +inf``, is carried as the pair (``v'``, ``changed``).  ``v`` and the
frontier / changed mask are updated in place; the list's order varies
between runs, its content and every result do not.

``bfs_level_update`` / ``sssp_level_update`` keep a plain list and an int32
count.  The level loop's pull levels call ``bfs_pull_update`` /
``sssp_pull_update`` on a run's ``frontier.LevelState``: the same pass,
appending to the next list with its degree offsets and size word, zeroing
the word of the level after (and, for BFS, keeping the push levels'
visited bitmap).  The frontier-proportional counterpart of the ``_auto``
updates is the push levels' (``traversal``); the SSSP push level's second
launch is this kernel's update of the touched vertices.
"""

from __future__ import annotations

import torch

from ..op import MIN_FLOAT
from . import LAUNCHES
from .build import check, load_library
from .frontier import LevelState, write_next_plain

__all__ = ["bfs_level_update", "bfs_level_update_plain", "sssp_level_update",
           "sssp_level_update_plain", "bfs_update_plain", "sssp_update_plain", "bfs_pull_update",
           "bfs_pull_update_plain", "sssp_pull_update", "sssp_pull_update_plain"]


def _check(what, tensors: dict, n: int, dtypes: dict) -> None:
    device = tensors["v"].device
    if device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {device}")
    for name, t in tensors.items():
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous tensor on {device}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{what}: {name} must be {dtypes[name]}, got {t.dtype}")
        want = (1,) if name == "count" else (n,)
        if t.shape != want:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want {want}")
    if n >= 2**31:
        raise ValueError(f"{what}: {n} vertices exceed int32 list indices")


def _write_list(new, lst, count):
    idx = torch.nonzero(new).flatten().to(torch.int32)
    lst[: idx.shape[0]] = idx
    count.fill_(idx.shape[0])


def bfs_update_plain(hits, v, front, depth: int):
    """In place: ``v`` and ``front`` become the next level's; returns the
    new frontier's mask."""
    v.copy_(torch.where(front, depth, v))
    new = hits & (v == 0)
    front.copy_(new)
    return new


def sssp_update_plain(hits, v, changed):
    """In place: ``v = min(v, hits)``, ``changed`` its decreased entries;
    returns them."""
    new_v = MIN_FLOAT(v, hits)
    new = new_v < v
    v.copy_(new_v)
    changed.copy_(new)
    return new


def bfs_level_update_plain(hits, v, front, depth: int, lst, count) -> None:
    _write_list(bfs_update_plain(hits, v, front, depth), lst, count)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def bfs_level_update(hits, v, front, depth: int, lst, count) -> None:
    """In place: ``v`` (int32 depths), ``front`` (bool) become the next
    level's; ``lst[:count]`` lists the new frontier (``count`` int32 [1])."""
    if v.device.type == "cpu":
        return bfs_level_update_plain(hits, v, front, depth, lst, count)
    n = v.shape[0]
    _check("bfs_level_update", {"hits": hits, "v": v, "front": front, "lst": lst, "count": count},
           n, {"hits": torch.bool, "v": torch.int32, "front": torch.bool, "lst": torch.int32,
               "count": torch.int32})
    rc = load_library().spla_bfs_level_update(n, hits.data_ptr(), v.data_ptr(), front.data_ptr(),
                                              int(depth), lst.data_ptr(), count.data_ptr(), 0, None,
                                              None, None, None, _stream(v))
    check(rc, "bfs_level_update")
    LAUNCHES["level_update"] += 1


def sssp_level_update_plain(hits, v, changed, lst, count) -> None:
    _write_list(sssp_update_plain(hits, v, changed), lst, count)


def sssp_level_update(hits, v, changed, lst, count) -> None:
    """In place: ``v`` (f32 distances) = min(v, hits); ``changed`` (bool)
    marks the decreased entries, ``lst[:count]`` lists them."""
    if v.device.type == "cpu":
        return sssp_level_update_plain(hits, v, changed, lst, count)
    n = v.shape[0]
    _check("sssp_level_update",
           {"hits": hits, "v": v, "changed": changed, "lst": lst, "count": count}, n,
           {"hits": torch.float32, "v": torch.float32, "changed": torch.bool,
            "lst": torch.int32, "count": torch.int32})
    rc = load_library().spla_sssp_level_update(n, hits.data_ptr(), v.data_ptr(), changed.data_ptr(),
                                               lst.data_ptr(), count.data_ptr(), 0, None, None, None,
                                               _stream(v))
    check(rc, "sssp_level_update")
    LAUNCHES["level_update"] += 1


# ---------------------------------------------------------------- the level loop's pull levels


def _next_args(S: LevelState):
    """The next list's slots, offsets and size word, and the word to clear."""
    L, P, row = S.level, S.ptr, 4 * S.n
    words = P["words"]
    return (P["lists"] + (L + 1) % 2 * row, words + 8 * ((L + 1) % 3),
            P["eoff"] + (L + 1) % 2 * row, words + 8 * ((L + 2) % 3))


def bfs_pull_update_plain(S: LevelState, hits) -> None:
    write_next_plain(S, bfs_update_plain(hits, S.v, S.mask, S.level + 1))


def bfs_pull_update(S: LevelState, hits) -> None:
    """A BFS pull level's update at depth ``S.level + 1``: ``hits`` is the
    pull's result (``S.pull_out``)."""
    if S.v.device.type == "cpu":
        return bfs_pull_update_plain(S, hits)
    lst, word, eoff, clear = _next_args(S)
    P = S.ptr
    rc = load_library().spla_bfs_level_update(S.n, hits.data_ptr(), P["v"], P["mask"], S.level + 1, lst,
                                              word, 1, eoff, P["indptr"], P["vis"], clear, _stream(S.v))
    check(rc, "bfs_pull_update")
    LAUNCHES["level_update"] += 1
    S.level += 1


def sssp_pull_update_plain(S: LevelState, hits) -> None:
    write_next_plain(S, sssp_update_plain(hits, S.v, S.mask))


def sssp_pull_update(S: LevelState, hits) -> None:
    """An SSSP pull level's update: ``hits`` is the pull's result
    (``S.pull_out``)."""
    if S.v.device.type == "cpu":
        return sssp_pull_update_plain(S, hits)
    lst, word, eoff, clear = _next_args(S)
    P = S.ptr
    rc = load_library().spla_sssp_level_update(S.n, hits.data_ptr(), P["v"], P["mask"], lst, word, 1, eoff,
                                               P["indptr"], clear, _stream(S.v))
    check(rc, "sssp_pull_update")
    LAUNCHES["level_update"] += 1
    S.level += 1
