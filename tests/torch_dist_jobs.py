"""Jobs that tests/test_torch_dist.py runs on every rank of a gloo world of
``spla_tpu_torch.parallel``.

The ranks are spawned processes that import this module to find a job, so
it imports neither jax nor spla_tpu (tests/conftest.py and the test files
do).  A job takes the rank's mesh and numpy inputs, builds the rank's
shard with ``interop.sharded_csr_from_numpy`` and returns numpy results;
ops travel by name.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spla_tpu_torch import op as OP
from spla_tpu_torch import parallel as P
from spla_tpu_torch.interop import sharded_csr_from_numpy, to_numpy
from spla_tpu_torch.parallel import comm, dist_ops


def _np(t):
    return t.detach().cpu().numpy()


def _shard(mesh, fields):
    return sharded_csr_from_numpy(fields, mesh.rank, mesh.device)


def mesh_info(mesh):
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend, "device": str(mesh.device),
            "axis_index": comm.axis_index(mesh),
            "rows": _np(P.gather_rows(mesh, torch.full((3,), mesh.rank, dtype=torch.int32,
                                                       device=mesh.device)))}


def collectives(mesh):
    """psum, pmax and a ring step of bool and float tensors."""
    r = mesh.rank
    x = torch.tensor([r + 1.0, -r], device=mesh.device)
    flags = torch.tensor([r % 2 == 0, True, False], device=mesh.device)
    moved = comm.ppermute(mesh, [x, flags])
    return {"psum": _np(comm.psum(mesh, x)), "pmax": _np(comm.pmax(mesh, x)), "ring": _np(moved[0]),
            "ring_flags": _np(moved[1]), "flags": _np(P.gather_rows(mesh, flags))}


def die(mesh, rank):
    """Rank ``rank`` exits; the others wait in a collective it never joins."""
    if mesh.rank == rank:
        os._exit(3)
    comm.psum(mesh, torch.ones(1, device=mesh.device))


def partition(mesh, kind, csr_fields, n_shards):
    """This rank's shard of a partitioner, made with the mesh."""
    from spla_tpu_torch.interop import csr_from_numpy

    a = csr_from_numpy(device="cpu", **csr_fields)
    if kind == "balanced":
        sc, old_of_new, new_of_old = P.shard_csr_by_rows_balanced(a, n_shards, mesh)
        return to_numpy(sc), old_of_new, new_of_old
    if kind == "split":
        return tuple(to_numpy(s) for s in P.shard_csr_split_diag(a, n_shards, mesh))
    return to_numpy(P.shard_csr_by_rows(a, n_shards, mesh))


def masked_spmv(mesh, fields, x_blocks, mul, add, init):
    A = _shard(mesh, fields)
    x = torch.from_numpy(np.array(x_blocks[mesh.rank])).to(mesh.device)
    return _np(P.dist_masked_spmv(mesh, A, x, getattr(OP, mul), getattr(OP, add), init))


def pagerank(mesh, fields, alpha, eps, off_fields=None):
    if off_fields is None:
        return _np(P.dist_pagerank(mesh, _shard(mesh, fields), alpha, eps))
    return _np(P.dist_pagerank_overlap(mesh, _shard(mesh, fields), _shard(mesh, off_fields), alpha, eps))


def traversal(mesh, kind, fields, source, frontier_cap):
    """dist_bfs / dist_sssp with stats, and the host reads of the loop."""
    fn = P.dist_bfs if kind == "bfs" else P.dist_sssp
    before = dist_ops.STATS["host_reads"]
    v, stats = fn(mesh, _shard(mesh, fields), source, frontier_cap=frontier_cap, with_stats=True)
    return _np(v), stats, dist_ops.STATS["host_reads"] - before


def pallas(mesh, name, cell_fields, *args, **kwargs):
    """A ``dist_*_pallas`` function (``_overlap`` ones take the split pair)."""
    sc = _shard(mesh, cell_fields)
    shards = sc if isinstance(sc, tuple) else (sc,)
    return _np(getattr(P, name)(mesh, *shards, *args, **kwargs))


def mxm(mesh, a_fields, b_fields, mul, add, init, **kwargs):
    R = P.dist_mxm(mesh, _shard(mesh, a_fields), _shard(mesh, b_fields), getattr(OP, mul), getattr(OP, add),
                   init, **kwargs)
    return to_numpy(R)


def mxmT_reduce(mesh, mask_fields, a_fields, b_fields, mul, add, select, init, products_cap=None):
    return P.dist_mxmT_masked_reduce(mesh, _shard(mesh, mask_fields), _shard(mesh, a_fields),
                                     _shard(mesh, b_fields), getattr(OP, mul), getattr(OP, add),
                                     getattr(OP, select), init, products_cap=products_cap)


def tc(mesh, fields):
    return P.dist_tc(mesh, _shard(mesh, fields))


def caps(mesh, a_fields, b_fields):
    A, B = _shard(mesh, a_fields), _shard(mesh, b_fields)
    return P.count_dist_mxm_cap(mesh, A, B), P.count_dist_mxmT_cap(mesh, A, B)


def small_stats(mesh):
    """dist_bfs / dist_sssp stats on ``tools.dist_times.SMALL``'s graphs."""
    from spla_tpu_torch.tools import dist_times as DT

    mats = DT.graphs(DT.SMALL, mesh.device)
    sh = {k: P.shard_csr_by_rows(mats[k], mesh.size, mesh) for k in ("bfs", "sssp", "road")}
    return {name: DT.CALLS[name](mesh, sh)[1] for name in ("bfs", "sssp", "road_bfs")}
