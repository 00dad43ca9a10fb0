"""The sharded layer (``spla_tpu_torch.parallel``) on one world: every dist
function once, with what each launched and read, and its wall.

``graphs(spec, device)`` makes the global inputs from seeds (the graphs of
``bench.py`` / ``bench_suite.py`` at the sizes ``spec`` gives);
``shard_all(mesh, mats)`` cuts this rank's shards of them;
``run_all(mesh, shards)`` calls each function once and returns, by name,
this rank's result (numpy), the kernel launches (``kernels.LAUNCHES``),
the dispatch counts (``ops.DISPATCH_STATS``), the loop's host reads and
iterations (``parallel.dist_ops.STATS``), the bytes its collectives moved
(``parallel.comm.COMM_STATS``) and, for BFS and SSSP, the stats dict;
``time_all`` gives each function's wall (host clock around a call that
ends in a synchronize, every rank starting together, median of 3 after
one; the largest over the ranks).  ``rank_job(mesh, spec, timed)`` does all
of it on a rank of a ``parallel.World`` (whose ranks import this module,
which imports no jax): ``parallel.spawn_world(rank_job, 4, "gloo",
["cuda:0"] * 4, args=(SMALL, True))`` is ``chip_smoke.py``'s part (b).  A
gloo world on CUDA tensors stages every collective through host memory,
so its walls are no measure of scaling.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import formats as F, kernels, op as OP
from .. import parallel as P
from ..ops.spmv import DISPATCH_STATS
from ..parallel import comm, dist_ops
from .graphs import random_graph, road_grid

__all__ = ["SMALL", "JAX_STATS_S4", "graphs", "shard_all", "CALLS", "run_all", "time_all", "rank_job"]

# the 4-rank gloo world's inputs: bench_suite.py's random graph (:24) cut to n = 2^17, a road grid of
# side 256 (:226, cut) and mxm_mprod_s's graph (:528)
SMALL = {"n": 1 << 17, "deg": 16, "road": 256, "mxm_n": 1 << 13}
# spla_tpu.parallel's stats on SMALL's graphs at S = 4 from vertex 0 with the default ladder (its CPU
# run; tests/test_torch_dist.py::test_small_graphs_stats_equal_the_recorded_jax_stats holds both)
JAX_STATS_S4 = {"bfs": {"comm_bytes": 303104, "sparse_levels": 5, "levels": 7},
                "sssp": {"comm_bytes": 5464064, "sparse_rounds": 9, "rounds": 17},
                "road_bfs": {"comm_bytes": 6375424, "sparse_levels": 511, "levels": 511}}
ALPHA, EPS = 0.85, 1e-6


def graphs(spec: dict, device) -> dict:
    """The global CsrMatrix inputs of ``run_all`` on ``device``, from seeds:
    ``bfs``/``tc`` the pattern (int32) of ``random_graph(n, deg)``, ``sssp``
    the transpose (the pull matrix, as ``dist_sssp`` takes) of its weights
    uniform(0.1, 2.0) from seed 2 (fill +inf), ``pr`` the graph
    scaled by 0.85 / out-degree (also ``spmv``'s matrix), ``road`` the
    side-``road`` grid and ``mxm`` ``random_graph(mxm_n, 16, seed=5)`` with
    values uniform(0.5, 1.5) from seed 11."""
    a = random_graph(spec["n"], spec["deg"])
    aw = a.copy()
    aw.data = np.random.default_rng(2).uniform(0.1, 2.0, a.nnz).astype(np.float32)
    outdeg = np.asarray(a.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1
    pr = a.multiply(0.85 / outdeg).tocsr().astype(np.float32)
    mx = random_graph(spec["mxm_n"], 16, seed=5)
    mx.data = np.random.default_rng(11).uniform(0.5, 1.5, mx.nnz).astype(np.float32)
    pattern = F.csr_from_scipy(a.astype(np.int32), device=device)
    return {"spmv": F.csr_from_scipy(pr, device=device), "pr": F.csr_from_scipy(pr, device=device),
            "bfs": pattern, "tc": pattern, "sssp": F.csr_from_scipy(aw.T.tocsr(), fill=np.float32(np.inf), device=device),
            "road": F.csr_from_scipy(road_grid(spec["road"]), device=device),
            "mxm": F.csr_from_scipy(mx, device=device)}


def shard_all(mesh, mats: dict) -> dict:
    """This rank's shards of ``mats`` (host partitioning), and its block of
    ``spmv``'s x (uniform [0, 1) from seed 1).  A ``tc_big`` entry, if
    given, is a second triangle count."""
    S = mesh.size
    sh = {k: P.shard_csr_by_rows(mats[k], S, mesh) for k in ("spmv", "pr", "bfs", "sssp", "road", "tc", "mxm")}
    sh["pr_split"] = P.shard_csr_split_diag(mats["pr"], S, mesh)
    sh["pr_cell"] = P.shard_cell_spmv(mats["pr"], S, mesh)
    sh["pr_cell_split"] = P.shard_cell_spmv_split(mats["pr"], S, mesh)
    sh["bfs_cell"] = P.shard_cell_spmv(mats["bfs"], S, mesh, values=1.0)
    sh["bfs_cell_split"] = P.shard_cell_spmv_split(mats["bfs"], S, mesh, values=1.0)
    sh["sssp_cell"] = P.shard_cell_spmv(mats["sssp"], S, mesh)
    sh["sssp_cell_split"] = P.shard_cell_spmv_split(mats["sssp"], S, mesh)
    if "tc_big" in mats:
        sh["tc_big"] = P.shard_csr_by_rows(mats["tc_big"], S, mesh)
    n = mats["spmv"].shape[0]
    x = np.random.default_rng(1).random(n, dtype=np.float32)
    sh["x"] = P.shard_vector_by_rows(x, S, sh["spmv"].mloc, mesh)
    return sh


CALLS = {
    "spmv": lambda m, s: P.dist_masked_spmv(m, s["spmv"], s["x"], OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0),
    "pr": lambda m, s: P.dist_pagerank(m, s["pr"], ALPHA, EPS),
    "pr_overlap": lambda m, s: P.dist_pagerank_overlap(m, *s["pr_split"], ALPHA, EPS),
    "pr_pallas": lambda m, s: P.dist_pagerank_pallas(m, s["pr_cell"], ALPHA, EPS),
    "pr_pallas_overlap": lambda m, s: P.dist_pagerank_pallas_overlap(m, *s["pr_cell_split"], ALPHA, EPS),
    "bfs": lambda m, s: P.dist_bfs(m, s["bfs"], 0, with_stats=True),
    "bfs_pallas": lambda m, s: P.dist_bfs_pallas(m, s["bfs_cell"], 0),
    "bfs_pallas_overlap": lambda m, s: P.dist_bfs_pallas_overlap(m, *s["bfs_cell_split"], 0),
    "sssp": lambda m, s: P.dist_sssp(m, s["sssp"], 0, with_stats=True),
    "sssp_pallas": lambda m, s: P.dist_sssp_pallas(m, s["sssp_cell"], 0),
    "sssp_pallas_overlap": lambda m, s: P.dist_sssp_pallas_overlap(m, *s["sssp_cell_split"], 0),
    "road_bfs": lambda m, s: P.dist_bfs(m, s["road"], 0, with_stats=True),
    "tc": lambda m, s: P.dist_tc(m, s["tc"]),
    "tc_big": lambda m, s: P.dist_tc(m, s["tc_big"]),
    "mxm": lambda m, s: P.dist_mxm(m, s["mxm"], s["mxm"], OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0),
}


def _numpy(out):
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    if isinstance(out, P.ShardedCsr):
        k = int(out.nnz)
        return {f: getattr(out, f)[:k].cpu().numpy() for f in ("row_ids", "cols", "values")}
    return out


def _counts():
    return (dict(kernels.LAUNCHES), dict(DISPATCH_STATS), dict(dist_ops.STATS), dict(comm.COMM_STATS))


def _delta(after, before):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def run_all(mesh, sh: dict) -> dict:
    """Each function of ``CALLS`` whose shards ``sh`` holds, once."""
    out = {}
    for name, call in CALLS.items():
        if name == "tc_big" and "tc_big" not in sh:
            continue
        before = _counts()
        res = call(mesh, sh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        launches, dispatch, loop, moved = (_delta(a, b) for a, b in zip(_counts(), before))
        stats = None
        if isinstance(res, tuple):
            res, stats = res
        out[name] = {"result": _numpy(res), "stats": stats, "launches": launches, "dispatch": dispatch,
                     "host_reads": loop.get("host_reads", 0), "iterations": loop.get("iterations", 0),
                     "comm": moved}
    return out


def _wall(mesh, fn) -> float:
    comm.psum(mesh, torch.zeros(1, device=mesh.device))  # the ranks start together
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return (time.perf_counter() - t0) * 1e3


def time_all(mesh, sh: dict, names) -> dict:
    """Each named call's wall in ms: the median of 3 after one, the largest
    over the ranks."""
    out = {}
    for name in names:
        fn = lambda: CALLS[name](mesh, sh)  # noqa: E731
        fn()
        walls = sorted(_wall(mesh, fn) for _ in range(3))
        out[name] = float(comm.pmax(mesh, torch.tensor([walls[1]], device=mesh.device)).item())
    return out


def rank_job(mesh, spec: dict, timed: bool = False) -> dict:
    """``run_all`` (and, if ``timed``, ``time_all``) on this rank's shards of
    ``graphs(spec)``; what every rank returns to the parent."""
    sh = shard_all(mesh, graphs(spec, mesh.device))
    kernels.reset_launches()
    out = {"calls": run_all(mesh, sh)}
    if timed:
        out["ms"] = time_all(mesh, sh, [k for k in CALLS if k in out["calls"]])
    return out

