"""The sharded layer (counterpart of ``spla_tpu/parallel``): the world of
ranks, block-row sharded CSR, the collective SpMV and the distributed graph
algorithms and SpGEMM, on ``torch.distributed`` (NCCL between cards, gloo
between host processes).

Each rank is a process.  Every rank calls a function with its ``Mesh``
(``make_device_mesh``; ``spawn_world`` starts the ranks) and its own
shard, and gets its own ``[mloc]`` rows back, where the JAX package's
single controller gets the global ``[S, mloc]`` array; ``gather_rows``
rebuilds the padded global vector on every rank.  Each rank's SpMV is
kernel 1 and ``dist_tc``'s intersection kernel 4, on CUDA tensors.
"""

from .mesh import Mesh, World, make_device_mesh, spawn_world
from .comm import gather_rows
from .dist_matrix import (
    ShardedCsr,
    shard_csr_by_rows,
    shard_csr_by_rows_balanced,
    shard_csr_split_diag,
    shard_vector_by_rows,
)
from .dist_ops import (
    dist_bfs,
    dist_masked_spmv,
    dist_pagerank,
    dist_pagerank_overlap,
    dist_sssp,
)
from .dist_cell import (
    ShardedCellSpmv,
    dist_bfs_pallas,
    dist_bfs_pallas_overlap,
    dist_pagerank_pallas,
    dist_pagerank_pallas_overlap,
    dist_sssp_pallas,
    dist_sssp_pallas_overlap,
    shard_cell_spmv,
    shard_cell_spmv_split,
)
from .dist_spgemm import (
    count_dist_mxm_cap,
    count_dist_mxmT_cap,
    dist_mxm,
    dist_mxmT_masked_reduce,
    dist_tc,
)

__all__ = [
    "make_device_mesh",
    "ShardedCsr",
    "shard_csr_by_rows",
    "shard_csr_by_rows_balanced",
    "shard_csr_split_diag",
    "shard_vector_by_rows",
    "dist_masked_spmv",
    "dist_pagerank",
    "dist_pagerank_overlap",
    "dist_bfs",
    "dist_sssp",
    "ShardedCellSpmv",
    "shard_cell_spmv",
    "dist_pagerank_pallas",
    "dist_bfs_pallas",
    "dist_sssp_pallas",
    "dist_pagerank_pallas_overlap",
    "dist_bfs_pallas_overlap",
    "dist_sssp_pallas_overlap",
    "shard_cell_spmv_split",
    "dist_mxm",
    "dist_mxmT_masked_reduce",
    "dist_tc",
    "count_dist_mxm_cap",
    "count_dist_mxmT_cap",
    "Mesh",
    "World",
    "spawn_world",
    "gather_rows",
]
