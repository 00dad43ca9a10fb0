"""Block-sparse (BSR) products (counterpart of ``spla_tpu/ops/bsr.py``):
``bsr_spmv`` and ``bsr_spmm`` over dense ``block x block`` tiles.

Each gathers x's (or X's) block rows by the stored blocks' columns, multiplies
every stored block by its slice in one batched product, and sums the
products into their block rows with ``index_add_`` (a dump row ``mb`` takes
the padding).  The accumulator is PLUS only, as in the reference.  A stored
block's unstored elements hold the fill and take part in the product.

f32 tiles multiply with ``torch.bmm`` in full f32: a call on CUDA tensors
raises while ``torch.backends.cuda.matmul.allow_tf32`` is set, since TF32
would change the results.  Integer tiles (cuBLAS has no integer batched
product) fold the tile's inner index in their own dtype, wrapping as the
JAX product does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..containers import BsrMatrix, DenseVec
from ..utils.segments import scalar_on

__all__ = ["bsr_spmv", "bsr_spmm"]


def _tile_products(blocks, xb):
    """``[E, bs, bs] @ [E, bs, k] -> [E, bs, k]`` in the tiles' dtype."""
    if blocks.is_floating_point():
        if blocks.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("bsr products are f32: unset torch.backends.cuda.matmul.allow_tf32 "
                               "(TF32 rounds the tiles' inputs to 10-bit mantissas)")
        return torch.bmm(blocks, xb)
    out = torch.zeros(blocks.shape[:2] + xb.shape[2:], dtype=blocks.dtype, device=blocks.device)
    for c in range(blocks.shape[2]):
        out += blocks[:, :, c, None] * xb[:, None, c, :]
    return out


def _block_row_sum(A: BsrMatrix, prod):
    """Sum each stored block's product ``[E, bs, k]`` into its block row:
    ``[mb, bs, k]``."""
    mb = A.block_shape[0]
    valid = A.valid_mask()
    prod = torch.where(valid[:, None, None], prod, 0)
    rows = torch.where(valid, A.row_ids, mb).long()
    out = torch.zeros((mb + 1,) + prod.shape[1:], dtype=prod.dtype, device=prod.device)
    return out.index_add_(0, rows, prod)[:mb]


def _block_slices(A: BsrMatrix, X):
    """X's rows padded to whole blocks, gathered by each stored block's
    column: ``[E, bs, k]``."""
    bs = A.block
    nb = A.block_shape[1]
    Xp = F.pad(X, (0, 0, 0, nb * bs - X.shape[0])).reshape(nb, bs, X.shape[1])
    return Xp[A.cols.clamp(0, nb - 1).long()]


def bsr_spmv(A: BsrMatrix, x, op_mul=None, op_add=None, init=0.0) -> torch.Tensor:
    """y = init + A @ x over (op_mul, PLUS): every stored block times its
    slice of x, summed by block row.  ``op_mul`` None or MULT is the tile
    product; any other elementwise ``op_mul(block, x_slice)`` is summed over
    the tile's columns."""
    add_name = getattr(op_add, "name", None)
    if not (op_add is None or add_name == "PLUS"):
        raise AssertionError(f"bsr_spmv accumulates PLUS only (got {add_name}); general monoids go "
                             "through the CSR SpMV (spla_tpu_torch.ops.mxv_masked)")
    if isinstance(x, DenseVec):
        x = x.values
    m = A.shape[0]
    xb = _block_slices(A, x[:, None])  # [E, bs, 1]
    if op_mul is None or getattr(op_mul, "name", None) == "MULT":
        prod = _tile_products(A.blocks, xb)
    else:
        prod = op_mul(A.blocks, xb.transpose(1, 2)).sum(2, keepdim=True, dtype=A.blocks.dtype)
    y = _block_row_sum(A, prod).reshape(-1)[:m]
    return (y + scalar_on(init, A.blocks.dtype, y.device)).to(A.blocks.dtype)


def bsr_spmm(A: BsrMatrix, X) -> torch.Tensor:
    """Y = A @ X for a dense X [n, k]: batched tile products, summed by block row."""
    mb = A.block_shape[0]
    Y = _block_row_sum(A, _tile_products(A.blocks, _block_slices(A, X)))
    return Y.reshape(mb * A.block, X.shape[1])[: A.shape[0]]
