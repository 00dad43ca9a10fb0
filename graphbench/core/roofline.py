"""The table of peaks and the bytes and operations a kernel's work needs.

A roofline share is the least time the chip could take for the work, the
larger of its bytes over the memory rate and its operations over the
compute rate, over the time the device took.  Inputs count once, read, and
outputs once, written, whatever a kernel reads again.
"""

from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM5 (80 GB HBM3), dense rates, at its 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12, "f32_flops_s": 67e12},
}


def bound_s(nbytes: float, flops: float, peaks: dict) -> tuple:
    """``(seconds, by)``: the larger of the bytes over the memory rate and the
    f32 operations over the f32 rate, and which of the two it is."""
    by_bytes, by_ops = nbytes / peaks["hbm_bytes_s"], flops / peaks["f32_flops_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def spmv_pull_work(m: int, n: int, nnz: int) -> tuple:
    """``(bytes, flops)`` of one full (MULT, PLUS) f32 pull y = A x over an m x n
    CSR: indptr, cols, values and x read once, y written once; a multiply and
    an add an entry."""
    return 4 * (m + 1) + 8 * nnz + 4 * n + 4 * m, 2 * nnz
