"""What the benchmark takes from the program (``spla_tpu_torch``): its CSR, built
on the device from the benchmark's sorted COO by the program's own
``formats.coo_to_csr``, and its counters.  The reference modules never
import this one."""

from __future__ import annotations

import torch


def csr(graph, values: torch.Tensor, fill: float):
    """The program's CsrMatrix of ``graph`` with ``values`` (one an entry)."""
    from spla_tpu_torch.containers import CooMatrix
    from spla_tpu_torch.formats import coo_to_csr

    device = graph.device
    coo = CooMatrix(shape=(graph.n, graph.n), rows=graph.rows, cols=graph.cols, values=values,
                    nnz=torch.tensor(graph.nnz, dtype=torch.int32, device=device),
                    fill=torch.tensor(fill, dtype=values.dtype, device=device))
    return coo_to_csr(coo)


def counters() -> dict:
    """A copy of the program's counters: ``algorithms.STATS`` (levels, push and
    pull levels, host reads, routes) and ``kernels.LAUNCHES`` (launches a kernel)."""
    from spla_tpu_torch import algorithms, kernels

    return {"stats": dict(algorithms.STATS), "launches": dict(kernels.LAUNCHES)}


def counters_since(before: dict) -> dict:
    now = counters()
    return {group: {k: v - before[group].get(k, 0) for k, v in now[group].items()} for group in now}


def build_kernels() -> None:
    """Build (at a checkout's first run) and load the program's CUDA library,
    under ``build/`` in the checkout."""
    from spla_tpu_torch.kernels.build import load_library

    load_library()
