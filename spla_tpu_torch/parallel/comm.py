"""Collectives over a ``Mesh``: the counterparts of ``lax.all_gather(...,
tiled=True)``, ``lax.psum``, ``lax.pmax``, ``lax.ppermute`` and
``lax.axis_index`` inside the JAX package's ``shard_map``.

In an NCCL world the tensors go to NCCL as they are.  In a gloo world,
gloo being a host transport, a CUDA tensor is copied to pinned host memory,
the collective runs there and the result is copied back to the device:
always, by design, and counted in ``COMM_STATS["staged_bytes"]``.  The
kernels still run on the card; the transport is the caller's choice.  Bool
tensors travel as bytes.

``COMM_STATS`` counts the calls and the bytes each rank's collectives
deliver to it (the gathered or reduced output, the received buffers).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["COMM_STATS", "reset_comm_stats", "axis_index", "all_gather", "gather_rows", "psum", "pmax",
           "ppermute", "Pending"]

COMM_STATS = {"calls": 0, "bytes": 0, "staged_bytes": 0}


def reset_comm_stats() -> None:
    for k in COMM_STATS:
        COMM_STATS[k] = 0


def axis_index(mesh: Mesh) -> int:
    """This rank's index on the mesh axis."""
    return mesh.rank


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _wire(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)  # waits for the stream: gloo reads the host copy at once
    COMM_STATS["staged_bytes"] += t.numel() * t.element_size()
    return host


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    COMM_STATS["staged_bytes"] += host.numel() * host.element_size()
    return host.to(device, non_blocking=True)


def _count(out: torch.Tensor) -> None:
    COMM_STATS["calls"] += 1
    COMM_STATS["bytes"] += out.numel() * out.element_size()


class Pending:
    """An asynchronous collective's result: ``wait()`` returns it, on the
    input's device; on a CUDA stream, later work is ordered after it."""

    def __init__(self, work, finish):
        self._work, self._finish = work, finish

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._finish()


def all_gather(mesh: Mesh, t: torch.Tensor, async_op: bool = False):
    """Every rank's 1-D ``t`` concatenated in rank order (``lax.all_gather``
    with ``tiled=True``), on every rank.  With ``async_op`` returns a
    ``Pending``: the collective runs while the caller issues other work."""
    wire = _wire(t)
    staged = _staged(mesh, wire)
    src = _to_host(wire) if staged else wire
    out = torch.empty(mesh.size * src.numel(), dtype=src.dtype, device=src.device, pin_memory=staged)
    work = dist.all_gather_into_tensor(out, src, group=mesh.group, async_op=async_op)
    _count(out)

    def finish():
        res = _to_device(out, t.device) if staged else out
        return res.view(torch.bool) if t.dtype == torch.bool else res

    return Pending(work, finish) if async_op else finish()


gather_rows = all_gather  # the padded global vector of a row-sharded one, on every rank


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    staged = _staged(mesh, t)
    buf = _to_host(t) if staged else t.clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    _count(buf)
    return _to_device(buf, t.device) if staged else buf


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on every rank (``lax.psum``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def pmax(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The largest ``t`` over the ranks, on every rank (``lax.pmax``)."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def ppermute(mesh: Mesh, tensors) -> list:
    """One step of a ring: each rank sends ``tensors`` to rank ``r - 1`` and
    receives rank ``r + 1``'s (``lax.ppermute`` with the permutation ``[(p,
    p - 1)]``), as new tensors of the same shapes and dtypes; every rank's
    must agree.  A world of one keeps its own."""
    if mesh.size == 1:
        return list(tensors)
    wires = [_wire(t) for t in tensors]
    staged = _staged(mesh, wires[0]) if wires else False
    send = [_to_host(w) if staged else w for w in wires]
    recv = [torch.empty_like(w, pin_memory=staged) if staged else torch.empty_like(w) for w in send]
    to, frm = (mesh.rank - 1) % mesh.size, (mesh.rank + 1) % mesh.size
    ops = [dist.P2POp(dist.isend, w, to, group=mesh.group) for w in send]
    ops += [dist.P2POp(dist.irecv, w, frm, group=mesh.group) for w in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = []
    for t, w in zip(tensors, recv):
        _count(w)
        res = _to_device(w, t.device) if staged else w
        out.append(res.view(torch.bool) if t.dtype == torch.bool else res)
    return out
