"""The world of ranks (counterpart of ``spla_tpu/parallel/mesh.py``).

JAX runs one controller over a ``jax.sharding.Mesh`` of devices.  PyTorch
runs one process a rank under ``torch.distributed``: NCCL between cards,
gloo between host processes.  A rank's ``Mesh`` holds its process group,
its rank, the world's size, the device its shards live on and the backend.

``make_device_mesh`` gives the current world's mesh, and starts a world of
one rank in this process when none is running.  ``spawn_world`` starts the
ranks of a larger world as processes (``torch.multiprocessing``, spawn),
runs one function on every rank and returns each rank's result; ``World``
keeps them running for several jobs.  The function is sent by import path,
so it must live in a module that imports no jax.  Every process group and
every wait has a timeout: a rank that dies or hangs fails the call.
"""

from __future__ import annotations

import contextlib
import datetime
import queue
import socket
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["Mesh", "World", "make_device_mesh", "spawn_world"]

TIMEOUT_S = 60.0  # a process group's collectives, and a job's wait for its ranks
POLL_S = 0.2  # how often a waiting parent looks for a rank that died


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D world: the collectives of ``comm`` run over
    ``group`` (None: the default group) and move tensors of ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = "d"

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(backend, init_method, rank, size, timeout_s):
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_device_mesh(n_devices: int | None = None, axis: str = "d", *, device,
                     timeout_s: float = TIMEOUT_S) -> Mesh:
    """This rank's mesh over the running world, its shards on ``device``.

    With no world running, starts one of a single rank in this process
    (NCCL for a CUDA device, gloo for the CPU); a larger world is started
    by ``spawn_world`` or by the caller's own ``init_process_group``.
    ``n_devices``, if given, must be the world's size."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"no world is running: start one of {n_devices} ranks with spawn_world")
        _init("nccl" if device.type == "cuda" else "gloo", f"tcp://localhost:{_free_port()}", 0, 1,
              timeout_s)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the world has {size} ranks, not {n_devices}")
    backend = str(dist.get_backend())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL world needs CUDA devices, got {device}")
    return Mesh(None, dist.get_rank(), size, device, backend, axis)


def _rank_main(rank, size, backend, device, init_method, timeout_s, threads, jobs, results):
    """A spawned rank: join the world, then run ``(fn, args, kwargs)`` jobs until a None."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        _init(backend, init_method, rank, size, timeout_s)
        mesh = make_device_mesh(size, device=device)
    except Exception:  # the parent raises it; this rank cannot go on
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while (job := jobs.get()) is not None:
            fn, args, kwargs = job
            try:
                results.put((rank, True, fn(mesh, *args, **kwargs)))
            except Exception:  # reported to the parent, which fails the job
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``size`` spawned ranks of one ``backend`` world, rank r on
    ``devices[r]`` (default: the CPU), each with ``threads`` torch threads
    if given.  ``run(fn, *args, **kwargs)`` calls ``fn(mesh, *args, **kwargs)``
    on every rank and returns the results by rank; a rank that raises, dies or passes
    ``timeout_s`` closes the world and fails the call.  Close it with
    ``close()`` or a ``with`` block."""

    def __init__(self, size: int, backend: str = "gloo", devices=None, timeout_s: float = TIMEOUT_S,
                 threads: int | None = None):
        devices = [torch.device("cpu")] * size if devices is None else [torch.device(d) for d in devices]
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        self.size, self.timeout_s = size, timeout_s
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        init_method = f"tcp://localhost:{_free_port()}"
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, size, backend, devices[r], init_method, timeout_s, threads,
                                         self._jobs[r], self._results))
                       for r in range(size)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        if self._procs is None:
            raise RuntimeError("the world is closed")
        for q in self._jobs:
            q.put((fn, args, kwargs))
        out = [None] * self.size
        got = 0
        deadline = time.monotonic() + self.timeout_s
        while got < self.size:
            try:
                rank, ok, value = self._results.get(timeout=POLL_S)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    self.close()
                    why = f"rank {dead[0]} exited" if dead else f"no result in {self.timeout_s} s"
                    raise RuntimeError(f"world of {self.size} ranks failed: {why}") from None
                continue
            if not ok:
                self.close()
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            got += 1
        return out

    def close(self) -> None:
        if self._procs is None:
            return
        procs, self._procs = self._procs, None
        for p, q in zip(procs, self._jobs):
            if p.is_alive():
                q.put(None)
            q.cancel_join_thread()  # a rank that died never reads its queue
        deadline = time.monotonic() + 10.0
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            # drain what the ranks still write, or a rank's exit can wait on its queue
            with contextlib.suppress(queue.Empty):
                while True:
                    self._results.get_nowait()
            for p in procs:
                p.join(timeout=POLL_S / len(procs))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def spawn_world(fn, world_size: int, backend: str = "gloo", devices=None, args=(),
                timeout_s: float = TIMEOUT_S, threads: int | None = None) -> list:
    """Start ``world_size`` ranks, run ``fn(mesh, *args)`` on each and return
    the results by rank (see ``World``).  Build the CUDA kernels in the
    parent first (``kernels.build.load_library()``), or every rank builds
    them."""
    with World(world_size, backend, devices, timeout_s, threads) as world:
        return world.run(fn, *args)
