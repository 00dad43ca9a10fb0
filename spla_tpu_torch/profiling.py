"""Time profiling: a tree of named scopes with their times and counts
(counterpart of ``spla_tpu/profiling.py``).

The reference's TimeProfiler (``src/profiling/time_profiler.hpp:44-100``)
keeps static labels with parent links, RAII scopes and dump/reset
(``Library::time_profile_dump/reset``, ``src/library.cpp:184-196``).  Here
a scope is timed by the port's :class:`~spla_tpu_torch.timer.Timer`: with
CUDA events on a CUDA device, whose end the scope waits for, so a scope
blocks on the work queued inside it; with the host clock elsewhere.  Each
scope also opens :func:`span`, so a ``torch.profiler`` trace carries the
same names.  Off by default, since the wait defeats asynchronous launches.

:func:`span` is the port's one way to name a range in a ``torch.profiler``
trace.  While the profiler records it opens a ``RecordFunction`` range
in the profiler's session, which shares the clock of the device's events;
otherwise it returns one shared no-op context, which costs one flag check
and no dispatcher call.  The range is torch's fast one
(``torch._C._profiler._RecordFunctionFast``), not
``torch.profiler.record_function``: that one enters and leaves through
two dispatcher ops, each profiled in turn, which on the H100's host made
the traced window's idle time a level a third to three quarters longer
in the BFS cells (``PERF.md``).  Besides the time profiler's scopes it
names, in ``algorithms.py``:

* ``spla.bfs``, ``spla.sssp``, ``spla.pr``: a whole public call; its
  ``args`` are a per-process query number, kept as the range's keyword
  input ``args`` where the profiler records inputs (``record_shapes``);
  the spans below nest in it;
* ``spla.level.push``, ``spla.level.pull``: one level's host work, from
  the direction chosen to the return of its last launch (PageRank: its
  pull and the add, an iteration a ``spla.level.pull``);
* ``spla.level.read``: the loop's host read (the frontier's count word,
  PageRank's step norm made and read, the resident route's round count).

The benchmark reads them among a trace's host operations
(``graphbench/core/spans.py``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import torch

from .timer import Timer

__all__ = ["TimeProfiler", "profiler", "span", "time_profile_scope"]

_recording = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_OFF = nullcontext()


def span(name: str, args=None):
    """A range named ``name`` in a ``torch.profiler`` trace, with ``args``
    as its keyword input ``args``; while no profiler records, a shared
    no-op context."""
    if not _recording():
        return _OFF
    return _range(name) if args is None else _range(name, (), {"args": args})


@dataclass
class _Label:
    name: str
    parent: str | None = None
    total_ms: float = 0.0
    count: int = 0


class TimeProfiler:
    def __init__(self):
        self._labels: dict[str, _Label] = {}
        self._stack = threading.local()
        # opt in with Library.set_time_profiling(True) or profiler.enabled = True
        self.enabled = False

    def _stk(self):
        if not hasattr(self._stack, "s"):
            self._stack.s = []
        return self._stack.s

    @contextmanager
    def scope(self, name: str, device=None):
        """A timed scope (reference TIME_PROFILE_SCOPE), nested under the
        scope open around it; ``device`` picks the timer (CUDA events on a
        CUDA device, else the host clock)."""
        if not self.enabled:
            yield
            return
        stk = self._stk()
        parent = stk[-1] if stk else None
        lbl = self._labels.setdefault(name, _Label(name, parent))
        stk.append(name)
        timer = Timer(device)
        timer.start()
        try:
            with span(name):
                yield
        finally:
            timer.stop()
            lbl.total_ms += timer.get_elapsed_ms()
            lbl.count += 1
            stk.pop()

    def dump(self) -> str:
        """The scope tree with each scope's ms and count (reference time_profile_dump)."""
        lines = ["-- time profile --"]

        def emit(lbl, depth):
            lines.append(f"{'  ' * depth}{lbl.name}: {lbl.total_ms:.3f} ms (x{lbl.count})")
            for child in self._labels.values():
                if child.parent == lbl.name:
                    emit(child, depth + 1)

        for root in [lbl for lbl in self._labels.values() if lbl.parent is None]:
            emit(root, 1)
        return "\n".join(lines)

    def reset(self):
        self._labels.clear()

    def stats(self) -> dict:
        return {k: {"ms": v.total_ms, "count": v.count, "parent": v.parent}
                for k, v in self._labels.items()}


profiler = TimeProfiler()


def time_profile_scope(name: str, device=None):
    return profiler.scope(name, device)
