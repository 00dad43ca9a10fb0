"""Time profiling: a tree of named scopes with their times and counts
(counterpart of ``spla_tpu/profiling.py``).

The reference's TimeProfiler (``src/profiling/time_profiler.hpp:44-100``)
keeps static labels with parent links, RAII scopes and dump/reset
(``Library::time_profile_dump/reset``, ``src/library.cpp:184-196``).  Here
a scope is timed by the port's :class:`~spla_tpu_torch.timer.Timer`: with
CUDA events on a CUDA device, whose end the scope waits for, so a scope
blocks on the work queued inside it; with the host clock elsewhere.  Each
scope also opens ``torch.profiler.record_function(name)``, so a
``torch.profiler`` trace carries the same names.  Off by default, since
the wait defeats asynchronous launches.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from .timer import Timer

__all__ = ["TimeProfiler", "profiler", "time_profile_scope"]


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
            with torch.profiler.record_function(name):
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
