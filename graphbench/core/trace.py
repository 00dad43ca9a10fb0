"""The traced run's reading of the device: ``torch.profiler`` over the whole
window, reduced to intervals.

* busy: the union of the device's kernel, copy and memset intervals inside
  the window (a span named ``WINDOW`` that the loop runs in);
* idle gaps: the window less the busy union, each named by the innermost
  host operation that was running at its midpoint on the loop's thread
  (``"python"`` where none was);
* device operations by name, for the per-layer readers and the breakdown.

The arithmetic (``union``, ``gaps``, ``innermost``, ``top``) is plain Python
over ``(start, end)`` pairs, so the tests can hold it to hand-made values.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

WINDOW = "graphbench.window"
TOP = 10  # entries of each list of the breakdown


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def gaps(merged, lo, hi) -> list:
    """The parts of ``[lo, hi]`` that the sorted disjoint ``merged`` leave uncovered."""
    out, at = [], lo
    for s, e in merged:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def innermost(host_ops, points) -> list:
    """For each point, the name of the innermost ``(name, start, end)`` that
    holds it (host operations on one thread nest), or None."""
    ops = sorted(host_ops, key=lambda o: (o[1], -o[2]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    names = [None] * len(points)
    stack, j = [], 0
    for i in order:
        p = points[i]
        while j < len(ops) and ops[j][1] <= p:
            while stack and stack[-1][2] <= ops[j][1]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        names[i] = stack[-1][0] if stack else None
    return names


def top(named, k: int = TOP) -> list:
    """``[[name, total], ...]`` of the ``k`` largest totals over ``(name, value)`` pairs."""
    totals = {}
    for name, v in named:
        totals[name] = totals.get(name, 0.0) + v
    return [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:k]]


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0].strip()[:160] or name[:160]


@dataclass
class Trace:
    lo: float  # the window, in seconds
    hi: float
    device_ops: list  # (name, start, end), clipped to the window
    host_ops: list  # (name, start, end) on the loop's thread

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy(self) -> list:
        return union((s, e) for _, s, e in self.device_ops)

    @property
    def busy_s(self) -> float:
        return length(self.busy())

    def device_time(self, pattern: str) -> tuple:
        """``(seconds, count)`` of the device operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [e - s for name, s, e in self.device_ops if rx.search(name)]
        return sum(hits), len(hits)

    def idle_gaps(self) -> list:
        """``(name, seconds)`` of each idle gap, named by what the host was doing."""
        idle = gaps(self.busy(), self.lo, self.hi)
        names = innermost(self.host_ops, [(s + e) / 2 for s, e in idle])
        return [(f"host: {n}" if n else "python", e - s) for n, (s, e) in zip(names, idle)]

    def breakdown(self) -> dict:
        return {"device_ops": top((short_name(n), e - s) for n, s, e in self.device_ops),
                "idle_gaps": top(self.idle_gaps())}


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def _is_annotation(ev) -> bool:
    check = getattr(ev, "is_user_annotation", None)
    return ev.name() == WINDOW or bool(check and check())


def from_events(events) -> Trace:
    """A Trace from the profiler's raw events (``prof.profiler.kineto_results.events()``)."""
    marks = [ev for ev in events if ev.name() == WINDOW and not _is_device(ev)]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    mark = marks[0]
    origin = mark.start_ns()  # times are seconds from the window's start
    lo, hi = 0.0, mark.duration_ns() * 1e-9
    thread = mark.start_thread_id()
    device_ops, host_ops = [], []
    for ev in events:
        if _is_annotation(ev):
            continue
        s = (ev.start_ns() - origin) * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if _is_device(ev):
            s, e = max(s, lo), min(e, hi)
            if e > s:
                device_ops.append((ev.name(), s, e))
        elif ev.start_thread_id() == thread and e > lo and s < hi:
            host_ops.append((ev.name(), s, e))
    return Trace(lo=lo, hi=hi, device_ops=device_ops, host_ops=host_ops)


def capture(fn, on_device: bool):
    """``(fn(), Trace)``: ``fn`` run inside the ``WINDOW`` span under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_device else [])
    with profile(activities=activities, record_shapes=False, with_stack=False, profile_memory=False) as prof:
        with record_function(WINDOW):
            result = fn()
    return result, from_events(prof.profiler.kineto_results.events())
