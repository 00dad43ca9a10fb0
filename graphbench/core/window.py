"""The measured window: one client in a closed loop, GAP's trial loop.

Each query starts when the one before has returned and its result has been
synchronised; its latency is the host clock from the call to that point.
The window closes when the last query started before ``seconds`` returns,
and its length runs to that moment.  A query that raises ends the window.

A reservoir sample of the finished queries (one a slot, drawn from the
run's seed) keeps a copy of each one's result, for the comparison after the
window.  The slots are the benchmark's own, allocated in set-up, so they add
a fixed number of bytes to the window's peak, which ``peak_mem_gib`` takes
off again; copying a result into its slot is the benchmark's work, after the
query's latency ends.
"""

from __future__ import annotations

import random
import time
import traceback
from dataclasses import dataclass, field


@dataclass
class Window:
    seconds: float  # asked for
    elapsed_s: float = 0.0  # from the first query's call to the last one's return
    latencies_s: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    error: str | None = None
    sample: list = field(default_factory=list)  # (query index, source, slot holding its result)


def closed_loop(call, sources: list, seconds: float, sync, slots: list, rng: random.Random) -> Window:
    """Run ``call(source)`` back to back over ``sources`` (cycled) for ``seconds``,
    keeping a reservoir sample of the results in ``slots`` (tensors of the
    result's shape and type)."""
    w = Window(seconds=seconds)
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        source = sources[i % len(sources)]
        w.attempted += 1
        try:
            out = call(source)
            sync()
        except Exception:  # the program failed: the window ends, the run is not correct
            w.failed += 1
            w.error = traceback.format_exc(limit=8)
            end = time.perf_counter()
            break
        end = time.perf_counter()
        w.latencies_s.append(end - t0)
        j = len(w.sample) if len(w.sample) < len(slots) else rng.randrange(i + 1)
        if j < len(slots):
            kept = slots[j].copy_(out) if out.shape == slots[j].shape else out  # a misshapen result is judged as it is
            w.sample[j:j + 1] = [(i, source, kept)]
        del out
        i += 1
    w.elapsed_s = end - start
    return w
