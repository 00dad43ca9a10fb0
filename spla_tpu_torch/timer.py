"""Timer with laps (counterpart of ``spla_tpu/timer.py``).

API of the reference ``spla::Timer`` (``include/spla/timer.hpp:49-72``):
start/stop/lap_begin/lap_end, elapsed ms, per-lap print.  A timer made for
a CUDA device records CUDA events on that device's current stream and
waits for the end event, so a lap is the time the device's stream takes
between the two marks, host gaps included; any other timer reads the
host's ``perf_counter``.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Timer"]


class _HostMark:
    def __init__(self):
        self.t = time.perf_counter()

    def ms_since(self, start: "_HostMark") -> float:
        return (self.t - start.t) * 1e3


class _CudaMark:
    def __init__(self, device):
        self.event = torch.cuda.Event(enable_timing=True)
        self.event.record(torch.cuda.current_stream(device))

    def ms_since(self, start: "_CudaMark") -> float:
        self.event.synchronize()
        return start.event.elapsed_time(self.event)


class Timer:
    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self._start = self._lap_start = None
        self._elapsed_ms = 0.0
        self._laps_ms: list[float] = []

    def _mark(self):
        return _CudaMark(self.device) if self.device.type == "cuda" else _HostMark()

    def start(self) -> None:
        self._start = self._mark()

    def stop(self) -> None:
        self._elapsed_ms = self._mark().ms_since(self._start)

    def lap_begin(self) -> None:
        self._lap_start = self._mark()

    def lap_end(self) -> None:
        self._laps_ms.append(self._mark().ms_since(self._lap_start))

    def get_elapsed_ms(self) -> float:
        return self._elapsed_ms

    def get_elapsed_sec(self) -> float:
        return self._elapsed_ms / 1e3

    def get_laps_ms(self) -> list[float]:
        return list(self._laps_ms)

    def print(self, end="") -> None:  # noqa: A003 - reference name
        print(", ".join(f"{lap:.3f}" for lap in self._laps_ms), end=end)

    def __repr__(self):
        return f"Timer(device={self.device}, laps_ms={self._laps_ms})"
