"""Library-level state: the accelerator, logging and profiling settings
(counterpart of ``spla_tpu/library.py``).

The reference Library singleton (``src/library.cpp:70-93,218-238``) picks
the accelerator and can force computation off it.  Here the accelerator is
a CUDA device.  Unlike ``spla_tpu``, whose ``set_platform`` is a no-op and
whose ``set_force_no_acceleration`` edits JAX's global platform list
(ROADMAP queue 3), these settings act: ``accelerator(index)`` returns
``cuda:<index>`` and raises when there is no such device, when the platform
index is not CUDA's, or when acceleration is forced off.  Nothing falls
back to the CPU: a caller that wants the CPU asks for it, with ``device=``
or, for the facade's objects, ``set_force_no_acceleration(True)``
(:meth:`Library.default_device`).

Logging mirrors the reference Logger and MessageCallback
(``src/core/logger.hpp:48-81``), with the ``SPLA_DEBUG`` switch
(``python/pyspla/bridge.py:633-672``).
"""

from __future__ import annotations

import logging
import os
import sys

import torch

from .profiling import profiler

__all__ = ["Library", "get_library", "set_message_callback", "log_msg"]

_logger = logging.getLogger("spla_tpu_torch")
if os.environ.get("SPLA_DEBUG"):
    logging.basicConfig(stream=sys.stderr, level=logging.DEBUG)

_message_callback = None


def set_message_callback(cb) -> None:
    """``cb(status, msg, file, function, line)``, the reference
    MessageCallback signature (``include/spla/config.hpp:154-158``); None
    sends messages to the ``spla_tpu_torch`` logger again."""
    global _message_callback
    _message_callback = cb


def log_msg(status, msg, file="", function="", line=0) -> None:
    if _message_callback is not None:
        _message_callback(status, msg, file, function, line)
    else:
        _logger.debug("[%s] %s", status, msg)


class Library:
    """Global runtime state (one per process, through :func:`get_library`)."""

    PLATFORMS = ("cuda",)

    def __init__(self):
        self.force_no_acceleration = False
        self.platform = 0
        self.device_index = 0
        self.queues_count = 1

    def set_force_no_acceleration(self, value: bool) -> None:
        """With True, :meth:`accelerator` raises and :meth:`default_device`
        is the CPU, until it is set False."""
        self.force_no_acceleration = bool(value)

    def set_platform(self, index: int) -> None:
        if not 0 <= index < len(self.PLATFORMS):
            raise ValueError(f"platform {index}: the only platform is 0 ({self.PLATFORMS[0]})")
        self.platform = index

    def set_device(self, index: int) -> None:
        """The CUDA device :meth:`accelerator` returns when given no index."""
        self.device_index = int(index)

    def set_queues_count(self, count: int) -> None:
        # kept for the reference API: ops run on the device's current stream
        self.queues_count = int(count)

    def accelerator(self, index: int | None = None) -> torch.device:
        """``cuda:<index>`` (default: :meth:`set_device`'s); raises when there
        is no such CUDA device or acceleration is forced off."""
        index = self.device_index if index is None else int(index)
        if self.force_no_acceleration:
            raise RuntimeError("acceleration is forced off (set_force_no_acceleration)")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the accelerator runs need an NVIDIA GPU")
        if not 0 <= index < torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {index} (count {torch.cuda.device_count()})")
        return torch.device("cuda", index)

    def default_device(self) -> torch.device:
        """Where a facade object made with no ``device=`` lives: the CPU when
        acceleration is forced off, else :meth:`accelerator` (which raises
        with no card)."""
        return torch.device("cpu") if self.force_no_acceleration else self.accelerator()

    def is_accelerated(self) -> bool:
        return torch.cuda.is_available() and not self.force_no_acceleration

    def get_accelerator_info(self) -> str:
        if not torch.cuda.is_available():
            return f"no accelerator (torch {torch.__version__})"
        return (f"cuda x{torch.cuda.device_count()}: {torch.cuda.get_device_name(0)} "
                f"(torch {torch.__version__}, CUDA {torch.version.cuda})")

    # -- profiling (reference library.cpp:184-196) --
    def set_time_profiling(self, enabled: bool) -> None:
        """Profiled dispatch: the facade's ops open scopes and wait for their
        results, so a scope's time is the device's (reference
        ``cl_debug.hpp:36-103``).  Off by default."""
        profiler.enabled = bool(enabled)

    def time_profile_dump(self) -> str:
        s = profiler.dump()
        print(s, file=sys.stderr)
        return s

    def time_profile_reset(self) -> None:
        profiler.reset()

    def finalize(self) -> None:
        pass


_LIB = None


def get_library() -> Library:
    global _LIB
    if _LIB is None:
        _LIB = Library()
    return _LIB
