"""Library-level state: the accelerator (counterpart of ``spla_tpu/library.py``).

The reference Library singleton (``src/library.cpp:70-93,218-238``) picks
the accelerator and can force computation off it.  Here the accelerator is
a CUDA device.  Unlike ``spla_tpu``, whose ``set_platform`` is a no-op and
whose ``set_force_no_acceleration`` edits JAX's global platform list
(ROADMAP queue 3), these settings act: ``accelerator(index)`` returns
``cuda:<index>`` and raises when there is no such device, when the platform
index is not CUDA's, or when acceleration is forced off.  Nothing falls
back to the CPU: a caller that wants the CPU asks for it.
"""

from __future__ import annotations

import torch

__all__ = ["Library", "get_library"]


class Library:
    """Global runtime state (one per process, through :func:`get_library`)."""

    PLATFORMS = ("cuda",)

    def __init__(self):
        self.force_no_acceleration = False
        self.platform = 0

    def set_force_no_acceleration(self, value: bool) -> None:
        """With True, :meth:`accelerator` raises until it is set False."""
        self.force_no_acceleration = bool(value)

    def set_platform(self, index: int) -> None:
        if not 0 <= index < len(self.PLATFORMS):
            raise ValueError(f"platform {index}: the only platform is 0 ({self.PLATFORMS[0]})")
        self.platform = index

    def accelerator(self, index: int = 0) -> torch.device:
        """``cuda:<index>``; raises when there is no such CUDA device or
        acceleration is forced off."""
        index = int(index)
        if self.force_no_acceleration:
            raise RuntimeError("acceleration is forced off (set_force_no_acceleration)")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the accelerator runs need an NVIDIA GPU")
        if not 0 <= index < torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {index} (count {torch.cuda.device_count()})")
        return torch.device("cuda", index)

    def get_accelerator_info(self) -> str:
        if not torch.cuda.is_available():
            return f"no accelerator (torch {torch.__version__})"
        return (f"cuda x{torch.cuda.device_count()}: {torch.cuda.get_device_name(0)} "
                f"(torch {torch.__version__}, CUDA {torch.version.cuda})")


_LIB = None


def get_library() -> Library:
    global _LIB
    if _LIB is None:
        _LIB = Library()
    return _LIB
