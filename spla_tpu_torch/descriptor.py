"""Traversal descriptor (counterpart of ``spla_tpu/descriptor.py``).

``push_only`` runs every BFS/SSSP level as a push over the frontier list,
``pull_only`` every level as a pull over the whole matrix; otherwise a
level pushes when its frontier holds at most ``front_factor * n`` vertices.
``push_pull`` (the adaptive choice, which is the default anyway),
``early_exit`` and ``struct_only`` are advisory: the algorithms read only
the first three fields, and give the same results whatever these hold.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["Descriptor"]


@dataclass(frozen=True)
class Descriptor:
    push_only: bool = False
    pull_only: bool = False
    push_pull: bool = False
    front_factor: float = 0.1
    early_exit: bool = False
    struct_only: bool = False

    def with_(self, **kw) -> "Descriptor":
        return replace(self, **kw)

    @staticmethod
    def make(**kw) -> "Descriptor":
        return Descriptor(**kw)
