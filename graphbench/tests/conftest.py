"""The benchmark's own tests: the harness on the CPU at tiny scale.

``cuda`` marks a test that needs an NVIDIA GPU; it skips without one, decided
inside the ``cuda_device`` fixture, never while a module is imported.
Run them all with ``python -m pytest graphbench/tests -q``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
