"""The package's banner and its accelerator (counterpart of
``spla_tpu/__main__.py``; the reference ``python/pyspla/__main__.py``
prints the project's banner).

Run as ``python -m spla_tpu_torch``.
"""

from __future__ import annotations

from .library import get_library


def main() -> None:
    print("****** spla_tpu_torch ******")
    print("Generalized sparse linear algebra on PyTorch and CUDA (a port of spla_tpu).")
    print("Import `spla_tpu_torch` as a module in your python scripts; "
          "the example CLIs live in `spla_tpu_torch.examples`.")
    print(get_library().get_accelerator_info())


if __name__ == "__main__":
    main()
