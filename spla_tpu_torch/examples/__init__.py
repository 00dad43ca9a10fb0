"""Example CLIs of the port (counterparts of the repository's ``examples/``).

Each loads a MatrixMarket graph, runs the algorithm on the accelerator
(``cuda:<--device>``) and on the CPU for ``--niters`` laps, checks both
against the sequential naive oracle, and prints the lap times::

    python -m spla_tpu_torch.examples.bfs  --mtxpath graph.mtx --source 0
    python -m spla_tpu_torch.examples.sssp --mtxpath graph.mtx --run-cpu false
    python -m spla_tpu_torch.examples.pr   --mtxpath graph.mtx --alpha 0.85 --eps 1e-6
    python -m spla_tpu_torch.examples.tc   --mtxpath graph.mtx --undirected true

The flags are the reference's (``examples/options.hpp:34-66``).  With
``--run-acc true`` and no CUDA device the CLI raises: it never runs the
accelerator laps on the CPU.

Two more go through the facade and the host tools::

    python -m spla_tpu_torch.examples.pi --n 1000000 [--cpu]
    python -m spla_tpu_torch.examples.convert --in graph.mtx --out out.mtx
"""
