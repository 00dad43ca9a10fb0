"""Measurement tools of the port and the seeded graphs they share.

* ``graphs`` — the JAX package's benchmark graph generators (numpy);
* ``ab_spmv`` — A/B timing of kernel 1, kernel 7 and row-split kernel 1
  (``python -m spla_tpu_torch.tools.ab_spmv``);
* ``probe_spmv`` — kernel 8's phase probes in ns per stored entry
  (``python -m spla_tpu_torch.tools.probe_spmv``).
"""
