"""Monte-Carlo pi, a user-defined op through the facade (``examples/pi.py``,
the reference's ``examples/pi.cpp``).

The reference registers a custom ``OpUnary`` with an OpenCL C source and a
host lambda (``examples/pi.cpp:55-67``).  Here the op is one torch
function; a user op has no kernel code, so it takes the plain PyTorch path
wherever the vector lives.  It hashes each seed into two uniforms and
tests the unit circle, giving the same 0/1 as ``examples/pi.py``'s op.

    python -m spla_tpu_torch.examples.pi --n 1000000 [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ..facade import Vector
from ..library import get_library
from ..op import PLUS_INT, OpUnary
from ..types import INT

_M32 = 0xFFFFFFFF


def _mul32(v, c: int):
    """``v * c mod 2^32`` for int64 ``v`` in [0, 2^32): in 16-bit halves of
    ``c``, so no product leaves int64's range.  torch has no uint32 shift
    on the CPU, so the hash runs in int64."""
    hi = (v * (c >> 16)) & 0xFFFF
    return ((hi << 16) + v * (c & 0xFFFF)) & _M32


def _fmix32(v):
    """murmur3's finalizer (``examples/pi.py:26-31``) on int64 values < 2^32."""
    v = v ^ (v >> 16)
    v = _mul32(v, 0x85EBCA6B)
    v = v ^ (v >> 13)
    v = _mul32(v, 0xC2B2AE35)
    return v ^ (v >> 16)


def is_in_unit_circle_fn(seed):
    """seed (int32) -> 1 if its hashed sample lands in the unit circle, else 0."""
    u = seed.to(torch.int64) & _M32
    a = _fmix32(u)
    b = _fmix32(u ^ 0x9E3779B9)
    # 24 high bits -> [-1, 1)
    x = (a >> 8).to(torch.float32) / (1 << 23) - 1.0
    y = (b >> 8).to(torch.float32) / (1 << 23) - 1.0
    return (x * x + y * y <= 1.0).to(torch.int32)


def run(argv=None) -> int:
    p = argparse.ArgumentParser("pi", description="compute pi with monte-carlo and spla_tpu_torch")
    p.add_argument("--n", type=int, default=1_000_000, help="number of samples")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)

    # a facade object's device is fixed when it is made, so the CPU is asked
    # for first (examples/pi.py sets it after making gen)
    if args.cpu:
        get_library().set_force_no_acceleration(True)

    is_in_unit_circle = OpUnary.make("is_in_unit_circle", INT, is_in_unit_circle_fn)

    gen = Vector.dense((args.n,), INT)
    gen.fill_noize(seed=int(time.time()))

    samples = gen.map(is_in_unit_circle)
    count = samples.reduce(PLUS_INT)

    pi = 4.0 * float(count.get()) / float(args.n)
    print(f"Pi is roughly {pi}")
    return 0


if __name__ == "__main__":
    sys.exit(run())
