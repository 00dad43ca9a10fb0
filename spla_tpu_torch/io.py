"""MatrixMarket IO: a loader with degree statistics, and save (counterpart
of ``spla_tpu/io.py``).

The reference MtxLoader (``include/spla/io.hpp:47-102``,
``src/io.cpp:50-157``): load with ``offset_indexes`` (1-based to 0-based),
``make_undirected`` (mirror edges) and ``remove_loops``; the same degree
statistics (min/max/avg/sd and a power-of-two histogram); save back.

The parser is the repository's ``native/mtxio.cpp``, unchanged, compiled
with g++ at first use into ``build/spla_tpu_torch/`` and bound with ctypes.
A failed build raises with g++'s message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .kernels.build import BUILD_ROOT

__all__ = ["MtxLoader", "load_mtx"]

MTXIO_SRC = Path(__file__).resolve().parents[1] / "native" / "mtxio.cpp"


def _build_mtxio() -> Path:
    source = MTXIO_SRC.read_bytes()
    lib = BUILD_ROOT / f"libmtxio-{hashlib.sha256(source).hexdigest()[:12]}.so"
    if not lib.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}")
        proc = subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                               str(MTXIO_SRC), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {MTXIO_SRC}:\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.cache
def _native_lib():
    """The compiled parser, built at first use."""
    lib = ctypes.CDLL(str(_build_mtxio()))
    lib.mtx_parse.restype = ctypes.c_void_p
    lib.mtx_parse.argtypes = [ctypes.c_char_p]
    lib.mtx_error.restype = ctypes.c_char_p
    lib.mtx_error.argtypes = [ctypes.c_void_p]
    for f in ("mtx_n_rows", "mtx_n_cols", "mtx_nnz"):
        getattr(lib, f).restype = ctypes.c_int64
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    for f in ("mtx_pattern", "mtx_symmetric"):
        getattr(lib, f).restype = ctypes.c_int
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.mtx_rows.restype = ctypes.POINTER(ctypes.c_int32)
    lib.mtx_rows.argtypes = [ctypes.c_void_p]
    lib.mtx_cols.restype = ctypes.POINTER(ctypes.c_int32)
    lib.mtx_cols.argtypes = [ctypes.c_void_p]
    lib.mtx_vals.restype = ctypes.POINTER(ctypes.c_double)
    lib.mtx_vals.argtypes = [ctypes.c_void_p]
    lib.mtx_release.restype = None
    lib.mtx_release.argtypes = [ctypes.c_void_p]
    return lib


def _parse_native(lib, path):
    h = lib.mtx_parse(str(path).encode())
    try:
        err = lib.mtx_error(h)
        if err:
            raise IOError(f"mtx parse failed: {err.decode()}")
        nnz = lib.mtx_nnz(h)
        m, n = lib.mtx_n_rows(h), lib.mtx_n_cols(h)
        rows = np.ctypeslib.as_array(lib.mtx_rows(h), shape=(nnz,)).copy()
        cols = np.ctypeslib.as_array(lib.mtx_cols(h), shape=(nnz,)).copy()
        vp = lib.mtx_vals(h)
        vals = (np.ctypeslib.as_array(vp, shape=(nnz,)).copy()
                if vp and not lib.mtx_pattern(h) else np.ones(nnz, np.float64))
        return m, n, rows, cols, vals, bool(lib.mtx_symmetric(h))
    finally:
        lib.mtx_release(h)


def _header_skew(path) -> bool:
    with open(path, "rb") as f:
        return b"skew-symmetric" in f.readline().lower()


@dataclass
class MtxLoader:
    """Reference-parity loader (``include/spla/io.hpp:47-102``)."""

    verbose: bool = True
    n_rows: int = 0
    n_cols: int = 0
    rows: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    cols: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    vals: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    stats: dict = field(default_factory=dict)

    @property
    def n_values(self) -> int:
        return int(self.rows.size)

    def load(self, path, offset_indexes: bool = True, make_undirected: bool = True,
             remove_loops: bool = True) -> "MtxLoader":
        t0 = time.perf_counter()
        m, n, rows, cols, vals, sym = _parse_native(_native_lib(), path)
        t_parse = time.perf_counter() - t0
        if offset_indexes:
            rows = rows - 1
            cols = cols - 1
        if sym or make_undirected:
            keep = rows != cols  # the diagonal is not mirrored
            # skew-symmetric files store the lower triangle of A = -Aᵀ
            mirrored = -vals[keep] if (sym and _header_skew(path)) else vals[keep]
            rows, cols, vals = (np.concatenate([rows, cols[keep]]),
                                np.concatenate([cols, rows[keep]]),
                                np.concatenate([vals, mirrored]))
        if remove_loops:
            keep = rows != cols
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
        self.n_rows, self.n_cols = int(m), int(n)
        self.rows, self.cols, self.vals = rows, cols, vals
        self._compute_stats(t_parse)
        if self.verbose:
            self._print_stats(path)
        return self

    def _compute_stats(self, t_parse):
        t0 = time.perf_counter()
        deg = np.bincount(self.rows, minlength=self.n_rows) if self.rows.size else np.zeros(1)
        order = np.clip(np.ceil(np.log2(np.maximum(deg, 1))), 0, 62).astype(int)
        self.stats = {
            "n_rows": self.n_rows,
            "n_cols": self.n_cols,
            "n_values": self.n_values,
            "deg_min": int(deg.min()),
            "deg_max": int(deg.max()),
            "deg_avg": float(deg.mean()),
            "deg_sd": float(deg.std()),
            "distribution": np.bincount(order).tolist(),
            "parse_s": t_parse,
            "stats_s": time.perf_counter() - t0,
        }

    def _print_stats(self, path):
        s = self.stats
        print(f"Loaded {path}: {s['n_rows']}x{s['n_cols']} nnz={s['n_values']} "
              f"deg[min={s['deg_min']} max={s['deg_max']} avg={s['deg_avg']:.2f} "
              f"sd={s['deg_sd']:.2f}] parse={s['parse_s']:.3f}s", file=sys.stderr)
        for i, c in enumerate(s["distribution"]):
            if c:
                print(f"  deg <= 2^{i}: {c}", file=sys.stderr)

    def save(self, path) -> None:
        """Write back in MatrixMarket coordinate format (1-based), formatted
        a column at a time in chunks of 2^20 lines."""
        chunk = 1 << 20
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n")
            f.write(f"{self.n_rows} {self.n_cols} {self.n_values}\n")
            for lo in range(0, self.n_values, chunk):
                hi = min(lo + chunk, self.n_values)
                rc = np.char.add(np.char.add((self.rows[lo:hi] + 1).astype("U10"), " "),
                                 (self.cols[lo:hi] + 1).astype("U10"))
                lines = np.char.add(np.char.add(rc, " "), np.char.mod("%.9g", self.vals[lo:hi]))
                f.write("\n".join(lines.tolist()))
                f.write("\n")

    def to_scipy(self):
        """CSR with the library's duplicate rule (the last one wins, as the
        reference examples' set() loop), not scipy's sum."""
        import scipy.sparse as sp

        key = self.rows.astype(np.int64) * self.n_cols + self.cols
        order = np.argsort(key, kind="stable")
        ks = key[order]
        last = np.empty(ks.size, bool)
        if ks.size:
            last[:-1] = ks[1:] != ks[:-1]
            last[-1] = True
        keep = order[last]
        return sp.coo_matrix((self.vals[keep], (self.rows[keep], self.cols[keep])),
                             shape=(self.n_rows, self.n_cols)).tocsr()

    def to_csr(self, dtype=np.float32, fill=0, *, device):
        from .formats import csr_from_scipy

        return csr_from_scipy(self.to_scipy().astype(dtype), fill=fill, dtype=dtype, device=device)


def load_mtx(path, **kw) -> MtxLoader:
    return MtxLoader(verbose=kw.pop("verbose", False)).load(path, **kw)
