"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

The sources in ``csrc/`` have a plain C interface (no PyTorch headers).
One nvcc per source compiles them all at once, in parallel, and one more
links the objects into a shared library.  It goes to
``build/spla_tpu_torch/<hash of sources and flags>/`` at the repository
root and is reused while the sources are unchanged.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BuildError", "load_library", "build_log", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "spla_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
# kernel 1's value entries from m to init: m, the plan, its segments and scratch, the operands
_PULL = (_I64, _INT, _INT, _I64, _I64, *(_P,) * 5, _INT, _I64, _I64, *(_P,) * 13)
SIGNATURES = {
    # mul, add, dtype, m, log2 team, hub_len, nhub (rows cut into chunks), nchunks, chunk_row,
    # chunk_c0, chunk_c1, chunk_hub, chunk_first, segments, nitems, nshort, items, short_rows, cuts,
    # part, part_any, done, indptr, cols, values, x, x_bits (null; the masked entry's bitmap),
    # row_sel, init (device pointer or null), init's 32 bits (when null), out, has, stream
    "spla_spmv_pull": (_INT, _INT, _INT, *_PULL, ctypes.c_uint32, _P, _P, _P),
    "spla_spmv_pull_masked": (_INT, _INT, _INT, *_PULL, ctypes.c_uint32, _P, _P, _P),
    # mul, swap, add, dtype, then spla_spmv_pull's arguments from m on
    "spla_spmv_pull_generic": (_INT, _INT, _INT, _INT, *_PULL, ctypes.c_uint32, _P, _P, _P),
    "spla_spmv_pull_generic_masked": (_INT, _INT, _INT, _INT, *_PULL, ctypes.c_uint32, _P, _P, _P),
    # n, x_valid (bytes), bits (int32 words), stream
    "spla_pack_valid_bits": (_I64, _P, _P, _P),
    # m, log2 team, hub_len, nhub, nchunks, chunk_row, chunk_c0, chunk_c1, chunk_hub, chunk_first,
    # indptr, cols, x_bits, row_sel, hits, stream
    "spla_spmv_pull_structural": (_I64, _INT, _INT, _I64, _I64, *(_P,) * 11),
    # mul, add, dtype, k, edges (a bound), list, eoff, total (device), indptr, cols, values, x, out,
    # stream
    "spla_spmv_push": (_INT, _INT, _INT, _I64, _I64, *(_P,) * 9),
    # k, edges (a bound), list, eoff, total (device), indptr, cols, hits, stream
    "spla_spmv_push_structural": (_I64, _I64, *(_P,) * 7),
    # k, edges, list, eoff, total, indptr, cols, v, front, vis, depth, next list, next eoff,
    # next word, clear word, stream
    "spla_bfs_push_level": (_I64, _I64, *(_P,) * 8, _INT, *(_P,) * 5),
    # k, edges, n, list, eoff, total, indptr, cols, values, d, hits, changed, touched, tcount,
    # tclear, next list, next eoff, next word, clear word, stream
    "spla_sssp_push_level": (_I64, _I64, _I64, *(_P,) * 17),
    # n, hits, v, front, depth, list, count, wide, eoff, indptr, vis, clear, stream
    "spla_bfs_level_update": (_I64, _P, _P, _P, _INT, _P, _P, _INT, *(_P,) * 5),
    # n, hits, v, changed, list, count, wide, eoff, indptr, clear, stream
    "spla_sssp_level_update": (_I64, *(_P,) * 5, _INT, *(_P,) * 4),
    # mode (0 kernel 4, 1 kernel 5, 2 gather), mul, add, dtype, structural, ordered, cap, mask row_ids/cols,
    # sel, A indptr/cols/values, B indptr/cols/values, hub_len, stored, nhub, nchunks, chunk_entry,
    # chunk_row, chunk_c0, chunk_c1, chunk_hub, chunk_first, part, part_any, done, init (device
    # pointer or null), init's 32 bits (when null), out, has, total, stream
    "spla_mxmt": (*(_INT,) * 6, _I64, *(_P,) * 9, _INT, _I64, _I64, _I64, *(_P,) * 10,
                  ctypes.c_uint32, *(_P,) * 4),
    # n, source, log2 team, wide_above, indptr, cols, v, queues, counters, stats, stream
    "spla_bfs_resident": (_I64, _INT, _INT, _I64, *(_P,) * 7),
    # n, source, log2 team, wide_above, indptr, cols, values, d, stamps, queues, counters,
    # stats, stream
    "spla_sssp_resident": (_I64, _INT, _INT, _I64, *(_P,) * 9),
    # sssp, log2 team, &ctas, &cluster, &registers
    "spla_resident_grid": (_INT, _INT, _P, _P, _P),
    # mul, add, slots, stage, nunits, units, unit_hub, hub_units, part, part_any, done, indptr,
    # cols, values, x, x_valid, row_sel, init (device pointer or null), init's 32 bits (when
    # null), out, has, stream
    "spla_spmv_staged": (_INT, _INT, _INT, _INT, _I64, *(_P,) * 13, ctypes.c_uint32, _P, _P, _P),
    # mul, swap, add, then spla_spmv_staged's arguments from slots on
    "spla_spmv_staged_generic": (_INT, _INT, _INT, _INT, _INT, _I64, *(_P,) * 13, ctypes.c_uint32, _P, _P, _P),
    # slots, stage, nunits, units, unit_hub, indptr, cols, x_valid, row_sel, hits, stream
    "spla_spmv_staged_structural": (_INT, _INT, _I64, *(_P,) * 8),
    # phase, m, n, indptr, cols, values, x, out_f, out_i, stream
    "spla_spmv_probe": (_INT, _I64, _I64, *(_P,) * 7),
    # m, n, A indptr/cols, B indptr/cols, bins: rows, nsmall, the 4 medium counts, nlarge,
    # row_products; large_words, row_nnz, stream
    "spla_mxm_symbolic": (_I64, _I64, *(_P,) * 5, *(_I64,) * 6, _P, _INT, _P, _P),
    # mul, add, dtype, m, n, A indptr/cols/values, B indptr/cols/values, the bins as above, cluster,
    # log2 W, radix passes, sym, init (device pointer or null), init's 32 bits (when null), cols,
    # values, rows, kept, stream
    "spla_mxm_numeric": (_INT, _INT, _INT, _I64, _I64, *(_P,) * 7, *(_I64,) * 6, _P, *(_INT,) * 3,
                         _P, _P, ctypes.c_uint32, *(_P,) * 5),
    # m, size, sym, ptr, kept, cols, values, rows, tmp cols, tmp values, init (device pointer or
    # null), init's 32 bits (when null), stream
    "spla_mxm_compact": (_I64, _I64, *(_P,) * 9, ctypes.c_uint32, _P),
    # phase, slots, stage, nunits, units, unit_hub, hub_units, part, part_any, done, indptr, cols,
    # values, x, resident words, out_f, out_i, stream
    "spla_spmv_probe_ring": (_INT, _INT, _INT, _I64, *(_P,) * 10, _INT, _P, _P, _P),
}


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise BuildError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels need it")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build_dir() -> Path:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in (*cus, *headers):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_all(cmds, log):
    """Run the commands side by side and log each one's output.  Returns the
    first failure's message, or None."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = None
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{out[-4000:]}"
    return failed


def _build(out_dir: Path, lib_path: Path) -> None:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tag = os.getpid()
    objs = [out_dir / f"{cu.stem}.{tag}.o" for cu in cus]
    log = []
    failed = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)]
                       for cu, o in zip(cus, objs)], log)
    tmp = out_dir / f"libspla_kernels.{tag}.so"
    if failed is None:
        failed = _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]], log)
    (out_dir / "build.log").write_text("".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed is not None:
        raise BuildError(failed)
    os.replace(tmp, lib_path)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' shared library."""
    out_dir = _build_dir()
    lib_path = out_dir / "libspla_kernels.so"
    if not lib_path.exists():
        _build(out_dir, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.spla_error_string.argtypes = (ctypes.c_int,)
    lib.spla_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """nvcc's command line and output (``-Xptxas -v`` register and
    shared-memory lines) of the loaded library's build."""
    load_library()
    return (_build_dir() / "build.log").read_text()


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned an error (``cudaGetLastError()``
    after its launch, or -1 for an instance the library does not hold)."""
    if rc != 0:
        msg = "instance not compiled" if rc < 0 else \
            load_library().spla_error_string(rc).decode()
        raise RuntimeError(f"{what}: launch failed: {msg} ({rc})")
