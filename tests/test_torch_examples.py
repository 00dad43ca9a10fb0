"""spla_tpu_torch's host modules (io, timer, library) and example CLIs.

``MtxLoader`` must give spla_tpu's rows, cols, values and shape bitwise on
the same file; each CLI runs on the CPU and checks itself against its naive
oracle; with ``--run-acc true`` and no CUDA device a CLI raises.
"""

import shutil

import numpy as np
import pytest
import torch

from spla_tpu.io import MtxLoader as JMtxLoader

from spla_tpu_torch import io as mtx_io
from spla_tpu_torch import library as L
from spla_tpu_torch.examples import bfs, pr, sssp, tc
from spla_tpu_torch.io import MtxLoader, load_mtx
from spla_tpu_torch.timer import Timer

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the MatrixMarket parser (native/mtxio.cpp) needs g++")

CLIS = {"bfs": bfs, "sssp": sssp, "pr": pr, "tc": tc}


@pytest.fixture(scope="module")
def mtx_path(tmp_path_factory):
    """A small random graph in 1-based MatrixMarket format, with real values,
    a self loop and a repeated edge."""
    rng = np.random.default_rng(13)
    n, m = 70, 220
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    r[:2], c[:2] = [4, 9], [4, 3]
    r[2], c[2] = 9, 3
    vals = rng.uniform(0.5, 2.0, m)
    path = tmp_path_factory.mktemp("mtx") / "g.mtx"
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n% a comment\n")
        f.write(f"{n} {n} {m}\n")
        for i, j, v in zip(r, c, vals):
            f.write(f"{i + 1} {j + 1} {v:.6f}\n")
    return str(path)


@needs_gxx
@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("remove_loops", [False, True])
def test_mtx_loader_matches_spla_tpu(mtx_path, undirected, remove_loops):
    kw = {"make_undirected": undirected, "remove_loops": remove_loops}
    want = JMtxLoader(verbose=False).load(mtx_path, **kw)
    got = MtxLoader(verbose=False).load(mtx_path, **kw)
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    for f in ("rows", "cols", "vals"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for k in ("n_values", "deg_min", "deg_max", "deg_avg", "deg_sd", "distribution"):
        assert got.stats[k] == want.stats[k]
    assert (got.to_scipy() != want.to_scipy()).nnz == 0


@needs_gxx
def test_mtx_save_round_trip(mtx_path, tmp_path):
    a = load_mtx(mtx_path, make_undirected=False, remove_loops=False)
    out = tmp_path / "out.mtx"
    a.save(out)
    b = load_mtx(out, make_undirected=False, remove_loops=False)
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_allclose(a.vals, b.vals, rtol=1e-8)
    A = a.to_csr(np.float32, device="cpu")
    assert A.shape == (a.n_rows, a.n_cols) and int(A.nnz) == a.to_scipy().nnz


@needs_gxx
@pytest.mark.parametrize("name", list(CLIS))
def test_cli_on_the_cpu(name, mtx_path, capsys):
    args = ["--mtxpath", mtx_path, "--run-acc", "false", "--niters", "1", "--verbose", "false",
            "--undirected", "true"]
    assert CLIS[name].run(args) == 0
    out = capsys.readouterr().out
    assert "verify cpu: OK" in out and "verify acc" not in out


@needs_gxx
@pytest.mark.parametrize("name", list(CLIS))
def test_cli_run_acc_without_cuda_raises(name, mtx_path, monkeypatch):
    """The deliberate difference from examples/common.py: no silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[name].run(["--mtxpath", mtx_path, "--run-acc", "true", "--niters", "1",
                        "--verbose", "false"])


def test_library_settings_act(monkeypatch):
    lib = L.Library()
    with pytest.raises(ValueError):
        lib.set_platform(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert lib.accelerator() == torch.device("cuda", 0)
    assert lib.accelerator(1) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="no CUDA device 2"):
        lib.accelerator(2)
    lib.set_force_no_acceleration(True)
    with pytest.raises(RuntimeError, match="forced off"):
        lib.accelerator()
    assert L.get_library() is L.get_library()


def test_library_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lib = L.Library()
    assert lib.get_accelerator_info().startswith("no accelerator")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lib.accelerator()


@needs_gxx
def test_mtx_parser_build_failure_raises(tmp_path, monkeypatch):
    """A parser that does not compile is reported with g++'s message, not
    replaced by another parser."""
    bad = tmp_path / "mtxio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(mtx_io, "MTXIO_SRC", bad)
    monkeypatch.setattr(mtx_io, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        mtx_io._build_mtxio()


def test_timer_laps_on_the_host(capsys):
    t = Timer()
    t.start()
    for _ in range(3):
        t.lap_begin()
        t.lap_end()
    t.stop()
    laps = t.get_laps_ms()
    assert len(laps) == 3 and all(x >= 0 for x in laps)
    assert t.get_elapsed_ms() >= sum(laps) and t.get_elapsed_sec() == t.get_elapsed_ms() / 1e3
    t.print(end="\n")
    assert capsys.readouterr().out.count(",") == 2
