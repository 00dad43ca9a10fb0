"""spla_tpu_torch's host modules (io, timer, library) and example CLIs.

``MtxLoader`` must give spla_tpu's rows, cols, values and shape bitwise on
the same file; each CLI runs on the CPU and checks itself against its naive
oracle; with ``--run-acc true`` and no CUDA device a CLI raises.  pi's user
op gives ``examples/pi.py``'s 0/1 on every seed tried, and convert writes
a file that loads back equal.
"""

import importlib.util
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spla_tpu.io import MtxLoader as JMtxLoader

from spla_tpu_torch import io as mtx_io
from spla_tpu_torch import library as L
from spla_tpu_torch.examples import bfs, convert, pi, pr, sssp, tc
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


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_push_pull_flag_makes_spla_tpus_descriptor(mode):
    """--push-pull 1 / 2 / 3 give push_only / pull_only / push_pull, as
    examples/common.py's make_descriptor does."""
    from dataclasses import asdict

    from examples.common import make_descriptor as j_make_descriptor
    from spla_tpu_torch.examples.common import make_descriptor
    from spla_tpu_torch.examples.options import make_options

    args = make_options("bfs", "").parse_args(["--mtxpath", "g.mtx", "--push-pull", str(mode),
                                              "--front-factor", "0.2"])
    got = make_descriptor(args)
    assert asdict(got) == asdict(j_make_descriptor(args))
    assert (got.push_only, got.pull_only, got.push_pull) == (mode == 1, mode == 2, mode == 3)


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


def _reference_example(name):
    """examples/<name>.py of the JAX package (a script, not a package module)."""
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pi_op_matches_the_reference_op():
    """The same 0/1 as examples/pi.py's jnp op on 4,096 seeds: random int32
    seeds, the 2^16 - 1 seeds just below 2^31 - 1 in steps, the edges, and
    negative seeds (which the reference casts to uint32)."""
    ref = _reference_example("pi")
    rng = np.random.default_rng(31)
    seeds = np.concatenate([rng.integers(0, 2**31 - 1, 2048), np.arange(2**31 - 2**16, 2**31, 64),
                            [0, 1, 2**31 - 1, -1, -(2**31)], -rng.integers(1, 2**31, 1019)]).astype(np.int32)
    assert seeds.size == 4096
    want = np.asarray(ref.is_in_unit_circle_fn(jnp.asarray(seeds)))
    got = pi.is_in_unit_circle_fn(torch.from_numpy(seeds))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.70 < want.mean() < 0.87  # the circle's share, pi / 4


def test_pi_cli_on_the_cpu(capsys):
    lib = L.get_library()
    try:
        assert pi.run(["--n", "20000", "--cpu"]) == 0
        assert lib.force_no_acceleration
    finally:
        lib.set_force_no_acceleration(False)
    est = float(re.search(r"Pi is roughly ([0-9.]+)", capsys.readouterr().out).group(1))
    assert abs(est - np.pi) < 0.08  # ~7 standard errors at 20,000 samples


def test_pi_cli_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pi.run(["--n", "100"])


@needs_gxx
@pytest.mark.parametrize("undirected", ["false", "true"])
def test_convert_round_trip(mtx_path, tmp_path, undirected, capsys):
    out = tmp_path / "converted.mtx"
    assert convert.run(["--in", mtx_path, "--out", str(out), "--offset-indices", "true",
                        "--make-undirected", undirected]) == 0
    assert f"saved to {out}" in capsys.readouterr().out
    kw = {"make_undirected": undirected == "true", "remove_loops": True}
    want = JMtxLoader(verbose=False).load(mtx_path, **kw)
    got = load_mtx(out, make_undirected=False, remove_loops=False)
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_allclose(got.vals, want.vals, rtol=1e-8)
    assert convert.run(["--in", str(out), "--stats-only", "true", "--make-undirected", "false"]) == 0
    assert "saved to" not in capsys.readouterr().out
