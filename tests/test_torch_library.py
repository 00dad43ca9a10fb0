"""spla_tpu_torch's library settings, time profiler and schedule, on the
cases of tests/test_library.py, and the package's banner."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from spla_tpu_torch import INT, get_library
from spla_tpu_torch import profiling as P
from spla_tpu_torch.facade import Matrix, Vector
from spla_tpu_torch.library import Library, log_msg, set_message_callback
from spla_tpu_torch.profiling import profiler, time_profile_scope
from spla_tpu_torch.schedule import Schedule, ScheduleTask, make_sched_task_callback, make_schedule

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def lib():
    """The library with its settings restored after the test."""
    lib = get_library()
    saved = dict(vars(lib))
    yield lib
    vars(lib).update(saved)
    profiler.enabled = False
    profiler.reset()


def test_library_info(lib):
    info = lib.get_accelerator_info()
    assert isinstance(info, str) and info
    assert ("cuda x" in info) == torch.cuda.is_available()


def test_force_no_acceleration(lib):
    lib.set_force_no_acceleration(True)
    assert not lib.is_accelerated()
    assert lib.default_device() == torch.device("cpu")
    with pytest.raises(RuntimeError, match="forced off"):
        lib.accelerator()
    lib.set_force_no_acceleration(False)
    assert lib.is_accelerated() == torch.cuda.is_available()


def test_device_and_queue_settings(lib, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    lib.set_device(1)
    assert lib.accelerator() == torch.device("cuda", 1)
    assert lib.default_device() == torch.device("cuda", 1)
    assert lib.accelerator(0) == torch.device("cuda", 0)
    lib.set_device(2)
    with pytest.raises(RuntimeError, match="no CUDA device 2"):
        lib.accelerator()
    lib.set_queues_count(4)
    assert lib.queues_count == 4
    with pytest.raises(ValueError):
        lib.set_platform(1)
    lib.finalize()


def test_message_callback():
    got = []
    set_message_callback(lambda *a: got.append(a))
    try:
        log_msg("Ok", "hello", "f.py", "fn", 1)
    finally:
        set_message_callback(None)
    assert got == [("Ok", "hello", "f.py", "fn", 1)]
    log_msg("Ok", "to the logger")  # no callback: the logger takes it


def test_profiler_disabled_by_default():
    # profiled dispatch waits for the device; it must be opted into
    assert P.TimeProfiler().enabled is False
    assert Library().force_no_acceleration is False


def test_profiler_scopes(lib):
    profiler.reset()
    profiler.enabled = True
    with time_profile_scope("outer"):
        with time_profile_scope("outer/inner"):
            time.sleep(0.01)
        with time_profile_scope("outer/inner"):
            pass
    s = profiler.stats()
    assert s["outer/inner"]["parent"] == "outer" and s["outer"]["parent"] is None
    assert s["outer/inner"]["count"] == 2 and s["outer"]["count"] == 1
    assert s["outer"]["ms"] >= s["outer/inner"]["ms"] >= 10
    dump = profiler.dump()
    assert dump.splitlines()[0] == "-- time profile --"
    assert dump.index("  outer:") < dump.index("    outer/inner:")
    assert "(x2)" in dump
    profiler.reset()
    profiler.enabled = False
    assert not profiler.stats()
    with time_profile_scope("off"):
        pass
    assert not profiler.stats()


def test_profiler_scopes_facade_ops(lib):
    lib.set_force_no_acceleration(True)
    profiler.reset()
    lib.set_time_profiling(True)
    A = Matrix.from_lists([0, 1, 2], [1, 2, 0], [1, 2, 3], shape=(3, 3), dtype=INT)
    v = Vector.from_lists([0, 2], [5, 7], (3,), INT)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        A.mxm(A, INT.MULT, INT.PLUS)
        for _ in range(3):
            v = v.vxm(v, A, INT.MULT, INT.PLUS, INT.ALWAYS)
        v.reduce(INT.PLUS)
    stats = profiler.stats()
    assert stats["matrix_mxm"]["count"] == 1 and stats["vector_vxm"]["count"] == 3
    assert stats["vector_reduce"]["count"] == 1
    names = {e.key for e in prof.key_averages()}
    assert {"matrix_mxm", "vector_vxm", "vector_reduce"} <= names
    dump = lib.time_profile_dump()
    assert "matrix_mxm" in dump and "vector_vxm" in dump
    lib.set_time_profiling(False)
    A.mxm(A, INT.MULT, INT.PLUS)
    assert profiler.stats()["matrix_mxm"]["count"] == 1
    lib.time_profile_reset()
    assert profiler.stats() == {}


def test_schedule_callback():
    # reference test_schedule.cpp:32-39: callback tasks through a Schedule, in order
    hits = []
    s = make_schedule()
    step = s.add_step(make_sched_task_callback(lambda: hits.append("a")))
    s.add_task(step, make_sched_task_callback(lambda: hits.append("b")))
    assert s.add_step(make_sched_task_callback(lambda: hits.append("c"))) == 1
    s.submit()
    assert hits == ["a", "b", "c"]


def test_schedule_of_facade_ops(lib):
    lib.set_force_no_acceleration(True)
    A = Matrix.from_lists([0, 1, 2], [1, 2, 0], [1, 2, 3], shape=(3, 3), dtype=INT)
    v = Vector.from_lists([0], [1], 3, INT)
    box = {"v": v}

    def step():
        box["v"] = box["v"].vxm(box["v"], A, INT.MULT, INT.PLUS, INT.ALWAYS)
        return box["v"].to_numpy().tolist()

    s = Schedule()
    s.add_step(ScheduleTask(step, "vxm"), ScheduleTask(step, "vxm"))
    s.add_step(ScheduleTask(lambda: box["v"].reduce(INT.PLUS).get(), "reduce"))
    assert [t.get_key() for st in s._steps for t in st] == ["vxm", "vxm", "reduce"]
    # v = e0: e0 A = 1 e1, then 1 * 2 e2; the sum is 2
    assert s.submit() == [[0, 1, 0], [0, 0, 2], 2]


def test_banner():
    r = subprocess.run([sys.executable, "-m", "spla_tpu_torch"], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "****** spla_tpu_torch ******"
    assert lines[-1].startswith("no accelerator (torch ")
