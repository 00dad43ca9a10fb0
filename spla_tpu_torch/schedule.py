"""Deferred-execution schedule (counterpart of ``spla_tpu/schedule.py``).

The reference submits ScheduleTask objects through a single-threaded
schedule (``src/schedule/schedule_st.cpp:46-69``, task classes
``src/schedule/schedule_tasks.hpp:47-465``).  Here a task is a thunk and a
schedule runs its steps in order; callback tasks (reference
exec_callback) are expressed so.
"""

from __future__ import annotations

from typing import Callable, List

__all__ = ["ScheduleTask", "Schedule", "make_schedule", "make_sched_task_callback"]


class ScheduleTask:
    """A deferred op application (reference ScheduleTask_*)."""

    def __init__(self, fn: Callable, name: str = "task"):
        self.fn = fn
        self.name = name

    def execute(self):
        return self.fn()

    def get_key(self) -> str:
        return self.name


class Schedule:
    """Ordered steps of task lists, submitted in order (reference
    ScheduleSingleThread::submit)."""

    def __init__(self):
        self._steps: List[List[ScheduleTask]] = []

    def add_step(self, *tasks: ScheduleTask) -> int:
        self._steps.append(list(tasks))
        return len(self._steps) - 1

    def add_task(self, step: int, task: ScheduleTask) -> None:
        self._steps[step].append(task)

    def submit(self):
        return [task.execute() for step in self._steps for task in step]


def make_schedule() -> Schedule:
    return Schedule()


def make_sched_task_callback(fn: Callable) -> ScheduleTask:
    """Reference exec_callback / ScheduleTask_callback."""
    return ScheduleTask(fn, "callback")
