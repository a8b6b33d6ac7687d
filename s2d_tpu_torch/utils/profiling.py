"""Step timing and device traces of the train loop, the port of
`s2d_tpu/utils/profiling.py`'s `StepTimer` and `trace`: `StepTimer` splits
each step's wall time into the wait for its batch (`data_time`) and the
step (`time` is both), and `trace` records a `torch.profiler` trace of the
CPU and, on a card, CUDA.

JAX's timer measures from one metric readback to the next, so a step's
`data_time` there also holds a checkpoint's save, and the second step's
the whole first step; this one times each step where it runs (a port of
the reference's IterationTimer split rather than of JAX's)."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the block into `logdir`/trace.json (no-op when logdir is
    empty)."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """A step's wall time split as detectron2's trainer splits it:
    `data_time` is the wait for the step's batch, `time` that wait plus the
    step's call (on a card the step reads its loss back to skip a
    non-finite one, so the call ends with the device's forward and
    backward). The loop calls `start` before it asks for a batch, so a
    checkpoint or an eval between two steps counts in neither."""

    def __init__(self):
        self._t0 = self._t1 = time.perf_counter()
        self.data_time = 0.0
        self.step_time = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def data_done(self) -> None:
        self._t1 = time.perf_counter()
        self.data_time = self._t1 - self._t0

    def step_done(self) -> None:
        self.step_time = time.perf_counter() - self._t1

    def metrics(self):
        return {"data_time": self.data_time, "time": self.data_time + self.step_time}
