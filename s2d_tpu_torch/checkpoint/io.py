"""Checkpoint save and resume of the train loop, as
`s2d_tpu/checkpoint/orbax_io.py` (`CheckpointWriter`, `latest_step`,
`restore_checkpoint`), with `torch.save` in place of Orbax.

Layout: `<directory>/<step>/state.pt`, one directory a step as JAX's
(`OUTPUT_DIR/checkpoints/<step>/`). A state is `TrainState.state_dict()`:
the student's and the teacher's state_dicts, the optimizer's moments,
accumulator, count and micro-step, and the step. A checkpoint is written
under `<step>.tmp` and renamed, so a directory named by a step is whole.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def _to_host(value: Any) -> Any:
    """A copy of `value` with every tensor copied to host memory."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


def save_checkpoint(directory: str, step: int, state_dict: dict) -> str:
    """Write `state_dict` as step `step` under `directory`; returns its path."""
    final = os.path.join(directory, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state_dict, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    return final


class CheckpointWriter:
    """The train loop's writer: `save(step, state)` copies the state to host
    memory on the calling thread (so the loop may go on changing it) and
    writes it on a background thread, one checkpoint at a time. A write
    error is raised by the next `save`, or by `wait`/`close`."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._err: list = []

    def save(self, step: int, state) -> None:
        self.wait()
        snapshot = _to_host(state.state_dict())
        self._thread = threading.Thread(target=self._write, args=(step, snapshot), daemon=True)
        self._thread.start()

    def _write(self, step: int, snapshot: dict) -> None:
        try:
            save_checkpoint(self.directory, step, snapshot)
        except BaseException as e:  # re-raised by the next save, wait or close
            self._err.append(e)

    def wait(self) -> None:
        """Wait for the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            err, self._err = self._err[0], []
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def latest_step(directory: str) -> Optional[int]:
    """The largest step with a whole checkpoint under `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(name) for name in os.listdir(directory)
             if name.isdigit() and os.path.isfile(os.path.join(directory, name, STATE_FILE))]
    return max(steps, default=None)


def restore_checkpoint(directory: str, state, step: Optional[int] = None):
    """Load step `step` (default: the latest) into `state` (a TrainState,
    in place) and return it."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, str(step), STATE_FILE)
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return state
