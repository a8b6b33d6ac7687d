"""Metric logging, as `s2d_tpu/utils/events.py`: scalars of each logged
step go to `OUTPUT_DIR/metrics.json` (one JSON object a line, with its
"iteration") and, where `torch.utils.tensorboard` imports, to a
tensorboard event file beside it; every `PRINT_PERIOD` iterations the
console gets the window's means and the iterations a second."""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Optional

PRINT_PERIOD = 20  # detectron2's metric drain period, as JAX's logger's


class MetricLogger:
    def __init__(self, output_dir: Optional[str] = None):
        self._json_path = None
        self._tb = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._json_path = os.path.join(output_dir, "metrics.json")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # the sink is optional, as in JAX
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=output_dir)
        self._window: deque = deque(maxlen=PRINT_PERIOD)
        self._last_flush = time.perf_counter()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        scalars["iteration"] = step
        self._window.append(scalars)
        if self._json_path:
            with open(self._json_path, "a") as f:
                f.write(json.dumps(scalars) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                if k != "iteration":
                    self._tb.add_scalar(k, v, step)
        if step % PRINT_PERIOD == 0:
            self._print(step)

    def _print(self, step: int) -> None:
        keys = [k for k in self._window[-1] if k != "iteration"]
        means = {k: sum(m.get(k, 0.0) for m in self._window) / len(self._window) for k in keys}
        now = time.perf_counter()
        iters_per_sec = len(self._window) / max(now - self._last_flush, 1e-9)
        self._last_flush = now
        parts = "  ".join(f"{k}: {v:.4f}" for k, v in sorted(means.items()))
        print(f"iter {step}  {parts}  ({iters_per_sec:.2f} it/s)", flush=True)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
