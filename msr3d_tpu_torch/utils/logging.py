"""Experiment logging: a JSONL metric stream and a step timer.

Copy of ``msr3d_tpu/utils/logging.py`` for the port. The JSONL file under
the experiment directory is the record; the JAX package's optional wandb
mirror is left out (it needs the network, which the GPU host does not have).
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

_LOG_FORMAT = "[%(asctime)s][%(name)s][%(levelname)s] %(message)s"


def get_logger(name: str = "msr3d_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_LOG_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricLogger:
    """Step-metric sink: ``<exp_dir>/metrics.jsonl``, one record a line.
    ``write=False`` (every rank but rank 0) logs nothing."""

    def __init__(self, exp_dir: str | Path, write: bool = True):
        self._fh = None
        if write:
            path = Path(exp_dir) / "metrics.jsonl"
            path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(path, "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if self._fh is None:
            return
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        rec["ts"] = time.time()
        self._fh.write(json.dumps(rec, default=float) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class StepTimer:
    """Wall-clock step timing."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.history: list[float] = []

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        if self._t0 is None:
            raise RuntimeError("tic() before toc()")
        dt = time.perf_counter() - self._t0
        self.history.append(dt)
        self._t0 = None
        return dt
