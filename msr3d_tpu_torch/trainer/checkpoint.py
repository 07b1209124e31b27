"""Checkpoints: the full training state, and learnable-only weights.

Counterpart of ``msr3d_tpu/trainer/checkpoint.py`` with ``torch.save`` in
place of orbax (which the GPU host does not have):

  1. The full training state (the trainable parameters, the optimizer
     state and step, and the ``Tracker``), one file per step under
     ``state/``, keeping only the newest, as the JAX trainer does. The
     frozen base is not part of it: nothing changes it, so it is rebuilt
     as it was.
  2. Weights-only learnable parameters by name (``latest``, ``best``),
     restored by overlaying them on a model.

Files are read back with ``torch.load(weights_only=True)``: tensors,
numbers and strings only.

With ``async_save`` (the config's ``async_checkpoint``) a full-state save
takes a CPU copy of the state at once and writes it from one background
thread, so training goes on while the file streams to disk; saves run one
after another in the order they were made, and ``wait()`` fences them (the
restore, ``latest_step`` and the end of a run wait), as orbax's
``wait_until_finished`` does in the JAX package.

With several ranks only rank 0 writes (``write=False`` elsewhere: the saves
do nothing) into the one shared directory, which every rank reads; the
trainer puts a barrier after each save. The JAX package writes from every
process into its own directory.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass
class Tracker:
    """Checkpointable progress record."""

    run_id: str = ""
    epoch: int = 0
    loader_step: int = 0
    overall_best_result: float = 0.0

    def state_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for k, v in state.items():
            if hasattr(self, k):
                setattr(self, k, v)

    def step_epoch(self) -> None:
        self.epoch += 1
        self.loader_step = 0


def _save(obj: Any, path: Path) -> None:
    """Write through a temporary file so a reader never sees half a file."""
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _to_cpu(obj: Any) -> Any:
    """A copy of a nested state with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, ckpt_dir: str | Path, async_save: bool = False, write: bool = True):
        self.dir = Path(ckpt_dir).resolve()
        self.state_dir = self.dir / "state"
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self.async_save = bool(async_save)
        self.write = write
        self._writer: Optional[ThreadPoolExecutor] = None  # one thread: saves in order
        self._pending: list[Future] = []

    # -- full training state -------------------------------------------------

    def _steps(self):
        return sorted(int(p.stem) for p in self.state_dir.glob("*.pt") if p.stem.isdigit())

    def _write_state(self, step: int, saved: Dict[str, Any]) -> None:
        _save(saved, self.state_dir / f"{step}.pt")
        for old in self._steps()[:-1]:
            (self.state_dir / f"{old}.pt").unlink()

    def save_state(self, step: int, state: Dict[str, Any], tracker: Tracker) -> None:
        """``state``: {"params", "opt_state", "step"}; overwrites ``step``.
        With ``async_save`` it returns once the CPU copy is taken."""
        if not self.write:
            return
        saved = {"state": _to_cpu(state), "tracker": tracker.state_dict()}
        if not self.async_save:
            self._write_state(step, saved)
            return
        if self._writer is None:
            self._writer = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="checkpoint-writer")
        self._pending.append(self._writer.submit(self._write_state, step, saved))

    def wait(self) -> None:
        """Block until every save made so far is on disk; a failed save
        raises here."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def close(self) -> None:
        """``wait()``, then stop the writer thread."""
        self.wait()
        if self._writer is not None:
            self._writer.shutdown()
            self._writer = None

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_state(self, tracker: Tracker) -> Optional[Dict[str, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        saved = torch.load(self.state_dir / f"{step}.pt", map_location="cpu",
                           weights_only=True)
        tracker.load_state_dict(saved["tracker"])
        return saved["state"]

    # -- weights-only (learnable params) -------------------------------------

    def save_weights(self, name: str, learnable: Dict[str, torch.Tensor]) -> None:
        if self.write:
            _save(learnable, self.dir / f"{name}.pt")

    def load_weights(self, name: str) -> Dict[str, torch.Tensor]:
        return torch.load(self.dir / f"{name}.pt", map_location="cpu", weights_only=True)

    def has_weights(self, name: str) -> bool:
        return (self.dir / f"{name}.pt").exists()
