"""LeoTrainer, the training half: LoRA training of MSR3D over injected loaders.

Counterpart of ``msr3d_tpu/trainer/leo_trainer.py`` (``__init__``,
``_device_batch``, ``train_one_epoch``, ``run``, the learnable and full-
state checkpoints, resume). ``cfg`` is a nested mapping with the YAML's
keys (``solver.*``, ``exp_dir``, ``rng_seed``, ``save_frequency``,
``resume``); ``loaders`` maps task → split → an iterable of the data dicts
the datasets yield; ``model`` is a port ``MSR3D``.

One optimizer step takes ``solver.gradient_accumulation_steps`` data
dicts. Their prompts (left-padded) and answers (bos + eos, right-padded)
share widths bucketed to multiples of 32 across the group, as in the JAX
trainer. The epoch's tail group trains too (``steps_per_epoch`` rounds up).
Dropout draws from a ``torch.Generator`` seeded from ``rng_seed`` on the
model's device.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md's
queue): building the model, loaders or evaluators from the YAML, eval
splits, ``parallel.tp/pp/sp > 1`` and fixed multi-host text buckets,
``remat``, ``inference_mode: retrieval``, ``vision_freeze: False`` and the
``Lamb`` optimizer.
"""

from __future__ import annotations

import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from msr3d_tpu_torch.optim.build import build_optim
from msr3d_tpu_torch.trainer.checkpoint import CheckpointManager, Tracker
from msr3d_tpu_torch.trainer.train_state import TrainStep, filter_learnable, merge_learnable
from msr3d_tpu_torch.utils.logging import MetricLogger, StepTimer, get_logger

logger = get_logger("msr3d_tpu_torch.trainer")

_TRAINING_SLICE = ("ROADMAP.md, queue: the training entry and what the first training "
                   "slice left")


def _not_ported(what: str, item: str = _TRAINING_SLICE) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


def _cfg(cfg: Mapping[str, Any], path: str, default=None):
    """The value at a dotted ``path`` of the nested config, or ``default``."""
    for key in path.split("."):
        if not isinstance(cfg, Mapping) or key not in cfg:
            return default
        cfg = cfg[key]
    return cfg


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class LeoTrainer:
    """``LeoTrainer(cfg, loaders, model=model).run()`` trains; so does
    ``train_one_epoch(epoch)``."""

    def __init__(self, cfg: Mapping[str, Any], loaders: Optional[Dict[str, Dict[str, Any]]] = None,
                 evaluators: Optional[Dict[str, Any]] = None, model=None):
        if model is None:
            raise _not_ported("building the model from the YAML (models/build.py)")
        if loaders is None:
            raise _not_ported("building the loaders from the YAML (data/build.py)")
        if evaluators:
            raise _not_ported("evaluation inside LeoTrainer")
        self._check_ported(cfg, model, loaders)
        self.model = model
        self.exp_dir = Path(cfg.get("exp_dir") or "./exp_default")
        self.exp_dir.mkdir(parents=True, exist_ok=True)

        solver = cfg["solver"]
        self.epochs = int(solver["epochs"])
        self.accum_steps = int(solver.get("gradient_accumulation_steps", 1))
        self.save_frequency = int(cfg.get("save_frequency", 0) or 0) or None
        train_loaders = [splits["train"] for splits in loaders.values() if "train" in splits]
        if len(train_loaders) != 1:
            raise ValueError(f"one train loader expected, got {len(train_loaders)}")
        self.train_loader = train_loaders[0]
        # ceil: the epoch's tail group trains too, and the schedule counts it
        self.steps_per_epoch = max(1, -(-len(self.train_loader) // self.accum_steps))
        total_steps = self.steps_per_epoch * self.epochs

        self.trainable_names = model.trainable_parameter_names()
        named = dict(model.network.named_parameters())
        self.params = {n: named[n] for n in self.trainable_names}
        self.optimizer, self.schedule, grad_norm = build_optim(cfg, total_steps, self.params)
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(int(cfg.get("rng_seed", 42)))
        self._train_step = TrainStep(self._micro_batch_loss, self.params, self.optimizer,
                                     grad_norm)

        self.tracker = Tracker(run_id=str(uuid.uuid4())[:8])
        self.ckpt = CheckpointManager(self.exp_dir / "ckpt")
        self.logger = MetricLogger(exp_dir=self.exp_dir)
        self.timer = StepTimer()
        if cfg.get("resume", False):
            self._try_resume()

    @staticmethod
    def _check_ported(cfg, model, loaders) -> None:
        for task, splits in loaders.items():
            if set(splits) - {"train"}:
                raise _not_ported(f"evaluation of {task}/{sorted(set(splits) - {'train'})}")
        for axis in ("tp", "pp", "sp"):
            if int(_cfg(cfg, f"parallel.{axis}", 1)) > 1:
                raise _not_ported(f"parallel.{axis} > 1", "ROADMAP.md, queue: parallelism")
        if cfg.get("fixed_text_buckets", False):
            raise _not_ported("fixed_text_buckets (the multi-host text widths)",
                              "ROADMAP.md, queue: parallelism")
        if _cfg(cfg, "model.llm.remat", False) or model.cfg.llm.remat:
            raise _not_ported("remat (activation checkpointing)")
        if _cfg(cfg, "model.llm.inference_mode", "generation") == "retrieval":
            raise _not_ported("inference_mode: retrieval",
                              "ROADMAP.md, queue: the other modes")
        if not model.cfg.prompter.vision_freeze:
            raise _not_ported("vision_freeze: False (the port's PointNet++ has inference "
                              "BatchNorm only)")

    # ------------------------------------------------------------------

    def _device_batch(self, data_dicts: List[Dict[str, Any]]) -> List[Dict[str, torch.Tensor]]:
        """One loss batch per data dict, on the model's device, with prompt
        and answer widths shared across the group (multiples of 32)."""
        model = self.model
        encoded = []
        for dd in data_dicts:
            ii, am = model._encode_prompts(model.build_text_prompt(dd))
            oi, om = model._encode_answers(dd["text_output"])
            encoded.append((dd, ii, am, oi, om))
        pad_in = _round_up(max(e[1].shape[1] for e in encoded), 32)
        pad_out = _round_up(max(e[3].shape[1] for e in encoded), 32)
        pad_id = model.tokenizer.pad_id

        def pad(x, width, fill, left):
            out = np.full((x.shape[0], width), fill, x.dtype)
            if left:
                out[:, width - x.shape[1]:] = x
            else:
                out[:, :x.shape[1]] = x
            return out

        return [
            model.loss_batch(dd, pad(ii, pad_in, pad_id, True), pad(am, pad_in, 0, True),
                             pad(oi, pad_out, pad_id, False), pad(om, pad_out, 0, False))
            for dd, ii, am, oi, om in encoded
        ]

    def _micro_batch_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model.network(**batch, generator=self.generator)["loss"].mean()

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        losses: List[float] = []
        group: List[Dict[str, Any]] = []
        skip = self.tracker.loader_step if epoch == self.tracker.epoch else 0

        def flush(consumed_through: int) -> None:
            nonlocal group
            batches = self._device_batch(group)
            group = []
            network = self.model.network
            network.train()
            try:
                self.timer.tic()
                metrics = self._train_step(batches)
                dt = self.timer.toc()
            finally:
                network.eval()
            step = self._train_step.step_count
            self.tracker.loader_step = consumed_through
            if self.save_frequency and step % self.save_frequency == 0:
                self.ckpt.save_state(step, self._state_dict(), self.tracker)
            losses.append(metrics["loss"])
            if step % 10 == 0 or step <= 2:
                self.logger.log(
                    {
                        "train/loss": metrics["loss"],
                        "train/grad_norm": metrics["grad_norm"],
                        "train/lr": float(self.schedule(step)),
                        "train/step_time_s": dt,
                        "epoch": epoch,
                    },
                    step=step,
                )

        i = -1
        for i, data_dict in enumerate(self.train_loader):
            if i < skip:
                continue
            group.append(data_dict)
            if len(group) == self.accum_steps:
                flush(i + 1)
        if group:
            flush(i + 1)
        return {"loss": float(np.mean(losses)) if losses else float("nan")}

    def run(self) -> None:
        for epoch in range(self.tracker.epoch, self.epochs):
            t0 = time.time()
            stats = self.train_one_epoch(epoch)
            logger.info(f"epoch {epoch}: loss {stats['loss']:.4f} ({time.time() - t0:.0f}s)")
            self.tracker.step_epoch()
            self.ckpt.save_state(self._train_step.step_count, self._state_dict(), self.tracker)
            self._save_learnable("latest")
        self.logger.close()

    # -- checkpoint plumbing --------------------------------------------

    def _state_dict(self) -> Dict[str, Any]:
        return {
            "params": filter_learnable(self.model.network, self.trainable_names),
            "opt_state": self.optimizer.state_dict(),
            "step": self._train_step.step_count,
        }

    def _save_learnable(self, name: str) -> None:
        self.ckpt.save_weights(name, filter_learnable(self.model.network,
                                                      self.trainable_names))

    def _try_resume(self) -> None:
        state = self.ckpt.restore_state(self.tracker)
        if state is None:
            return
        merge_learnable(self.model.network, state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self._train_step.step_count = int(state["step"])
        logger.info(f"resumed from step {self._train_step.step_count} "
                    f"(epoch {self.tracker.epoch}, loader_step {self.tracker.loader_step})")
