"""LeoTrainer, the training half: LoRA training of MSR3D from the YAML.

Counterpart of ``msr3d_tpu/trainer/leo_trainer.py`` (``__init__``,
``_device_batch``, ``train_one_epoch``, ``run``, the learnable and full-
state checkpoints, resume, the preemption handlers, ``build_trainer``).
``cfg`` is the YAML's config (a ``Config`` or a nested mapping with its
keys: ``solver.*``, ``exp_dir``, ``rng_seed``, ``save_frequency``,
``resume``, ``preempt_save``, ``model``, ``data``, ``task``). Without an
injected ``model`` it is built from ``cfg.model`` (``models/build.py``),
given seeded random weights and then the checkpoints the config names
(``load_pretrained_from_config``); without injected ``loaders`` they are
built from ``cfg.task`` (``data/build.py``), task → split → an iterable of
the data dicts the datasets yield.

One optimizer step takes ``solver.gradient_accumulation_steps`` data
dicts. Their prompts (left-padded) and answers (bos + eos, right-padded)
share widths bucketed to multiples of 32 across the group, as in the JAX
trainer. The epoch's tail group trains too (``steps_per_epoch`` rounds up).
Dropout draws from a ``torch.Generator`` seeded from ``rng_seed`` on the
model's device; its state is part of the full training state. The time the
loop waits on the loader is logged with each step (``train/data_wait_s``).

SIGTERM and SIGUSR1 set a flag that is read at the optimizer-step
boundary: the trainer then saves the full state and returns, and a rerun
with the same ``exp_dir`` and ``resume: True`` goes on from there
(``preempt_save: false`` turns this off).

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md's
queue): evaluation (val/test splits, evaluators, ``mode: test``,
``inference_mode: retrieval``), ``parallel.tp/pp/sp > 1`` and fixed
multi-host text buckets, ``remat``, and ``vision_freeze: False``.
"""

from __future__ import annotations

import contextlib
import signal
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from msr3d_tpu_torch.config import Config, cfg2dict, config_from_dict
from msr3d_tpu_torch.optim.build import build_optim
from msr3d_tpu_torch.registry import TRAINER_REGISTRY
from msr3d_tpu_torch.trainer.checkpoint import CheckpointManager, Tracker
from msr3d_tpu_torch.trainer.train_state import TrainStep, filter_learnable, merge_learnable
from msr3d_tpu_torch.utils.logging import MetricLogger, StepTimer, get_logger

logger = get_logger("msr3d_tpu_torch.trainer")

_EVALUATION = "ROADMAP.md, queue: the training entry, (b) evaluation"


class Preempted(Exception):
    """Raised at an optimizer-step boundary after SIGTERM/SIGUSR1; the
    epoch loop saves the full training state and returns."""


def _not_ported(what: str, item: str) -> NotImplementedError:
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


@TRAINER_REGISTRY.register(name="LeoTrainer")
class LeoTrainer:
    """``LeoTrainer(cfg).run()`` trains (``build_trainer(cfg).run()`` from
    the entry); so does ``train_one_epoch(epoch)``. ``loaders`` and
    ``model`` may be injected."""

    def __init__(self, cfg, loaders: Optional[Dict[str, Dict[str, Any]]] = None,
                 evaluators: Optional[Dict[str, Any]] = None, model=None):
        config = cfg if isinstance(cfg, Config) else config_from_dict(dict(cfg))
        cfg = cfg2dict(config)  # resolved once: plain dicts from here on
        self.cfg = cfg
        if evaluators:
            raise _not_ported("evaluation inside LeoTrainer", _EVALUATION)
        if cfg.get("mode", "train") != "train":
            raise _not_ported(f"mode {cfg.get('mode')!r} (evaluation)", _EVALUATION)
        if loaders is None:
            from msr3d_tpu_torch.data.build import build_task_loaders

            loaders = build_task_loaders(config)
        built = model is None
        if built:
            from msr3d_tpu_torch.models.build import build_model

            model = build_model(config)
        self._check_ported(cfg, model, loaders)
        if built:  # weights after the checks: a 7B init is not cheap
            from msr3d_tpu_torch.models.load_weights import load_pretrained_from_config

            model.init_params()
            for src in load_pretrained_from_config(model, config):
                logger.info(f"loaded pretrained weights: {src}")
        self.model = model
        self.exp_dir = Path(cfg.get("exp_dir") or "./exp_default")
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        self._preempted = False  # set by the SIGTERM/SIGUSR1 handler

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
        self.data_wait_history: List[float] = []  # seconds the loop waited on the loader, a step
        if cfg.get("resume", False):
            self._try_resume()

    @staticmethod
    def _check_ported(cfg, model, loaders) -> None:
        for task, splits in loaders.items():
            if set(splits) - {"train"}:
                raise _not_ported(f"evaluation of {task}/{sorted(set(splits) - {'train'})}",
                                  _EVALUATION)
        for axis in ("tp", "pp", "sp"):
            if int(_cfg(cfg, f"parallel.{axis}", 1)) > 1:
                raise _not_ported(f"parallel.{axis} > 1", "ROADMAP.md, queue: parallelism")
        if cfg.get("fixed_text_buckets", False):
            raise _not_ported("fixed_text_buckets (the multi-host text widths)",
                              "ROADMAP.md, queue: parallelism")
        if _cfg(cfg, "model.llm.remat", False) or model.cfg.llm.remat:
            raise _not_ported("remat (activation checkpointing)",
                              "ROADMAP.md, queue: QLoRA and the training-memory options")
        if _cfg(cfg, "model.llm.inference_mode", "generation") == "retrieval":
            raise _not_ported("inference_mode: retrieval", _EVALUATION)
        if not model.cfg.prompter.vision_freeze:
            raise _not_ported("vision_freeze: False (the port's PointNet++ has inference "
                              "BatchNorm only)", "ROADMAP.md, queue: the other modes")

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
        """One pass over the train loader. Raises ``Preempted`` at the first
        step boundary after a preemption signal (a partial group trains
        first, as the epoch's tail does, so ``tracker.loader_step`` marks
        exactly what was trained on)."""
        losses: List[float] = []
        group: List[Dict[str, Any]] = []
        skip = self.tracker.loader_step if epoch == self.tracker.epoch else 0
        waited = 0.0

        def flush(consumed_through: int) -> None:
            nonlocal group, waited
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
            self.data_wait_history.append(waited)
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
                        "train/data_wait_s": waited,
                        "epoch": epoch,
                    },
                    step=step,
                )
            waited = 0.0

        batches = iter(self.train_loader)
        i = -1
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    data_dict = next(batches)
                except StopIteration:
                    break
                i += 1
                if i < skip:
                    continue
                waited += time.perf_counter() - t0
                group.append(data_dict)
                if len(group) == self.accum_steps:
                    flush(i + 1)
                if self._preempted:
                    if group:
                        flush(i + 1)
                    raise Preempted()
            if group:
                flush(i + 1)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()  # stops the loader's prefetch thread
        return {"loss": float(np.mean(losses)) if losses else float("nan")}

    def run(self) -> None:
        with self._preemption_handlers():
            self._run_train()
        self.logger.close()

    def _run_train(self) -> None:
        for epoch in range(self.tracker.epoch, self.epochs):
            t0 = time.time()
            try:
                stats = self.train_one_epoch(epoch)
            except Preempted:
                step = self._train_step.step_count
                self.ckpt.save_state(step, self._state_dict(), self.tracker)
                logger.warning(f"preempted at epoch {epoch}, step {step}: full state saved; "
                               "rerun with the same exp_dir and resume=True to go on")
                return
            logger.info(f"epoch {epoch}: loss {stats['loss']:.4f} ({time.time() - t0:.0f}s)")
            self.tracker.step_epoch()
            self.ckpt.save_state(self._train_step.step_count, self._state_dict(), self.tracker)
            self._save_learnable("latest")

    def _preemption_handlers(self):
        """SIGTERM/SIGUSR1 handlers that set the flag ``train_one_epoch``
        reads at step boundaries (the step in flight completes). Off with
        ``preempt_save: false``; a no-op outside the main thread."""
        if not bool(self.cfg.get("preempt_save", True)):
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def handlers():
            def handler(signum, frame):
                self._preempted = True

            saved = []
            try:
                for sig in (signal.SIGTERM, signal.SIGUSR1):
                    saved.append((sig, signal.signal(sig, handler)))
            except ValueError:  # not the main thread
                pass
            try:
                yield
            finally:
                for sig, prev in saved:
                    signal.signal(sig, prev)

        return handlers()

    # -- checkpoint plumbing --------------------------------------------

    def _state_dict(self) -> Dict[str, Any]:
        return {
            "params": filter_learnable(self.model.network, self.trainable_names),
            "opt_state": self.optimizer.state_dict(),
            "step": self._train_step.step_count,
            "generator": self.generator.get_state(),
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
        if "generator" in state:
            self.generator.set_state(state["generator"])
        logger.info(f"resumed from step {self._train_step.step_count} "
                    f"(epoch {self.tracker.epoch}, loader_step {self.tracker.loader_step})")


def build_trainer(cfg, **kwargs):
    """``cfg.trainer``'s class (``LeoTrainer``) on ``cfg``."""
    return TRAINER_REGISTRY.get(cfg.get("trainer", "LeoTrainer"))(cfg, **kwargs)
