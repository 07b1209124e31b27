"""LeoTrainer: LoRA training and evaluation of MSR3D from the YAML.

Counterpart of ``msr3d_tpu/trainer/leo_trainer.py`` (``__init__``,
``_device_batch``, ``train_one_epoch``, ``eval_task``, ``_run_eval``,
``run``, the learnable and full-state checkpoints, resume, the preemption
handlers, ``build_trainer``).
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

A step's loss and grad norm are read from the device ``train_metrics_lag``
steps after the step was dispatched (default 1, as in the JAX trainer; 0 reads
each step at once), so the loop does not wait on the card between steps; the
reads drain at the epoch's end and before a preemption save, and
``train/step_time_s`` is the time from dispatch to that read.
``async_checkpoint: true`` writes the full-state saves from a background
thread (``CheckpointManager``). ``profile.steps: n`` traces the steps after
step 2 through step 2 + n with ``torch.profiler`` into ``exp_dir/profile``.

SIGTERM and SIGUSR1 set a flag that is read at the optimizer-step
boundary: the trainer then saves the full state and returns, and a rerun
with the same ``exp_dir`` and ``resume: True`` goes on from there
(``preempt_save: false`` turns this off).

Evaluation: one evaluator a task that names one (``build_task_evaluators``,
or injected), run over the task's ``val`` loader every ``eval_interval``
epochs and over its ``test`` loader after the last, at most
``num_batch_eval`` batches each. Generation (``inference_mode:
generation``) decodes each batch with ``MSR3D.generate_async``, at most
``eval_pipeline_depth`` batches (default 3) waiting for their
``finalize``, with ``eval_engine: continuous`` through the slot-refill
engines of ``serving.py`` (``_eval_continuous``; with
``eval_engine_opts.prefix_pool`` the prefix-pool engines), or with
``eval_engine: grouped`` through the scene-grouped batcher
(``_eval_grouped``); retrieval
scores the
dataset's ``answer_cands`` with ``MSR3D.predict_answers``. Metrics are
logged as ``{split}/{task}/{metric}`` at the current step, and a val
target above ``tracker.overall_best_result``
saves the learnable weights as ``best``. Any ``mode`` but ``train`` (``test``,
``eval``) loads ``best`` when there is one and evaluates the test split; a
config without a train task builds no optimizer.

Data parallelism (one process a rank over ``torch.distributed``,
``parallel/mesh.py``): dp is the world size. Each rank's loaders hold its
shard of each split (``data/build.py``), so every rank takes the same number
of micro-batches a step, which the step checks; ``TrainStep`` averages the
trainable gradients and the loss over the ranks. The trainable parameters
start bit-equal on every rank (seeded init, a digest gathered after init and
after a resume) and must end so (the same check after training raises on a
divergence); each rank's dropout generator is seeded from ``rng_seed``
plus its rank. Text widths are the fixed buckets of ``fixed_text_buckets``
on every multi-rank run (``prompt_pad_to`` and ``max_out_len`` rounded up to
32), as in the JAX trainer. Evaluation drops the last batch's wrap-around
duplicates (``padded_tail``) and gathers every rank's records, rank 0's
first, into each rank's evaluator. Rank 0 alone writes ``metrics.jsonl``,
``results.json`` and the checkpoints, and a barrier follows each save; a
preemption signal stops every rank, dp and tp, at the same step boundary
(the ranks agree the flag with each step's micro-batch count).

Tensor parallelism (``parallel.tp`` > 1): the ranks form dp × tp
(``parallel/mesh.py``'s ``init_mesh``, tp the fastest-varying rank index),
the model is built with the rank's shard of the LLM (``parallel/sharding.py``).
The tp ranks of one dp group compute on the same rows (the loaders shard by
dp rank, and tp rank 0 alone iterates its loader and broadcasts each batch
over the tp group), draw the same dropout masks (the generator is seeded by
dp rank; a row-parallel input's mask is the full mask's slice) and compute
the same loss; ``TrainStep`` sums the partial gradients over tp and
averages over the dp group. The replica checks compare each trainable
parameter within its tp index's dp group, and the replicated ones across the
tp group too. Evaluation gathers records over the dp group only, so each
sample counts once. The checkpoints hold the full tensors, gathered over tp
(rank 0 writes), so a run saved at one tp resumes at another; a load
shards them again.

Pipeline parallelism (``parallel.pp`` > 1, ``parallel.microbatches``
default pp): the ranks form dp × tp × pp (pp the fastest-varying rank
index), and each rank's model holds its stage's blocks beside everything
outside them (an injected full model is split, ``MSR3D.shard_for_training``).
Rank (d, 0, 0) iterates the loader and broadcasts each batch over the dp
index's tp × pp ranks. A step's loss runs the GPipe schedule of
``parallel/llm_pp.py`` over the micro-batches of each accumulation
micro-batch, forward and backward; the trainable parameters outside the
blocks get their gradient on stage 0 alone, which is broadcast over the pp
group before the norm and the clip, so the stages' replicas stay bit-equal
(checked with the dp and tp replicas). The global norm adds each stage's
block gradients once (a sum over pp) and the replicated ones once.
Evaluation gathers the other stages' blocks onto the ranks of pp rank 0,
which evaluate with the whole LLM as at pp = 1 while the other pp ranks wait
at a barrier, and every pp rank gets the results; each sample is scored
once. Checkpoints hold the full tensors, gathered over tp and pp (rank 0
writes), so a run saved at one pp resumes at another; JAX saves its stacked
layout instead, a deliberate difference beside the rank-0 writes.

Sequence parallelism (``parallel.sp`` > 1): the ranks form dp × tp × sp (sp
the fastest-varying rank index; pp × sp raises, as JAX's pipeline asserts),
and each rank's LLM knows its sequence block (an injected model with sp = 1
in its config takes it, ``MSR3D.shard_for_training``). Rank (d, 0, 0, 0)
iterates the loader and broadcasts each batch over the dp index's tp × sp
ranks, which seed their generator by dp rank, so the point encoder, the
prompter and the splices run whole and alike on each; the LLM's training
forward runs on the rank's sequence block with ring attention, the loss is
the whole sequence's on every sp rank, and ``TrainStep`` sums every
trainable gradient over sp before the dp average, the norm and the clip.
The replica checks compare every trainable parameter across the sp group
too. Evaluation runs on every rank (the tp × sp ranks of a dp index on one
broadcast batch); generation is dense or flash, never the ring, and the
records gather over the dp group, so each sample counts once. Checkpoints
hold full tensors (nothing splits over sp), so a run saved at one sp
resumes at another.

Training with the point encoder unfrozen
(``vision.args.freeze: False``) raises ``ValueError``: the JAX trainer fails
on it (its train step does not make ``batch_stats`` mutable), so the port
does not run it either; evaluation with it runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
import uuid
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from msr3d_tpu_torch.config import Config, cfg2dict, config_from_dict
from msr3d_tpu_torch.optim.build import build_optim
from msr3d_tpu_torch.parallel import mesh, pipeline, ring_attention, tensor_parallel
from msr3d_tpu_torch.parallel.mesh import (
    all_reduce_max,
    barrier,
    check_replicas_equal,
    is_main_process,
    process_allgather_objects,
    rank,
)
from msr3d_tpu_torch.parallel.sharding import gather_full_state_dict, shard_like, shard_tensor
from msr3d_tpu_torch.registry import TRAINER_REGISTRY
from msr3d_tpu_torch.trainer.checkpoint import CheckpointManager, Tracker
from msr3d_tpu_torch.trainer.train_state import TrainStep, filter_learnable, merge_learnable
from msr3d_tpu_torch.utils.logging import MetricLogger, StepTimer, get_logger

logger = get_logger("msr3d_tpu_torch.trainer")

# the data dict's keys that go to the evaluators beside the predictions
_RECORD_KEYS = ("answer_list", "answer_label", "text_output", "data_idx", "sqa_type", "source",
                "scan_id", "index", "type", "prompt", "prompt_after_obj", "obj_labels",
                "obj_masks")


class Preempted(Exception):
    """Raised at an optimizer-step boundary after SIGTERM/SIGUSR1; the
    epoch loop saves the full training state and returns."""


def _cfg(cfg: Mapping[str, Any], path: str, default=None):
    """The value at a dotted ``path`` of the nested config, or ``default``."""
    for key in path.split("."):
        if not isinstance(cfg, Mapping) or key not in cfg:
            return default
        cfg = cfg[key]
    return cfg


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _batches(loader, axis: str = "mp"):
    """An iterator over ``loader``'s batches. Where this rank's ``axis``
    group has more than one rank (the tp·pp·sp model-parallel ranks of a dp
    index for ``mp``, the tp ranks for ``tp``) only its first rank
    iterates the loader (its reads, augmentation and workers) and broadcasts
    each batch over the group, then None at its end; the other ranks take
    the broadcasts. So the tp and pp ranks of a dp index compute on one
    batch (a loader draws its points and answers from each process's own
    global generators). Closing it closes the loader's iterator."""
    if mesh.first_group_size(axis) == 1:
        return iter(loader)
    first = mesh.tp_rank() == 0 and (axis == "tp" or mesh.pp_rank() == mesh.sp_rank() == 0)
    return _first_rank_batches(loader, axis) if first else _broadcast_batches(axis)


def _first_rank_batches(loader, axis: str):
    batches = iter(loader)
    try:
        for data_dict in batches:
            yield mesh.broadcast_from_first(data_dict, axis)
        mesh.broadcast_from_first(None, axis)  # the end, for the other ranks
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()


def _broadcast_batches(axis: str):
    while True:
        data_dict = mesh.broadcast_from_first(None, axis)
        if data_dict is None:
            return
        yield data_dict


def _find_answer_cands(loader) -> Optional[List[str]]:
    """The answer vocabulary (``answer_cands``) found down the loader's
    dataset chain (the SQA3D datasets carry it), or None."""
    obj = loader
    for _ in range(8):
        cands = getattr(obj, "answer_cands", None)
        if cands is not None:
            return list(cands)
        nxt = getattr(obj, "dataset", None)
        if nxt is None or nxt is obj:
            return None
        obj = nxt
    return None


@TRAINER_REGISTRY.register(name="LeoTrainer")
class LeoTrainer:
    """``LeoTrainer(cfg).run()`` trains and evaluates, or evaluates alone
    (``build_trainer(cfg).run()`` from the entry); so do
    ``train_one_epoch(epoch)`` and ``eval_task(task, split)``. ``loaders``,
    ``evaluators`` and ``model`` may be injected."""

    def __init__(self, cfg, loaders: Optional[Dict[str, Dict[str, Any]]] = None,
                 evaluators: Optional[Dict[str, Any]] = None, model=None):
        config = cfg if isinstance(cfg, Config) else config_from_dict(dict(cfg))
        cfg = cfg2dict(config)  # resolved once: plain dicts from here on
        self.cfg = cfg
        self.mode = cfg.get("mode", "train")
        # generation (the configs' route) or retrieval scoring over the
        # dataset's answer vocabulary
        self.inference_mode = _cfg(cfg, "model.llm.inference_mode", "generation")
        # dp x tp x pp x sp over the ranks
        parallel = cfg.get("parallel") or {}
        self.dp, self.tp = mesh.init_mesh(parallel)
        self.pp, self.sp = mesh.pp_size(), mesh.sp_size()
        self.microbatches = int(parallel.get("microbatches", self.pp))
        self.fixed_text_buckets = self.dp > 1 or bool(cfg.get("fixed_text_buckets", False))
        if loaders is None:
            from msr3d_tpu_torch.data.build import build_task_loaders

            loaders = build_task_loaders(config)
        built = model is None
        if built:
            from msr3d_tpu_torch.models.build import build_model

            model = build_model(config)
        if built:  # weights after the checks: a 7B init is not cheap
            from msr3d_tpu_torch.models.load_weights import load_pretrained_from_config

            model.init_params()
            for src in load_pretrained_from_config(model, config):
                logger.info(f"loaded pretrained weights: {src}")
        llm = model.cfg.llm
        if (llm.tp_size, llm.pp_size, llm.sp_size) == (1, 1, 1) and (self.pp > 1 or self.sp > 1):
            model.shard_for_training()  # a full model: this rank's stage, tp shard, sp block
            llm = model.cfg.llm
        if (llm.tp_size, llm.pp_size, llm.sp_size) != (self.tp, self.pp, self.sp):
            raise ValueError(f"the model's LLM is split over tp={llm.tp_size} x pp="
                             f"{llm.pp_size} x sp={llm.sp_size}, the config's parallel.tp x pp "
                             f"x sp is {self.tp} x {self.pp} x {self.sp}")
        self.model = model
        self.loaders = loaders
        self.exp_dir = Path(cfg.get("exp_dir") or "./exp_default")
        self.exp_dir.mkdir(parents=True, exist_ok=True)
        if evaluators is None:
            from msr3d_tpu_torch.evaluator.build import build_task_evaluators

            evaluators = build_task_evaluators(cfg, self.exp_dir)
        if not is_main_process():  # rank 0 writes results.json
            for evaluator in evaluators.values():
                if hasattr(evaluator, "save"):
                    evaluator.save = False
        self.evaluators = evaluators
        self._preempted = False  # set by the SIGTERM/SIGUSR1 handler
        self._stop = False  # the ranks' agreed preemption flag (more than one rank)
        self.replicated_digest: Optional[str] = None  # of the last tp replica check
        self.pp_digest: Optional[str] = None  # of the last pp replica check
        self.sp_digest: Optional[str] = None  # of the last sp replica check
        self._whole_depth = 0  # open _whole_llm contexts (pp: the other stages' blocks held)

        solver = cfg["solver"]
        self.epochs = int(solver["epochs"])
        self.accum_steps = int(solver.get("gradient_accumulation_steps", 1))
        self.eval_interval = int(solver.get("eval_interval", 1))
        self.num_batch_eval = int(solver.get("num_batch_eval", 0) or 0) or None
        self.save_frequency = int(cfg.get("save_frequency", 0) or 0) or None
        self.metrics_lag = max(0, int(cfg.get("train_metrics_lag", 1)))
        self.profile_steps = int((cfg.get("profile") or {}).get("steps", 0) or 0)
        self._profiler = None
        train_loaders = [splits["train"] for splits in loaders.values() if "train" in splits]
        if len(train_loaders) > 1:
            raise ValueError(f"one train loader expected, got {len(train_loaders)}")
        self.train_loader = train_loaders[0] if train_loaders else None
        if (self.train_loader is not None and self.mode == "train"
                and not model.cfg.prompter.vision_freeze):
            raise ValueError(
                "vision.args.freeze: False with a train loader: the JAX trainer fails on it "
                "(flax.errors.ModifyScopeVariableError: its train step applies the "
                "network without mutable=['batch_stats'], which the point encoder's "
                "training BatchNorm writes), so the port does not train it; evaluation "
                "with freeze: False runs")
        # ceil: the epoch's tail group trains too, and the schedule counts it
        self.steps_per_epoch = (max(1, -(-len(self.train_loader) // self.accum_steps))
                                if self.train_loader is not None else 1)
        total_steps = self.steps_per_epoch * self.epochs

        self.trainable_names = model.trainable_parameter_names()
        self.generator = torch.Generator(device=model.device)
        # by dp rank: the tp ranks of a dp group draw the same masks
        self.generator.manual_seed(int(cfg.get("rng_seed", 42)) + mesh.dp_rank())
        self.optimizer = self.schedule = self._train_step = None
        if self.train_loader is not None:  # evaluation alone needs no optimizer
            named = dict(model.network.named_parameters())
            self.params = {n: named[n] for n in self.trainable_names}
            self.optimizer, self.schedule, grad_norm = build_optim(cfg, total_steps,
                                                                   self.params)
            network = model.network
            if self.pp > 1:
                from msr3d_tpu_torch.parallel.llm_pp import make_pp_loss_fn

                self._pp_loss = make_pp_loss_fn(network, self.microbatches)
            self._train_step = TrainStep(self._micro_batch_loss, self.params,
                                         self.optimizer, grad_norm, data_parallel=self.dp,
                                         tp_sharded=network.tp_dims(),
                                         tp_partial=network.tp_partial(),
                                         pp_local=self._stage_names(self.params)
                                         if self.pp > 1 else None)

        self.tracker = Tracker(run_id=str(uuid.uuid4())[:8])
        self.ckpt = CheckpointManager(self.exp_dir / "ckpt",
                                      async_save=bool(cfg.get("async_checkpoint", False)),
                                      write=is_main_process())
        self.logger = MetricLogger(exp_dir=self.exp_dir, write=is_main_process())
        self.timer = StepTimer()
        self.data_wait_history: List[float] = []  # seconds the loop waited on the loader, a step
        self.tp_comm_history: List[float] = []  # host seconds in tp collectives, a step
        self.pp_comm_history: List[float] = []  # host seconds in pp transfers, a step
        self.sp_comm_history: List[float] = []  # host seconds in the ring's hops, a step
        if cfg.get("resume", False) and self._train_step is not None:
            self._try_resume()
        if mesh.world_size() > 1:
            self._check_replicas("after init" + (" and resume" if cfg.get("resume") else ""))

    @property
    def step(self) -> int:
        """Optimizer steps taken (0 without a train loader)."""
        return self._train_step.step_count if self._train_step is not None else 0

    @staticmethod
    def _stage_names(names) -> List[str]:
        """The names among ``names`` of a pipeline stage's own parameters
        (its blocks'); the others are on every stage."""
        return [n for n in names if n.startswith("llm.layer.")]

    def _check_replicas(self, when: str) -> str:
        """Raise unless each trainable parameter is bit-equal on the ranks of
        its dp group and of its sp group, a tp-replicated one on the tp ranks
        too and one outside the blocks on the pp ranks too; returns the
        digest of this rank's."""
        named = dict(self.model.network.named_parameters())
        mine = {n: named[n] for n in self.trainable_names}
        if self.sp > 1:
            self.sp_digest = check_replicas_equal(mine, f"the trainable parameters {when}",
                                                  group=mesh.sp_control_group())
        if self.pp > 1:
            stage = set(self._stage_names(mine))
            self.pp_digest = check_replicas_equal(
                {n: t for n, t in mine.items() if n not in stage},
                f"the trainable parameters outside the blocks {when}",
                group=mesh.pp_control_group())
        if self.tp > 1:
            sharded = self.model.network.tp_dims()
            self.replicated_digest = check_replicas_equal(
                {n: t for n, t in mine.items() if n not in sharded},
                f"the replicated trainable parameters {when}", group=mesh.tp_control_group())
        return check_replicas_equal(mine, f"the trainable parameters {when}",
                                    group=mesh.dp_control_group())

    # ------------------------------------------------------------------

    def _device_batch(self, data_dicts: List[Dict[str, Any]]) -> List[Dict[str, torch.Tensor]]:
        """One loss batch per data dict, on the model's device, with prompt
        and answer widths shared across the group (multiples of 32), or the
        fixed buckets: widths every rank shares, whatever its batch."""
        model = self.model
        encoded = []
        for dd in data_dicts:
            ii, am = model._encode_prompts(model.build_text_prompt(dd))
            oi, om = model._encode_answers(dd["text_output"])
            encoded.append((dd, ii, am, oi, om))
        max_in = max(e[1].shape[1] for e in encoded)
        if self.fixed_text_buckets:
            pad_in = _round_up(model.prompt_pad_to, 32)
            pad_out = _round_up(model.max_out_len, 32)
            if max_in > pad_in:
                raise ValueError(f"prompt length {max_in} exceeds prompt_pad_to="
                                 f"{model.prompt_pad_to} (the fixed text bucket of "
                                 "fixed_text_buckets and of every multi-rank run)")
        else:
            pad_in = _round_up(max_in, 32)
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
        if self.pp > 1:  # the pipelined forward and backward: a detached loss
            return self._pp_loss(batch, self.generator)
        return self.model.network(**batch, generator=self.generator)["loss"].mean()

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        """One pass over the train loader. Raises ``Preempted`` at the first
        step boundary after a preemption signal (a partial group trains
        first, as the epoch's tail does, so ``tracker.loader_step`` marks
        exactly what was trained on, and every step's metrics are read)."""
        if self.train_loader is None:
            raise ValueError("no train loader configured")
        losses: List[float] = []
        group: List[Dict[str, Any]] = []
        skip = self.tracker.loader_step if epoch == self.tracker.epoch else 0
        waited = 0.0
        pending: deque = deque()  # (metrics, step, dispatch time, data wait)

        def process_one() -> None:
            metrics, step, t0, wait = pending.popleft()
            loss = float(metrics["loss"])  # the read waits for the step
            dt = time.perf_counter() - t0
            self.timer.history.append(dt)
            losses.append(loss)
            if step % 10 == 0 or step <= 2:
                self.logger.log(
                    {
                        "train/loss": loss,
                        "train/grad_norm": float(metrics["grad_norm"]),
                        "train/lr": float(self.schedule(step)),
                        "train/step_time_s": dt,
                        "train/data_wait_s": wait,
                        "epoch": epoch,
                    },
                    step=step,
                )

        def flush(consumed_through: int) -> None:
            nonlocal group, waited
            if mesh.world_size() > 1:
                self._agree_step(len(group))
            batches = self._device_batch(group)
            group = []
            network = self.model.network
            network.train()
            try:
                t0 = time.perf_counter()
                comm0, pp0 = tensor_parallel.COMM["seconds"], pipeline.COMM["seconds"]
                sp0 = ring_attention.COMM["seconds"]
                metrics = self._train_step(batches)
                # host seconds in the tp collectives, the pp transfers and
                # the ring's hops (each waits for the card)
                self.tp_comm_history.append(tensor_parallel.COMM["seconds"] - comm0)
                self.pp_comm_history.append(pipeline.COMM["seconds"] - pp0)
                self.sp_comm_history.append(ring_attention.COMM["seconds"] - sp0)
            finally:
                network.eval()
            step = self._train_step.step_count
            self.tracker.loader_step = consumed_through
            self.data_wait_history.append(waited)
            self._profile(step)
            if self.save_frequency and step % self.save_frequency == 0:
                self._save_state(step)
            pending.append((metrics, step, t0, waited))
            while len(pending) > self.metrics_lag:
                process_one()
            waited = 0.0

        batches = _batches(self.train_loader)
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
                # one process stops at once; ranks only where they agreed to
                if self._preempted if mesh.world_size() == 1 else (self._stop and not group):
                    if group:
                        flush(i + 1)
                    while pending:
                        process_one()
                    raise Preempted()
            if group:
                flush(i + 1)
            while pending:
                process_one()
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()  # stops the loader's prefetch thread
        return {"loss": float(np.mean(losses)) if losses else float("nan")}

    def _agree_step(self, n_micro: int) -> None:
        """One host collective over every rank (dp x tp x pp x sp) before each step of
        more than one rank: every rank must bring the same number of
        micro-batches (equal-length shards guarantee it), and a preemption
        flag raised on any rank stops them all after this step."""
        got = all_reduce_max([n_micro, -n_micro, int(self._preempted)])
        if got[:2] != [n_micro, -n_micro]:
            raise RuntimeError(f"rank {rank()} has {n_micro} micro-batches this step, others "
                               f"between {-got[1]} and {got[0]}")
        self._stop = bool(got[2])

    def _profile(self, step: int) -> None:
        """``profile.steps`` n: start a ``torch.profiler`` trace once step 2
        is dispatched and write it to ``exp_dir/profile`` once step 2 + n is,
        as the JAX trainer traces steps into the same place."""
        if not self.profile_steps:
            return
        if step == 2 and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.model.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif step == 2 + self.profile_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self._profiler is None:
            return
        self._profiler.stop()
        out = self.exp_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace_step{self._train_step.step_count}.json"
        self._profiler.export_chrome_trace(str(path))
        self._profiler = None
        logger.info(f"profiler trace written to {path}")

    @staticmethod
    def _trim_record(record: Dict[str, Any], batch: int, keep: int) -> Dict[str, Any]:
        """Drop the trailing ``batch - keep`` samples of a record (a
        sharded eval loader's wrap-around duplicates)."""
        out = {}
        for k, v in record.items():
            if isinstance(v, (list, tuple)) and len(v) == batch:
                out[k] = list(v)[:keep]
            elif isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == batch:
                out[k] = v[:keep]
            else:
                out[k] = v
        return out

    def eval_task(self, task: str, split: str) -> Dict[str, Any]:
        """Evaluate one task's split → the evaluator's results (``{}``
        without an evaluator), at most ``num_batch_eval`` batches:
        generation through ``MSR3D.generate_async`` with up to
        ``eval_pipeline_depth`` batches unfinalized (the texts are the
        blocking loop's), or through the continuous engines with
        ``eval_engine: continuous``; retrieval through
        ``MSR3D.predict_answers`` over the loader's ``answer_cands``.
        Under pp every rank calls it: the ranks of pp rank 0 evaluate with
        the whole LLM (``_whole_llm``), the others wait for their results.
        Under sp every rank evaluates, the tp × sp ranks of a dp index on the
        batches their first rank broadcasts (retrieval's loss forward runs
        the ring, so they must)."""
        if self.pp == 1:
            return self._eval_task(task, split)
        with self._whole_llm():
            results = self._eval_task(task, split) if mesh.pp_rank() == 0 else None
            return mesh.broadcast_object(results, mesh.global_rank("pp", 0),
                                         mesh.pp_control_group())

    @contextlib.contextmanager
    def _whole_llm(self):
        """pp > 1: for the duration the ranks of pp rank 0 hold the whole LLM
        (their stage's blocks and the other stages', received over the pp
        group, ``llm_pp.gather_whole_llm``) and run generation as at pp = 1;
        the received blocks go at its end. Every pp rank enters it;
        re-entrant."""
        if self.pp == 1 or self._whole_depth:
            self._whole_depth += 1
            try:
                yield
            finally:
                self._whole_depth -= 1
            return
        from msr3d_tpu_torch.parallel.llm_pp import gather_whole_llm

        model = self.model
        stage_llm, stage_cfg = model.network.llm, model.cfg
        whole = gather_whole_llm(stage_llm)
        if whole is not None:
            model.cfg = dataclasses.replace(stage_cfg, llm=whole.cfg)
            model.network.llm, model.network.cfg = whole, model.cfg
        self._whole_depth += 1
        try:
            yield
        finally:
            self._whole_depth -= 1
            model.network.llm, model.cfg, model.network.cfg = stage_llm, stage_cfg, stage_cfg

    def _eval_task(self, task: str, split: str) -> Dict[str, Any]:
        loader = self.loaders[task][split]
        evaluator = self.evaluators.get(task)
        if evaluator is not None:
            evaluator.reset()
        generation = self.inference_mode == "generation"
        answer_cands = None if generation else _find_answer_cands(loader)
        if not generation and answer_cands is None:
            raise ValueError("inference_mode: retrieval needs a dataset with answer_cands "
                             "(e.g. ScanNetSQA3D)")
        # a sharded loader's last batch may end in wrap-around duplicates
        # (padded_tail); they go before the records are gathered from every
        # rank, so each sample is scored once (the identity with one rank)
        n_batches = len(loader) if hasattr(loader, "__len__") else None
        padded_tail = getattr(loader, "padded_tail", 0)

        def emit(i: int, data_dict: Dict[str, Any], record: Dict[str, Any]) -> None:
            if evaluator is None:
                return
            for k in _RECORD_KEYS:
                if k in data_dict:
                    record[k] = data_dict[k]
            if padded_tail and n_batches is not None and i == n_batches - 1:
                b = len(record.get("output_text", record.get("answers_id", [])))
                record = self._trim_record(record, b, b - padded_tail)
            # over the dp group: the tp and sp ranks of a dp group hold the
            # same samples, so each counts once
            for gathered in process_allgather_objects([record], mesh.dp_control_group()):
                evaluator.update(gathered)

        depth = max(0, int(self.cfg.get("eval_pipeline_depth", 3)))
        pending: deque = deque()  # (batch index, data_dict, finalize)

        def finalize_oldest() -> None:
            i, data_dict, finalize = pending.popleft()
            emit(i, data_dict, {"output_text": finalize()["output_text"]})

        batches = _batches(loader, "mp" if self.sp > 1 else "tp")
        try:
            eval_engine = str(self.cfg.get("eval_engine", "") or "").lower()
            if generation and eval_engine == "continuous":
                self._eval_continuous(batches, emit)
            elif generation and eval_engine == "grouped":
                self._eval_grouped(batches, emit)
            else:
                for i, data_dict in enumerate(batches):
                    if self.num_batch_eval and i >= self.num_batch_eval:
                        break
                    if generation:
                        pending.append((i, data_dict, self.model.generate_async(dict(data_dict))))
                        while len(pending) > depth:
                            finalize_oldest()
                    else:
                        out = self.model.predict_answers(dict(data_dict), answer_cands)
                        emit(i, data_dict, {"answer_scores": out["answer_scores"],
                                            "answers_id": out["answers_id"]})
                while pending:
                    finalize_oldest()
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()  # stops the loader's prefetch thread
        if evaluator is None:
            return {}
        _, results = evaluator.record(split)
        return results

    def _eval_continuous(self, batches, emit) -> None:
        """Generation eval through the slot-refill engines (``eval_engine:
        continuous``): the requests of all loader batches share one pool of
        slots, so a short answer's slot refills at once. With ``num_beams``
        above 1 the beam engine serves (each slot one request's beam search
        at its own depth). With ``prefix_pool: true`` the prefix-pool
        engines serve instead (each scene's prefix prefilled once into a
        shared pool of KV blocks: MSQA asks many questions a scene), greedy
        or beam; their knobs are ``num_prefixes``, ``prefix_len`` and
        ``suffix_len``. Engine options come from ``eval_engine_opts``
        (``num_slots``, ``refill_group``, ``chunk_steps``, ``lookahead``,
        ``spec_k``, ...), with the JAX trainer's defaults."""
        from msr3d_tpu_torch.serving import (
            ContinuousBatchingServer,
            ContinuousBeamBatchingServer,
            PrefixPoolContinuousBatchingServer,
            PrefixPoolContinuousBeamBatchingServer,
        )

        opts = dict(self.cfg.get("eval_engine_opts", {}) or {})
        prefix_pool = bool(opts.pop("prefix_pool", False))
        if self.model.num_beams != 1:
            # beam slots carry num_beams KV rows each: a smaller default pool
            cls = (PrefixPoolContinuousBeamBatchingServer if prefix_pool
                   else ContinuousBeamBatchingServer)
            engine = cls(
                self.model, num_slots=int(opts.pop("num_slots", 8)),
                refill_group=int(opts.pop("refill_group", 4)),
                chunk_steps=int(opts.pop("chunk_steps", 16)),
                lookahead=int(opts.pop("lookahead", 1)), **opts)
        elif prefix_pool:
            engine = PrefixPoolContinuousBatchingServer(
                self.model, num_slots=int(opts.pop("num_slots", 32)),
                refill_group=int(opts.pop("refill_group", 8)),
                chunk_steps=int(opts.pop("chunk_steps", 16)),
                lookahead=int(opts.pop("lookahead", 1)), **opts)
        else:
            engine = ContinuousBatchingServer(
                self.model, num_slots=int(opts.pop("num_slots", 32)),
                refill_group=int(opts.pop("refill_group", 8)),
                chunk_steps=int(opts.pop("chunk_steps", 16)),
                lookahead=int(opts.pop("lookahead", 1)),
                spec_k=int(opts.pop("spec_k", 0)), **opts)
        self._eval_requests(batches, emit, lambda samples, on_result: engine.run(
            samples, on_result=on_result), "prefix-pool" if prefix_pool else "continuous")

    def _eval_grouped(self, batches, emit) -> None:
        """Generation eval through the scene-grouped batcher (``eval_engine:
        grouped``): requests whose scene arrays are byte-identical (one scene
        and situation, several questions) are answered by one grouped
        program, the scene encode and prefix prefill once a scene; requests
        that share nothing form singleton groups. Beam search composes. The
        options come from ``eval_engine_opts`` with the JAX trainer's
        defaults: ``scenes_per_batch`` 4, ``questions_per_scene`` 8,
        ``pipeline_depth`` 3, and ``max_open_scenes``, ``max_new_tokens``,
        ``use_beam``."""
        from msr3d_tpu_torch.serving import SceneGroupBatchingServer

        opts = dict(self.cfg.get("eval_engine_opts", {}) or {})
        engine = SceneGroupBatchingServer(
            self.model, scenes_per_batch=int(opts.pop("scenes_per_batch", 4)),
            questions_per_scene=int(opts.pop("questions_per_scene", 8)),
            pipeline_depth=int(opts.pop("pipeline_depth", 3)), **opts)

        def serve(samples, on_result) -> None:
            for res in engine.run(samples):
                on_result(res)

        self._eval_requests(batches, emit, serve, "grouped")

    def _eval_requests(self, batches, emit, serve, what: str) -> None:
        """Feed the loader batches to an engine as single requests and emit
        each batch's texts in loader order once its last request is done.
        Batches are read lazily, and a batch is kept only until then.
        ``serve(samples, on_result)`` runs the engine over the request
        iterator, calling ``on_result`` with each result."""
        from msr3d_tpu_torch.serving import uncollate_batch

        records: Dict[int, list] = {}  # batch index -> [data_dict, texts, left]
        rid_map: List[tuple] = []  # rid -> (batch index, row)
        done: set = set()
        next_emit = 0

        def sample_iter():
            for i, data_dict in enumerate(batches):
                if self.num_batch_eval and i >= self.num_batch_eval:
                    break
                samples = uncollate_batch(data_dict)
                records[i] = [data_dict, [None] * len(samples), len(samples)]
                for j, sample in enumerate(samples):
                    rid_map.append((i, j))
                    yield sample

        def flush() -> None:
            nonlocal next_emit
            while next_emit in done:
                done.discard(next_emit)
                data_dict, texts, _ = records.pop(next_emit)
                emit(next_emit, data_dict, {"output_text": texts})
                next_emit += 1

        def on_result(res) -> None:
            i, j = rid_map[res.id]
            rec = records[i]
            rec[1][j] = res.output_text
            rec[2] -= 1
            if rec[2] == 0:
                done.add(i)
                flush()

        serve(sample_iter(), on_result)
        flush()
        assert not records, f"{what} eval: batches left unemitted"

    def _run_eval(self, split: str, epoch: int) -> None:
        """Evaluate every task with an evaluator and a ``split`` loader, log
        ``{split}/{task}/{metric}`` at the current step, and after val save
        ``best`` when the best task target beats the tracker's."""
        best_metric = -float("inf")
        tasks = [task for task, splits in self.loaders.items()
                 if split in splits and task in self.evaluators]
        # pp: the blocks gathered once for every task
        with self._whole_llm() if tasks else contextlib.nullcontext():
            for task in tasks:
                results = self.eval_task(task, split)
                self.logger.log({f"{split}/{task}/{k}": v for k, v in results.items()
                                 if isinstance(v, (int, float))}, step=self.step)
                target = results.get("target_metric")
                if target is not None and target > best_metric:
                    best_metric = target
        if split == "val" and best_metric > self.tracker.overall_best_result:
            self.tracker.overall_best_result = best_metric
            self._save_learnable("best")

    def run(self) -> None:
        if self.mode == "train":
            with self._preemption_handlers():
                try:
                    self._run_train()
                finally:
                    self._stop_profile()
        else:
            if self.ckpt.has_weights("best"):
                self.load_learnable("best")
            self._run_eval("test", 0)
        self.ckpt.close()  # every async save on disk before the run ends
        self.logger.close()
        barrier()

    def _run_train(self) -> None:
        for epoch in range(self.tracker.epoch, self.epochs):
            t0 = time.time()
            try:
                stats = self.train_one_epoch(epoch)
            except Preempted:
                step = self._train_step.step_count
                self._save_state(step)
                self.ckpt.wait()
                logger.warning(f"preempted at epoch {epoch}, step {step}: full state saved; "
                               "rerun with the same exp_dir and resume=True to go on")
                return
            logger.info(f"epoch {epoch}: loss {stats['loss']:.4f} ({time.time() - t0:.0f}s)")
            self.tracker.step_epoch()
            self._save_state(self._train_step.step_count)
            self._save_learnable("latest")
            if (epoch + 1) % self.eval_interval == 0:
                self._run_eval("val", epoch)
        if mesh.world_size() > 1:
            digest = self._check_replicas("after training")
            logger.info(f"the trainable parameters agree across {self.dp} ranks after "
                        f"training (sha256 {digest})")
            if self.tp > 1:
                logger.info(f"the replicated trainable parameters agree across {self.tp} tp "
                            f"ranks after training (sha256 {self.replicated_digest})")
            if self.pp > 1:
                logger.info(f"the trainable parameters outside the blocks agree across "
                            f"{self.pp} pp ranks after training (sha256 {self.pp_digest})")
            if self.sp > 1:
                logger.info(f"the trainable parameters agree across {self.sp} sp ranks after "
                            f"training (sha256 {self.sp_digest})")
        self._run_eval("test", self.epochs)

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

    def _learnable(self) -> Dict[str, torch.Tensor]:
        """The learnable parameters, full (gathered over tp and pp), on the CPU."""
        return self._gather_stages(gather_full_state_dict(
            filter_learnable(self.model.network, self.trainable_names),
            self.model.network.tp_dims()))

    def _gather_stages(self, local: Dict[str, Any]) -> Dict[str, Any]:
        """name → value of every pp stage's (the blocks' of each stage, the
        rest of stage 0's), on every pp rank; the identity at pp = 1. The
        values are moved to the CPU for the host gather."""
        if self.pp == 1:
            return local
        stage = set(self._stage_names(local))
        cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v  # noqa: E731
        mine = {n: ({k: cpu(x) for k, x in v.items()} if isinstance(v, dict) else cpu(v))
                for n, v in local.items() if n in stage or mesh.pp_rank() == 0}
        merged: Dict[str, Any] = {}
        for part in process_allgather_objects([mine], mesh.pp_control_group()):
            merged.update(part)
        return merged

    def _own(self, full: Mapping[str, Any]) -> Dict[str, Any]:
        """The entries of a full (every stage's) dict that this rank's model
        holds: pp drops the other stages' blocks; any other name is kept."""
        named = dict(self.model.network.named_parameters())
        return {n: v for n, v in full.items()
                if not (n.startswith("llm.layer.") and n not in named)}

    def _state_dict(self) -> Dict[str, Any]:
        """The full training state: full tensors (the sharded parameters and
        their moments gathered over tp), as JAX's checkpoints hold global
        arrays. Every rank calls it (the gathers), rank 0 writes it."""
        opt_state = self.optimizer.state_dict()
        dims = self.model.network.tp_dims()
        opt_state["state"] = self._gather_stages(
            {n: gather_full_state_dict(st, {k: dims.get(n) for k in st})
             for n, st in opt_state["state"].items()})
        state = {
            "params": self._learnable(),
            "opt_state": opt_state,
            "step": self._train_step.step_count,
            "generator": self.generator.get_state(),
        }
        if self.dp > 1:  # each dp rank's dropout generator, by dp rank
            state["generators"] = process_allgather_objects([state["generator"]],
                                                            mesh.dp_control_group())
        return state

    def _save_state(self, step: int) -> None:
        """The full state, written by rank 0; every rank waits for it."""
        self.ckpt.save_state(step, self._state_dict(), self.tracker)
        barrier()

    def _save_learnable(self, name: str) -> None:
        """The learnable weights as ``name``, written by rank 0; every rank
        waits for the file, so a load of it on any rank reads it whole."""
        self.ckpt.save_weights(name, self._learnable())
        barrier()

    def load_learnable(self, name: str) -> None:
        """Overlay the learnable weights saved as ``name`` on the model."""
        merge_learnable(self.model.network,
                        shard_like(self.model.network, self._own(self.ckpt.load_weights(name))))
        logger.info(f"loaded the learnable weights {name!r} from {self.ckpt.dir}")

    def _try_resume(self) -> None:
        state = self.ckpt.restore_state(self.tracker)
        if state is None:
            return
        merge_learnable(self.model.network,
                        shard_like(self.model.network, self._own(state["params"])))
        opt_state, dims, llm = state["opt_state"], self.model.network.tp_dims(), self.model.cfg.llm
        opt_state["state"] = {n: {k: shard_tensor(v, dims.get(n), llm.tp_rank, llm.tp_size)
                                  for k, v in st.items()}
                              for n, st in self._own(opt_state["state"]).items()}
        self.optimizer.load_state_dict(opt_state)
        self._train_step.step_count = int(state["step"])
        generators = state.get("generators", [state["generator"]] if "generator" in state else [])
        if len(generators) == self.dp:
            self.generator.set_state(generators[mesh.dp_rank()])
        else:  # saved by another rank count: each rank restarts from its seed, as JAX's does
            logger.info(f"the checkpoint holds {len(generators)} dropout generator states for "
                        f"{self.dp} ranks: each rank's generator starts from its seed")
        logger.info(f"resumed from step {self._train_step.step_count} "
                    f"(epoch {self.tracker.epoch}, loader_step {self.tracker.loader_step})")


def build_trainer(cfg, **kwargs):
    """``cfg.trainer``'s class (``LeoTrainer``) on ``cfg``."""
    return TRAINER_REGISTRY.get(cfg.get("trainer", "LeoTrainer"))(cfg, **kwargs)
