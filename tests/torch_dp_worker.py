"""One rank of the port's multi-process tests, and the harness that starts them.

The parent test writes a job (a pickle of what the ranks need) and starts
``world`` copies of this file with ``run_ranks``; each joins a gloo group on
the CPU through ``initialize_distributed_from_env`` and runs the job's
``kind``:

* ``collectives``: ``process_allgather_objects`` with payloads of different
  sizes, a dp mean, ``all_reduce_max``, ``check_replicas_equal``;
* ``loaders``: ``build_dataloader_leo`` over a toy dataset, train and eval,
  and the shard each rank's loader takes;
* ``train_eval``: the port's ``LeoTrainer`` on the tiny model: ``eval_task``
  over a sharded eval loader (blocking, then ``eval_engine: continuous``),
  then one epoch of training on this rank's rows of the global batches.

This file imports no JAX (the ranks run torch alone), so the parent can
also call ``train_eval`` in its own process as the one-rank reference.
Every rank has a timeout, and so has its process group.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from msr3d_tpu_torch.parallel import mesh  # noqa: E402

GROUP_TIMEOUT_S = 120
RANK_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int, r: int, port: int) -> dict:
    """The env contract of rank ``r``, one intra-op thread a rank."""
    return dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                MSR3D_DIST_TIMEOUT_S=str(GROUP_TIMEOUT_S), OMP_NUM_THREADS="1")


def wait_all(procs, timeout: float = RANK_TIMEOUT_S) -> list:
    """Each process's (stdout, stderr); on a failure or a timeout every
    process is killed and the assertion shows each one's stderr."""
    outs, failed = [], False
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err += f"\n[killed after {timeout} s]"
                failed = True
            outs.append((out, err))
            failed |= p.returncode != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        tails = "\n".join(f"--- process {i} (rc {p.returncode}):\n{err[-3000:]}"
                          for i, (p, (_, err)) in enumerate(zip(procs, outs)))
        raise AssertionError(f"a rank failed:\n{tails}")
    return outs


def run_ranks(job: dict, out_dir: Path, world: int = 2, script: str = __file__) -> list:
    """Run ``job`` on ``world`` ranks of ``script`` (this file's jobs by
    default); each rank's JSON result."""
    out_dir.mkdir(parents=True, exist_ok=True)
    job_path = out_dir / "job.pkl"
    job_path.write_bytes(pickle.dumps(job))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, script, str(job_path), str(out_dir)],
                              env=rank_env(world, r, port), cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    wait_all(procs)
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------


def collectives(job: dict, out_dir: Path) -> dict:
    r, w = mesh.rank(), mesh.world_size()
    gathered = mesh.process_allgather_objects([{"rank": r, "items": ["x"] * (r + 1)}])
    local = torch.full((2, 4), float(r + 1))
    mean = float(mesh.all_reduce_sum_(local.clone()).mean()) / w
    same = mesh.check_replicas_equal({"w": torch.arange(6.0).reshape(2, 3)}, "equal tensors")
    try:
        mesh.check_replicas_equal({"w": torch.full((3,), float(r))}, "rank-valued tensors")
        differing = None
    except RuntimeError as exc:
        differing = str(exc)
    mesh.barrier()
    return dict(rank=r, world=w, backend=torch.distributed.get_backend(), gathered=gathered,
                mean=mean, max=mesh.all_reduce_max([r, -r, 7]), digest=same,
                differing=differing)


class ToyDataset:
    def __init__(self, cfg, split):
        self.n = int(cfg["toy_len"][split])

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"sample_id": i}


def loaders(job: dict, out_dir: Path) -> dict:
    from msr3d_tpu_torch.data.build import build_dataloader_leo
    from msr3d_tpu_torch.registry import DATASET_REGISTRY

    DATASET_REGISTRY.register(ToyDataset, name="ToyDataset")
    out = {}
    for split, args in job["splits"].items():
        loader = build_dataloader_leo(job["cfg"], "ToyDataset", "", {}, args, split)
        loader.prefetch = 0
        out[split] = dict(num_shards=loader.num_shards, shard_id=loader.shard_id,
                          len=len(loader), padded_tail=loader.padded_tail,
                          order=[[d["sample_id"] for d in b] for b in loader])
    return dict(rank=mesh.rank(), loaders=out)


class SampleDataset:
    """Fixed samples (one dict of numpy and strings each), as a dataset."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def collate(items):
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else list(vals)
    return out


class RowsLoader:
    """The global batches' rows ``lo:hi``, one batch a loader step."""

    def __init__(self, batches, lo: int, hi: int):
        self.batches, self.lo, self.hi = batches, lo, hi

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            yield {k: v[self.lo:self.hi] for k, v in b.items()}


def build_model(job: dict):
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D

    model = MSR3D(job["network_cfg"], ByteTokenizer(), device="cpu", **job["model_kw"])
    assert model.load_jax_params(job["params"]) == []
    return model


def train_eval(job: dict, out_dir: Path) -> dict:
    """``eval_task`` blocking and continuous over this rank's shard of the
    eval samples, then one epoch over this rank's rows of the global
    batches; each results.json copied beside the outputs."""
    from msr3d_tpu_torch.data.build import DataLoader
    from msr3d_tpu_torch.evaluator.msqa_eval import MSQAEval
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    r, w = mesh.rank(), mesh.world_size()
    rows = job["global_rows"] // w
    eval_loader = DataLoader(SampleDataset(job["eval_samples"]), batch_size=job["eval_batch"],
                             collate_fn=collate, prefetch=0, num_shards=w, shard_id=r)
    save_dir = out_dir / f"eval_rank{r}"
    trainer = LeoTrainer(
        dict(job["cfg"], exp_dir=str(out_dir / "exp")),
        loaders={"msr3d_train": {"train": RowsLoader(job["batches"], r * rows, (r + 1) * rows)},
                 "msqa": {"test": eval_loader}},
        evaluators={"msqa": MSQAEval(task_name="msqa", save_dir=save_dir)},
        model=build_model(job))
    out = dict(rank=r, world=w, dp=trainer.dp, fixed=trainer.fixed_text_buckets,
               padded_tail=eval_loader.padded_tail, eval={})
    for engine in ("blocking", "continuous"):
        if engine == "continuous":
            trainer.cfg.update(eval_engine="continuous", eval_engine_opts=job["engine_opts"])
        out["eval"][engine] = trainer.eval_task("msqa", "test")
        if (save_dir / "results.json").exists():
            shutil.copy(save_dir / "results.json", out_dir / f"results_{engine}_rank{r}.json")
    step = trainer._train_step = _Recording(trainer._train_step)
    trainer.train_one_epoch(0)
    trainer.logger.close()
    torch.save({n: p.detach().clone() for n, p in trainer.params.items()},
               out_dir / f"params_rank{r}.pt")
    out.update(step_losses=step.losses, steps=step.step_count,
               digest=mesh.tensors_digest(trainer.params))
    return out


class _Recording:
    """A ``TrainStep`` that also keeps each step's (all-reduced) loss and
    its grad norm."""

    def __init__(self, step):
        self.step, self.losses, self.grad_norms = step, [], []

    def __call__(self, batches):
        metrics = self.step(batches)
        self.losses.append(float(metrics["loss"]))
        self.grad_norms.append(float(metrics["grad_norm"]))
        return metrics

    @property
    def step_count(self):
        return self.step.step_count


JOBS = {"collectives": collectives, "loaders": loaders, "train_eval": train_eval}


def main(job_path: str, out_dir: str, jobs: dict = JOBS) -> None:
    torch.set_num_threads(1)
    assert mesh.initialize_distributed_from_env(
        "cpu", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S)), "no env contract"
    try:
        job = pickle.loads(Path(job_path).read_bytes())
        result = jobs[job["kind"]](job, Path(out_dir))
        (Path(out_dir) / f"rank{mesh.rank()}.json").write_text(json.dumps(result, default=str))
    finally:
        mesh.destroy()


if __name__ == "__main__":
    main(*sys.argv[1:3])
