"""One rank of the port's pipeline-parallel tests (``tests/test_torch_pp.py``).

The harness is ``tests/torch_dp_worker.py``'s (``run_ranks(..., script=
torch_pp_worker.__file__)``): each rank joins a gloo group on the CPU, one
intra-op thread, with its own timeout and its group's. One job, ``pp``, at
the layout its ``parallel`` names:

* the rank's place in the mesh and its groups' ranks;
* with ``logits``: the tiny Llama's teacher-forcing logits through
  ``llm_pp.llm_logits_from_blocks`` at each micro-batch count, the stage's
  LLM built from the whole state dict;
* ``LeoTrainer`` over the tiny MSR3D (a full model the trainer splits into
  the rank's stage and tp shard), one AdamW step on the dp rank's rows of a
  global batch: the loss, the grad norm, the gradients the optimizer took
  and the updated trainable parameters, gathered whole (rank 0 saves them);
* with ``eval``: an ``eval_task`` over an eval loader sharded by dp rank
  (rank 0 writes results.json), and the full state and ``latest`` saved;
* with ``resume_dir``: a second ``LeoTrainer`` resuming the full state a
  one-process run saved there, its parameters and moments gathered whole
  (rank 0 saves them).

This file imports no JAX.
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dp_worker as dpw  # noqa: E402
from msr3d_tpu_torch.parallel import mesh  # noqa: E402


def _logits(job: dict) -> dict:
    from msr3d_tpu_torch.models.llm.llama import LlamaModel
    from msr3d_tpu_torch.parallel.llm_pp import llm_logits_from_blocks
    from msr3d_tpu_torch.parallel.sharding import shard_like

    cfg = dataclasses.replace(job["llama_cfg"], tp_size=mesh.tp_size(), tp_rank=mesh.tp_rank(),
                              pp_size=mesh.pp_size(), pp_rank=mesh.pp_rank())
    llm = LlamaModel(cfg)
    keep = set(llm.state_dict())
    llm.load_state_dict(shard_like(llm, {n: torch.from_numpy(v) for n, v in
                                         job["llama_state"].items() if n in keep}))
    out = {"blocks": sorted({n.split(".")[1] for n in keep if n.startswith("layer.")})}
    embeds = torch.from_numpy(job["embeds"]) if mesh.pp_rank() == 0 else None
    with torch.no_grad():
        for m in job["microbatches"]:
            out[m] = llm_logits_from_blocks(llm, embeds, torch.from_numpy(job["mask"]),
                                            microbatches=m).numpy().tolist()
    return out


def pp(job: dict, out_dir: Path) -> dict:
    from msr3d_tpu_torch.data.build import DataLoader
    from msr3d_tpu_torch.evaluator.msqa_eval import MSQAEval
    from msr3d_tpu_torch.parallel.sharding import gather_full_state_dict
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    r = mesh.rank()
    parallel = job["cfg"]["parallel"]
    dp, tp = mesh.init_mesh(parallel)
    out = dict(rank=r, dp=dp, tp=tp, pp=mesh.pp_size(), dp_rank=mesh.dp_rank(),
               tp_rank=mesh.tp_rank(), pp_rank=mesh.pp_rank(),
               groups={axis: [mesh.global_rank(axis, i) for i in range(n)] for axis, n in
                       (("dp", dp), ("tp", tp), ("pp", mesh.pp_size()))})
    if job.get("logits"):
        out["logits"] = _logits(job["logits"])

    model = dpw.build_model(job)
    rows, d = job["global_rows"] // dp, mesh.dp_rank()
    loaders = {"msr3d_train": {"train": dpw.RowsLoader(job["batches"], d * rows,
                                                       (d + 1) * rows)}}
    evaluators = {}
    if job.get("eval"):
        loaders["msqa"] = {"test": DataLoader(dpw.SampleDataset(job["eval_samples"]),
                                              batch_size=2, collate_fn=dpw.collate, prefetch=0,
                                              num_shards=dp, shard_id=d)}
        evaluators["msqa"] = MSQAEval(task_name="msqa", save_dir=out_dir / f"eval_rank{r}")
    trainer = LeoTrainer(dict(job["cfg"], exp_dir=str(out_dir / "exp")), loaders=loaders,
                         evaluators=evaluators, model=model)
    net = model.network
    out.update(blocks=sorted({n.split(".")[2] for n, _ in net.named_parameters()
                              if n.startswith("llm.layer.")}),
               llm_params=sum(p.numel() for p in net.llm.parameters()))
    taken, step = [], trainer.optimizer.step

    def record(grads):
        full = gather_full_state_dict({n: g.detach().clone() for n, g in grads.items()},
                                      net.tp_dims())
        taken.append(trainer._gather_stages({n: g.cpu() for n, g in full.items()}))
        return step(grads)

    trainer.optimizer.step = record
    steps = trainer._train_step = dpw._Recording(trainer._train_step)
    trainer.train_one_epoch(0)
    trainer.logger.close()
    params = trainer._learnable()
    if r == 0:
        torch.save(dict(grads=taken, params=params), out_dir / "step.pt")
    out.update(losses=steps.losses, grad_norms=steps.grad_norms, steps=steps.step_count,
               digest=trainer._check_replicas("after the step"), pp_digest=trainer.pp_digest)
    if job.get("eval"):
        out["eval"] = trainer.eval_task("msqa", "test")
        results = out_dir / f"eval_rank{r}" / "results.json"
        if results.exists():
            shutil.copy(results, out_dir / f"results_rank{r}.json")
        trainer._save_state(steps.step_count)
        trainer._save_learnable("latest")
        trainer.ckpt.close()
    if job.get("resume_dir"):
        resumed = LeoTrainer(dict(job["cfg"], exp_dir=job["resume_dir"], resume=True),
                             loaders={"msr3d_train": loaders["msr3d_train"]}, evaluators={},
                             model=dpw.build_model(job))
        moments = resumed._gather_stages({n: dict(st)
                                          for n, st in resumed.optimizer.state.items()})
        params = resumed._learnable()
        if r == 0:
            torch.save(dict(params=params, moments=moments, step=resumed.step),
                       out_dir / "resumed.pt")
    return out


JOBS = {"pp": pp}

if __name__ == "__main__":
    dpw.main(*sys.argv[1:3], jobs=JOBS)
