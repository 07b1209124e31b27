"""One rank of the port's tensor-parallel tests (``tests/test_torch_tp.py``).

The harness is ``tests/torch_dp_worker.py``'s (``run_ranks(..., script=
torch_tp_worker.__file__)``): each rank joins a gloo group on the CPU, one
intra-op thread, with its own timeout and its group's. Jobs:

* ``serve`` (two ranks, tp = 2): the tiny Llama's forward (embeddings,
  logits) from a full state dict sharded by ``shard_like``; then the tiny
  MSR3D made full, split by ``MSR3D.shard_for_serving(tensor_parallel=True)``
  and run through greedy and beam ``generate``, the continuous greedy,
  speculative and beam engines and the prefix-pool engine on the same
  requests on both ranks;
* ``train`` (four ranks, dp = 2 x tp = 2): ``LeoTrainer`` with
  ``parallel.tp: 2`` on the tiny MSR3D, an ``eval_task`` over a loader
  sharded by dp rank, one epoch of two optimizer steps on the dp rank's rows
  of the global batches, the full state and ``latest`` saved; then the same
  epoch with ``remat: full`` and flash attention.

The ``serve`` ranks then run ``dropout_runs`` (dp = 1 x tp = 2, LoRA
dropout 0.1, each process's global numpy generator seeded by its rank and
drawn by the train loader): one epoch with the batches as the trainer
shares them over tp, one with each tp rank iterating its own loader, and one
where a preemption flag is raised on tp rank 0 alone. The parent runs the
first at tp = 1 in its own process as the reference.

This file imports no JAX.
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dp_worker as dpw  # noqa: E402
from msr3d_tpu_torch.parallel import mesh  # noqa: E402


def _tokens(results) -> dict:
    return {r.id: np.asarray(r.output_tokens).tolist() for r in results}


def serve(job: dict, out_dir: Path) -> dict:
    from msr3d_tpu_torch import serving
    from msr3d_tpu_torch.models.llm.llama import LlamaModel
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.parallel.sharding import shard_like

    dp, tp = mesh.init_mesh({"tp": 2})
    out = dict(rank=mesh.rank(), dp=dp, tp=tp, tp_rank=mesh.tp_rank())

    # the LLM forward: embeddings and logits, every rank's whole
    cfg = dataclasses.replace(job["llama_cfg"], tp_size=tp, tp_rank=mesh.tp_rank())
    llm = LlamaModel(cfg)
    full = {n: torch.from_numpy(v) for n, v in job["llama_state"].items()}
    llm.load_state_dict(shard_like(llm, full))
    out["llm_shapes"] = {n: list(t.shape) for n, t in llm.state_dict().items()}
    with torch.no_grad():
        ids = torch.from_numpy(job["ids"]).long()
        embeds = llm.embed(ids)
        logits = llm(embeds, torch.from_numpy(job["mask"]).long())
    out["embeds"], out["logits"] = embeds.numpy().tolist(), logits.numpy().tolist()

    # generation and the engines over the model split for serving
    model = MSR3D(job["network_cfg"], ByteTokenizer(), device="cpu", **job["model_kw"])
    assert model.load_jax_params(job["params"]) == []
    model.shard_for_serving(tensor_parallel=True)
    out["llm_params"] = sum(p.numel() for p in model.network.llm.parameters())
    reqs, budgets = job["requests"], job["budgets"]
    batch = serving._collate(reqs)
    for beam in (False, True):
        got = model.generate(dict(batch), use_beam=beam, max_new_tokens=job["max_new"])
        out["generate_beam" if beam else "generate_greedy"] = got["output_tokens"].tolist()
    kw = job["engine_kw"]
    engines = {
        "continuous": serving.ContinuousBatchingServer(model, **kw),
        "speculative": serving.ContinuousBatchingServer(model, spec_k=3, spec_ngram=2, **kw),
        "beam": serving.ContinuousBeamBatchingServer(model, **kw),
    }
    out["digests"] = {}
    for name, engine in engines.items():
        out[name] = _tokens(engine.run(reqs, budgets=budgets))
        out["digests"][name] = engine.tokens_digest
    pool = serving.PrefixPoolContinuousBatchingServer(model, **job["pool_kw"])
    out["pool"] = _tokens(pool.run(job["pool_requests"]))
    out["digests"]["pool"] = pool.tokens_digest
    out["dropout"] = dropout_runs(job["dropout"], out_dir)
    return out


class GlobalRNGLoader:
    """``rows`` rows of each global batch, picked by the process's global
    numpy generator, as the port's loaders draw points and answers from it."""

    def __init__(self, batches, rows: int):
        self.batches, self.rows = batches, rows

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            pick = np.sort(np.random.choice(len(b["text_output"]), self.rows, replace=False))
            yield {k: [v[i] for i in pick] if isinstance(v, list) else v[pick]
                   for k, v in b.items()}


def dropout_runs(job: dict, out_dir: Path, runs=("shared", "own", "preempt")) -> dict:
    """One epoch of ``LeoTrainer`` at LoRA dropout 0.1 over a
    ``GlobalRNGLoader``, each process's global generator seeded by its rank:
    ``shared``, the loader's batches as the trainer shares them over tp
    (the losses, grad norms, the gradients the optimizer took and the
    updated parameters, gathered whole; rank 0 saves the last two);
    ``own``, each tp rank iterating its own loader (the digests of the
    replicated trainable parameters over the tp group); ``preempt``, a
    preemption flag raised on tp rank 0 alone (whether each rank stopped,
    and after how many steps). At tp = 1 (one process) only ``shared``."""
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.parallel.sharding import gather_full_state_dict
    from msr3d_tpu_torch.trainer import leo_trainer

    out = {}
    for run in runs:
        model = MSR3D(job["network_cfg"], ByteTokenizer(), device="cpu", **job["model_kw"])
        assert model.load_jax_params(job["params"]) == []
        model.shard_for_serving(tensor_parallel=True)
        state = np.random.get_state()
        np.random.seed(mesh.rank())
        batches = leo_trainer._batches
        if run == "own":
            leo_trainer._batches = lambda loader, axis="mp": iter(loader)
        try:
            trainer = leo_trainer.LeoTrainer(
                dict(job["cfg"], exp_dir=str(out_dir / f"dropout_{run}")),
                loaders={"msr3d_train": {"train": GlobalRNGLoader(job["batches"], job["rows"])}},
                evaluators={}, model=model)
            dims = model.network.tp_dims()
            taken, step = [], trainer.optimizer.step

            def record(grads):
                taken.append({n: g.cpu() for n, g in gather_full_state_dict(
                    {n: g.detach().clone() for n, g in grads.items()}, dims).items()})
                return step(grads)

            trainer.optimizer.step = record
            steps = trainer._train_step = dpw._Recording(trainer._train_step)
            trainer._preempted = run == "preempt" and mesh.tp_rank() == 0
            try:
                trainer.train_one_epoch(0)
                stopped = False
            except leo_trainer.Preempted:
                stopped = True
        finally:
            leo_trainer._batches = batches
            np.random.set_state(state)
        trainer.logger.close()
        named = dict(model.network.named_parameters())
        replicated = {n: named[n] for n in trainer.trainable_names if n not in dims}
        out[run] = dict(losses=steps.losses, grad_norms=steps.grad_norms,
                        steps=steps.step_count, stopped=stopped,
                        replicated_digests=mesh.process_allgather_objects(
                            [mesh.tensors_digest(replicated)], mesh.tp_control_group()))
        if run == "shared":
            params = trainer._learnable()
            if mesh.rank() == 0:
                torch.save(dict(grads=taken, params=params),
                           out_dir / f"dropout_tp{mesh.tp_size()}.pt")
    return out


def _trainer(job: dict, out_dir: Path, name: str, **llm):
    from msr3d_tpu_torch.data.build import DataLoader
    from msr3d_tpu_torch.evaluator.msqa_eval import MSQAEval
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    net_cfg = job["network_cfg"]
    net_cfg = dataclasses.replace(net_cfg, llm=dataclasses.replace(net_cfg.llm, **llm))
    model = MSR3D(net_cfg, ByteTokenizer(), device="cpu", **job["model_kw"])
    assert model.load_jax_params(job["params"]) == []
    model.shard_for_serving(tensor_parallel=True)
    rows, d = job["global_rows"] // mesh.dp_size(), mesh.dp_rank()
    eval_loader = DataLoader(dpw.SampleDataset(job["eval_samples"]),
                             batch_size=job["eval_batch"], collate_fn=dpw.collate, prefetch=0,
                             num_shards=mesh.dp_size(), shard_id=d)
    return LeoTrainer(
        dict(job["cfg"], exp_dir=str(out_dir / name)),
        loaders={"msr3d_train": {"train": dpw.RowsLoader(job["batches"], d * rows,
                                                         (d + 1) * rows)},
                 "msqa": {"test": eval_loader}},
        evaluators={"msqa": MSQAEval(task_name="msqa",
                                     save_dir=out_dir / f"eval_{name}_rank{mesh.rank()}")},
        model=model)


def train(job: dict, out_dir: Path) -> dict:
    r = mesh.rank()
    mesh.init_mesh(job["cfg"]["parallel"])
    trainer = _trainer(job, out_dir, "exp")
    out = dict(rank=r, dp=trainer.dp, tp=trainer.tp, dp_rank=mesh.dp_rank(),
               tp_rank=mesh.tp_rank(), sharded=sorted(trainer.model.network.tp_dims()))
    out["eval"] = trainer.eval_task("msqa", "test")
    results = out_dir / f"eval_exp_rank{r}" / "results.json"
    if results.exists():
        shutil.copy(results, out_dir / f"results_rank{r}.json")
    runs = {}
    for name, tr in (("exp", trainer), ("remat", None)):
        if tr is None:
            tr = _trainer(job, out_dir, name, remat=True, remat_policy="full",
                          flash_attention=True)
        step = tr._train_step = dpw._Recording(tr._train_step)
        tr.train_one_epoch(0)
        tr.logger.close()
        torch.save({n: p.detach().clone() for n, p in tr.params.items()},
                   out_dir / f"{name}_params_rank{r}.pt")
        runs[name] = dict(step_losses=step.losses, steps=step.step_count,
                          digest=tr._check_replicas("at the end of the job"))
        if name == "exp":  # the full state and the learnable weights, gathered
            tr._save_state(step.step_count)
            tr._save_learnable("latest")
            tr.ckpt.close()
    out["runs"] = runs
    return out


JOBS = {"serve": serve, "train": train}

if __name__ == "__main__":
    dpw.main(*sys.argv[1:3], jobs=JOBS)
