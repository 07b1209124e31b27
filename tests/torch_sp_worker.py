"""One rank of the port's sequence-parallel tests (``tests/test_torch_sp.py``).

The harness is ``tests/torch_dp_worker.py``'s (each rank joins a gloo group
on the CPU, one intra-op thread, with its own timeout and its group's). One
spawn runs every job of its world size in turn, each on the mesh its
``parallel`` names (the mesh is rebuilt between jobs):

* ``ring``: ``ring_attention`` on each case's blocks (the sp group of an sp
  = 4 mesh, or the sp groups of dp 2 x sp 2 with the batch split by dp
  rank), its output and the gradients of ``sum(out * g)`` w.r.t. q, k, v;
* ``llama``: the tiny Llama at sp = 4 from a whole state dict, its logits
  on this rank's block and the LoRA gradients of the block's share of a
  sum-of-squares loss, summed over sp; then the same under ``remat`` with
  each policy;
* ``network``: ``MSR3DNetwork``'s per-sequence loss at sp = 4;
* ``train``: ``LeoTrainer`` over the tiny MSR3D (a full model the trainer
  gives its sp block and tp shard), one AdamW step on the dp rank's rows of
  the global batches: the losses, grad norms, the gradients the optimizer
  took and the updated parameters, gathered whole (rank 0 saves them); with
  ``eval`` an ``eval_task`` and the full state and ``latest`` saved; with
  ``resume_dir`` a second trainer resuming a one-process run's full state.

Each rank writes its tensors with ``torch.save`` beside its JSON. This file
imports no JAX.
"""

from __future__ import annotations

import dataclasses
import shutil
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dp_worker as dpw  # noqa: E402
from msr3d_tpu_torch.parallel import mesh  # noqa: E402

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _fresh_mesh(parallel: dict):
    """This job's mesh: the previous job's layout is dropped (its groups
    stay alive, unused), then ``init_mesh`` builds the new one."""
    mesh._MESH = None
    return mesh.init_mesh(parallel)


def ring(job: dict, out_dir: Path) -> dict:
    from msr3d_tpu_torch.parallel.ring_attention import ring_attention, sequence_block

    _fresh_mesh({"sp": 4})
    r = mesh.rank()
    # dp 2 x sp 2: the two sp groups (every rank builds both, in order)
    pairs = [dist.new_group(g) for g in mesh.mesh_groups(2, 1, 1, 2)["sp"]]
    out = {}
    for name, case in job["ring"].items():
        dtype = _DTYPES[case["dtype"]]
        q, k, v, g = (torch.from_numpy(case[x]).to(dtype) for x in ("q", "k", "v", "g"))
        valid = torch.from_numpy(case["key_valid"])
        if case["layout"] == "dp2-sp2":
            d, s, n, group = r // 2, r % 2, 2, pairs[r // 2]
            q, k, v, g, valid = (t.chunk(2, dim=0)[d] for t in (q, k, v, g, valid))
        else:
            s, n, group = mesh.sp_rank(), 4, None
        blocks = [sequence_block(t, n, s).clone().requires_grad_() for t in (q, k, v)]
        got = ring_attention(*blocks, causal=case["causal"], key_valid=valid, group=group)
        (got.float() * sequence_block(g, n, s).float()).sum().backward()
        out[name] = dict(out=got.detach().float(), grads=[b.grad.float() for b in blocks])
    torch.save(out, out_dir / f"ring_rank{r}.pt")
    return {"sp_rank": mesh.sp_rank(), "dp_rank": mesh.dp_rank()}


def _llama_run(cfg, state, embeds, mask):
    """Logits of this rank's block and the LoRA gradients of the block's
    share of ``sum((logits · mask)²) / sum(mask)``, summed over sp."""
    from msr3d_tpu_torch.models.llm.llama import LlamaModel

    llm = LlamaModel(cfg)
    # the JAX model initialised on embeddings holds no embedding table
    assert llm.load_state_dict(state, strict=False).missing_keys == ["embed_tokens.weight"]
    lo, hi = llm.sp_window(mask.shape[1])
    logits = llm(embeds, mask)
    local = (logits.float() * mask[:, lo:hi, None].float()).square().sum() / mask.sum()
    local.backward()
    grads = {n: p.grad.clone() for n, p in llm.named_parameters() if p.grad is not None}
    for t in grads.values():
        mesh.all_reduce_sum_(t, group=mesh.sp_group())
    return logits.detach(), grads, float(local), (lo, hi)


def llama(job: dict, out_dir: Path) -> dict:
    _fresh_mesh({"sp": 4})
    cfg = dataclasses.replace(job["llama_cfg"], sp_size=mesh.sp_size(), sp_rank=mesh.sp_rank())
    state = {n: torch.from_numpy(v) for n, v in job["llama_state"].items()}
    embeds, mask = torch.from_numpy(job["embeds"]), torch.from_numpy(job["mask"])
    logits, grads, loss, window = _llama_run(cfg, state, embeds, mask)
    remat = {}
    for policy in ("full", "dots", "residuals"):
        r_logits, r_grads, r_loss, _ = _llama_run(
            dataclasses.replace(cfg, remat=True, remat_policy=policy), state, embeds, mask)
        remat[policy] = dict(
            loss_equal=r_loss == loss, logits_equal=bool(torch.equal(r_logits, logits)),
            grads_equal=sorted(n for n in grads if torch.equal(r_grads[n], grads[n])),
            grads_max_diff=max(float((r_grads[n] - grads[n]).abs().max()) for n in grads))
    torch.save(dict(logits=logits, grads=grads), out_dir / f"llama_rank{mesh.rank()}.pt")
    return dict(window=list(window), grad_names=sorted(grads), remat=remat)


def network(job: dict, out_dir: Path) -> dict:
    from msr3d_tpu_torch.convert import load_jax_params
    from msr3d_tpu_torch.models.msr3d import MSR3DNetwork

    _fresh_mesh({"sp": 4})
    cfg = job["network_cfg"]
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, sp_size=mesh.sp_size(), sp_rank=mesh.sp_rank()))
    net = MSR3DNetwork(cfg).eval()
    load_jax_params(net, job["network_params"])
    batch = {k: torch.from_numpy(v) for k, v in job["network_batch"].items()}
    batch = {k: v.long() if "ids" in k else v for k, v in batch.items()}
    with torch.no_grad():
        loss = net(**batch)["loss"]
    return dict(loss=loss.tolist())


def train(job: dict, out_dir: Path) -> dict:
    """One run of ``job`` at ``job['cfg']['parallel']``, into ``out_dir/name``."""
    from msr3d_tpu_torch.data.build import DataLoader
    from msr3d_tpu_torch.evaluator.msqa_eval import MSQAEval
    from msr3d_tpu_torch.parallel.sharding import gather_full_state_dict
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    out_dir = out_dir / job["name"]
    out_dir.mkdir(parents=True, exist_ok=True)
    r = mesh.rank()
    dp, tp = _fresh_mesh(job["cfg"]["parallel"])
    out = dict(rank=r, dp=dp, tp=tp, sp=mesh.sp_size(), dp_rank=mesh.dp_rank(),
               tp_rank=mesh.tp_rank(), sp_rank=mesh.sp_rank(),
               groups={axis: [mesh.global_rank(axis, i) for i in range(n)]
                       for axis, n in (("dp", dp), ("tp", tp), ("sp", mesh.sp_size()))})
    rows, d = job["global_rows"] // dp, mesh.dp_rank()
    loaders = {"msr3d_train": {"train": dpw.RowsLoader(job["batches"], d * rows,
                                                       (d + 1) * rows)}}
    evaluators = {}
    if job.get("eval"):
        loaders["msqa"] = {"test": DataLoader(dpw.SampleDataset(job["eval_samples"]),
                                              batch_size=2, collate_fn=dpw.collate, prefetch=0,
                                              num_shards=dp, shard_id=d)}
        evaluators["msqa"] = MSQAEval(task_name="msqa", save_dir=out_dir / f"eval_rank{r}")
    model = dpw.build_model(job)
    trainer = LeoTrainer(dict(job["cfg"], exp_dir=str(out_dir / "exp")), loaders=loaders,
                         evaluators=evaluators, model=model)
    net = model.network
    out["llm"] = (net.cfg.llm.tp_size, net.cfg.llm.sp_size, net.cfg.llm.sp_rank)
    taken, step = [], trainer.optimizer.step

    def record(grads):
        taken.append(gather_full_state_dict({n: g.detach().clone() for n, g in grads.items()},
                                            net.tp_dims()))
        return step(grads)

    trainer.optimizer.step = record
    steps = trainer._train_step = dpw._Recording(trainer._train_step)
    trainer.train_one_epoch(0)
    trainer.logger.close()
    params = trainer._learnable()
    if r == 0:
        torch.save(dict(grads=taken, params=params), out_dir / "step.pt")
    out.update(losses=steps.losses, grad_norms=steps.grad_norms, steps=steps.step_count,
               digest=trainer._check_replicas("after the step"), sp_digest=trainer.sp_digest,
               step_sp_comm_s=trainer.sp_comm_history)
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
        params = resumed._learnable()
        moments = {n: {k: v.clone() for k, v in st.items()}
                   for n, st in resumed.optimizer.state.items()}
        out["resumed"] = dict(step=resumed.step, sp=resumed.sp,
                              llm_sp=resumed.model.cfg.llm.sp_size)
        if r == 0:
            torch.save(dict(params=params, moments=moments), out_dir / "resumed.pt")
    return out


def run_all(job: dict, out_dir: Path) -> dict:
    """Every job of this spawn in turn: ``ring``, ``llama``, ``network`` and
    each of ``train``'s runs where the job gives them."""
    out = {}
    for kind in ("ring", "llama", "network"):
        if job.get(kind):
            out[kind] = JOBS[kind](job, out_dir)
    out["train"] = {run["name"]: train(dict(job["train_common"], **run), out_dir)
                    for run in job.get("train", [])}
    return out


JOBS = {"ring": ring, "llama": llama, "network": network, "sp": run_all}

if __name__ == "__main__":
    dpw.main(*sys.argv[1:3], jobs=JOBS)
