"""One rank of the port's tests of quantized bases under tensor parallelism
(``tests/test_torch_quant_tp.py``).

The harness is ``tests/torch_dp_worker.py``'s (``run_ranks(..., script=
torch_quant_tp_worker.__file__)``): each rank joins a gloo group on the CPU,
one intra-op thread, with its own timeout and its group's. One job, ``quant``
(dp 1 x tp 2):

* ``layers``: single ``LoraDense`` layers at tp = 2, each rank loading its
  shards of a whole layer's quantized values and scales (``shard_tensor``
  with the layer's specs), the whole output of each;
* ``forward``: the tiny quantized Llama's training forward (its logits) from
  the whole state dict sharded by ``shard_like``;
* ``generate``: the tiny quantized MSR3D loaded whole from JAX's tree, split
  by ``MSR3D.shard_for_serving(tensor_parallel=True)``, greedy ``generate``;
  over one of the configurations also the continuous greedy and beam
  engines and the prefix-pool engine;
* ``qlora``: ``LeoTrainer`` with ``parallel.tp: 2`` over an int4 base with
  group scales, one epoch; the losses, grad norms and the trained
  parameters gathered whole (rank 0 saves them).

This file imports no JAX.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dp_worker as dpw  # noqa: E402
from msr3d_tpu_torch.parallel import mesh  # noqa: E402


def layer_outputs(cases, tp: int, tp_rank: int) -> list:
    """Each case's whole output from this rank's shards of the layer."""
    from msr3d_tpu_torch.models.llm.llama import LoraDense
    from msr3d_tpu_torch.parallel.sharding import shard_tensor

    outs = []
    for case in cases:
        cfg = dataclasses.replace(case["cfg"], tp_size=tp, tp_rank=tp_rank)
        mod = LoraDense(case["d_in"], case["d_out"], cfg, use_lora=case["lora"],
                        tp_mode=case["mode"], scale_split=case["scale_split"])
        state = {}
        for leaf, value in case["state"].items():
            spec = case["specs"].get(leaf)
            state[leaf] = shard_tensor(torch.from_numpy(value), spec, tp_rank, tp)
        mod.load_state_dict(state)
        x = torch.from_numpy(case["x"])
        if case["mode"] == "row":
            x = x.chunk(tp, dim=-1)[tp_rank]
        with torch.no_grad():
            outs.append(mod(x).numpy())
    return outs


def engine_tokens(model, job: dict) -> dict:
    """The continuous greedy and beam engines' and the prefix-pool engine's
    tokens by request id (the parent runs this at tp = 1 too)."""
    from msr3d_tpu_torch import serving

    kw, pool_kw = job["engine_kw"], job["pool_kw"]
    runs = {"continuous": serving.ContinuousBatchingServer(model, **kw).run(job["requests"]),
            "beam": serving.ContinuousBeamBatchingServer(model, **kw).run(job["requests"]),
            "pool": serving.PrefixPoolContinuousBatchingServer(model, **pool_kw).run(
                job["pool_requests"])}
    return {name: {r.id: np.asarray(r.output_tokens).tolist() for r in results}
            for name, results in runs.items()}


def quant(job: dict, out_dir: Path) -> dict:
    from msr3d_tpu_torch.models.llm.llama import LlamaModel
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.parallel.sharding import gather_full_state_dict, shard_like
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    dp, tp = mesh.init_mesh({"tp": 2})
    out = dict(rank=mesh.rank(), dp=dp, tp=tp, tp_rank=mesh.tp_rank())
    out["layers"] = [o.tolist() for o in layer_outputs(job["layers"], tp, mesh.tp_rank())]

    out["forward"], out["shapes"] = {}, {}
    for name, fwd in job["forward"].items():
        cfg = dataclasses.replace(fwd["cfg"], tp_size=tp, tp_rank=mesh.tp_rank())
        llm = LlamaModel(cfg)
        llm.load_state_dict(shard_like(llm, {n: torch.from_numpy(v)
                                             for n, v in fwd["state"].items()}))
        out["shapes"][name] = {n: list(t.shape) for n, t in llm.state_dict().items()
                               if n.startswith("layer.0.")}
        with torch.no_grad():
            logits = llm(llm.embed(torch.from_numpy(job["ids"]).long()),
                         torch.from_numpy(job["mask"]).long())
        out["forward"][name] = logits.numpy().tolist()

    out["generate"] = {}
    for name, gen in job["generate"].items():
        model = MSR3D(gen["network_cfg"], ByteTokenizer(), device="cpu", **job["generate_kw"])
        assert model.load_jax_params(gen["params"]) == []
        model.shard_for_serving(tensor_parallel=True)
        out["generate"][name] = model.generate(dict(job["requests"]), use_beam=False)[
            "output_tokens"].tolist()
        if name == job["engines"]["config"]:
            out["engines"] = engine_tokens(model, job["engines"])

    q = job["qlora"]
    model = MSR3D(q["network_cfg"], ByteTokenizer(), device="cpu", **q["model_kw"])
    assert model.load_jax_params(q["params"]) == []
    model.shard_for_serving(tensor_parallel=True)
    trainer = LeoTrainer(dict(q["cfg"], exp_dir=str(out_dir / "qlora")),
                         loaders={"msr3d_train": {"train": dpw.RowsLoader(q["batches"], 0, 4)}},
                         evaluators={}, model=model)
    buffers = {n: b.clone() for n, b in model.network.named_buffers() if "weight_q" in n}
    step = trainer._train_step = dpw._Recording(trainer._train_step)
    trainer.train_one_epoch(0)
    trainer.logger.close()
    params = gather_full_state_dict({n: p.detach() for n, p in trainer.params.items()},
                                    model.network.tp_dims())
    if mesh.rank() == 0:
        torch.save(params, out_dir / "qlora_params.pt")
    out["qlora"] = dict(
        losses=step.losses, grad_norms=step.grad_norms, steps=step.step_count,
        buffers_unchanged=all(torch.equal(b, dict(model.network.named_buffers())[n])
                              for n, b in buffers.items()),
        sharded=sorted(n for n in model.network.tp_dims() if "weight_q" in n))
    return out


JOBS = {"quant": quant}

if __name__ == "__main__":
    dpw.main(*sys.argv[1:3], jobs=JOBS)
