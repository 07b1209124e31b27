"""Pipeline parallelism of the port (``parallel/mesh.py``'s dp × tp × pp
layout, ``parallel/pipeline.py``'s GPipe schedule, ``parallel/llm_pp.py``,
pp in ``LeoTrainer``) against the JAX package's own pp
(``msr3d_tpu/parallel/llm_pp.py``: ``llm_logits_from_blocks`` and
``make_pp_apply_fn`` called directly, jitted, on its virtual CPU devices:
the targets of ``tests/test_pipeline.py:170, :295, :403``), in fp32, on real
gloo groups of separate CPU processes (``tests/torch_pp_worker.py``, each
rank with its own timeout and its group's) and in this process:

1. ``mesh_groups`` against JAX's ``make_mesh`` device array for (dp, tp, pp)
   in {(1,1,2), (2,1,2), (1,2,2)}: pp is the fastest-varying rank index;
2. the tiny Llama's logits at pp = 2 with M in {1, 2} micro-batches within
   1e-5 of JAX's pipelined ``llm_logits_from_blocks``;
3. one full-network AdamW step through ``LeoTrainer`` at dp 1 x pp 2, dp 2 x
   pp 2 and tp 2 x pp 2 (M = 2) against JAX's ``make_pp_apply_fn`` step at
   (dp 2, pp 2) and (tp 2, pp 2): the loss, the clipped LoRA (and every
   trainable) gradients and the updated parameters within JAX's test's
   tolerance, rtol 2e-5 / atol 1e-6 (its optimizer and schedule too); the
   stages' replicated parameters bit-equal;
4. JAX's three pp quirks, through the port's pp path (one stage, in this
   process) against ``make_pp_apply_fn``/``llm_logits_from_blocks`` on a pp
   = 1 mesh, which take the same branch: the blocks deterministic under LoRA
   dropout, remat always ``full``, and under flash attention no
   ``key_valid`` (padded prompt keys seen, unlike the port's plain flash
   forward);
5. the dp 2 x pp 2 run's evaluation scores each sample once (the texts of a
   one-process evaluation of the same weights), and its checkpoint resumes
   at pp = 1 bit-equal; a one-process run's checkpoint resumes at pp = 2
   bit-equal.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msr3d_tpu.config import config_from_dict
from msr3d_tpu.optim.build import build_optim as jax_build_optim
from msr3d_tpu.parallel.llm_pp import llm_logits_from_blocks as jax_llm_logits_from_blocks
from msr3d_tpu.parallel.llm_pp import make_pp_apply_fn, pp_state_shardings
from msr3d_tpu.parallel.llm_pp import stack_llm_blocks, unstack_llm_blocks
from msr3d_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from msr3d_tpu.parallel.mesh import make_mesh
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.llama import LlamaModel
from msr3d_tpu_torch.parallel import llm_pp, mesh

import torch_dp_worker as dpw
import torch_pp_worker
from test_torch_distributed import N_EVAL, _eval_samples, _global_batches
from test_torch_tp import _llama
from test_torch_train import SCENE_TOKENS, _jax_model, _port_model
from torch_parity_utils import one_torch_thread, to_numpy_tree, torch_llama_config, \
    torch_network_config

RTOL, ATOL = 2e-5, 1e-6  # JAX's tests/test_pipeline.py full-network tolerance
SOLVER = {"grad_norm": 5.0, "epochs": 1, "gradient_accumulation_steps": 1,
          "optim": {"name": "AdamW",
                    "args": {"lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 0.0}},
          "sched": {"name": "warmup_cosine_instructblip", "args": {"warmup_steps": 2}}}
LAYOUTS = {"dp1-pp2": (1, 1, 2), "dp2-pp2": (2, 1, 2), "tp2-pp2": (1, 2, 2)}
# the JAX run each port layout is held to (dp 1 x pp 2 computes what dp 2 x
# pp 2 does: the same micro-batches through the same stages)
JAX_OF = {"dp1-pp2": "dp2-pp2", "dp2-pp2": "dp2-pp2", "tp2-pp2": "tp2-pp2"}
MODEL_KW = dict(scene_token_len=SCENE_TOKENS, max_out_len=16, repetition_penalty=1.5)


def _cfg(exp_dir, dp, tp, pp):
    return {"exp_dir": str(exp_dir), "mode": "train", "rng_seed": 0, "solver": dict(SOLVER),
            "fixed_text_buckets": True,
            "parallel": {"tp": tp, "pp": pp, "microbatches": 2}}


# ---------------------------------------------------------------------------
# 1. the rank layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_groups_lay_out_ranks_as_jax(layout, cpu_devices):
    dp, tp, pp = LAYOUTS[layout]
    ids = np.vectorize(lambda d: d.id)(make_mesh(JaxMeshConfig(dp=dp, tp=tp, pp=pp),
                                                 devices=jax.devices("cpu")[:dp * tp * pp])
                                       .devices)[..., 0]  # (dp, tp, pp)
    groups = mesh.mesh_groups(dp, tp, pp)
    assert groups["pp"] == ids.reshape(dp * tp, pp).tolist()
    assert groups["tp"] == ids.transpose(0, 2, 1).reshape(dp * pp, tp).tolist()
    assert groups["dp"] == ids.transpose(1, 2, 0).reshape(tp * pp, dp).tolist()
    assert groups["mp"] == ids.reshape(dp, tp * pp).tolist()
    assert mesh.MeshConfig(tp=tp, pp=pp).resolve(dp * tp * pp) == JaxMeshConfig(
        dp=-1, tp=tp, pp=pp).resolve(dp * tp * pp)


# ---------------------------------------------------------------------------
# the runs: the ranks, and JAX on the same inputs
# ---------------------------------------------------------------------------


def _jax_step(jmodel, batch, dp, tp, pp):
    """JAX's pipelined step as ``make_train_step`` takes it at accumulation
    1: the loss and the gradients of ``make_pp_apply_fn`` over the stacked
    layout (placed by ``pp_state_shardings``), then the optimizer's update →
    (loss, gradients, updated params), unstacked, by port name."""
    jmesh = make_mesh(JaxMeshConfig(dp=dp, tp=tp, pp=pp), devices=jax.devices("cpu")[:dp * tp * pp])
    stacked = stack_llm_blocks(jmodel.params)
    apply = make_pp_apply_fn(jmodel.network, jmesh, microbatches=2, data_parallel=dp > 1,
                             tensor_parallel=tp > 1)
    opt, _ = jax_build_optim(config_from_dict({"solver": SOLVER}), total_steps=1,
                             trainable_mask=jmodel.get_opt_params_mask(stacked)["params"])
    with jmesh:
        stacked = jax.device_put(stacked, pp_state_shardings(jmesh, stacked,
                                                             tensor_parallel=tp > 1))
        rest = {k: v for k, v in stacked.items() if k != "params"}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: apply(dict(rest, params=p), batch, jax.random.key(1))))(stacked["params"])
        updates, _ = jax.jit(opt.update)(grads, opt.init(stacked["params"]), stacked["params"])
        new = optax.apply_updates(stacked["params"], updates)
    names = lambda tree: {n: t.numpy() for n, t in jax_to_torch_state_dict(  # noqa: E731
        to_numpy_tree(unstack_llm_blocks(dict(rest, params=tree))))[0].items()}
    return float(loss), names(grads), names(new)


@pytest.fixture(scope="module")
def pp_runs(cpu_devices, tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    # 2. the tiny Llama's pipelined logits
    jcfg, jmod, variables, ids, mask = _llama()
    embeds = np.asarray(jax.jit(lambda v, i: jmod.apply(v, i, method=jmod.embed_tokens))(
        variables, ids))
    jmesh = make_mesh(JaxMeshConfig(dp=1, tp=1, pp=2), devices=jax.devices("cpu")[:2])
    llm_params = stack_llm_blocks({"params": {"llm": variables["params"]}})["params"]["llm"]
    jax_logits = {m: np.asarray(jax.jit(lambda p, e, m=m: jax_llm_logits_from_blocks(
        jcfg, p, e, mask, mesh=jmesh, microbatches=m))(llm_params, embeds)) for m in (1, 2)}
    logits_job = dict(llama_cfg=torch_llama_config(jcfg), embeds=embeds, mask=mask,
                      microbatches=[1, 2], llama_state={
                          n: t.numpy() for n, t in
                          jax_to_torch_state_dict(to_numpy_tree(variables))[0].items()})

    # 3. the step: the batch as the port's trainer builds it, for JAX too
    jmodel = _jax_model(flash=False, window=True)
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    with one_torch_thread():
        one = LeoTrainer(dict(_cfg(root / "batch", 1, 1, 1), parallel={}), loaders={},
                         evaluators={}, model=_port_model(jmodel))
        batch = {k: v.numpy() for k, v in one._device_batch([_global_batches()[0]])[0].items()}
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in batch.items()}
    jax_steps = {name: _jax_step(jmodel, jbatch, *LAYOUTS[name]) for name in set(JAX_OF.values())}

    job = dict(kind="pp", network_cfg=torch_network_config(jmodel.cfg),
               params=jax.tree_util.tree_map(np.array, jmodel.params), model_kw=MODEL_KW,
               batches=_global_batches()[:1], global_rows=4, eval_samples=_eval_samples())
    # a one-process run's full state, for the dp 1 x pp 2 ranks to resume
    one_dir = root / "one"
    with one_torch_thread():
        one = LeoTrainer(_cfg(one_dir, 1, 1, 1), loaders={"msr3d_train": {
            "train": dpw.RowsLoader(_global_batches()[:1], 0, 4)}}, evaluators={},
            model=_port_model(jmodel))
        one.train_one_epoch(0)
        one._save_state(one.step)
        one_state = dict(params=one._learnable(), step=one.step,
                         moments={n: dict(st) for n, st in one.optimizer.state.items()})
    ranks = {}
    for name, (dp, tp, pp) in LAYOUTS.items():
        run = dict(copy.deepcopy(job), cfg=_cfg(root / "unused", dp, tp, pp),
                   logits=logits_job if name == "dp1-pp2" else None, eval=name == "dp2-pp2",
                   resume_dir=str(one_dir) if name == "dp1-pp2" else None)
        ranks[name] = dpw.run_ranks(run, root / name, world=dp * tp * pp,
                                    script=torch_pp_worker.__file__)
    return dict(root=root, jax_logits=jax_logits, jax_steps=jax_steps, ranks=ranks, job=job,
                jmodel=jmodel, batch=batch, one_state=one_state)


# ---------------------------------------------------------------------------
# 2-3. logits and the step
# ---------------------------------------------------------------------------


def test_pp_ranks_hold_their_stage(pp_runs):
    for name, ranks in pp_runs["ranks"].items():
        dp, tp, pp = LAYOUTS[name]
        for r in ranks:
            assert (r["dp"], r["tp"], r["pp"]) == (dp, tp, pp)
            assert r["rank"] == (r["dp_rank"] * tp + r["tp_rank"]) * pp + r["pp_rank"]
            assert r["groups"]["pp"] == list(range(r["rank"] - r["pp_rank"],
                                                   r["rank"] - r["pp_rank"] + pp))
            # the tiny LLM's 2 blocks: one a stage, under its global index
            assert r["blocks"] == [str(r["pp_rank"])]
        # the stages' replicated parameters agree (the trainer checked them)
        assert len({r["pp_digest"] for r in ranks}) == 1


@pytest.mark.parametrize("m", [1, 2])
def test_pp_logits_match_jax_pipeline(pp_runs, m):
    for r in pp_runs["ranks"]["dp1-pp2"]:
        assert r["logits"]["blocks"] == [str(r["pp_rank"])]
        np.testing.assert_allclose(r["logits"][str(m)], pp_runs["jax_logits"][m], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pp_step_matches_jax_make_pp_apply_fn(pp_runs, name):
    ranks = pp_runs["ranks"][name]
    loss, grads, new = pp_runs["jax_steps"][JAX_OF[name]]
    assert all(r["steps"] == 1 for r in ranks)
    assert len({r["losses"][0] for r in ranks}) == 1  # every rank reports the loss
    np.testing.assert_allclose(ranks[0]["losses"][0], loss, rtol=RTOL)
    step = torch.load(pp_runs["root"] / name / "step.pt")
    got_grads, params = step["grads"][0], step["params"]
    assert any(n.startswith("llm.layer.1.") for n in got_grads)  # stage 1's, gathered
    trainable = sorted(got_grads)
    norm = np.sqrt(sum(float(np.square(grads[n].astype(np.float64)).sum()) for n in trainable))
    np.testing.assert_allclose(ranks[0]["grad_norms"][0], norm, rtol=RTOL)
    clip = min(1.0, SOLVER["grad_norm"] / norm)
    lora = [n for n in trainable if "lora_" in n]
    assert lora
    for n in trainable:
        np.testing.assert_allclose(got_grads[n].numpy(), grads[n] * clip, rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    assert sorted(params) == trainable
    for n in trainable:
        np.testing.assert_allclose(params[n].numpy(), new[n], rtol=RTOL, atol=ATOL, err_msg=n)


# ---------------------------------------------------------------------------
# 4. JAX's pp quirks
# ---------------------------------------------------------------------------


def _pp_loss(model, batch, generator=None):
    """The port's pp loss (one stage: the same code path with no sends)."""
    model.network.train()
    try:
        with one_torch_thread():
            return float(llm_pp.make_pp_loss_fn(model.network, 1)(
                {k: torch.from_numpy(v) for k, v in batch.items()}, generator))
    finally:
        model.network.eval()


def _jax_pp_loss(jmodel, batch, **kw):
    jmesh = make_mesh(JaxMeshConfig(dp=1, tp=1, pp=1), devices=jax.devices("cpu")[:1])
    apply = make_pp_apply_fn(jmodel.network, jmesh, microbatches=1, **kw)
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in batch.items()}
    with jmesh:
        return float(jax.jit(apply)(stack_llm_blocks(jmodel.params), jbatch, jax.random.key(1)))


def test_pp_blocks_run_without_lora_dropout(pp_runs):
    """lora_dropout 0.1 in train mode: the pp path's blocks are
    deterministic (JAX's ``scan_blocks`` passes no ``deterministic=False``),
    so its loss is the dropout-free one and JAX's pp loss, while the plain
    forward draws masks and parts from it."""
    batch = pp_runs["batch"]
    jmodel = _jax_model(flash=False, window=True, lora_dropout=0.1)
    model = _port_model(jmodel)
    gen = torch.Generator().manual_seed(0)
    pp = _pp_loss(model, batch, gen)
    no_dropout = _pp_loss(_port_model(_jax_model(flash=False, window=True)), batch)
    assert pp == no_dropout
    np.testing.assert_allclose(pp, _jax_pp_loss(jmodel, batch), rtol=1e-5)
    model.network.train()
    with torch.no_grad(), one_torch_thread():
        plain = float(model.network(**{k: torch.from_numpy(v) for k, v in batch.items()},
                                    generator=gen)["loss"].mean())
    assert abs(plain - pp) > 1e-4


def test_pp_remat_takes_the_full_policy(pp_runs, monkeypatch):
    """remat with remat_policy ``dots``: the pp path checkpoints each block
    under ``full`` (JAX's pp branch passes no policy), with the loss of the
    pp path without remat and of JAX's pp path with remat."""
    batch = pp_runs["batch"]
    jmodel = _jax_model(flash=False, window=True, remat=True, remat_policy="dots")
    model = _port_model(jmodel)
    assert (model.cfg.llm.remat, model.cfg.llm.remat_policy) == (True, "dots")
    policies, remat_block = [], llm_pp._remat_block
    monkeypatch.setattr(llm_pp, "_remat_block", lambda block, policy, *a: (
        policies.append(policy), remat_block(block, policy, *a))[1])
    loss = _pp_loss(model, batch)
    assert policies == ["full"] * model.cfg.llm.num_hidden_layers
    assert loss == _pp_loss(_port_model(_jax_model(flash=False, window=True)), batch)
    np.testing.assert_allclose(loss, _jax_pp_loss(jmodel, batch, remat=True), rtol=1e-5)


def test_pp_flash_sees_padded_prompt_keys_as_jax():
    """Under flash attention JAX's pp path hands the blocks no ``key_valid``
    (all keys valid, causal only): a left-padded row's queries see its pad
    keys. The port's pp logits are JAX's pp logits; its plain flash forward
    masks the pads, so the padded row parts from them and the full rows do
    not."""
    jcfg, jmod, variables, ids, mask = _llama()
    jcfg = dataclasses.replace(jcfg, flash_attention=True)
    embeds = np.asarray(jax.jit(lambda v, i: jmod.apply(v, i, method=jmod.embed_tokens))(
        variables, ids))
    jmesh = make_mesh(JaxMeshConfig(dp=1, tp=1, pp=1), devices=jax.devices("cpu")[:1])
    llm_params = stack_llm_blocks({"params": {"llm": variables["params"]}})["params"]["llm"]
    want = np.asarray(jax.jit(lambda p, e: jax_llm_logits_from_blocks(
        jcfg, p, e, mask, mesh=jmesh))(llm_params, embeds))
    llm = LlamaModel(torch_llama_config(jcfg))
    llm.load_state_dict(jax_to_torch_state_dict(to_numpy_tree(variables))[0])
    with torch.no_grad(), one_torch_thread():
        got = llm_pp.llm_logits_from_blocks(llm, torch.from_numpy(embeds),
                                            torch.from_numpy(mask)).numpy()
        plain = llm(torch.from_numpy(embeds), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    padded = ~mask.all(axis=1)
    assert padded.any() and (~padded).any()
    np.testing.assert_allclose(got[~padded], plain[~padded], rtol=1e-5, atol=1e-5)
    assert np.abs(got[padded] - plain[padded]).max() > 1e-3


# ---------------------------------------------------------------------------
# 5. evaluation and the checkpoint of the dp 2 x pp 2 run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resumed(pp_runs):
    """The dp 2 x pp 2 run's full state resumed in one process at pp = 1,
    with the same eval loader unsharded."""
    from msr3d_tpu_torch.data.build import DataLoader
    from msr3d_tpu_torch.evaluator.msqa_eval import MSQAEval
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    root = pp_runs["root"] / "dp2-pp2"
    cfg = dict(_cfg(root / "exp", 1, 1, 1), parallel={}, resume=True)
    with one_torch_thread():
        trainer = LeoTrainer(cfg, loaders={
            "msr3d_train": {"train": dpw.RowsLoader(_global_batches()[:1], 0, 4)},
            "msqa": {"test": DataLoader(dpw.SampleDataset(_eval_samples()), batch_size=2,
                                        collate_fn=dpw.collate, prefetch=0)}},
            evaluators={"msqa": MSQAEval(task_name="msqa", save_dir=root / "eval_one")},
            model=_port_model(pp_runs["jmodel"]))
        results = trainer.eval_task("msqa", "test")
    return trainer, results, json.loads((root / "eval_one" / "results.json").read_text())


def test_checkpoint_saved_at_pp2_resumes_at_pp1(pp_runs, resumed):
    trainer = resumed[0]
    assert (trainer.dp, trainer.tp, trainer.pp, trainer.step) == (1, 1, 1, 1)
    saved = torch.load(pp_runs["root"] / "dp2-pp2" / "step.pt")["params"]
    assert any(n.startswith("llm.layer.1.") for n in saved)
    for name, value in saved.items():
        np.testing.assert_array_equal(trainer.params[name].detach().numpy(), value.numpy(),
                                      err_msg=name)
    assert set(trainer.optimizer.state) == set(saved)
    latest = trainer.ckpt.load_weights("latest")
    assert latest.keys() == saved.keys()


def test_checkpoint_saved_at_pp1_resumes_at_pp2(pp_runs):
    """The one-process run's full state resumed by the dp 1 x pp 2 ranks:
    each stage takes its blocks' tensors and the rest, and the parameters and
    the moments gathered over the stages are the saved ones, bit for bit."""
    want = pp_runs["one_state"]
    got = torch.load(pp_runs["root"] / "dp1-pp2" / "resumed.pt")
    assert got["step"] == want["step"] == 1
    assert got["params"].keys() == want["params"].keys()
    assert any(n.startswith("llm.layer.1.") for n in got["params"])
    for name, value in want["params"].items():
        assert torch.equal(got["params"][name], value), name
    assert got["moments"].keys() == want["moments"].keys()
    for name, state in want["moments"].items():
        for key, value in state.items():
            assert torch.equal(got["moments"][name][key].cpu(), value.cpu()), (name, key)


def test_pp_eval_scores_each_sample_once(pp_runs, resumed):
    root = pp_runs["root"] / "dp2-pp2"
    ranks = pp_runs["ranks"]["dp2-pp2"]
    assert not any((root / f"results_rank{r}.json").exists() for r in (1, 2, 3))
    records = json.loads((root / "results_rank0.json").read_text())
    assert sorted(r["index"] for r in records) == list(range(N_EVAL))
    _, one_results, one_records = resumed
    assert (sorted(records, key=lambda r: r["index"])
            == sorted(one_records, key=lambda r: r["index"]))
    for r in ranks:  # every rank, pp rank 1 too, returns the results
        for key, value in one_results.items():
            assert r["eval"][key] == pytest.approx(float(value), rel=1e-9, abs=1e-12), key
