"""Tensor parallelism of the port (``parallel/tensor_parallel.py``, the
megatron layout of ``parallel/sharding.py`` in ``models/llm/llama.py``, dp ×
tp in ``LeoTrainer``, ``MSR3D.shard_for_serving`` and the engines) against
the JAX package, in fp32 on real gloo groups of separate CPU processes
(``tests/torch_tp_worker.py``, each rank with its own timeout and its
group's), at dropout 0 unless stated:

1. two ranks at tp = 2: the tiny Llama's forward (GQA, LoRA, a vocab of 256
   split over the ranks) against JAX's ``shard_variables`` forward on
   ``MeshConfig(dp=4, tp=2)`` over the 8 CPU devices at
   ``tests/test_parallel.py``'s tolerance (atol 2e-4 on the logits), and
   against the port's tp = 1 at 1e-5;
2. the same two ranks: greedy and beam ``generate``, the continuous greedy,
   speculative and beam engines and the prefix-pool engine on the tiny
   MSR3D with a vocab of 264 (so the logits are gathered), tokens equal to
   JAX's unsharded runs, the ranks' token digests equal; then a
   ``LeoTrainer`` epoch at LoRA dropout 0.1 over a loader that draws from
   each process's global generator, against tp = 1 within 1e-5, the tp
   ranks' replicated parameters parting when each iterates its own loader,
   and a preemption flag on one tp rank stopping both;
3. four ranks at dp = 2 x tp = 2: two ``LeoTrainer`` steps against JAX's
   ``LeoTrainer`` with ``parallel: {tp: 2}`` (losses, grad norms, every
   gathered trainable parameter, at JAX's two-process tolerance: rtol 1e-4,
   atol 2e-5), once more with ``remat: full`` and flash attention; an
   evaluation that scores each sample once; the full state saved at tp = 2
   resumed at tp = 1 bit-equal.
"""

import copy
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu import serving as jax_serving
from msr3d_tpu.config import config_from_dict
from msr3d_tpu.data.build import DataLoader as JaxDataLoader
from msr3d_tpu.evaluator.msqa_eval import MSQAEval as JaxMSQAEval
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from msr3d_tpu.parallel.mesh import make_mesh
from msr3d_tpu.parallel.sharding import shard_variables
from msr3d_tpu.trainer.leo_trainer import LeoTrainer as JaxLeoTrainer
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.llama import LlamaModel
from msr3d_tpu_torch.models.llm.tokenizer import SCENE_PLACEHOLDER
from msr3d_tpu_torch.parallel.sharding import gather_state_dict, network_param_spec, shard_dims

import torch_dp_worker as dpw
import torch_tp_worker
from test_torch_distributed import _assert_params_close, _eval_samples, _global_batches
from test_torch_serving import prompt_bucket, text_requests
from test_torch_train import SCENE_TOKENS, _jax_model, _metrics, _trainer_cfg
from torch_parity_utils import (
    TINY_PROMPTER,
    one_torch_thread,
    perturbed,
    to_numpy_tree,
    torch_llama_config,
    torch_network_config,
)

MAX_NEW = 8
BUDGETS = [1, 3, 8, 5, 2, 8]
N_EVAL = 5


def _run_ranks(job, out_dir, world):
    return dpw.run_ranks(job, out_dir, world=world, script=torch_tp_worker.__file__)


# ---------------------------------------------------------------------------
# 1-2. the forward, generation and the engines at tp = 2
# ---------------------------------------------------------------------------


def _llama():
    """The tiny JAX Llama (GQA, LoRA, vocab 256), perturbed, and a batch."""
    jcfg = JaxLlamaConfig.tiny(vocab_size=256, dtype=jnp.float32, lora_rank=4,
                               num_key_value_heads=2)
    jmod = JaxLlamaModel(jcfg)
    ids = np.random.default_rng(0).integers(5, 250, size=(4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    mask[1, :4] = 0  # a left-padded row
    variables = perturbed(jax.jit(lambda i, m: jmod.init(
        jax.random.key(0), i, m,
        method=lambda mod, i_, m_: mod(mod.embed_tokens(i_), m_)))(ids, mask), seed=3, std=0.02)
    return jcfg, jmod, variables, ids, mask


@functools.lru_cache(maxsize=None)
def _msr3d():
    """The tiny JAX MSR3D without images, vocab 264 (even: the logits split
    over tp = 2), 2 beams, repetition penalty 1 (speculative decoding
    needs it), perturbed."""
    tok = JaxByteTokenizer()
    llm = JaxLlamaConfig.tiny(vocab_size=264, dtype=jnp.float32, lora_rank=4)
    net_cfg = JaxMSR3DNetworkConfig(prompter=TINY_PROMPTER, llm=llm,
                                    backbone_name="convnext_test")
    kw = dict(scene_token_len=5, max_out_len=16, num_beams=2, repetition_penalty=1.0)
    jmodel = JaxMSR3D(net_cfg, tok, **kw)
    data = jax_serving._collate(text_requests(2))
    ids, attn = jmodel._encode_prompts(jmodel.build_text_prompt(data))
    answers, answer_mask = jmodel._encode_answers(["a chair", "yes"])
    batch = jmodel._scene_batch(data)
    batch.update(input_ids=ids, attention_mask=attn, output_ids=answers, output_mask=answer_mask)
    jmodel.params = perturbed(jmodel.init_params(batch), seed=4, std=0.05)
    return jmodel, kw


def _pool_requests():
    """3 scenes x 2 questions, scene-major: each scene's prefix is shared."""
    scenes = text_requests(3, seed=2)
    keys = [k for k in scenes[0] if k != "msr3d_prompt"]
    return [dict({k: scenes[s][k] for k in keys},
                 msr3d_prompt=f"Scene number {s}: {SCENE_PLACEHOLDER}. USER: question {q}?")
            for s in range(3) for q in range(2)]


def _tokens(results):
    return {r.id: np.asarray(r.output_tokens).tolist() for r in results}


@pytest.fixture(scope="module")
def serve_runs(cpu_devices, tmp_path_factory):
    jcfg, jmod, variables, ids, mask = _llama()
    embeds = jax.jit(lambda v, i: jmod.apply(v, i, method=jmod.embed_tokens))(variables, ids)
    fwd = jax.jit(lambda v, e, m: jmod.apply(v, e, m)[0])
    mesh = make_mesh(JaxMeshConfig(dp=4, tp=2))
    with mesh:
        sharded = shard_variables(mesh, {"params": {"llm": variables["params"]}})
        sharded_logits = np.asarray(fwd({"params": sharded["params"]["llm"]}, embeds, mask))
    llama_state = {n: t.numpy() for n, t in
                   jax_to_torch_state_dict(to_numpy_tree(variables))[0].items()}

    jmodel, model_kw = _msr3d()
    reqs = text_requests(len(BUDGETS), seed=6)
    engine_kw = dict(num_slots=3, refill_group=1, chunk_steps=3, max_new_tokens=MAX_NEW,
                     prompt_len=prompt_bucket(jmodel, reqs))
    pool_kw = dict(num_slots=4, num_prefixes=3, refill_group=2, prefix_len=64,
                   suffix_len=64, chunk_steps=3, max_new_tokens=MAX_NEW)
    batch = jax_serving._collate(reqs)
    want = {f"generate_{name}": np.asarray(jmodel.generate(
        dict(batch), use_beam=beam, max_new_tokens=MAX_NEW)["output_tokens"]).tolist()
        for name, beam in (("greedy", False), ("beam", True))}
    want["continuous"] = _tokens(jax_serving.ContinuousBatchingServer(
        jmodel, **engine_kw).run(reqs, budgets=BUDGETS))
    want["beam"] = _tokens(jax_serving.ContinuousBeamBatchingServer(
        jmodel, **engine_kw).run(reqs, budgets=BUDGETS))
    want["pool"] = _tokens(jax_serving.PrefixPoolContinuousBatchingServer(
        jmodel, **pool_kw).run(_pool_requests()))

    job = dict(kind="serve", llama_cfg=torch_llama_config(jcfg), llama_state=llama_state,
               ids=ids, mask=mask, network_cfg=torch_network_config(jmodel.cfg),
               params=to_numpy_tree(jmodel.params), model_kw=model_kw, requests=reqs,
               budgets=BUDGETS, max_new=MAX_NEW, engine_kw=engine_kw, pool_kw=pool_kw,
               pool_requests=_pool_requests(), dropout=_dropout_job())
    out_dir = tmp_path_factory.mktemp("tp_serve")
    ranks = _run_ranks(job, out_dir, world=2)
    # the dropout epoch at tp = 1 in this process, its generator seeded as
    # rank 0's
    one_dir = tmp_path_factory.mktemp("tp_dropout_one")
    dropout_job = dict(job["dropout"], cfg={k: v for k, v in job["dropout"]["cfg"].items()
                                            if k != "parallel"})
    with one_torch_thread():
        dropout_one = torch_tp_worker.dropout_runs(dropout_job, one_dir, runs=("shared",))

    tmod = LlamaModel(torch_llama_config(jcfg)).eval()
    tmod.load_state_dict({n: torch.from_numpy(v) for n, v in llama_state.items()})
    with torch.no_grad(), one_torch_thread():
        t_ids = torch.from_numpy(ids).long()
        one = tmod(tmod.embed(t_ids), torch.from_numpy(mask).long()).numpy()
        one_embeds = tmod.embed(t_ids).numpy()
    return dict(ranks=ranks, want=want, sharded_logits=sharded_logits,
                jax_embeds=np.asarray(embeds), one=one, one_embeds=one_embeds,
                dropout_one=dropout_one["shared"],
                dropout_files=(out_dir / "dropout_tp2.pt", one_dir / "dropout_tp1.pt"))


def _dropout_job():
    """The tiny trainable MSR3D at LoRA dropout 0.1 (no remat: JAX cannot
    trace the two together), dp 1 x tp 2, 2 of the 4 rows of each global
    batch a loader step (3 batches at accumulation 2: 2 optimizer steps)."""
    jmodel = _jax_model(flash=False, window=True)
    net_cfg = torch_network_config(jmodel.cfg)
    net_cfg = dataclasses.replace(net_cfg, llm=dataclasses.replace(net_cfg.llm,
                                                                   lora_dropout=0.1))
    return dict(network_cfg=net_cfg, params=jax.tree_util.tree_map(np.array, jmodel.params),
                model_kw=dict(scene_token_len=SCENE_TOKENS, max_out_len=16,
                              repetition_penalty=1.5),
                cfg=_cfg("unused"), batches=_global_batches(), rows=2)


def test_tp_forward_matches_jax_sharded_and_one_process(serve_runs):
    ranks = serve_runs["ranks"]
    assert [(r["dp"], r["tp"], r["tp_rank"]) for r in ranks] == [(1, 2, 0), (1, 2, 1)]
    # each rank holds half the heads (2 of 4 q, 1 of 2 kv), half the MLP
    # columns and half the vocab
    shapes = ranks[0]["llm_shapes"]
    assert shapes["layer.0.attn.q_proj.weight"] == [32, 64]
    assert shapes["layer.0.attn.k_proj.weight"] == [16, 64]
    assert shapes["layer.0.attn.o_proj.weight"] == [64, 32]
    assert shapes["layer.0.mlp.down_proj.lora_a"] == [4, 64]
    assert shapes["embed_tokens.weight"] == shapes["lm_head.weight"] == [128, 64]
    for r in ranks:
        np.testing.assert_array_equal(r["embeds"], serve_runs["one_embeds"])
        np.testing.assert_allclose(r["embeds"], serve_runs["jax_embeds"], rtol=0, atol=0)
        # tests/test_parallel.py's tolerance for JAX's own tp forward
        np.testing.assert_allclose(r["logits"], serve_runs["sharded_logits"], atol=2e-4)
        np.testing.assert_allclose(r["logits"], serve_runs["one"], rtol=1e-5, atol=1e-5)
    # the gathered logits are the same bits on both ranks
    np.testing.assert_array_equal(ranks[0]["logits"], ranks[1]["logits"])


@pytest.mark.parametrize("name", ["generate_greedy", "generate_beam", "continuous",
                                  "speculative", "beam", "pool"])
def test_tp_generation_equals_jax_unsharded(serve_runs, name):
    ranks, want = serve_runs["ranks"], serve_runs["want"]
    # speculative greedy emits greedy's tokens (the JAX engine's own test)
    expected = want["continuous" if name == "speculative" else name]
    for r in ranks:
        got = r[name]
        if isinstance(got, dict):
            got = {int(k): v for k, v in got.items()}
        assert got == expected, (r["rank"], name)
    if not name.startswith("generate"):
        assert ranks[0]["digests"][name] == ranks[1]["digests"][name]


def test_tp_serving_holds_half_of_the_split_llm(serve_runs):
    """A rank holds half of each split tensor and all of each replicated
    one (the norms, the column-parallel LoRA A, the row-parallel B)."""
    from msr3d_tpu_torch.models.msr3d import MSR3D

    jmodel, kw = _msr3d()
    full = MSR3D(torch_network_config(jmodel.cfg), device="cpu", **kw).network
    shapes = {n: tuple(p.shape) for n, p in full.named_parameters() if n.startswith("llm.")}
    dims = shard_dims(shapes, 2)
    assert dims["llm.lm_head.weight"] == 0 and dims["llm.layer.0.attn.q_proj.lora_a"] is None
    want = sum(int(np.prod(s)) // (2 if dims[n] is not None else 1) for n, s in shapes.items())
    assert [r["llm_params"] for r in serve_runs["ranks"]] == [want] * 2


def _relative_errors(got, want):
    """Each tensor's ‖got − want‖ / ‖want‖; the key bias's against the
    whole gradient's norm (its true gradient is 0: both sides hold rounding
    noise, ROADMAP.md section 3); tensors that are 0 on both sides skipped."""
    total = float(torch.sqrt(sum(g.double().square().sum() for g in want.values())))
    return {n: float((got[n] - g).norm()) / (total if n.endswith("self_attn.w_ks.bias")
                                             else float(g.norm()))
            for n, g in want.items() if bool(g.any()) or bool(got[n].any())}


def test_tp_dropout_step_equals_one_process(serve_runs):
    """dp 1 x tp 2 at LoRA dropout 0.1 against tp = 1 in one process, both
    on rank 0's loader draws: the row-parallel projections draw their
    dropout masks whole and keep their slice, so the losses, the grad norms,
    the gradients the optimizer took and the updated parameters (gathered)
    agree within 1e-5."""
    ranks, one = serve_runs["ranks"], serve_runs["dropout_one"]
    got, want = (torch.load(f) for f in serve_runs["dropout_files"])
    assert one["steps"] == 2 and len(want["grads"]) == 2
    for r in ranks:
        shared = r["dropout"]["shared"]
        assert shared["steps"] == 2
        np.testing.assert_allclose(shared["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(shared["grad_norms"], one["grad_norms"], rtol=1e-5)
    assert ranks[0]["dropout"]["shared"]["losses"] == ranks[1]["dropout"]["shared"]["losses"]
    # the row-parallel LoRA A, whose gradient holds the sliced mask, is split
    assert "llm.layer.0.attn.o_proj.lora_a" in got["grads"][0]
    for g, w in zip(got["grads"], want["grads"]):
        assert g.keys() == w.keys()
        errors = _relative_errors(g, w)
        assert max(errors.values()) <= 1e-5, max(errors.items(), key=lambda kv: kv[1])
    assert got["params"].keys() == want["params"].keys()
    lrs = [m["train/lr"] for m in _metrics(serve_runs["dropout_files"][1].parent
                                           / "dropout_shared")]
    initial = {n: t.numpy() for n, t in jax_to_torch_state_dict(
        _jax_model(flash=False, window=True).params)[0].items()}
    _assert_params_close({n: t.numpy() for n, t in got["params"].items()},
                         {n: t.numpy() for n, t in want["params"].items()}, lrs, rtol=1e-5,
                         atol=1e-6, initial=initial)


def test_tp_ranks_compute_on_tp_rank0s_batches(serve_runs):
    """Each process's global generator is seeded by its rank. With the
    trainer's sharing (tp rank 0 iterates the loader and broadcasts each
    batch) the tp ranks' replicated trainable parameters stay bit-equal;
    with each tp rank iterating its own loader they part."""
    for r in serve_runs["ranks"]:
        shared, own = r["dropout"]["shared"], r["dropout"]["own"]
        assert len(set(shared["replicated_digests"])) == 1
        assert len(set(own["replicated_digests"])) == 2


def test_tp_preemption_on_one_rank_stops_every_rank(serve_runs):
    """A preemption flag raised on tp rank 0 alone stops both tp ranks after
    the same step (the ranks agree the flag at dp = 1 too)."""
    runs = [r["dropout"]["preempt"] for r in serve_runs["ranks"]]
    assert [(g["stopped"], g["steps"]) for g in runs] == [(True, 1), (True, 1)]


# ---------------------------------------------------------------------------
# 3. dp = 2 x tp = 2 training, evaluation and the checkpoint
# ---------------------------------------------------------------------------


def _cfg(exp_dir):
    return dict(_trainer_cfg(exp_dir, accum=2), fixed_text_buckets=True,
                parallel={"tp": 2})


@pytest.fixture(scope="module")
def train_runs(cpu_devices, tmp_path_factory):
    """The port's four ranks and JAX's trainer with ``parallel: {tp: 2}`` (dp
    = 4 x tp = 2 over the 8 CPU devices) on the same global batches."""
    root = tmp_path_factory.mktemp("tp_train")
    jmodel = _jax_model(flash=False, window=True)
    job = dict(kind="train", network_cfg=torch_network_config(jmodel.cfg),
               params=jax.tree_util.tree_map(np.array, jmodel.params),
               model_kw=dict(scene_token_len=SCENE_TOKENS, max_out_len=16,
                             repetition_penalty=1.5),
               cfg=_cfg(root / "unused"), batches=_global_batches(), global_rows=4,
               eval_samples=_eval_samples(), eval_batch=2)
    ranks = _run_ranks(copy.deepcopy(job), root / "ranks", world=4)

    jax_dir = root / "jax"
    jtrainer = JaxLeoTrainer(
        config_from_dict(_cfg(jax_dir / "exp")),
        loaders={"msr3d_train": {"train": dpw.RowsLoader(_global_batches(), 0, 4)},
                 "msqa": {"test": JaxDataLoader(dpw.SampleDataset(_eval_samples()),
                                                batch_size=2, collate_fn=dpw.collate,
                                                prefetch=0)}},
        evaluators={"msqa": JaxMSQAEval(task_name="msqa", save_dir=jax_dir / "eval")},
        model=jmodel)
    assert jtrainer.mesh.shape["tp"] == 2
    jax_eval = jtrainer.eval_task("msqa", "test")
    jax_records = json.loads((jax_dir / "eval" / "results.json").read_text())
    jtrainer.train_one_epoch(0)
    trained = {n: t.numpy() for n, t in
               jax_to_torch_state_dict(jax.tree_util.tree_map(
                   np.asarray, jtrainer.state.params))[0].items()}
    initial = {n: t.numpy() for n, t in jax_to_torch_state_dict(jmodel.params)[0].items()}
    return dict(root=root, job=job, ranks=ranks, jax_dir=jax_dir, trained=trained,
                initial=initial, jax_eval=jax_eval, jax_records=jax_records)


def _gathered(root, run, ranks):
    """rank → its trainable tensors; then every tp group's shards joined."""
    shards = [torch.load(root / "ranks" / f"{run}_params_rank{r['rank']}.pt") for r in ranks]
    dims = {n: network_param_spec(n, t.dim()) for n, t in shards[0].items()}
    return [gather_state_dict([shards[d * 2], shards[d * 2 + 1]], dims) for d in range(2)], dims


@pytest.mark.parametrize("run", ["exp", "remat"])
def test_dp_tp_training_matches_jax(train_runs, run):
    ranks, root = train_runs["ranks"], train_runs["root"]
    assert [(r["dp"], r["tp"], r["dp_rank"], r["tp_rank"]) for r in ranks] == [
        (2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
    runs = [r["runs"][run] for r in ranks]
    assert [g["steps"] for g in runs] == [2] * 4
    # every rank reports the global batch's loss; the tp ranks hold equal
    # replicated parameters and the dp ranks equal shards (the trainer checks)
    assert all(g["step_losses"] == runs[0]["step_losses"] for g in runs)
    assert runs[0]["digest"] == runs[2]["digest"] and runs[1]["digest"] == runs[3]["digest"]
    want = _metrics(train_runs["jax_dir"] / "exp")
    np.testing.assert_allclose(runs[0]["step_losses"], [m["train/loss"] for m in want],
                               rtol=1e-4)
    got = _metrics(root / "ranks" / run)
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    for g, w in zip(got, want):
        # the global norm of the full gradients: shards summed over tp
        np.testing.assert_allclose(g["train/grad_norm"], w["train/grad_norm"], rtol=1e-4)
    full, dims = _gathered(root, run, ranks)
    assert any(d is not None for d in dims.values())
    for name in full[0]:
        np.testing.assert_array_equal(full[0][name].numpy(), full[1][name].numpy(),
                                      err_msg=name)
    trained = train_runs["trained"]
    _assert_params_close({n: t.numpy() for n, t in full[0].items()},
                         {n: trained[n] for n in full[0]}, [m["train/lr"] for m in got],
                         rtol=1e-4, atol=2e-5, initial=train_runs["initial"])


def test_dp_tp_eval_scores_each_sample_once_as_jax(train_runs):
    ranks, root = train_runs["ranks"], train_runs["root"]
    # rank 0 alone wrote results.json; it holds each sample once
    assert not any((root / "ranks" / f"results_rank{r}.json").exists() for r in (1, 2, 3))
    records = json.loads((root / "ranks" / "results_rank0.json").read_text())
    assert sorted(r["index"] for r in records) == list(range(N_EVAL))
    by_index = sorted(records, key=lambda r: r["index"])
    assert by_index == sorted(train_runs["jax_records"], key=lambda r: r["index"])
    for r in ranks:
        for key, value in train_runs["jax_eval"].items():
            assert r["eval"][key] == pytest.approx(float(value), rel=1e-9, abs=1e-12), key


def test_checkpoint_saved_at_tp2_resumes_at_tp1(train_runs, tmp_path):
    """The full state written at tp = 2 (the shards gathered) resumes in one
    process at tp = 1: its parameters and moments bit-equal to the ranks'
    gathered ones, its step and ``latest`` too."""
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    root, job = train_runs["root"], train_runs["job"]
    full, _ = _gathered(root, "exp", train_runs["ranks"])
    model = MSR3D(job["network_cfg"], ByteTokenizer(), device="cpu", **job["model_kw"])
    assert model.load_jax_params(job["params"]) == []
    cfg = dict(_trainer_cfg(root / "ranks" / "exp", accum=2), resume=True)
    with one_torch_thread():
        trainer = LeoTrainer(cfg, loaders={"msr3d_train": {"train": dpw.RowsLoader(
            _global_batches(), 0, 4)}}, evaluators={}, model=model)
    assert (trainer.dp, trainer.tp, trainer.step) == (1, 1, 2)
    for name, value in full[0].items():
        np.testing.assert_array_equal(trainer.params[name].detach().numpy(), value.numpy(),
                                      err_msg=name)
    moments = trainer.optimizer.state
    assert set(moments) == set(full[0])
    q = "llm.layer.0.attn.q_proj.lora_b"  # split over tp in the save
    assert moments[q]["mu"].shape == trainer.params[q].shape == (64, 4)
    latest = trainer.ckpt.load_weights("latest")
    for name, value in full[0].items():
        np.testing.assert_array_equal(latest[name].numpy(), value.numpy(), err_msg=name)
