"""The trainer's memory options and last knobs in the port against the JAX
package: QLoRA over an int8/int4 base, the trainer's steps and generation
under remat, the point encoder's training-mode BatchNorm, the refusal of
unfrozen-encoder training (the JAX trainer fails on it), the
``MSR3D_NAN_CHECKS`` guard, ``train_metrics_lag``, ``async_checkpoint`` and
``profile.steps``.

Everything runs in fp32 on the CPU. One JAX init (the tiny MSR3D, weights
perturbed with numpy noise so LoRA B is nonzero) serves the file; the JAX
side runs jitted where it computes. Each tolerance is stated where it is
used.
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
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

import msr3d_tpu.utils.debug as jax_debug
import msr3d_tpu_torch.models.llm.llama as port_llama
import msr3d_tpu_torch.utils.debug as port_debug
from msr3d_tpu.config import config_from_dict
from msr3d_tpu.models.llm.convert import quantize_llm_params
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu.nn.pointnet import PcdObjEncoder as JaxPcdObjEncoder
from msr3d_tpu.nn.transformers import MultiHeadAttentionSpatial as JaxSpatialAttention
from msr3d_tpu.trainer.leo_trainer import LeoTrainer as JaxLeoTrainer
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.llama import LlamaModel, LoraDense
from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
from msr3d_tpu_torch.models.msr3d import MSR3D
from msr3d_tpu_torch.nn.pointnet import PcdObjEncoder
from msr3d_tpu_torch.nn.transformers import MultiHeadAttentionSpatial
from msr3d_tpu_torch.trainer import train_state
from msr3d_tpu_torch.trainer.checkpoint import CheckpointManager, Tracker
from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

from torch_parity_utils import (
    TINY_PROMPTER,
    one_torch_thread,
    perturbed,
    scene_inputs,
    to_numpy_tree,
    torch_llama_config,
    torch_network_config,
)

SCENE_TOKENS = 6
# fp32 on both sides, summed in other orders: values of order 1 agree to a
# few ulps; 1e-5 leaves room for the depth of the model (tests/test_torch_train.py)
ATOL = 1e-5
# training BatchNorm divides by a batch variance taken as E[x²] - E[x]²,
# which cancels, so each stage grows the summation-order rounding of its
# batch means by E[x²] / Var. One SharedMLP stage agrees within 6e-6; through
# three stages and the fc, against a float64 run of the same arithmetic, the
# port's fp32 embeddings are within 5.1e-6 and JAX's within 4.3e-5 (XLA's CPU
# reduction sums less exactly), so the two are held within 1e-4
BATCH_STATS_ATOL = 1e-4
QUANT_MODES = {"int8": dict(quantize_bits=8), "int4": dict(quantize_bits=4),
               "int4-group": dict(quantize_bits=4, quantize_group=16)}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _data(seed: int, answers=("a chair", "yes")):
    data = scene_inputs(seed)
    data["msr3d_prompt"] = ["You are in a scene: 景. What is on the table?",
                            "Scene 景 here. Can I go north?"]
    data["text_output"] = list(answers)
    return data


class _Loader:
    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        answers = [("a chair", "yes"), ("the red lamp", "no"), ("two", "behind me")]
        for i in range(self.n):
            yield _data(i, answers[i % len(answers)])


def _jax_cfg(prompter=TINY_PROMPTER, **llm):
    return JaxMSR3DNetworkConfig(
        prompter=prompter,
        llm=JaxLlamaConfig.tiny(vocab_size=JaxByteTokenizer().vocab_size, dtype=jnp.float32,
                                lora_rank=4, **llm),
        answer_window_loss=True)


@functools.lru_cache(maxsize=None)
def _variables():
    """The file's one JAX init: the tiny MSR3D's variables, perturbed."""
    model = JaxMSR3D(_jax_cfg(), JaxByteTokenizer(), scene_token_len=SCENE_TOKENS,
                     max_out_len=16)
    data = _data(0)
    ids, attn = model._encode_prompts(model.build_text_prompt(data))
    out_ids, out_mask = model._encode_answers(data["text_output"])
    batch = model._scene_batch(data)
    batch.update(input_ids=ids, attention_mask=attn, output_ids=out_ids, output_mask=out_mask)
    return to_numpy_tree(perturbed(model.init_params(batch), seed=4, std=0.05))


def _quantized_variables(jcfg):
    """The shared variables with the LLM's base quantized on the host, as
    ``quantize_llm_params`` converts a checkpoint: both packages get this
    base (JAX's flax init of a quantized model gives a dead one)."""
    variables = unfreeze(copy.deepcopy(_variables()))
    variables["params"]["llm"] = quantize_llm_params(variables["params"]["llm"], jcfg.llm)
    return variables


def _jax_model(jcfg, variables):
    model = JaxMSR3D(jcfg, JaxByteTokenizer(), scene_token_len=SCENE_TOKENS, max_out_len=16,
                     repetition_penalty=1.5)
    model.params = jax.tree_util.tree_map(np.array, variables)
    return model


def _port_model(jcfg, variables) -> MSR3D:
    """The port's model with JAX's weights; ``llm_proj_img``, which a tree
    initialised without images does not hold, from the port's seed."""
    model = MSR3D(torch_network_config(jcfg), ByteTokenizer(), scene_token_len=SCENE_TOKENS,
                  max_out_len=16, repetition_penalty=1.5, device="cpu")
    model.init_params(seed=0)
    assert model.load_jax_params(variables) == []
    return model


def _trainer_cfg(exp_dir, **extra):
    cfg = {
        "exp_dir": str(exp_dir), "mode": "train", "rng_seed": 0,
        "solver": {
            "gradient_accumulation_steps": 1, "grad_norm": 5.0, "epochs": 1,
            "optim": {"name": "AdamW",
                      "args": {"lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 0.05}},
            "sched": {"name": "warmup_cosine_instructblip", "args": {"warmup_steps": 2}},
        },
    }
    cfg.update(extra)
    return cfg


def _metrics(exp_dir):
    with open(exp_dir / "metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


# ---------------------------------------------------------------------------
# QLoRA: LoRA over a quantized base
# ---------------------------------------------------------------------------


def _rebuilt_weights_kept(model, embeds, mask):
    """Loss of ``mean(logits²)`` and the count of tensors autograd keeps
    for the backward that have a dequantized weight's shape (in, out) or
    (in/2, out) in the compute dtype."""
    shapes = set()
    for mod in model.modules():
        if isinstance(mod, LoraDense) and mod.bits:
            shapes |= {(mod.in_features, mod.out_features),
                       (mod.in_features // 2, mod.out_features)}
    kept = []

    def pack(t):
        if t.dtype == torch.float32 and tuple(t.shape) in shapes:
            kept.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model(embeds, mask).float().square().mean()
    return loss, len(kept)


@pytest.mark.parametrize("mode", list(QUANT_MODES))
def test_qlora_lora_grads_match_jax(mode, monkeypatch):
    """The scenario of ``tests/test_llama.py``'s QLoRA test, on a base both
    packages share: LoRA gradients over an int8, int4 and int4-group base
    against JAX's (1e-5, fp32), the quantized buffers bit-unchanged and
    without gradients. The product with the quantized base runs through
    ``_QuantizedBase``: the loss and the gradients equal autograd's over
    the plain rebuild bit for bit, and no rebuilt weight is kept for the
    backward (autograd over the plain ops keeps one a projection)."""
    jcfg = _jax_cfg(quantize=True, **QUANT_MODES[mode])
    llm_vars = {"params": _quantized_variables(jcfg)["params"]["llm"]}
    r = np.random.default_rng(3)
    embeds = (r.normal(size=(2, 12, 64)) * 0.5).astype(np.float32)
    mask = np.ones((2, 12), np.int32)
    mask[1, :4] = 0

    jmodel = JaxLlamaModel(jcfg.llm)
    flat = flatten_dict(llm_vars["params"])
    lora = {k: jnp.asarray(v) for k, v in flat.items() if k[-1].startswith("lora")}
    rest = {k: jnp.asarray(v) for k, v in flat.items() if not k[-1].startswith("lora")}

    @jax.jit
    def value_and_grad(leaves):
        def loss(lv):
            logits = jmodel.apply({"params": unflatten_dict({**rest, **lv})},
                                  jnp.asarray(embeds), jnp.asarray(mask))[0]
            return jnp.mean(logits ** 2)
        return jax.value_and_grad(loss)(leaves)

    want_loss, want_grads = value_and_grad(lora)
    want_grads = jax_to_torch_state_dict(
        {"params": unflatten_dict(to_numpy_tree(want_grads))})[0]

    model = LlamaModel(torch_llama_config(jcfg.llm))
    model.load_state_dict(jax_to_torch_state_dict(llm_vars)[0], strict=True)
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    assert buffers and all(b.dtype in (torch.int8, torch.float32) for b in buffers.values())
    et, mt = torch.from_numpy(embeds), torch.from_numpy(mask)

    loss, kept = _rebuilt_weights_kept(model, et, mt)
    assert kept == 0
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    assert set(grads) == set(want_grads) and all("lora_" in n for n in grads)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    for name, grad in grads.items():
        np.testing.assert_allclose(grad.numpy(), want_grads[name].numpy(), rtol=ATOL, atol=1e-6,
                                   err_msg=name)
    assert sum(float(g.abs().sum()) for n, g in grads.items() if n.endswith("lora_b")) > 0
    for name, buf in model.named_buffers():
        assert not buf.requires_grad and torch.equal(buf, buffers[name]), name

    # autograd over the plain rebuild: the same bits, and the rebuilt
    # weights kept for the backward
    model.zero_grad(set_to_none=True)
    monkeypatch.setattr(port_llama._QuantizedBase, "apply",
                        staticmethod(lambda x, mod: mod._dequant_product(x)))
    plain_loss, plain_kept = _rebuilt_weights_kept(model, et, mt)
    plain_loss.backward()
    # one rebuilt weight a projection (int4: one a half), save the first
    # layer's q/k/v, whose input carries no gradient
    per_weight = 1 if jcfg.llm.quantize_bits == 8 else 2
    assert plain_kept == per_weight * (7 * jcfg.llm.num_hidden_layers - 3)
    assert torch.equal(plain_loss, loss)
    for name, grad in grads.items():
        assert torch.equal(dict(model.named_parameters())[name].grad, grad), name


def _qlora_remat_cfg():
    """QLoRA with activation checkpointing: an int8 base, remat ``dots``."""
    return _jax_cfg(quantize=True, quantize_bits=8, remat=True, remat_policy="dots")


@functools.lru_cache(maxsize=None)
def _jax_qlora_run(tmp_root: str):
    """Three JAX ``LeoTrainer`` steps (accumulation 1) over the int8 base
    under remat ``dots``: (metrics, trained params)."""
    jcfg = _qlora_remat_cfg()
    jtrainer = JaxLeoTrainer(config_from_dict(_trainer_cfg(f"{tmp_root}/jax")),
                             loaders={"t": {"train": _Loader(3)}}, evaluators={},
                             model=_jax_model(jcfg, _quantized_variables(jcfg)))
    jtrainer.train_one_epoch(0)
    from pathlib import Path

    return (_metrics(Path(tmp_root) / "jax"),
            jax_to_torch_state_dict(to_numpy_tree(jtrainer.state.params))[0])


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_qlora"))


@pytest.mark.parametrize("lag", [0, 1, 2])
def test_qlora_remat_trainer_steps_match_jax_at_every_metrics_lag(lag, jax_root, tmp_path,
                                                                  monkeypatch):
    """Three optimizer steps over an int8 base under remat ``dots`` at
    ``train_metrics_lag`` 0, 1 and 2: the logged losses and grad norms
    (1e-5 relative) and the trained parameters (1e-6, as
    ``tests/test_torch_train.py``) equal the JAX trainer's, the int8 buffers
    are bit-unchanged and LoRA moved. The lag shows in the order of dispatch
    and read: a step's metrics are read ``lag`` dispatches later, and all
    are read by the epoch's end."""
    want_metrics, trained = _jax_qlora_run(jax_root)
    jcfg = _qlora_remat_cfg()
    model = _port_model(jcfg, _quantized_variables(jcfg))
    assert (model.cfg.llm.remat, model.cfg.llm.remat_policy) == (True, "dots")
    initial = {n: p.detach().clone() for n, p in model.network.named_parameters()}
    buffers = {n: b.clone() for n, b in model.network.named_buffers() if "weight_" in n}
    assert len(buffers) == 2 * 7 * jcfg.llm.num_hidden_layers

    trainer = LeoTrainer(_trainer_cfg(tmp_path, train_metrics_lag=lag),
                         loaders={"t": {"train": _Loader(3)}}, model=model)
    events = []
    step_call = train_state.TrainStep.__call__

    def dispatch(self, micro_batches):
        out = step_call(self, micro_batches)
        assert isinstance(out["loss"], torch.Tensor)  # nothing read back yet
        events.append(f"d{self.step_count}")
        return out

    monkeypatch.setattr(train_state.TrainStep, "__call__", dispatch)
    log = trainer.logger.log
    trainer.logger.log = lambda metrics, step=None: (events.append(f"r{step}"),
                                                     log(metrics, step=step))
    trainer.train_one_epoch(0)
    # steps 1 and 2 are logged (then every tenth), and every step is read
    assert events == {0: ["d1", "r1", "d2", "r2", "d3"],
                      1: ["d1", "d2", "r1", "d3", "r2"],
                      2: ["d1", "d2", "d3", "r1", "r2"]}[lag]
    assert len(trainer.timer.history) == 3

    got = _metrics(tmp_path)
    assert [m["step"] for m in got] == [m["step"] for m in want_metrics] == [1, 2]
    for g, w in zip(got, want_metrics):
        for key in ("train/loss", "train/grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=ATOL, err_msg=key)
        np.testing.assert_allclose(g["train/lr"], w["train/lr"], rtol=1e-6)
    params = dict(model.network.named_parameters())
    lrs = [m["train/lr"] for m in got]
    assert {n for n in trainer.trainable_names if n not in trained} == {
        "llm_proj_img.weight", "llm_proj_img.bias"}  # no images in the JAX tree
    for name in (n for n in trainer.trainable_names if n in trained):
        atol = 1e-6
        if name.endswith("self_attn.w_ks.bias"):
            # a true gradient of 0 that Adam scales up from rounding noise
            # (tests/test_torch_train.py): held to the size of the updates
            atol = 2 * sum(lrs) * (1 + 0.05 * float(initial[name].abs().max()))
        np.testing.assert_allclose(params[name].detach().numpy(), trained[name].numpy(),
                                   atol=atol, err_msg=name)
    lora = [n for n in trainer.trainable_names if "lora_" in n]
    assert lora and all(not torch.equal(params[n].detach(), initial[n]) for n in lora)
    for name, buf in model.network.named_buffers():
        if name in buffers:
            assert torch.equal(buf, buffers[name]), name


def test_remat_model_generates_like_jax_and_its_twin():
    """A ``remat: True`` model (QLoRA's int8 base, ``dots``) generates JAX's
    greedy tokens and its ``remat: False`` twin's: neither package
    checkpoints while generating (JAX through its remat-stripped twin)."""
    jcfg = _qlora_remat_cfg()
    variables = _quantized_variables(jcfg)
    data = _data(7)
    want = np.asarray(_jax_model(jcfg, variables).generate(
        dict(data), use_beam=False, max_new_tokens=6)["output_tokens"])
    model = _port_model(jcfg, variables)
    got = model.generate(dict(data), use_beam=False, max_new_tokens=6)["output_tokens"]
    np.testing.assert_array_equal(got, want)
    twin = _port_model(dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, remat=False)),
                       variables)
    np.testing.assert_array_equal(
        twin.generate(dict(data), use_beam=False, max_new_tokens=6)["output_tokens"], got)


# ---------------------------------------------------------------------------
# the point encoder unfrozen: train-mode BatchNorm, and the trainer's refusal
# ---------------------------------------------------------------------------


def _encoder_variables():
    tree = _variables()
    enc = {"params": tree["params"]["visual_prompter"]["obj_encoder"],
           "batch_stats": tree["batch_stats"]["visual_prompter"]["obj_encoder"]}
    return enc


def _port_encoder(freeze: bool) -> PcdObjEncoder:
    cfg = TINY_PROMPTER
    module = PcdObjEncoder(cfg.sa_n_points, cfg.sa_n_samples, cfg.sa_radii, cfg.sa_mlps,
                           compute_dtype=torch.float32, freeze=freeze)
    state, skipped = jax_to_torch_state_dict(_encoder_variables())
    assert skipped == []
    module.load_state_dict(state, strict=True)
    return module


def test_train_mode_batchnorm_matches_flax():
    """``PcdObjEncoder(freeze=False)`` in ``train()``: the embeddings, the
    new running statistics and the encoder's gradients equal flax's
    ``apply(..., deterministic=False, mutable=["batch_stats"])``: the
    statistics within 1e-5, the embeddings within ``BATCH_STATS_ATOL``, the
    gradients within ``BATCH_STATS_ATOL`` of each tensor's largest (order
    10-100: sums over every point). Frozen in ``train()``
    or unfrozen in ``eval()`` it reads the running statistics and changes
    none: unfrozen, gradients flow (JAX applies no ``stop_gradient``)."""
    cfg = TINY_PROMPTER
    pcds = scene_inputs(2)["obj_fts"]
    variables = _encoder_variables()
    jmod = JaxPcdObjEncoder(sa_n_points=cfg.sa_n_points, sa_n_samples=cfg.sa_n_samples,
                            sa_radii=cfg.sa_radii, sa_mlps=cfg.sa_mlps,
                            compute_dtype=jnp.float32, freeze=False)
    weights = np.random.default_rng(9).normal(size=(pcds.shape[0], pcds.shape[1],
                                                    cfg.sa_mlps[-1][-1])).astype(np.float32)

    # forward and backward as two programs (a vjp of the jitted forward):
    # jitted into one program with its backward, XLA's CPU compile of this
    # encoder in training mode gives other gradients (20.08 against 13.50,
    # JAX op by op and the port, for one first-layer weight, where a central
    # difference of 1e-4 in float64 gives 13.62), while the forward agrees
    @jax.jit
    def train_apply(params):
        (embeds, _), new = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(pcds),
            deterministic=False, mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)})
        return jnp.sum(embeds * weights), (embeds, new["batch_stats"])

    loss, backward, (jembeds, jstats) = jax.vjp(train_apply, variables["params"],
                                                has_aux=True)
    jgrads = backward(jnp.ones_like(loss))[0]
    want_stats = jax_to_torch_state_dict({"batch_stats": to_numpy_tree(jstats)})[0]
    want_grads = jax_to_torch_state_dict({"params": to_numpy_tree(jgrads)})[0]

    module = _port_encoder(freeze=False).train()
    stats_before = {n: b.clone() for n, b in module.named_buffers()}
    embeds = module(torch.from_numpy(pcds))
    np.testing.assert_allclose(embeds.detach().numpy(), np.asarray(jembeds),
                               atol=BATCH_STATS_ATOL)
    (embeds * torch.from_numpy(weights)).sum().backward()
    assert set(want_stats) == set(stats_before)
    for name, buf in module.named_buffers():
        assert not torch.equal(buf, stats_before[name]), name
        np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), atol=ATOL,
                                   rtol=ATOL, err_msg=name)
    grads = {n: p.grad for n, p in module.named_parameters() if p.grad is not None}
    assert grads and all(n.startswith("pcd_net.") for n in grads)
    for name, grad in grads.items():
        want = want_grads[name].numpy()
        np.testing.assert_allclose(grad.numpy(), want, rtol=0, err_msg=name,
                                   atol=BATCH_STATS_ATOL * float(np.abs(want).max()))

    frozen = _port_encoder(freeze=True)
    with torch.no_grad():
        want = frozen.eval()(torch.from_numpy(pcds))
        assert torch.equal(frozen.train()(torch.from_numpy(pcds)), want)
    assert all(torch.equal(b, stats_before[n]) for n, b in frozen.named_buffers())
    thawed = _port_encoder(freeze=False).eval()
    got = thawed(torch.from_numpy(pcds))
    assert torch.equal(got.detach(), want) and got.requires_grad
    assert all(torch.equal(b, stats_before[n]) for n, b in thawed.named_buffers())


def test_unfrozen_encoder_training_is_refused_as_jax_fails(tmp_path):
    """``vision.args.freeze: False`` with a train loader: the JAX trainer's
    first step fails (its train step applies the network without
    ``mutable=["batch_stats"]``), so the port's trainer raises at
    construction. Evaluation with ``freeze: False`` runs."""
    import flax

    prompter = dataclasses.replace(TINY_PROMPTER, vision_freeze=False)
    jcfg = _jax_cfg(prompter=prompter)
    jtrainer = JaxLeoTrainer(config_from_dict(_trainer_cfg(tmp_path / "jax")),
                             loaders={"t": {"train": _Loader(1)}}, evaluators={},
                             model=_jax_model(jcfg, _variables()))
    with pytest.raises(flax.errors.ModifyScopeVariableError, match="batch_stats"):
        jtrainer.train_one_epoch(0)

    model = _port_model(jcfg, _variables())
    assert not model.cfg.prompter.vision_freeze
    with pytest.raises(ValueError, match="ModifyScopeVariableError"):
        LeoTrainer(_trainer_cfg(tmp_path / "port"), loaders={"t": {"train": _Loader(1)}},
                   model=model)
    evaluate = LeoTrainer(_trainer_cfg(tmp_path / "eval", mode="eval"),
                          loaders={"t": {"test": _Loader(1)}}, model=model)
    assert evaluate.eval_task("t", "test") == {}  # generation ran, no evaluator
    stats = {n: b.clone() for n, b in model.network.named_buffers()}
    out = model.generate(_data(3), use_beam=False, max_new_tokens=3)["output_tokens"]
    assert out.shape == (2, 3)
    assert all(torch.equal(b, stats[n]) for n, b in model.network.named_buffers())


# ---------------------------------------------------------------------------
# the NaN guard
# ---------------------------------------------------------------------------


def test_nan_guard_raises_jax_message(monkeypatch):
    """``MSR3D_NAN_CHECKS`` on (JAX's ``_ENABLED`` and the port's, patched
    here): a NaN in one scene's input makes that scene's fused attention
    weights non-finite, and both packages raise ``FloatingPointError`` with
    the same message. Off, the guard is the identity and reads nothing."""
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 5, 32)).astype(np.float32)
    locs = r.normal(size=(2, 5, 5, 5)).astype(np.float32)
    jmod = JaxSpatialAttention(32, 4)
    variables = jmod.init(jax.random.key(0), x, x, x, locs)
    bad = x.copy()
    bad[0, 1, 3] = np.nan
    module = MultiHeadAttentionSpatial(32, 4).eval()

    assert not port_debug._ENABLED
    probe = torch.tensor([float("nan")])
    assert port_debug.assert_finite(probe, "x") is probe
    monkeypatch.setattr(jax_debug, "_ENABLED", True)
    monkeypatch.setattr(port_debug, "_ENABLED", True)
    with pytest.raises(FloatingPointError) as jax_error:
        jmod.apply(variables, bad, bad, bad, locs)
    with pytest.raises(FloatingPointError) as port_error:
        module(torch.from_numpy(bad), torch.from_numpy(locs))
    assert str(port_error.value) == str(jax_error.value) == (
        "spatial fused_attn: 100/200 non-finite values")
    _, fused = module(torch.from_numpy(x), torch.from_numpy(locs))  # finite: passes
    assert bool(torch.isfinite(fused).all())


# ---------------------------------------------------------------------------
# async_checkpoint and profile.steps
# ---------------------------------------------------------------------------


def test_async_checkpoint_resumes_like_an_uninterrupted_run(tmp_path, monkeypatch):
    """With ``async_checkpoint`` the full state is written from a background
    thread: a run preempted after step 1 (its metrics read before the save)
    and resumed equals an uninterrupted synchronous run bit for bit, in the
    learnable weights and the optimizer's moments. Back-to-back saves land
    in order and ``latest_step`` waits for them."""
    jcfg = _jax_cfg()

    def trainer(exp, **extra):
        return LeoTrainer(_trainer_cfg(tmp_path / exp, save_frequency=1, **extra),
                          loaders={"t": {"train": _Loader(3)}},
                          model=_port_model(jcfg, _variables()))

    whole = trainer("whole")
    whole.run()
    assert whole.ckpt.latest_step() == 3

    step_call = train_state.TrainStep.__call__
    cut = trainer("cut", async_checkpoint=True)
    assert cut.ckpt.async_save

    def preempting(self, micro_batches):
        out = step_call(self, micro_batches)
        cut._preempted = True
        return out

    monkeypatch.setattr(train_state.TrainStep, "__call__", preempting)
    cut.run()
    monkeypatch.setattr(train_state.TrainStep, "__call__", step_call)
    assert cut.step == 1 and cut.ckpt.latest_step() == 1
    assert [m["step"] for m in _metrics(tmp_path / "cut")] == [1]
    resumed = trainer("cut", async_checkpoint=True, resume=True)
    assert resumed.step == 1 and resumed.tracker.loader_step == 1
    resumed.run()
    assert resumed.step == 3 and resumed.ckpt.latest_step() == 3
    want, got = whole.ckpt.load_weights("latest"), resumed.ckpt.load_weights("latest")
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for name, state in whole.optimizer.state.items():
        for key, val in state.items():
            assert torch.equal(resumed.optimizer.state[name][key], val), (name, key)

    manager = CheckpointManager(tmp_path / "burst", async_save=True)
    for step in (1, 2, 3):
        manager.save_state(step, {"params": {"w": torch.full((4,), float(step))}},
                           Tracker(loader_step=step))
    assert manager.latest_step() == 3
    assert sorted(p.name for p in manager.state_dir.iterdir()) == ["3.pt"]
    tracker = Tracker()
    assert torch.equal(manager.restore_state(tracker)["params"]["w"], torch.full((4,), 3.0))
    assert tracker.loader_step == 3
    manager.close()


def test_profile_steps_writes_a_trace(tmp_path):
    """``profile.steps: 1``: a ``torch.profiler`` trace of the steps after
    step 2 through step 3 in ``exp_dir/profile``, as the JAX trainer traces
    them into the same place."""
    trainer = LeoTrainer(_trainer_cfg(tmp_path, profile={"steps": 1}),
                         loaders={"t": {"train": _Loader(4)}},
                         model=_port_model(_jax_cfg(), _variables()))
    trainer.run()
    traces = list((tmp_path / "profile").iterdir())
    assert [p.name for p in traces] == ["trace_step3.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
