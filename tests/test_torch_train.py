"""The LoRA training path of the port against the JAX package's: the flash
backward (the plain version of kernels K2dq and K2dkv), the loss functions,
``MSR3DNetwork.forward`` with its trainable gradients, dropout, and two
``LeoTrainer`` steps, the whole slice.

The models hold the same weights: the JAX model's own, perturbed with numpy
noise so LoRA B is nonzero and the adapters take part, converted with
``msr3d_tpu_torch.convert``. Everything runs in fp32 on the CPU; the JAX
flash kernels run in Pallas interpret mode. Each tolerance is stated where
it is used, with its reason.
"""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.config import config_from_dict
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.models.msr3d import MSR3DNetworkConfig as JaxMSR3DNetworkConfig
from msr3d_tpu.models.msr3d import build_targets as jax_build_targets
from msr3d_tpu.models.msr3d import sequence_ce_loss as jax_sequence_ce_loss
from msr3d_tpu.models.msr3d import sequence_ce_loss_windowed as jax_sequence_ce_loss_windowed
from msr3d_tpu.ops.flash_attention import _fwd_call as jax_fwd_call
from msr3d_tpu.ops.flash_attention import _Spec as JaxFlashSpec
from msr3d_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from msr3d_tpu.trainer.leo_trainer import LeoTrainer as JaxLeoTrainer
from msr3d_tpu_torch.convert import jax_to_torch_state_dict, torch_name
from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
from msr3d_tpu_torch.models.msr3d import (
    MSR3D,
    build_targets,
    sequence_ce_loss,
    sequence_ce_loss_windowed,
)
from msr3d_tpu_torch.ops.flash_attention import (
    _group_sum,
    flash_attention,
    flash_attention_backward_reference,
    flash_attention_train,
)
from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer
from msr3d_tpu_torch.trainer.train_state import merge_learnable

from torch_flash_bwd_model import CASE_IDS, CASES, kernel_model_backward, make_case, torch_inputs
from torch_flash_fwd_model import forward_inputs, kernel_model_forward
from torch_parity_utils import (
    IMAGE_PROMPTS,
    TINY_PROMPTER,
    image_inputs,
    one_torch_thread,
    perturbed,
    scene_inputs,
    torch_network_config,
)

SCENE_TOKENS = 6
# fp32 on both sides, summed in other orders: values of order 1 agree to a
# few ulps (1e-7), and 1e-5 leaves room for the depth of the model
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """The tiny models run on one intra-op thread: more gain nothing, and in
    a parallel run each worker's thread pool would oversubscribe the cores."""
    with one_torch_thread():
        yield


def _tree_paths(tree):
    """{"params/a/b": leaf} of a nested-dict pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


# ---------------------------------------------------------------------------
# 1. The flash backward
# ---------------------------------------------------------------------------


def test_flash_backward_matches_jax_vjp():
    """fp32, left padding, one fully masked row, GQA n_rep 2. The JAX side
    runs the Pallas kernels in interpret mode; both sides are fp32 math in
    other summation orders, so 1e-5 on gradients of order 1."""
    r = np.random.default_rng(11)
    b, t, hq, hkv, d = 2, 21, 4, 2, 16
    q, do = (r.normal(size=(b, t, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (r.normal(size=(b, t, hkv, d)).astype(np.float32) for _ in range(2))
    valid = np.ones((b, t), bool)
    valid[1, :5] = False  # left padding: rows 0-4 of batch 1 see no valid key
    valid[0, 7] = False

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, key_valid=jnp.asarray(valid), block_q=16,
                                   block_k=16, interpret=True)

    out_j, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tvalid = torch.from_numpy(valid)
    out, lse = flash_attention(tq, tk, tv, key_valid=tvalid)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    plain = flash_attention_backward_reference(tq, tk, tv, out, lse, tdo, tvalid)

    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    got = flash_attention_train(*leaves, key_valid=tvalid)
    auto = torch.autograd.grad(got, leaves, tdo)
    for name, w, p, a in zip(("dq", "dk", "dv"), want, plain, auto):
        np.testing.assert_allclose(p.numpy(), w, atol=ATOL, err_msg=f"plain {name}")
        np.testing.assert_allclose(a.numpy(), w, atol=ATOL, err_msg=f"autograd {name}")
    # the kernels' contract: no valid key → dq exactly 0; invalid key → dk = dv = 0
    dq, dk, dv = plain
    assert bool((dq[1, :5] == 0).all())
    assert bool((dk[1, :5] == 0).all()) and bool((dv[1, :5] == 0).all())
    assert bool((dk[0, 7] == 0).all()) and bool((dv[0, 7] == 0).all())


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_flash_backward_kernel_arithmetic_matches_jax_kernels(case):
    """The CUDA kernels' arithmetic (p and ds as hi + lo 16-bit parts, see
    ``torch_flash_bwd_model``) against the JAX package's own backward kernels
    in Pallas interpret mode, on 16-bit inputs. Both keep fp32 sums of exact
    products and round each gradient once to the 16-bit dtype, so they land
    one ulp apart at most (2^-7 of the value in bf16) plus 1e-2 near zero:
    the tolerance the kernels are held to on the card. The JAX side sums the
    GQA group after rounding per q head, as the port does."""
    arrays = make_case(case)
    q, k, v, do, valid = arrays
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[case[1]]

    def f(q_, k_, v_):
        return jax_flash_attention(q_, k_, v_, key_valid=jnp.asarray(valid), block_q=16,
                                   block_k=16, interpret=True)

    out_j, vjp = jax.vjp(f, *(jnp.asarray(x).astype(jdtype) for x in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do).astype(jdtype))]

    # delta from the JAX forward's 16-bit output, as its backward takes it
    inputs = torch_inputs(case, arrays, out=np.asarray(out_j.astype(jnp.float32)))
    dq, dk, dv = kernel_model_backward(*inputs)
    hkv = k.shape[2]
    got = (dq, _group_sum(dk, hkv), _group_sum(dv, hkv))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.float().numpy(), w, atol=1e-2, rtol=1e-2, err_msg=name)
    # the contract's exact zeros, on both sides
    t = q.shape[1]
    has_key = (np.tril(np.ones((t, valid.shape[1]), bool))[None] & valid[:, None, :]).any(-1)
    dead_key = ~(valid & (np.arange(valid.shape[1]) < t))
    assert not want[0][~has_key].any() and not dq.float().numpy()[~has_key].any()
    for g, w in zip(got[1:], want[1:]):
        assert not w[dead_key].any() and not g.float().numpy()[dead_key].any()


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_flash_forward_kernel_arithmetic_matches_jax_kernel(case):
    """K2f's arithmetic (see ``torch_flash_fwd_model``) against the JAX
    package's forward kernel in Pallas interpret mode (16 x 16 blocks, as
    ``flash_attention`` takes them off the TPU), on 16-bit inputs, output and
    lse. Both keep fp32 scores and sums and round p to the value dtype
    against the running max of their own key tiles (64 keys here, 16 there),
    and the output once: 1e-2 + 1e-2·|out|, the tolerance K2f is held to on
    the card; lse is fp32 on both sides, 1e-3. Rows without a valid key are
    exactly 0 on both sides."""
    arrays = make_case(case)
    q, k, v, _, valid = arrays
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[case[1]]
    tp, sp = -(-t // 16) * 16, -(-s // 16) * 16
    spec = JaxFlashSpec(causal=True, scale=float(1.0 / np.sqrt(d)), block_q=16, block_k=16,
                        n_rep=hq // hkv, t=t, s=s, interpret=True)

    def heads_first(x, n):  # (B, T, H, D) -> (B, H, n, D), zero-padded
        x = jnp.asarray(x).astype(jdtype).transpose(0, 2, 1, 3)
        return jnp.pad(x, ((0, 0), (0, 0), (0, n - x.shape[2]), (0, 0)))

    valid_j = jnp.pad(jnp.asarray(valid, jnp.int32)[:, None, :], ((0, 0), (0, 0), (0, sp - s)))
    out_j, lse_j = jax_fwd_call(spec, heads_first(q, tp), heads_first(k, sp), heads_first(v, sp),
                                valid_j)
    want_out = np.asarray(out_j[:, :, :t].transpose(0, 2, 1, 3).astype(jnp.float32))
    want_lse = np.asarray(lse_j[:, :, :t, 0])

    out, lse = kernel_model_forward(*forward_inputs(case, arrays))
    np.testing.assert_allclose(out.float().numpy(), want_out, atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-3, rtol=0)
    has_key = (np.tril(np.ones((t, s), bool))[None] & valid[:, None, :]).any(-1)  # (B, T)
    for got, want in ((out.float().numpy(), want_out), (lse.numpy().transpose(0, 2, 1),
                                                        want_lse.transpose(0, 2, 1))):
        assert not want[~has_key].any() and not got[~has_key].any()


# ---------------------------------------------------------------------------
# 2. The loss functions
# ---------------------------------------------------------------------------


def test_loss_functions_match_jax():
    r = np.random.default_rng(12)
    b, t_in, t_out, vocab = 3, 7, 5, 11
    input_ids = r.integers(0, vocab, size=(b, t_in))
    output_ids = r.integers(0, vocab, size=(b, t_out))
    output_mask = np.ones((b, t_out), np.int32)
    output_mask[1, 3:] = 0
    output_mask[2, 1:] = 0  # bos only: no target, the row's loss is 0
    targets = build_targets(*(torch.from_numpy(x) for x in (input_ids, output_ids, output_mask)))
    want_targets = jax_build_targets(*(jnp.asarray(x) for x in (input_ids, output_ids,
                                                                  output_mask)))
    np.testing.assert_array_equal(targets.numpy(), np.asarray(want_targets))

    logits = r.normal(size=(b, t_in + t_out, vocab)).astype(np.float32) * 3
    full = sequence_ce_loss(torch.from_numpy(logits), targets)
    np.testing.assert_allclose(full.numpy(), np.asarray(jax_sequence_ce_loss(
        jnp.asarray(logits), want_targets)), atol=1e-6)
    window = logits[:, t_in - 1:-1]
    windowed = sequence_ce_loss_windowed(torch.from_numpy(window), targets, t_in)
    np.testing.assert_allclose(windowed.numpy(), np.asarray(jax_sequence_ce_loss_windowed(
        jnp.asarray(window), want_targets, t_in)), atol=1e-6)
    # the same terms; the full form also sums the zeros of the prompt positions
    torch.testing.assert_close(windowed, full, atol=1e-6, rtol=0)
    assert full[2] == 0


# ---------------------------------------------------------------------------
# 3. MSR3DNetwork.forward: loss and trainable gradients
# ---------------------------------------------------------------------------


def _data(seed: int, answers=("a chair", "yes")):
    data = scene_inputs(seed)
    data["msr3d_prompt"] = [
        "You are in a scene: 景. What is on the table?",
        "Scene 景 here. Can I go north?",
    ]
    data["text_output"] = list(answers)
    return data


def _image_data(seed: int, case: str):
    """``_data`` with image placeholders in the prompts and images: MSR3D
    images with some masked or all masked, or a LEO single view (request
    2's masked)."""
    data = _data(seed)
    data["msr3d_prompt"] = list(IMAGE_PROMPTS)
    masks = {"some-masked": [[1, 1, 0], [1, 0, 0]], "all-masked": [[0, 0, 0], [0, 0, 0]],
             "leo": [[1], [0]]}[case]
    images = image_inputs(seed + 50, masks)
    if case == "leo":
        data["img_fts"] = images["msr3d_imgs"][:, 0]
        data["img_masks"] = images["msr3d_img_masks"][:, 0]
    else:
        data.update(images)
    return data


def _jax_model(flash: bool, window: bool, seed: int = 4, **llm):
    """The tiny JAX MSR3D, initialised on a batch with images so that its
    tree holds the image encoder and ``llm_proj_img`` (flax creates them at
    their first call), weights perturbed."""
    tok = JaxByteTokenizer()
    cfg = JaxMSR3DNetworkConfig(
        prompter=TINY_PROMPTER,
        llm=JaxLlamaConfig.tiny(vocab_size=tok.vocab_size, dtype=jnp.float32, lora_rank=4,
                                flash_attention=flash, **llm),
        backbone_name="convnext_test", answer_window_loss=window,
    )
    model = JaxMSR3D(cfg, tok, scene_token_len=SCENE_TOKENS, max_out_len=16,
                     repetition_penalty=1.5)
    model.params = jax.tree_util.tree_map(np.array, _initial_params(seed))
    return model


@functools.lru_cache(maxsize=None)
def _initial_params(seed: int):
    """The initial weights: the model's options (flash, answer window, LoRA
    dropout) do not change them, so one init serves every test."""
    model = JaxMSR3D(
        JaxMSR3DNetworkConfig(prompter=TINY_PROMPTER, llm=JaxLlamaConfig.tiny(
            vocab_size=JaxByteTokenizer().vocab_size, dtype=jnp.float32, lora_rank=4),
            backbone_name="convnext_test"),
        JaxByteTokenizer(), scene_token_len=SCENE_TOKENS, max_out_len=16)
    return perturbed(model.init_params(_jax_batch(model, _image_data(0, "some-masked"))),
                     seed=seed, std=0.05)


def _jax_batch(model: JaxMSR3D, data):
    ids, attn = model._encode_prompts(model.build_text_prompt(data))
    out_ids, out_mask = model._encode_answers(data["text_output"])
    ids, attn = model._pad_to_bucket(ids, attn, side="left")
    out_ids, out_mask = model._pad_to_bucket(out_ids, out_mask, side="right")
    batch = model._scene_batch(data)
    batch.update(input_ids=ids, attention_mask=attn, output_ids=out_ids, output_mask=out_mask)
    return batch


def _port_model(jmodel: JaxMSR3D, **kw) -> MSR3D:
    model = MSR3D(torch_network_config(jmodel.cfg), ByteTokenizer(),
                  scene_token_len=SCENE_TOKENS, max_out_len=16, repetition_penalty=1.5,
                  device="cpu", **kw)
    skipped = model.load_jax_params(jmodel.params)
    assert skipped == [], skipped
    return model


@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_network_loss_and_trainable_grads_match_jax(flash, window):
    _assert_loss_and_grads_match(_jax_model(flash, window), _data(5))


@pytest.mark.parametrize("case", ["some-masked", "all-masked", "leo"])
def test_network_loss_and_trainable_grads_with_images_match_jax(case):
    """Requests with images: the image encoder is frozen and keeps no graph,
    ``llm_proj_img`` trains. All images masked: the loss does not see them,
    and ``llm_proj_img``'s gradient is 0 on both sides."""
    _assert_loss_and_grads_match(_jax_model(flash=False, window=False), _image_data(5, case),
                                 images=True)


def _assert_loss_and_grads_match(jmodel, data, images=False):
    jbatch = {k: jnp.asarray(v) for k, v in _jax_batch(jmodel, data).items()}
    assert ("images" in jbatch) == images

    def loss_fn(variables):
        return jmodel.network.apply(variables, **jbatch)["loss"]

    want_loss = np.asarray(loss_fn(jmodel.params))
    want_grads = jax.grad(lambda v: loss_fn(v).mean())(jmodel.params)

    model = _port_model(jmodel)
    got = model.forward(data)["loss"]
    np.testing.assert_allclose(got.detach().numpy(), want_loss, atol=ATOL)
    got.mean().backward()

    # the trainable set is get_opt_params_mask's True leaves, by port name
    mask = _tree_paths(jmodel.get_opt_params_mask())
    want_names = {torch_name(path)[0] for path, on in mask.items() if on}
    names = model.trainable_parameter_names()
    assert set(names) == want_names and len(names) == len(want_names)
    assert any(n.startswith("llm_proj_img.") for n in names)
    params = dict(model.network.named_parameters())
    assert {n for n, p in params.items() if p.requires_grad} == want_names

    # gradients of order 1e-2..1 through a 2-layer fp32 model: 1e-5 absolute
    # (fp32 sums in other orders, as the loss)
    want = jax_to_torch_state_dict(want_grads)[0]
    for name in names:
        grad = params[name].grad
        if grad is None:
            # a request without images does not reach llm_proj_img: JAX's
            # gradient is 0 there, as the trainer takes a missing one
            assert not images and name.startswith("llm_proj_img."), name
            grad = torch.zeros_like(params[name])
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(), atol=ATOL, err_msg=name)
    frozen = [n for n, p in params.items() if n not in want_names]
    assert frozen and all(params[n].grad is None for n in frozen)
    assert any(n.startswith("image_encoder.") for n in frozen)


# ---------------------------------------------------------------------------
# 5. The trainer, the whole slice
# ---------------------------------------------------------------------------


class _Loader:
    """Tiny MSR3D data dicts, without images or, with ``images``, with three
    MSR3D images a request, some masked or all masked in turn (the JAX
    trainer stacks a group's micro-batches, so M stays the same)."""

    def __init__(self, n: int, seed: int = 0, images: bool = False):
        self.n, self.seed, self.images = n, seed, images

    def __len__(self):
        return self.n

    def __iter__(self):
        answers = [("a chair", "yes"), ("the red lamp", "no"), ("two", "behind me")]
        for i in range(self.n):
            if self.images:
                data = _image_data(self.seed + i, ("some-masked", "all-masked")[i % 2])
                data["text_output"] = list(answers[i % len(answers)])
                yield data
            else:
                yield _data(self.seed + i, answers[i % len(answers)])


def _trainer_cfg(exp_dir, accum=2):
    return {
        "exp_dir": str(exp_dir),
        "mode": "train",
        "rng_seed": 0,
        "solver": {
            "gradient_accumulation_steps": accum,
            "grad_norm": 5.0,
            "epochs": 1,
            "optim": {"name": "AdamW",
                      "args": {"lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 0.05}},
            "sched": {"name": "warmup_cosine_instructblip", "args": {"warmup_steps": 2}},
        },
    }


def _metrics(exp_dir):
    with open(exp_dir / "metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
def test_leo_trainer_two_steps_match_jax(flash, tmp_path):
    """3 batches at accumulation 2: one full group and a tail group, so 2
    optimizer steps. Losses and grad norms agree at fp32 rounding (1e-5);
    after the two AdamW steps (lr up to 5e-4) the learnable parameters agree
    within 1e-6, since each update is lr·m̂/(√v̂+ε) and the gradients agree
    to ~1e-6 relative."""
    jmodel = _jax_model(flash, window=True)
    model = _port_model(jmodel)  # the same initial weights
    initial = {n: p.detach().clone() for n, p in model.network.named_parameters()}
    cfg = _trainer_cfg(tmp_path / "port")
    jtrainer = JaxLeoTrainer(config_from_dict(_trainer_cfg(tmp_path / "jax")),
                             loaders={"msr3d_train": {"train": _Loader(3)}}, evaluators={},
                             model=jmodel)
    trainer = LeoTrainer(copy.deepcopy(cfg), loaders={"msr3d_train": {"train": _Loader(3)}},
                         model=model)
    assert trainer.steps_per_epoch == jtrainer.steps_per_epoch == 2
    jtrainer.train_one_epoch(0)
    stats = trainer.train_one_epoch(0)
    assert np.isfinite(stats["loss"])
    assert trainer.tracker.loader_step == jtrainer.tracker.loader_step == 3
    assert trainer._train_step.step_count == int(jtrainer.state.step) == 2

    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    for g, w in zip(got, want):
        for key in ("train/loss", "train/grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=ATOL, err_msg=key)
        np.testing.assert_allclose(g["train/lr"], w["train/lr"], rtol=1e-6)

    trained = jax_to_torch_state_dict(jtrainer.state.params)[0]
    params = dict(model.network.named_parameters())
    lrs = [m["train/lr"] for m in got]
    moved = 0
    for name in trainer.trainable_names:
        atol = 1e-6
        if name.endswith("self_attn.w_ks.bias"):
            # the key bias shifts every score of a row alike, which softmax
            # ignores: its true gradient is 0 and both sides hold rounding
            # noise, which Adam's m̂/(√v̂+ε) scales up to O(1). Held only to
            # the size of the two updates, Σ lr·(1 + wd·|p|)
            atol = 2 * sum(lrs) * (1 + 0.05 * float(initial[name].abs().max()))
        np.testing.assert_allclose(params[name].detach().numpy(), trained[name].numpy(),
                                   atol=atol, err_msg=name)
        moved += int(not torch.equal(params[name].detach(), initial[name]))
    assert moved == len(trainer.trainable_names)  # every trainable tensor took the updates
    assert all(torch.equal(p, initial[n]) for n, p in model.network.named_parameters()
               if n not in trainer.params)  # and nothing else moved

    # learnable save → load into a fresh port model gives the same loss
    data = _data(9)
    trainer._save_learnable("latest")
    fresh = _port_model(jmodel)
    merge_learnable(fresh.network, trainer.ckpt.load_weights("latest"))
    with torch.no_grad():
        assert torch.equal(fresh.forward(dict(data))["loss"], model.forward(dict(data))["loss"])

    # the full state resumes: parameters, optimizer moments, step and tracker
    trainer.ckpt.save_state(2, trainer._state_dict(), trainer.tracker)
    resumed = LeoTrainer(dict(cfg, resume=True), loaders={"msr3d_train": {"train": _Loader(3)}},
                         model=_port_model(jmodel))
    assert resumed._train_step.step_count == 2 and resumed.tracker.loader_step == 3
    assert resumed.optimizer.count == 2
    for name in trainer.trainable_names:
        assert torch.equal(resumed.params[name], params[name])
        for key, val in trainer.optimizer.state[name].items():
            assert torch.equal(resumed.optimizer.state[name][key], val)


def test_leo_trainer_steps_with_images_match_jax(tmp_path):
    """Two optimizer steps over batches with images (3 batches at
    accumulation 2): losses, grad norms and the learnable parameters agree
    as in the test above; ``llm_proj_img`` moved, the image encoder did
    not."""
    jmodel = _jax_model(flash=False, window=True)
    model = _port_model(jmodel)
    encoder = {n: t.clone() for n, t in model.network.image_encoder.state_dict().items()}
    jtrainer = JaxLeoTrainer(config_from_dict(_trainer_cfg(tmp_path / "jax")),
                             loaders={"msr3d_train": {"train": _Loader(3, images=True)}},
                             evaluators={}, model=jmodel)
    trainer = LeoTrainer(_trainer_cfg(tmp_path / "port"),
                         loaders={"msr3d_train": {"train": _Loader(3, images=True)}},
                         model=model)
    jtrainer.train_one_epoch(0)
    trainer.train_one_epoch(0)
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    for g, w in zip(got, want):
        for key in ("train/loss", "train/grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=ATOL, err_msg=key)
    trained = jax_to_torch_state_dict(jtrainer.state.params)[0]
    params = dict(model.network.named_parameters())
    initial = jax_to_torch_state_dict(jmodel.params)[0]
    for name in ("llm_proj_img.weight", "llm_proj_img.bias"):
        np.testing.assert_allclose(params[name].detach().numpy(), trained[name].numpy(),
                                   atol=1e-6, err_msg=name)
        assert not torch.equal(params[name].detach(), initial[name])
    assert all(torch.equal(t, encoder[n])
               for n, t in model.network.image_encoder.state_dict().items())


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    from msr3d_tpu_torch.models.llm.tokenizer import HFTokenizer

    model = _port_model(_jax_model(flash=False, window=False))
    loaders = {"msr3d_train": {"train": _Loader(1)}}
    cfg = _trainer_cfg(tmp_path)
    # eval_engine: continuous (with the prefix-pool engines too) and grouped
    # are ported (tests/test_torch_eval.py, tests/test_torch_scene_group.py)
    pooled = LeoTrainer(dict(cfg, eval_engine="continuous",
                             eval_engine_opts={"prefix_pool": True}), loaders=loaders,
                        model=model)
    assert pooled.cfg["eval_engine_opts"] == {"prefix_pool": True}
    assert LeoTrainer(dict(cfg, eval_engine="grouped"), loaders=loaders,
                      model=model).cfg["eval_engine"] == "grouped"
    # tp, pp and sp are ported (tests/test_torch_tp.py, tests/test_torch_pp.py,
    # tests/test_torch_sp.py); one process cannot hold two tp, pp or sp
    # ranks, as JAX's MeshConfig cannot resolve them over one device
    for axis in ("tp", "pp", "sp"):
        with pytest.raises(ValueError, match="1 ranks not divisible by tp"):
            LeoTrainer(dict(cfg, parallel={axis: 2}), loaders=loaders, model=model)
    # remat is ported (tests/test_torch_remat.py); training the point encoder
    # unfrozen is refused, as the JAX trainer fails on it
    # (tests/test_torch_train_options.py)
    import dataclasses

    thawed = _port_model(_jax_model(flash=False, window=False))
    thawed.cfg = dataclasses.replace(thawed.cfg, prompter=dataclasses.replace(
        thawed.cfg.prompter, vision_freeze=False))
    with pytest.raises(ValueError, match="ModifyScopeVariableError"):
        LeoTrainer(cfg, loaders=loaders, model=thawed)
    with pytest.raises(NotImplementedError, match="tokenizer"):
        HFTokenizer(str(tmp_path))
    import torch.distributed as dist

    from msr3d_tpu_torch.data.build import build_dataloader_leo
    from msr3d_tpu_torch.registry import DATASET_REGISTRY

    class Toy:  # a registered dataset of 5 samples
        def __init__(self, cfg, split):
            pass

        def __len__(self):
            return 5

    monkeypatch.setitem(DATASET_REGISTRY._obj_map, "Toy", Toy)
    with monkeypatch.context() as m:  # two ranks (the ranks themselves:
        # tests/test_torch_distributed.py): each loader takes rank 1's shard
        m.setattr(dist, "is_initialized", lambda: True)
        m.setattr(dist, "get_world_size", lambda: 2)
        m.setattr(dist, "get_rank", lambda: 1)
        sharded = {split: build_dataloader_leo(cfg, "Toy", "", {}, {"batchsize": 2}, split)
                   for split in ("train", "val")}
    assert all((ld.num_shards, ld.shard_id) == (2, 1) for ld in sharded.values())
    assert (len(sharded["train"]), sharded["val"].padded_tail) == (1, 1)
    # ported since: evaluation (val and test splits, evaluators, mode: test,
    # retrieval; tests/test_torch_eval.py), Lamb, and the model and loaders
    # built from the YAML (tests/test_torch_entry.py)
    split = LeoTrainer(cfg, loaders={"t": {"train": _Loader(1), "val": _Loader(1)}},
                       evaluators={"t": object()}, model=model)
    assert split.loaders["t"]["val"] is not None and list(split.evaluators) == ["t"]
    assert LeoTrainer(dict(cfg, mode="test"), loaders=loaders, model=model).mode == "test"
    retrieval = LeoTrainer(dict(cfg, model={"llm": {"inference_mode": "retrieval"}}),
                           loaders=loaders, model=model)
    assert retrieval.inference_mode == "retrieval"
    evaluate = LeoTrainer(dict(cfg, mode="eval"), loaders={"t": {"test": _Loader(1)}},
                          model=model)
    assert evaluate.train_loader is None and evaluate.optimizer is None
    lamb = copy.deepcopy(cfg)
    lamb["solver"]["optim"]["name"] = "Lamb"
    assert type(LeoTrainer(lamb, loaders=loaders, model=model).optimizer).__name__ == "Lamb"


# ---------------------------------------------------------------------------
# 6. Dropout
# ---------------------------------------------------------------------------


def test_dropout_follows_the_generator_and_train_mode():
    """Spatial dropout 0.1 and LoRA dropout 0.1: in train() mode the same
    generator seed gives the same loss and another seed another; eval()
    mode draws nothing and equals the loss without dropout."""
    import dataclasses

    jmodel = _jax_model(flash=False, window=False, lora_dropout=0.1)
    cfg = torch_network_config(jmodel.cfg)
    se = dataclasses.replace(cfg.prompter.spatial_encoder, dropout=0.1)
    cfg = dataclasses.replace(cfg, prompter=dataclasses.replace(cfg.prompter,
                                                                spatial_encoder=se))
    assert cfg.llm.lora_dropout == 0.1
    model = MSR3D(cfg, ByteTokenizer(), scene_token_len=SCENE_TOKENS, max_out_len=16,
                  device="cpu")
    model.load_jax_params(jmodel.params)
    data = _data(6)

    def loss(seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model.forward(dict(data), generator=gen)["loss"]

    deterministic = loss()
    assert torch.equal(loss(1), deterministic)  # eval(): the generator is not read
    model.network.train()
    a, b, c = loss(1), loss(1), loss(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, deterministic)
    with pytest.raises(ValueError, match="Generator"):
        loss()
    model.network.eval()
    assert torch.equal(loss(), deterministic)
