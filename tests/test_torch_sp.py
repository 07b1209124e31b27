"""Sequence parallelism of the port (``parallel/ring_attention.py``, the sp
axis of ``parallel/mesh.py``, the ring route of ``models/llm/llama.py``, the
per-sequence CE over sp, sp in ``LeoTrainer``) against the JAX package, in
fp32 unless stated, the port's ranks on real gloo groups of separate CPU
processes (``tests/torch_sp_worker.py``, each rank with its own timeout and
its group's; one spawn a world size), JAX on its virtual CPU devices:

1. ``mesh_groups`` against JAX's (dp, tp, pp, sp) device array: sp is the
   fastest-varying rank index;
2. ``ring_attention`` against JAX's ``ring_attention`` at its tests'
   tolerances (``tests/test_ring_attention.py``: 2e-5 forward; rtol 2e-4,
   atol 3e-5 for the gradients w.r.t. q, k and v): causal and bidirectional
   at sp = 4, left key padding (rows with a valid key compared, the port's
   others exactly 0), GQA (the port passes the un-repeated kv heads), dp 2 x
   sp 2, sp = 1 in this process, and bf16 inputs (tolerance below);
3. the tiny Llama at T = 256 with left padding at sp = 4: logits and every
   LoRA gradient against JAX's ``sp_axis`` model under its mesh (rtol 5e-5
   and 2e-4, as ``test_llama_sp_forward_and_grads_long_context``), and each
   ``remat`` policy's loss and gradients equal to the run without remat;
4. ``MSR3DNetwork``'s loss at sp = 4 in JAX's
   ``test_full_network_sp_loss_matches`` setting (rtol 1e-5, atol 1e-6);
5. one AdamW ``LeoTrainer`` step at ``{sp: 2}``, dp 2 x sp 2 and tp 2 x sp
   2 against JAX's trainer with ``parallel: {sp: 2}`` and ``{tp: 2, sp:
   2}`` on the same config (losses and norms at rtol 1e-5, the updated
   parameters at rtol 2e-5 / atol 1e-6), and the clipped gradients the
   optimizer took against ``jax.grad`` of JAX's sp network on the same
   batch; the sp ranks' parameters bit-equal; with LoRA dropout 0.1 the
   ``{sp: 2}`` step equals the port's one-process step (the masks drawn
   whole and sliced; JAX's masks come from another generator);
6. the ``{sp: 2}`` run's evaluation scores each sample once, its checkpoint
   resumes at sp = 1 bit-equal, and a one-process checkpoint resumes at sp =
   2 bit-equal;
7. the refusals: pp x sp (JAX's pipeline asserts) and a sequence that does
   not divide by sp (JAX's ring asserts).
"""

import copy
import json
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.config import config_from_dict
from msr3d_tpu.models.llm.llama import LlamaConfig as JaxLlamaConfig
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from msr3d_tpu.parallel.mesh import make_mesh
from msr3d_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from msr3d_tpu.trainer.leo_trainer import LeoTrainer as JaxLeoTrainer
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel
from msr3d_tpu_torch.parallel import mesh
from msr3d_tpu_torch.parallel.ring_attention import ring_attention

import torch_dp_worker as dpw
import torch_sp_worker
from test_torch_distributed import N_EVAL, _assert_params_close, _eval_samples, _global_batches
from test_torch_train import SCENE_TOKENS, _jax_model, _metrics, _port_model
from torch_parity_utils import one_torch_thread, perturbed, to_numpy_tree, torch_llama_config, \
    torch_network_config

FWD_TOL = 2e-5  # JAX's tests/test_ring_attention.py
GRAD_RTOL, GRAD_ATOL = 2e-4, 3e-5
# bf16: the forward rounds as JAX's (q·k, p and the output to bf16; its bits
# are JAX's on this CPU), held to one bf16 ulp (2^-8 relative); the port's
# backward sums in fp32 and rounds once where JAX's autodiff rounds its bf16
# products, so the gradients (|g| up to 4) part by an ulp or two there
BF16_FWD_TOL = 2.0 ** -8
BF16_GRAD_RTOL, BF16_GRAD_ATOL = 2.0 ** -7, 2.0 ** -5
RTOL, ATOL = 2e-5, 1e-6  # an AdamW step's parameters, as tests/test_torch_pp.py holds them
SOLVER = {"grad_norm": 5.0, "epochs": 1, "gradient_accumulation_steps": 1,
          "optim": {"name": "AdamW",
                    "args": {"lr": 1e-3, "betas": [0.9, 0.999], "weight_decay": 0.0}},
          "sched": {"name": "warmup_cosine_instructblip", "args": {"warmup_steps": 2}}}
LAYOUTS = {"sp2": (1, 1, 2), "dp2-sp2": (2, 1, 2), "tp2-sp2": (1, 2, 2)}
# the JAX trainer each port layout is held to (JAX's mesh takes all 8
# devices: dp 4 x sp 2 and dp 2 x tp 2 x sp 2, the same global batch)
JAX_OF = {"sp2": "sp", "dp2-sp2": "sp", "tp2-sp2": "tp-sp"}
JAX_PARALLEL = {"sp": {"sp": 2}, "tp-sp": {"tp": 2, "sp": 2}}
MODEL_KW = dict(scene_token_len=SCENE_TOKENS, max_out_len=16, repetition_penalty=1.5)
RING = dict(b=2, s=32, h=2, d=8)  # JAX's ring test shapes
LLAMA_T = 256


def _cfg(exp_dir, parallel):
    return {"exp_dir": str(exp_dir), "mode": "train", "rng_seed": 0, "solver": dict(SOLVER),
            "fixed_text_buckets": True, "parallel": dict(parallel)}


def _start(job, out_dir, world):
    """The ranks of ``job`` started (``dpw.run_ranks`` without the wait), so
    that the JAX side runs meanwhile."""
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "job.pkl").write_bytes(pickle.dumps(job))
    port = dpw.free_port()
    return [subprocess.Popen([sys.executable, torch_sp_worker.__file__, str(out_dir / "job.pkl"),
                              str(out_dir)], env=dpw.rank_env(world, r, port), cwd=str(dpw.REPO),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _results(procs, out_dir):
    dpw.wait_all(procs)
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(len(procs))]


# ---------------------------------------------------------------------------
# the inputs
# ---------------------------------------------------------------------------


def _ring_cases():
    rng = np.random.default_rng(0)
    b, s, h, d = RING["b"], RING["s"], RING["h"], RING["d"]
    mk = lambda heads: rng.normal(size=(b, s, heads, d)).astype(np.float32)  # noqa: E731
    full = np.ones((b, s), bool)
    padded = np.arange(s)[None, :] >= np.array([[5], [11]])  # JAX's test's left padding
    cases = {}
    for name, layout, causal, valid, kv_heads, dtype in (
            ("causal", "sp4", True, full, h, "float32"),
            ("bidirectional", "sp4", False, full, h, "float32"),
            ("padded", "sp4", True, padded, h, "float32"),
            ("gqa", "sp4", True, padded, 1, "float32"),
            ("dp2-sp2", "dp2-sp2", True, padded, h, "float32"),
            ("bf16", "sp4", True, padded, h, "bfloat16")):
        cases[name] = dict(q=mk(h), k=mk(kv_heads), v=mk(kv_heads), g=mk(h), key_valid=valid,
                           causal=causal, layout=layout, dtype=dtype)
    return cases


def _llama():
    base = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=2, max_position_embeddings=LLAMA_T, lora_rank=4,
                dtype=jnp.float32)
    cfg = JaxLlamaConfig(**base)
    rng = np.random.default_rng(1)
    embeds = (rng.normal(size=(2, LLAMA_T, 32)) * 0.3).astype(np.float32)
    mask = np.ones((2, LLAMA_T), np.int32)
    mask[0, :7] = 0  # left padding on row 0
    variables = perturbed(jax.jit(JaxLlamaModel(cfg).init)(
        jax.random.key(0), jnp.asarray(embeds), jnp.asarray(mask)), seed=2, std=0.05)
    return base, variables, embeds, mask


def _network():
    import __graft_entry__ as ge

    network = ge._make_network(tiny=True)
    batch = ge._make_batch(np.random.default_rng(0), b=2, n_obj=6, n_pts=32, t_in=24, t_out=8,
                           vocab=512)
    variables = to_numpy_tree(jax.jit(network.init)(jax.random.key(0), **{
        k: jnp.asarray(v) for k, v in batch.items()}))
    return network, variables, batch


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_ring(case):
    b = RING["b"]
    layout = {"sp4": (JaxMeshConfig(dp=1, tp=2, pp=1, sp=4), None),
              "dp2-sp2": (JaxMeshConfig(dp=2, tp=2, pp=1, sp=2), "dp"),
              "sp1": (JaxMeshConfig(dp=1, tp=8, pp=1, sp=1), None)}
    cfg, batch_axis = layout[case["layout"]]
    jmesh = make_mesh(cfg, devices=jax.devices("cpu"))
    dtype = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    rep = case["q"].shape[2] // case["k"].shape[2]  # JAX's model repeats kv heads first
    q, k, v = (jnp.asarray(case[x], dtype) for x in ("q", "k", "v"))
    g, valid = jnp.asarray(case["g"]), jnp.asarray(case["key_valid"])

    def run(q, k, v):
        out = jax_ring_attention(jmesh, q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
                                 axis="sp", causal=case["causal"], key_valid=valid,
                                 batch_axis=batch_axis)
        return jnp.sum(out.astype(jnp.float32) * g), out

    assert b % jmesh.shape["dp"] == 0
    (_, out), grads = jax.jit(jax.value_and_grad(run, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out.astype(jnp.float32)), [np.asarray(x.astype(jnp.float32)) for x in grads]


def _jax_llama(base, variables, embeds, mask):
    model = JaxLlamaModel(JaxLlamaConfig(**base, sp_axis="sp"))
    jmesh = make_mesh(JaxMeshConfig(dp=1, tp=1, pp=1, sp=4), devices=jax.devices("cpu")[:4])
    m = jnp.asarray(mask)

    def loss(v, e):
        logits, _, _ = model.apply(v, e, m)
        masked = logits.astype(jnp.float32) * m[..., None].astype(jnp.float32)
        return jnp.sum(masked ** 2) / jnp.sum(m), logits

    with jmesh:
        (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables, jnp.asarray(embeds))
    names = {n: t.numpy() for n, t in jax_to_torch_state_dict(to_numpy_tree(grads))[0].items()}
    return float(value), np.asarray(logits), names


def _jax_network_loss(network, variables, batch):
    import dataclasses

    from msr3d_tpu.models.msr3d import MSR3DNetwork as JaxMSR3DNetwork

    cfg = dataclasses.replace(network.cfg, llm=dataclasses.replace(network.cfg.llm,
                                                                   sp_axis="sp"))
    jmesh = make_mesh(JaxMeshConfig(dp=1, tp=1, pp=1, sp=4), devices=jax.devices("cpu")[:4])
    with jmesh:
        loss = jax.jit(lambda v, b: JaxMSR3DNetwork(cfg).apply(v, **b)["loss"])(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(loss)


def _jax_trainer(jmodel, root, parallel):
    """JAX's ``LeoTrainer`` at ``parallel`` on the global batch: (its loss
    and norm, its updated trainable parameters by port name)."""
    trainer = JaxLeoTrainer(config_from_dict(_cfg(root / "exp", parallel)),
                            loaders={"msr3d_train": {"train": dpw.RowsLoader(
                                _global_batches()[:1], 0, 4)}}, evaluators={}, model=jmodel)
    assert trainer.mesh.shape["sp"] == 2
    trainer.train_one_epoch(0)
    params = {n: t.numpy() for n, t in jax_to_torch_state_dict(jax.tree_util.tree_map(
        np.asarray, trainer.state.params))[0].items()}
    return _metrics(root / "exp"), params


def _jax_grads(jmodel, batch):
    """``jax.grad`` of JAX's sp network's mean loss on the trainer's batch,
    by port name, and the first AdamW update of them."""
    jmesh = make_mesh(JaxMeshConfig(dp=4, tp=1, pp=1, sp=2), devices=jax.devices("cpu"))
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
              for k, v in batch.items()}
    params = jmodel.params

    def loss(p):
        return jmodel.network.apply(p, **jbatch)["loss"].mean()

    with jmesh:
        value, grads = jax.jit(jax.value_and_grad(loss))(params)
    names = {n: t.numpy() for n, t in jax_to_torch_state_dict(to_numpy_tree(grads))[0].items()}
    return float(value), names


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sp_runs(cpu_devices, tmp_path_factory):
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    root = tmp_path_factory.mktemp("sp")
    cases = _ring_cases()
    base, variables, embeds, mask = _llama()
    network, net_vars, net_batch = _network()
    jmodel = _jax_model(flash=False, window=True, sp_axis="sp", sp_data_axis="dp")
    one_dir = root / "one"
    with one_torch_thread():
        # the trainer's batch, for JAX's gradients; and a one-process run's
        # full state, for the sp ranks to resume
        one = LeoTrainer(_cfg(one_dir / "exp", {}), loaders={"msr3d_train": {
            "train": dpw.RowsLoader(_global_batches()[:1], 0, 4)}}, evaluators={},
            model=_port_model(jmodel))
        batch = {k: v.numpy() for k, v in one._device_batch([_global_batches()[0]])[0].items()}
        one.train_one_epoch(0)
        one._save_state(one.step)
        one_state = dict(params=one._learnable(), step=one.step,
                         moments={n: dict(st) for n, st in one.optimizer.state.items()})
    common = dict(kind="sp", network_cfg=torch_network_config(jmodel.cfg),
                  params=jax.tree_util.tree_map(np.array, jmodel.params), model_kw=MODEL_KW,
                  batches=_global_batches()[:1], global_rows=4, eval_samples=_eval_samples())
    runs = {name: dict(name=name, cfg=_cfg(root / "unused", {"tp": tp, "sp": sp}))
            for name, (_, tp, sp) in LAYOUTS.items()}
    runs["sp2"].update(eval=True, resume_dir=str(one_dir / "exp"))
    # LoRA dropout on: the sp ranks' masks are slices of sp = 1's
    dropout_cfg = torch_network_config(jmodel.cfg, lora_dropout=0.1)
    runs["sp2-dropout"] = dict(name="sp2-dropout", cfg=_cfg(root / "unused", {"sp": 2}),
                               network_cfg=dropout_cfg)
    with one_torch_thread():
        one_dropout = _one_process_step(root / "one_dropout", dropout_cfg, jmodel)
    four = dict(kind="sp", ring=cases, llama=True, network=True,
                llama_cfg=torch_llama_config(JaxLlamaConfig(**base)),
                llama_state={n: t.numpy() for n, t in
                             jax_to_torch_state_dict(to_numpy_tree(variables))[0].items()},
                embeds=embeds, mask=mask, network_params=net_vars, network_batch=net_batch,
                network_cfg=torch_network_config(network.cfg), train_common=common,
                train=[runs["dp2-sp2"], runs["tp2-sp2"]])
    two = dict(kind="sp", train_common=common, train=[runs["sp2"], runs["sp2-dropout"]])
    procs = {4: _start(copy.deepcopy(four), root / "four", 4),
             2: _start(copy.deepcopy(two), root / "two", 2)}
    try:
        jax_side = dict(
            ring={name: _jax_ring(case) for name, case in cases.items()},
            sp1=_jax_ring(dict(cases["padded"], layout="sp1")),
            llama=_jax_llama(base, variables, embeds, mask),
            network=_jax_network_loss(network, net_vars, net_batch),
            grads=_jax_grads(jmodel, batch),
            # a model each: JAX's trainer points its model at the trained params
            trainers={name: _jax_trainer(_jax_model(flash=False, window=True, sp_axis="sp",
                                                    sp_data_axis="dp"), root / f"jax_{name}", par)
                      for name, par in JAX_PARALLEL.items()})
    finally:  # the ranks end, whatever happened here
        ranks = {world: _results(p, root / ("four" if world == 4 else "two"))
                 for world, p in procs.items()}
    return dict(root=root, cases=cases, jax=jax_side, ranks=ranks, jmodel=jmodel,
                embeds=embeds, mask=mask, one_state=one_state, one_dir=one_dir,
                one_dropout=one_dropout)


def _one_process_step(exp_root, network_cfg, jmodel):
    """One ``LeoTrainer`` step of ``network_cfg`` (JAX's weights) in this
    process at sp = 1: its loss and the gradients the optimizer took."""
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    model = MSR3D(network_cfg, ByteTokenizer(), device="cpu", **MODEL_KW)
    assert model.load_jax_params(jmodel.params) == []
    trainer = LeoTrainer(_cfg(exp_root / "exp", {}), loaders={"msr3d_train": {
        "train": dpw.RowsLoader(_global_batches()[:1], 0, 4)}}, evaluators={}, model=model)
    taken, step = [], trainer.optimizer.step
    trainer.optimizer.step = lambda grads: (taken.append(
        {n: g.detach().clone() for n, g in grads.items()}), step(grads))[1]
    trainer.train_one_epoch(0)
    return dict(loss=_metrics(exp_root / "exp")[0]["train/loss"], grads=taken[0])


# ---------------------------------------------------------------------------
# 1. the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp, tp, sp", [(1, 1, 4), (2, 1, 2), (1, 2, 2), (2, 2, 2)])
def test_mesh_groups_lay_out_sp_fastest_as_jax(dp, tp, sp, cpu_devices):
    ids = np.vectorize(lambda d: d.id)(make_mesh(JaxMeshConfig(dp=dp, tp=tp, pp=1, sp=sp),
                                                 devices=cpu_devices[:dp * tp * sp]).devices)
    ids = ids[:, :, 0, :]  # (dp, tp, sp)
    groups = mesh.mesh_groups(dp, tp, 1, sp)
    assert groups["sp"] == ids.reshape(dp * tp, sp).tolist()
    assert groups["tp"] == ids.transpose(0, 2, 1).reshape(dp * sp, tp).tolist()
    assert groups["dp"] == ids.transpose(1, 2, 0).reshape(tp * sp, dp).tolist()
    assert groups["mp"] == ids.reshape(dp, tp * sp).tolist()
    assert mesh.MeshConfig(tp=tp, sp=sp).resolve(dp * tp * sp) == JaxMeshConfig(
        dp=-1, tp=tp, sp=sp).resolve(dp * tp * sp)


# ---------------------------------------------------------------------------
# 2. the ring
# ---------------------------------------------------------------------------


def _gathered_ring(sp_runs, name):
    """The ranks' blocks of case ``name`` joined: (out, [dq, dk, dv])."""
    ranks = [torch.load(sp_runs["root"] / "four" / f"ring_rank{r}.pt")[name] for r in range(4)]
    if sp_runs["cases"][name]["layout"] == "dp2-sp2":  # rank = 2·d + s
        join = lambda xs: torch.cat([torch.cat(xs[:2], 1), torch.cat(xs[2:], 1)], 0)  # noqa
    else:
        join = lambda xs: torch.cat(xs, 1)  # noqa: E731
    return (join([r["out"] for r in ranks]).numpy(),
            [join([r["grads"][i] for r in ranks]).numpy() for i in range(3)])


@pytest.mark.parametrize("name", ["causal", "bidirectional", "padded", "gqa", "dp2-sp2", "bf16"])
def test_ring_matches_jax_ring_attention(sp_runs, name):
    case = sp_runs["cases"][name]
    got, got_grads = _gathered_ring(sp_runs, name)
    want, want_grads = sp_runs["jax"]["ring"][name]
    fwd_tol, grad_rtol, grad_atol = ((BF16_FWD_TOL, BF16_GRAD_RTOL, BF16_GRAD_ATOL)
                                     if name == "bf16" else (FWD_TOL, GRAD_RTOL, GRAD_ATOL))
    rows = np.ones(case["key_valid"].shape, bool)
    if case["causal"]:  # a left-padded query row sees a valid key where it is valid
        rows = case["key_valid"]
        # the port's rows without a valid key are 0, as the flash kernel's
        assert (got[~rows] == 0).all()
    np.testing.assert_allclose(got[rows], want[rows], rtol=fwd_tol, atol=fwd_tol)
    for label, g, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=grad_rtol, atol=grad_atol,
                                   err_msg=f"grad w.r.t. {label}")


def test_ring_of_one_rank_matches_jax():
    case = dict(_ring_cases()["padded"], layout="sp1")
    q, k, v = (torch.from_numpy(case[x]).requires_grad_() for x in ("q", "k", "v"))
    with one_torch_thread():
        out = ring_attention(q, k, v, causal=True, key_valid=torch.from_numpy(case["key_valid"]))
        (out * torch.from_numpy(case["g"])).sum().backward()
    want, want_grads = _jax_ring(case)
    rows = case["key_valid"]
    np.testing.assert_allclose(out.detach().numpy()[rows], want[rows], rtol=FWD_TOL, atol=FWD_TOL)
    for label, t, w in zip("qkv", (q, k, v), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"grad w.r.t. {label}")


# ---------------------------------------------------------------------------
# 3-4. the LLM and the network
# ---------------------------------------------------------------------------


def test_llama_sp4_logits_and_lora_grads_match_jax(sp_runs):
    ranks = [r["llama"] for r in sp_runs["ranks"][4]]
    s = LLAMA_T // 4
    assert [r["window"] for r in ranks] == [[i * s, (i + 1) * s] for i in range(4)]
    saved = [torch.load(sp_runs["root"] / "four" / f"llama_rank{r}.pt") for r in range(4)]
    logits = torch.cat([x["logits"] for x in saved], 1).numpy()
    _, want_logits, want_grads = sp_runs["jax"]["llama"]
    valid = sp_runs["mask"].astype(bool)
    np.testing.assert_allclose(logits[valid], want_logits[valid], rtol=5e-5, atol=5e-5)
    grads = saved[0]["grads"]
    assert all(torch.equal(x["grads"][n], grads[n]) for x in saved for n in grads)
    checked = 0
    for name, want in want_grads.items():
        if np.abs(want).max() == 0:
            continue
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=2e-4, atol=1e-5, err_msg=name)
        checked += 1
    assert checked >= 4 and all("lora_" in n for n in grads)


@pytest.mark.parametrize("policy", ["full", "dots", "residuals"])
def test_remat_under_sp_equals_no_remat(sp_runs, policy):
    """The ring inside a checkpointed segment reruns its hops in the
    recompute, in one order on every rank: the loss, logits and gradients
    are the run's without remat, bit for bit."""
    for r in sp_runs["ranks"][4]:
        got = r["llama"]["remat"][policy]
        assert got["loss_equal"] and got["logits_equal"], got
        assert got["grads_equal"] == r["llama"]["grad_names"], got["grads_max_diff"]


def test_network_sp4_loss_matches_jax(sp_runs):
    want = sp_runs["jax"]["network"]
    losses = [r["network"]["loss"] for r in sp_runs["ranks"][4]]
    assert all(x == losses[0] for x in losses)  # every sp rank holds the whole loss
    np.testing.assert_allclose(losses[0], want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# 5. the trainer
# ---------------------------------------------------------------------------


def _train(sp_runs, name):
    world = 2 if name.startswith("sp2") else 4
    return [r["train"][name] for r in sp_runs["ranks"][world]], sp_runs["root"] / (
        "two" if world == 2 else "four") / name


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sp_step_matches_jax_trainer(sp_runs, name):
    ranks, out = _train(sp_runs, name)
    dp, tp, sp = LAYOUTS[name]
    for r in ranks:
        assert (r["dp"], r["tp"], r["sp"]) == (dp, tp, sp)
        assert r["rank"] == (r["dp_rank"] * tp + r["tp_rank"]) * sp + r["sp_rank"]
        assert r["groups"]["sp"] == list(range(r["rank"] - r["sp_rank"],
                                               r["rank"] - r["sp_rank"] + sp))
        assert r["llm"] == [tp, sp, r["sp_rank"]]  # the trainer gave the LLM its block
        assert r["steps"] == 1 and r["step_sp_comm_s"][0] > 0
    assert len({r["losses"][0] for r in ranks}) == 1  # every rank reports the loss
    for r in ranks:  # the sp replicas bit-equal (the trainer checked them)
        assert r["sp_digest"] == ranks[r["rank"] - r["sp_rank"]]["sp_digest"]
    metrics, trained = sp_runs["jax"]["trainers"][JAX_OF[name]]
    np.testing.assert_allclose(ranks[0]["losses"][0], metrics[0]["train/loss"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norms"][0], metrics[0]["train/grad_norm"],
                               rtol=1e-5)
    jax_loss, jax_grads = sp_runs["jax"]["grads"]
    np.testing.assert_allclose(ranks[0]["losses"][0], jax_loss, rtol=1e-5)
    step = torch.load(out / "step.pt")
    got_grads, params = step["grads"][0], step["params"]
    norm = np.sqrt(sum(float(np.square(jax_grads[n].astype(np.float64)).sum())
                       for n in got_grads))
    clip = min(1.0, SOLVER["grad_norm"] / norm)
    assert any("lora_" in n for n in got_grads)
    for n, g in got_grads.items():
        np.testing.assert_allclose(g.numpy(), jax_grads[n] * clip, rtol=RTOL, atol=ATOL,
                                   err_msg=n)
    initial = {n: t.numpy() for n, t in jax_to_torch_state_dict(sp_runs["jmodel"].params)[0]
               .items()}
    _assert_params_close({n: t.numpy() for n, t in params.items()},
                         {n: trained[n] for n in params}, [metrics[0]["train/lr"]], rtol=RTOL,
                         atol=ATOL, initial=initial)


def test_sp_lora_dropout_masks_are_sp1s(sp_runs):
    """LoRA dropout 0.1 in the trainer's step: each sp rank draws every
    input's mask for the whole sequence and keeps its block's rows, so the
    step is the one-process step's (the attention sums in another order);
    a mask drawn apart would move the loss by the dropout's own effect."""
    ranks, out = _train(sp_runs, "sp2-dropout")
    want = sp_runs["one_dropout"]
    plain = _train(sp_runs, "sp2")[0][0]["losses"][0]  # the same step without dropout
    assert abs(want["loss"] - plain) > 1e-3
    assert ranks[0]["losses"][0] == ranks[1]["losses"][0]
    np.testing.assert_allclose(ranks[0]["losses"][0], want["loss"], rtol=1e-6)
    got = torch.load(out / "step.pt")["grads"][0]
    assert got.keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# 6. evaluation and the checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resumed(sp_runs):
    """The ``{sp: 2}`` run's full state resumed in one process at sp = 1,
    with the same eval loader."""
    from msr3d_tpu_torch.data.build import DataLoader
    from msr3d_tpu_torch.evaluator.msqa_eval import MSQAEval
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    _, out = _train(sp_runs, "sp2")
    cfg = dict(_cfg(out / "exp", {}), resume=True)
    with one_torch_thread():
        trainer = LeoTrainer(cfg, loaders={
            "msr3d_train": {"train": dpw.RowsLoader(_global_batches()[:1], 0, 4)},
            "msqa": {"test": DataLoader(dpw.SampleDataset(_eval_samples()), batch_size=2,
                                        collate_fn=dpw.collate, prefetch=0)}},
            evaluators={"msqa": MSQAEval(task_name="msqa", save_dir=out / "eval_one")},
            model=_port_model(sp_runs["jmodel"]))
        results = trainer.eval_task("msqa", "test")
    return trainer, results, json.loads((out / "eval_one" / "results.json").read_text())


def test_checkpoint_saved_at_sp2_resumes_at_sp1(sp_runs, resumed):
    trainer = resumed[0]
    assert (trainer.dp, trainer.sp, trainer.step, trainer.model.cfg.llm.sp_size) == (1, 1, 1, 1)
    _, out = _train(sp_runs, "sp2")
    saved = torch.load(out / "step.pt")["params"]
    for name, value in saved.items():
        np.testing.assert_array_equal(trainer.params[name].detach().numpy(), value.numpy(),
                                      err_msg=name)
    assert set(trainer.optimizer.state) == set(saved)
    assert trainer.ckpt.load_weights("latest").keys() == saved.keys()


def test_checkpoint_saved_at_sp1_resumes_at_sp2(sp_runs):
    want = sp_runs["one_state"]
    ranks, out = _train(sp_runs, "sp2")
    assert all(r["resumed"] == {"step": 1, "sp": 2, "llm_sp": 2} for r in ranks)
    got = torch.load(out / "resumed.pt")
    assert got["params"].keys() == want["params"].keys()
    for name, value in want["params"].items():
        assert torch.equal(got["params"][name], value), name
    for name, state in want["moments"].items():
        for key, value in state.items():
            assert torch.equal(got["moments"][name][key].cpu(), value.cpu()), (name, key)


def test_sp_eval_scores_each_sample_once(sp_runs, resumed):
    ranks, out = _train(sp_runs, "sp2")
    assert not (out / "results_rank1.json").exists()  # rank 0 alone writes
    records = json.loads((out / "results_rank0.json").read_text())
    assert sorted(r["index"] for r in records) == list(range(N_EVAL))
    _, one_results, one_records = resumed
    assert (sorted(records, key=lambda r: r["index"])
            == sorted(one_records, key=lambda r: r["index"]))
    for r in ranks:  # both sp ranks evaluate and return the results
        for key, value in one_results.items():
            assert r["eval"][key] == pytest.approx(float(value), rel=1e-9, abs=1e-12), key


# ---------------------------------------------------------------------------
# 7. the refusals
# ---------------------------------------------------------------------------


def test_pp_times_sp_raises_as_jax_asserts():
    with pytest.raises(NotImplementedError, match="pp × sp composition not supported"):
        mesh.MeshConfig(pp=2, sp=2).resolve(4)
    with pytest.raises(NotImplementedError, match="pp × sp"):
        LlamaConfig.tiny(pp_size=2, sp_size=2)


def test_sequence_not_dividing_by_sp_raises_as_jax_asserts(cpu_devices):
    jmesh = make_mesh(JaxMeshConfig(dp=1, tp=2, pp=1, sp=4), devices=cpu_devices)
    x = jnp.zeros((1, 30, 2, 8))
    with pytest.raises(AssertionError, match="not divisible by sp=4"):
        jax_ring_attention(jmesh, x, x, x, axis="sp")
    llm = LlamaModel(LlamaConfig.tiny(sp_size=4, sp_rank=1, dtype=torch.float32))
    with pytest.raises(ValueError, match="sequence length 30 not divisible by sp=4"):
        llm(torch.zeros((1, 30, 64)), torch.ones((1, 30), dtype=torch.int32))
