"""The port's training entry from the YAML against the JAX package's.

* ``models/build.py``: the LLM, prompter and model settings the YAML gives
  equal JAX's, on the debug config and on ``configs/msr3d.yaml`` with a
  Vicuna-7B ``config.json`` and a SentencePiece ``tokenizer.model`` that
  the test writes (configs compared, no 7B model built); every knob the
  port does not run raises.
* The entry end to end: ``msr3d_tpu_torch.run.main`` on
  ``configs/debug_synthetic.yaml`` (``device=cpu``, eval task emptied,
  nothing injected; the JAX initial weights carried over by replacing the
  port's seeded init) against ``LeoTrainer`` of the JAX package built from
  the same YAML, over the two optimizer steps of one epoch (8 samples,
  batch 2, accumulation 2).
* Preemption: SIGUSR1 after step 1 saves the full state at that boundary,
  and a rerun with ``resume=True`` ends equal to an uninterrupted run.
* The checkpoint loaders (PointNet++, scene encoder, from the config) leave
  the port's parameters equal to JAX's after its loaders.
* ``Lamb``: three steps equal ``optax.lamb`` through JAX's ``build_optim``.
* The port's modules import ``yaml`` and ``PIL`` only inside functions.
"""

import ast
import dataclasses
import json
import os
import random
import signal
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msr3d_tpu.models.build as jax_build
from msr3d_tpu.config import config_from_dict as jax_config_from_dict
from msr3d_tpu.config import load_config as jax_load_config
from msr3d_tpu.data.build import build_task_loaders as jax_build_task_loaders
from msr3d_tpu.models import load_weights as jax_load_weights
from msr3d_tpu.models.llm.sentencepiece import serialize_model_proto
from msr3d_tpu.optim.build import build_optim as jax_build_optim
from msr3d_tpu.trainer.leo_trainer import LeoTrainer as JaxLeoTrainer
from msr3d_tpu_torch import run as port_run
import msr3d_tpu_torch.models.build as port_build
from msr3d_tpu_torch.config import config_from_dict, load_config
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.data import synthetic
from msr3d_tpu_torch.data.scan_loader import ScanCache
from msr3d_tpu_torch.models import load_weights
from msr3d_tpu_torch.models.msr3d import MSR3D
from msr3d_tpu_torch.optim.build import build_optim, clip_by_global_norm
from msr3d_tpu_torch.trainer import train_state

from test_sentencepiece import _mini_bpe_pieces
from test_torch_train import _jax_model, _port_model
from torch_parity_utils import to_numpy_tree

REPO = Path(__file__).resolve().parent.parent
DEBUG = REPO / "configs" / "debug_synthetic.yaml"
FLAGSHIP = REPO / "configs" / "msr3d.yaml"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the public Vicuna-7B geometry (its HF config.json)
VICUNA_7B = {"vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
             "num_hidden_layers": 32, "num_attention_heads": 32, "rms_norm_eps": 1e-6,
             "max_position_embeddings": 2048, "tie_word_embeddings": False}


def _as_port(value):
    if isinstance(value, (jnp.dtype, np.dtype)) or value in (jnp.float32, jnp.bfloat16):
        return _DTYPES[np.dtype(value).name]
    return value


def _assert_fields_equal(port_cfg, jax_cfg) -> None:
    """Every field of the port's dataclass equals the JAX one's (nested
    dataclasses field by field, dtypes by name)."""
    for f in dataclasses.fields(port_cfg):
        got, want = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(got):
            _assert_fields_equal(got, want)
        else:
            assert got == _as_port(want), f.name


def _capture_msr3d(monkeypatch, module):
    """Replace ``module.MSR3D`` with a recorder of its arguments."""
    seen = {}

    def record(net_cfg, tokenizer, **kw):
        seen.update(net_cfg=net_cfg, tokenizer=tokenizer, kw=kw)
        return SimpleNamespace(**seen)

    monkeypatch.setattr(module, "MSR3D", record)
    return seen


def _assert_models_match(port, jax_model) -> None:
    _assert_fields_equal(port["net_cfg"].prompter, jax_model["net_cfg"].prompter)
    _assert_fields_equal(port["net_cfg"].llm, jax_model["net_cfg"].llm)
    for key in ("backbone_name", "image_pooling", "freeze_image_encoder"):
        assert getattr(port["net_cfg"], key) == getattr(jax_model["net_cfg"], key), key
    jkw = jax_model["kw"]
    for key, val in port["kw"].items():
        if key != "device":
            assert val == jkw[key], key
    for key in ("pad_id", "bos_id", "eos_id", "img_token_id", "scene_token_id", "vocab_size"):
        assert getattr(port["tokenizer"], key) == getattr(jax_model["tokenizer"], key), key


def _sp_checkpoint(root: Path) -> Path:
    """A checkpoint directory as the flagship's ``cfg_path`` reads it: the
    Vicuna-7B ``config.json`` and a BPE ``tokenizer.model`` (no weights)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(VICUNA_7B))
    (root / "tokenizer.model").write_bytes(serialize_model_proto(_mini_bpe_pieces()))
    return root


def test_build_model_matches_jax_on_the_debug_config(monkeypatch):
    overrides = ["device=cpu"]
    jax_seen = _capture_msr3d(monkeypatch, jax_build)
    jax_build.build_model(jax_load_config(DEBUG, overrides))
    port_seen = _capture_msr3d(monkeypatch, port_build)
    port_build.build_model(load_config(DEBUG, overrides))
    _assert_models_match(port_seen, jax_seen)
    monkeypatch.undo()
    model = port_build.build_model(load_config(DEBUG, overrides))
    assert isinstance(model, MSR3D) and model.device.type == "cpu"
    assert model.max_context_len == 128 and model.max_out_len == 16
    assert model.cfg.llm.lora_rank == 4 and model.cfg.llm.param_dtype == torch.bfloat16


def test_build_config_matches_jax_at_the_flagship_geometry(tmp_path, monkeypatch):
    ckpt = _sp_checkpoint(tmp_path / "vicuna")
    overrides = [f"model.llm.cfg_path={ckpt}", "model.llm.flash_attention=true"]
    jax_seen = _capture_msr3d(monkeypatch, jax_build)
    jax_build.build_model(jax_load_config(FLAGSHIP, overrides))
    port_seen = _capture_msr3d(monkeypatch, port_build)
    port_build.build_model(load_config(FLAGSHIP, overrides))
    _assert_models_match(port_seen, jax_seen)
    llm = port_seen["net_cfg"].llm
    assert (llm.vocab_size, llm.hidden_size, llm.num_hidden_layers, llm.lora_rank,
            llm.flash_attention, llm.param_dtype) == (32000, 4096, 32, 16, True, torch.bfloat16)
    assert type(port_seen["tokenizer"]).__name__ == "SPTokenizer"
    assert port_seen["kw"]["max_context_len"] == 256 and port_seen["kw"]["num_beams"] == 5


@pytest.mark.parametrize("override, match", [
    ("model.llm.remat=true", "remat"),
    ("parallel.sp=2", "parallel.sp"),
    ("eval_spec_k=2", "eval_spec_k"),
    ("eval_do_sample=true", "eval_do_sample"),
    ("eval_top_k=5", "eval_top_k"),
    ("eval_top_p=0.9", "eval_top_p"),
    ("compact_transfer=true", "compact_transfer"),
    ("model.prompter.model.situation_type=as_object", "as_object"),
    ("model.prompter.model.attn_flat.use_attn_flat=true", "AttFlat"),
])
def test_unported_knobs_raise(override, match):
    with pytest.raises(NotImplementedError, match=match):
        port_build.build_model(load_config(DEBUG, ["device=cpu", override]))


@pytest.mark.parametrize("name", ["OSE3D", "OSE3DORIG"])
def test_leo_prompter_nodes_build_as_object_which_raises(name):
    """The LEO prompter names build the ``as_object`` situation mode, as in
    JAX; the port raises on that mode (ROADMAP.md, the other modes)."""
    from msr3d_tpu.registry import MODEL_REGISTRY as JAX_REGISTRY
    from msr3d_tpu_torch.registry import MODEL_REGISTRY

    node = load_config(DEBUG).model.prompter
    assert JAX_REGISTRY.get(name)(
        jax_config_from_dict(node.to_dict())).cfg.situation_type == "as_object"
    assert MODEL_REGISTRY.get("OSE3DSituation")(node, device="cpu").cfg.situation_type == \
        "as_transform_for_objects"
    with pytest.raises(NotImplementedError, match="as_object"):
        MODEL_REGISTRY.get(name)(node, device="cpu")


# ---------------------------------------------------------------------------
# the entry end to end
# ---------------------------------------------------------------------------


def _entry_overrides(root: Path, exp_dir: Path, fp32: bool):
    ovs = [f"data.scan_family_base={root}/scan_family", f"data.rscan_base={root}/rscan",
           f"data.ARkit_base={root}/arkit", f"data.msr3d_base={root}/msr3d",
           "task.msqa_scannet.mode=[]", "debug.debug_size=8", f"exp_dir={exp_dir}"]
    return ovs + (["model.llm.param_dtype=fp32"] if fp32 else [])


def _switch_to_fp32(monkeypatch) -> None:
    """The compute dtypes the YAML cannot set (the LLM's and the point
    encoder's), switched to fp32 the same way in both builders."""
    for module, dtype in ((jax_build, jnp.float32), (port_build, torch.float32)):
        llm = module.build_llm_config
        prompter = module.OSE3DConfig
        monkeypatch.setattr(module, "build_llm_config",
                            lambda c, t, _llm=llm, _d=dtype: _llm(c, t, dtype=_d))
        monkeypatch.setattr(module, "OSE3DConfig", SimpleNamespace(
            from_config=lambda c, _p=prompter: dataclasses.replace(
                _p.from_config(c), obj_encoder_dtype="float32")))


def _seed_globals(seed: int = 0) -> None:
    random.seed(seed)
    np.random.seed(seed)


def _metrics(exp_dir: Path):
    with open(exp_dir / "metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


# fp32 on both sides, summed in other orders: a few ulps on values of order
# 1 (1e-7); 1e-5 leaves room for the depth of the model and two Adam steps
FP32_TOL = 1e-5
# bf16 compute on both sides (XLA's and PyTorch's CPU kernels round the
# matmuls and the bf16 base weights in other orders): one bf16 rounding is
# 2^-8 = 3.9e-3 relative, and the tiny network's loss stacks a few of them,
# so the losses agree within 2e-2 relative. An Adam update is lr·m̂/(√v̂+ε),
# of size at most lr whatever the gradient, so after two steps (lr ≤ 5e-4
# with the YAML's warm-up) the LoRA parameters differ by at most
# 2·(5e-4 + 5e-4) = 2e-3 even where rounding turns an update's sign
BF16_LOSS_RTOL = 2e-2
BF16_PARAM_ATOL = 2e-3


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_entry_trains_like_jax(precision, tmp_path, monkeypatch):
    fp32 = precision == "fp32"
    root = tmp_path / "data"
    synthetic.build_full_tree(root, np.random.default_rng(7))
    if fp32:
        _switch_to_fp32(monkeypatch)
    ScanCache.clear()

    jcfg = jax_load_config(DEBUG, _entry_overrides(root, tmp_path / "jax", fp32))
    jloaders = jax_build_task_loaders(jcfg)  # what the JAX trainer builds itself
    jtrain = jloaders["msr3d_train"]["train"]
    # the JAX trainer initialises its params from a batch it peeks; without
    # prefetch that peek reads on this thread and leaves no prefetch thread
    # drawing from the global generators after they are re-seeded
    jtrain.prefetch = 0
    jtrainer = JaxLeoTrainer(jcfg, loaders=jloaders, evaluators={})
    jtrain.prefetch = 2
    jparams = to_numpy_tree(jtrainer.model.params)
    initial = jax_to_torch_state_dict(jparams)[0]
    monkeypatch.setattr(MSR3D, "init_params", lambda self, seed=None:
                        self.load_jax_params(jparams))
    _seed_globals()
    jtrainer.train_one_epoch(0)  # the epoch of run(), without its orbax saves
    _seed_globals()
    trainer = port_run.main(["--config", str(DEBUG), "device=cpu",
                             *_entry_overrides(root, tmp_path / "port", fp32)])

    assert trainer.model.cfg.llm.dtype == (torch.float32 if fp32 else torch.bfloat16)
    assert (tmp_path / "port" / "config.yaml").exists()
    assert trainer._train_step.step_count == int(jtrainer.state.step) == 2
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    rtol = FP32_TOL if fp32 else BF16_LOSS_RTOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train/loss"], w["train/loss"], rtol=rtol)
        np.testing.assert_allclose(g["train/lr"], w["train/lr"], rtol=1e-6)
    trained = jax_to_torch_state_dict(jtrainer.state.params)[0]
    params = dict(trainer.model.network.named_parameters())
    lora = [n for n in trainer.trainable_names if "lora_" in n]
    assert len(lora) == 2 * 2 * 2  # A and B of q_proj and v_proj in 2 layers
    atol = FP32_TOL if fp32 else BF16_PARAM_ATOL
    for name in lora:
        np.testing.assert_allclose(params[name].detach().float().numpy(),
                                   trained[name].float().numpy(), atol=atol, err_msg=name)
        assert not torch.equal(params[name].detach().float(), initial[name].float()), name
    assert trainer.ckpt.has_weights("latest") and trainer.ckpt.latest_step() == 2
    ScanCache.clear()


def test_preemption_saves_at_the_step_and_resumes(tmp_path, monkeypatch):
    root = tmp_path / "data"
    synthetic.build_full_tree(root, np.random.default_rng(7))
    step_call = train_state.TrainStep.__call__
    handlers = []

    def signalling_step(self, micro_batches):
        out = step_call(self, micro_batches)
        handlers.append(signal.getsignal(signal.SIGUSR1))
        if self.step_count == 1 and preempt:
            os.kill(os.getpid(), signal.SIGUSR1)
        return out

    monkeypatch.setattr(train_state.TrainStep, "__call__", signalling_step)

    def entry(exp_dir, *extra):
        _seed_globals()
        ScanCache.clear()
        return port_run.main(["--config", str(DEBUG), "device=cpu",
                              *_entry_overrides(root, exp_dir, fp32=False), *extra])

    preempt = False
    whole = entry(tmp_path / "whole")
    assert whole._train_step.step_count == 2

    preempt = True
    cut = entry(tmp_path / "cut")
    assert cut._train_step.step_count == 1 and cut._preempted
    assert cut.ckpt.latest_step() == 1 and not cut.ckpt.has_weights("latest")
    saved = torch.load(tmp_path / "cut" / "ckpt" / "state" / "1.pt", weights_only=True)
    assert saved["tracker"]["loader_step"] == 2 and saved["tracker"]["epoch"] == 0
    assert signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL  # handlers restored

    preempt = False
    resumed = entry(tmp_path / "cut", "resume=True")
    assert resumed._train_step.step_count == 2
    want = whole.ckpt.load_weights("latest")
    got = resumed.ckpt.load_weights("latest")
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name

    handlers.clear()
    entry(tmp_path / "off", "preempt_save=false")
    assert handlers and all(h is signal.SIG_DFL for h in handlers)
    ScanCache.clear()


def test_mode_test_and_eval_splits_raise(tmp_path):
    root = tmp_path / "data"
    synthetic.build_full_tree(root, np.random.default_rng(7))
    ovs = _entry_overrides(root, tmp_path / "x", fp32=False)
    with pytest.raises(NotImplementedError, match="evaluation"):
        port_run.main(["--config", str(DEBUG), "device=cpu", *ovs, "mode=test"])
    with pytest.raises(NotImplementedError, match="evaluation"):
        port_run.main(["--config", str(DEBUG), "device=cpu",
                       *[o for o in ovs if not o.startswith("task.")]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_run.main(["--config", str(DEBUG), *ovs])
    ScanCache.clear()


# ---------------------------------------------------------------------------
# checkpoint loaders
# ---------------------------------------------------------------------------


def _reference_name(name: str) -> str:
    """A port prompter parameter → its name in the reference's torch
    modules."""
    for port, ref in ((".ffn.linear", ".linear"), ("spatial_layer.", "spatial_encoder."),
                      ("_encoder.dense.", "_encoder.0."), ("_encoder.norm.", "_encoder.1.")):
        name = name.replace(port, ref)
    return name


def _pointnet_state(net, rng, prefix: str, jmodel=None):
    """The point encoder's parameters and statistics as the reference's
    PointNetPP names them (1×1 convs, BatchNorm2d inside ``bn.bn``); with
    ``prefix`` ``pcd_net.`` a PcdObjEncoder's, whose semantic head (shapes
    from ``jmodel``) the JAX loader reads and the port skips."""
    sd = {}
    for name, t in net.visual_prompter.obj_encoder.state_dict().items():
        value = torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
        name = name.replace("pcd_net.", "")
        if ".dense." in name:
            i, j = name.split(".")[1], name.split(".")[4]
            sd[f"{prefix}encoder.{i}.mlps.0.layer{j}.conv.weight"] = value[:, :, None, None]
        elif ".bn." in name:
            i, j, leaf = name.split(".")[1], name.split(".")[4], name.split(".")[5]
            if leaf == "running_var":
                value = value.abs() + 0.5
            sd[f"{prefix}encoder.{i}.mlps.0.layer{j}.bn.bn.{leaf}"] = value
        else:
            sd[f"{prefix}{name}"] = value
    if prefix:
        head = jmodel.params["params"]["visual_prompter"]["obj_encoder"]["sem_head"]
        for i, layer, leaf, t in ((0, "fc1", "kernel", True), (0, "fc1", "bias", False),
                                  (2, "norm", "scale", False), (2, "norm", "bias", False),
                                  (4, "fc2", "kernel", True), (4, "fc2", "bias", False)):
            shape = np.shape(head[layer][leaf])
            value = rng.normal(size=shape[::-1] if t else shape).astype(np.float32)
            key = "weight" if leaf in ("kernel", "scale") else "bias"
            sd[f"obj3d_clf_pre_head.{i}.{key}"] = torch.from_numpy(value)
    return sd


def _scene_encoder_state(net, rng):
    """A learnable-only reference save: the prompter (without the point
    encoder), an ``anchor_feat`` this mode lacks, and both projections,
    behind DDP's ``module.`` prefix."""
    sd = {}
    for name, t in net.state_dict().items():
        if name.startswith("visual_prompter.") and ".obj_encoder." not in name:
            sd["module." + _reference_name(name)] = torch.from_numpy(
                rng.normal(size=t.shape).astype(np.float32))
        elif name.startswith(("llm_proj.", "llm_proj_img.")):
            sd["module." + name] = torch.from_numpy(rng.normal(size=t.shape).astype(np.float32))
    sd["module.visual_prompter.anchor_feat"] = torch.ones(1, 1, 32)
    return sd


def _assert_port_equals_jax(model, jmodel) -> None:
    want = jax_to_torch_state_dict(to_numpy_tree(jmodel.params))[0]
    got = model.network.state_dict()
    for name, value in want.items():
        assert torch.equal(got[name].float(), value.float()), name


@pytest.mark.parametrize("layout", ["pointnetpp", "pcd_obj_encoder"])
def test_pointnet_and_scene_encoder_loaders_match_jax(layout, tmp_path):
    jmodel = _jax_model(flash=False, window=False)
    model = _port_model(jmodel)
    rng = np.random.default_rng(1)
    prefix = "pcd_net." if layout == "pcd_obj_encoder" else ""
    torch.save(_pointnet_state(model.network, rng, prefix, jmodel), tmp_path / "pointnetpp.pt")
    torch.save(_scene_encoder_state(model.network, rng), tmp_path / "best.pth")

    variables = jax.tree_util.tree_map(np.array, jmodel.params)
    variables = jax_load_weights._tree_to_mutable(variables)
    jax_load_weights.load_pointnet_weights(variables, tmp_path / "pointnetpp.pt",
                                           jmodel.cfg.prompter.sa_mlps)
    jax_load_weights.load_scene_encoder_weights(variables, tmp_path / "best.pth")
    jmodel.params = variables
    before = {n: t.clone() for n, t in model.network.state_dict().items()}
    load_weights.load_pointnet_weights(model.network, tmp_path / "pointnetpp.pt",
                                       model.cfg.prompter.sa_mlps)
    load_weights.load_scene_encoder_weights(model.network, tmp_path / "best.pth")
    _assert_port_equals_jax(model, jmodel)
    after = model.network.state_dict()
    changed = {n for n in after if not torch.equal(after[n], before[n])}
    assert any(".bn." in n and "running_var" in n for n in changed)  # the statistics too
    assert any("spatial_layer.0.self_attn.lang_cond_fc" in n for n in changed)
    assert {"llm_proj.weight", "llm_proj_img.weight"} <= changed
    assert not any(n.startswith(("llm.", "image_encoder.")) for n in changed)


def test_load_pretrained_from_config_matches_jax(tmp_path):
    jmodel = _jax_model(flash=False, window=False)
    model = _port_model(jmodel)
    rng = np.random.default_rng(2)
    (tmp_path / "pretrain").mkdir()
    torch.save(_scene_encoder_state(model.network, rng),
               tmp_path / "pretrain" / "pytorch_model.bin")
    torch.save(_pointnet_state(model.network, rng, ""), tmp_path / "pointnetpp.pt")
    cfg = {"pretrain_ckpt_path": str(tmp_path / "pretrain"),
           "model": {"prompter": {"model": {"vision": {"args": {
               "path": str(tmp_path / "pointnetpp.pt")}}}},
               "llm": {"cfg_path": str(tmp_path)}}}  # no *.bin / *.safetensors: no LLM
    jmodel.params = jax_load_weights._tree_to_mutable(
        jax.tree_util.tree_map(np.array, jmodel.params))
    want = jax_load_weights.load_pretrained_from_config(jmodel, jax_config_from_dict(cfg))
    got = load_weights.load_pretrained_from_config(model, config_from_dict(cfg))
    assert got == want and len(got) == 2
    _assert_port_equals_jax(model, jmodel)
    assert load_weights.load_pretrained_from_config(model, config_from_dict({})) == []


# ---------------------------------------------------------------------------
# Lamb
# ---------------------------------------------------------------------------


def test_lamb_matches_optax():
    """Three steps, with clipping and weight decay, on a tensor with a zero
    norm (its trust ratio is 1) and two without; 1e-6 is a few fp32 ulps of
    parameters of order 1."""
    cfg = {"solver": {"grad_norm": 1.0, "optim": {"name": "Lamb", "args": {
        "lr": 1e-2, "weight_decay": 0.05, "betas": [0.8, 0.9]}},
        "sched": {"name": "warmup_cosine_instructblip", "args": {"warmup_steps": 1}}}}
    rng = np.random.default_rng(0)
    init = {"a": rng.normal(size=(4, 3)).astype(np.float32), "b": np.zeros(5, np.float32),
            "c": rng.normal(size=(2, 2, 3)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]
    tx, _ = jax_build_optim(jax_config_from_dict(cfg), total_steps=3)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, _, clip = build_optim(cfg, 3, params)
    assert type(opt).__name__ == "Lamb" and clip == 1.0
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        tg = [torch.from_numpy(g[k]) for k in params]
        opt.step(dict(zip(params, clip_by_global_norm(tg, clip))))
    for k in init:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, err_msg=k)
        assert not np.array_equal(np.asarray(jparams[k]), init[k])


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------


def test_yaml_and_pil_are_imported_only_inside_functions():
    """The GPU host has neither: a module-level import would break the
    import of the whole package there."""
    files = sorted((REPO / "msr3d_tpu_torch").rglob("*.py"))
    bad = []
    for path in files:
        tree = ast.parse(path.read_text())
        for node in tree.body:  # module level only; function bodies may import them
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("yaml", "PIL")]
    assert len(files) > 30 and not bad, bad
