"""Quantized bases under tensor parallelism (``parallel/sharding.py``'s specs
of ``weight_q``/``weight_scale``, the int4 row repacking of
``models/llm/convert.py``, the tp paths of ``LoraDense``) against the JAX
package, in fp32, on a real gloo group of two CPU processes
(``tests/torch_quant_tp_worker.py``, each rank with its own timeout and its
group's) and in this process:

1. shard-then-gather of the tiny MSR3D's int4 tree gives back JAX's packed
   bits at tp 2 and 4, a row-parallel rank's shard being its contiguous
   input rows repacked; the specs are JAX's, with JAX's fallback for a group
   scale whose groups do not divide by tp, and an int4 block whose packed
   rows do not divide raises;
2. single layers at tp = 2: s8×s8 bit-equal to tp = 1 (the absmax's max and
   the int32 sum over tp), int4 with groups of 32 that straddle a rank's
   nibble halves within 1e-6, and at tp = 4 a replicated group scale read
   by global row;
3. the tiny quantized Llama's forward at tp = 2 within 2e-4 of JAX's
   ``shard_variables`` forward (``tests/test_parallel.py``'s tolerance; the
   s8×s8 one, LoRA merged, bit-equal to the port's tp = 1 as well), and
   greedy tokens of ``tests/test_torch_quant.py``'s five quantized
   configurations at tp = 2 equal to JAX's generate over ``shard_variables``
   on a dp 1 x tp 2 mesh; the continuous greedy and beam engines and the
   prefix-pool engine over int4 with groups and the int8 KV cache at tp = 2
   equal to tp = 1's tokens; the HF loader quantizing a checkpoint into a
   rank's shards;
4. one epoch of QLoRA (int4, groups of 32) at dp 1 x tp 2 against JAX's
   ``LeoTrainer`` with ``parallel: {tp: 2}``: losses and grad norms within
   1e-4, the trained parameters at JAX's two-process tolerance (rtol 1e-4,
   atol 2e-5), the quantized buffers unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msr3d_tpu.config import config_from_dict
from msr3d_tpu.models.llm import convert as jconvert
from msr3d_tpu.models.llm.llama import LlamaModel as JaxLlamaModel
from msr3d_tpu.models.msr3d import MSR3D as JaxMSR3D
from msr3d_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from msr3d_tpu.parallel.mesh import make_mesh
from msr3d_tpu.parallel.sharding import shard_variables
from msr3d_tpu.trainer.leo_trainer import LeoTrainer as JaxLeoTrainer
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.models.llm.convert import quantize_kernel, unpack_int4
from msr3d_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel, LoraDense
from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
from msr3d_tpu_torch.models.load_weights import load_llm_weights
from msr3d_tpu_torch.models.msr3d import MSR3D
from msr3d_tpu_torch.parallel.sharding import (
    PACKED_ROWS,
    gather_state_dict,
    llm_tp_dims,
    shard_dims,
    shard_state_dict,
)

import torch_dp_worker as dpw
import torch_quant_tp_worker
from test_torch_distributed import _assert_params_close, _global_batches
from test_torch_quant import (
    GENERATE_CONFIGS,
    NEW_TOKENS,
    PENALTY,
    SCENE_TOKENS,
    _jax_quantized_model,
    _requests,
)
from test_torch_serving import prompt_bucket, text_requests
from test_torch_tp import _llama, _pool_requests
from test_torch_train import _jax_model, _metrics, _trainer_cfg
from torch_parity_utils import one_torch_thread, to_numpy_tree, torch_llama_config, \
    torch_network_config

# the KV cache is not on the forward; s8×s8 runs with its LoRA merged (rank
# 0, bench_qa's record configuration): with LoRA, the row-parallel A's
# partial sums part from tp = 1's at an fp32 ulp, which the next layer's
# per-token int8 rounding can turn into a whole int8 step (2.7e-3 on the
# logits of this config); its greedy tokens with LoRA are held below
FORWARD_CONFIGS = {name: dict(quant, lora_rank=0) if quant.get("act_quantize") else quant
                   for name, quant in GENERATE_CONFIGS.items() if not quant.get("kv_quantize")}
QLORA = dict(quantize=True, quantize_bits=4, quantize_group=32)
ENGINE_CONFIG = "int4-g32-kv8"  # the engines' quantized configuration


# ---------------------------------------------------------------------------
# 1. the specs and the int4 repacking, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_int4_shard_then_gather_gives_back_jax_packed_bits(tp):
    jmodel = _jax_quantized_model(dict(quantize=True, quantize_bits=4, quantize_group=32))
    jax_llm = to_numpy_tree(jmodel.params)["params"]["llm"]
    full = {n: t for n, t in jax_to_torch_state_dict(to_numpy_tree(jmodel.params))[0].items()
            if n.startswith("llm.")}
    shards = [shard_state_dict(full, r, tp, int4=True) for r in range(tp)]
    dims = shard_dims({n: tuple(v.shape) for n, v in full.items()}, tp, int4=True)
    back = gather_state_dict(shards, dims)
    for name, value in full.items():
        assert torch.equal(back[name], value), name
    down = "llm.layer.0.mlp.down_proj.weight_q"
    assert dims[down] == PACKED_ROWS and dims["llm.layer.0.mlp.gate_proj.weight_q"] == 1
    np.testing.assert_array_equal(back[down].numpy(),
                                  jax_llm["layer_0"]["mlp"]["down_proj"]["kernel_q"])
    # a rank's shard is its contiguous input rows, packed into its own halves
    rows = unpack_int4(full[down]).chunk(tp, dim=0)
    for r in range(tp):
        assert torch.equal(unpack_int4(shards[r][down]), rows[r])
    # the group scales: down's 4 groups split over tp; o_proj's 2 split at
    # tp = 2 and replicate at tp = 4 (JAX's fallback), as llm_tp_dims lays
    # out the model it builds
    o_scale = "llm.layer.0.attn.o_proj.weight_scale"
    assert dims["llm.layer.0.mlp.down_proj.weight_scale"] == 0
    assert dims[o_scale] == (0 if tp == 2 else None)
    assert dims["llm.layer.0.attn.q_proj.weight_scale"] == 1
    cfg = torch_llama_config(jmodel.cfg.llm, tp_size=tp, tp_rank=0)
    llm_tp_dims.cache_clear()
    built = {f"llm.{n}": d for n, d in llm_tp_dims(cfg).items()}
    assert built == {n: d for n, d in dims.items() if d is not None}
    llm = LlamaModel(cfg, device="meta")
    assert tuple(llm.layer[0].attn.o_proj.weight_scale.shape) == ((1, 64) if tp == 2 else (2, 64))


def test_int4_block_whose_packed_rows_do_not_divide_raises():
    """gate/up (64/2, 130) split their 130 columns over tp = 2, but down's
    65 packed rows do not divide: the block cannot split, and says which."""
    cfg = LlamaConfig.tiny(intermediate_size=130, quantize=True, quantize_bits=4, tp_size=2)
    with pytest.raises(ValueError, match=r"layer\.\*\.mlp\.down_proj"):
        LlamaModel(cfg, device="meta")


# ---------------------------------------------------------------------------
# 2. single layers at tp = 2 (the ranks) and tp = 4 (partial sums here)
# ---------------------------------------------------------------------------


def _layer_case(seed, bits, group, act, mode, lora=False, d_in=64, d_out=48, tp=2):
    r = np.random.default_rng(seed)
    cfg = LlamaConfig.tiny(dtype=torch.float32, lora_rank=4 if lora else 0, quantize=True,
                           quantize_bits=bits, quantize_group=group, act_quantize=act)
    kernel = torch.from_numpy((r.normal(size=(d_in, d_out)) * 0.05).astype(np.float32))
    q, s = quantize_kernel(kernel, bits, group)
    state = {"weight_q": q.numpy(), "weight_scale": s.numpy()}
    if lora:
        state["lora_a"] = (r.normal(size=(4, d_in)) * 0.1).astype(np.float32)
        state["lora_b"] = (r.normal(size=(d_out, 4)) * 0.1).astype(np.float32)
    n_g = d_in // group if group else 0
    split = not group or n_g % tp == 0
    if mode == "col":
        specs = {"weight_q": 1, "weight_scale": 1 if group else None, "lora_b": 0}
    else:
        specs = {"weight_q": PACKED_ROWS if bits == 4 else 0,
                 "weight_scale": 0 if group and split else None, "lora_a": 1}
    x = (r.normal(size=(2, 3, d_in)) * 2.0).astype(np.float32)
    return dict(cfg=cfg, d_in=d_in, d_out=d_out, lora=lora, mode=mode, scale_split=split,
                state=state, specs=specs, x=x)


LAYER_CASES = {
    "s8s8-int8-row": (1, 8, None, True, "row"),
    "s8s8-int8-col": (2, 8, None, True, "col"),
    "s8s8-int4-row": (3, 4, None, True, "row"),
    "s8s8-int4-col": (4, 4, None, True, "col"),
    "int4-g32-row": (5, 4, 32, False, "row"),
    "int4-g32-col": (6, 4, 32, False, "col"),
    "int4-row": (7, 4, None, False, "row"),
    "int8-col": (8, 8, None, False, "col"),
}
LORA_CASE = ("s8s8-int8-row-lora", (9, 8, None, True, "row", True))


def _cases():
    named = dict(LAYER_CASES, **{LORA_CASE[0]: LORA_CASE[1]})
    return {name: _layer_case(*args) for name, args in named.items()}


def _whole_layer(case):
    mod = LoraDense(case["d_in"], case["d_out"], case["cfg"], use_lora=case["lora"])
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in case["state"].items()})
    with torch.no_grad():
        return mod(torch.from_numpy(case["x"])).numpy()


# ---------------------------------------------------------------------------
# the ranks, and JAX on the same inputs
# ---------------------------------------------------------------------------


def _quantized_llama(quant):
    """The tiny JAX Llama of ``tests/test_torch_tp.py`` (GQA, LoRA, vocab
    256, perturbed) with its base quantized by JAX's ``quantize_llm_params``
    (``lora_rank`` 0 in ``quant``: its LoRA factors dropped)."""
    jcfg, _, variables, ids, mask = _llama()
    jcfg = dataclasses.replace(jcfg, **quant)
    params = to_numpy_tree(variables)["params"]
    if not jcfg.lora_rank:
        def drop_lora(tree):
            return {k: drop_lora(v) if isinstance(v, dict) else v for k, v in tree.items()
                    if not k.startswith("lora_")}

        params = drop_lora(params)
    params = jconvert.quantize_llm_params(params, jcfg)
    return jcfg, JaxLlamaModel(jcfg), {"params": params}, ids, mask


def _qlora_jax_model():
    jmodel = _jax_model(flash=False, window=True)
    jcfg = dataclasses.replace(jmodel.cfg, llm=dataclasses.replace(jmodel.cfg.llm, **QLORA))
    params = to_numpy_tree(jmodel.params)
    params["params"]["llm"] = jconvert.quantize_llm_params(params["params"]["llm"], jcfg.llm)
    model = JaxMSR3D(jcfg, jmodel.tokenizer, scene_token_len=jmodel.scene_token_len,
                     max_out_len=16, repetition_penalty=1.5)
    model.params = params
    return model


def _qlora_cfg(exp_dir):
    return dict(_trainer_cfg(exp_dir, accum=2), fixed_text_buckets=True, parallel={"tp": 2})


@pytest.fixture(scope="module")
def runs(cpu_devices, tmp_path_factory):
    root = tmp_path_factory.mktemp("quant_tp")
    cases = _cases()
    forward, jax_forward = {}, {}
    serve_mesh = make_mesh(JaxMeshConfig(dp=1, tp=2), devices=jax.devices("cpu")[:2])
    for name, quant in FORWARD_CONFIGS.items():
        jcfg, jmod, variables, ids, mask = _quantized_llama(quant)
        embeds = jax.jit(lambda v, i: jmod.apply(v, i, method=jmod.embed_tokens))(variables, ids)
        with serve_mesh:
            sharded = shard_variables(serve_mesh, {"params": {"llm": variables["params"]}})
            jax_forward[name] = np.asarray(jax.jit(lambda v, e, m: jmod.apply(v, e, m)[0])(
                {"params": sharded["params"]["llm"]}, embeds, mask))
        forward[name] = dict(cfg=torch_llama_config(jcfg), state={
            n: t.numpy() for n, t in jax_to_torch_state_dict(variables)[0].items()})
        if quant.get("act_quantize"):  # the port's tp = 1, for the bit-equal check
            one = LlamaModel(forward[name]["cfg"])
            one.load_state_dict({n: torch.from_numpy(v) for n, v in forward[name]["state"].items()})
            with torch.no_grad(), one_torch_thread():
                forward[name]["one"] = one(one.embed(torch.from_numpy(ids).long()),
                                           torch.from_numpy(mask).long()).numpy()

    generate, jax_tokens = {}, {}
    generate_kw = dict(scene_token_len=SCENE_TOKENS, max_out_len=NEW_TOKENS,
                       repetition_penalty=PENALTY)
    for name, quant in GENERATE_CONFIGS.items():
        jmodel = _jax_quantized_model(quant)
        generate[name] = dict(network_cfg=torch_network_config(jmodel.cfg),
                              params=to_numpy_tree(jmodel.params))
        if name == ENGINE_CONFIG:
            reqs = text_requests(4, seed=6)
            engines = dict(config=name, requests=reqs, pool_requests=_pool_requests(),
                           engine_kw=dict(num_slots=3, refill_group=1, chunk_steps=3,
                                          max_new_tokens=8, prompt_len=prompt_bucket(jmodel, reqs)),
                           pool_kw=dict(num_slots=4, num_prefixes=3, refill_group=2,
                                        prefix_len=64, suffix_len=64, chunk_steps=3,
                                        max_new_tokens=8))
            one = MSR3D(generate[name]["network_cfg"], ByteTokenizer(), device="cpu",
                        **generate_kw)
            assert one.load_jax_params(generate[name]["params"]) == []
            with one_torch_thread():
                engines_one = torch_quant_tp_worker.engine_tokens(one, engines)
        jmodel.shard_for_serving(serve_mesh, tensor_parallel=True)
        jax_tokens[name] = np.asarray(jmodel.generate(_requests(), use_beam=False)[
            "output_tokens"]).tolist()

    jq = _qlora_jax_model()
    qlora = dict(network_cfg=torch_network_config(jq.cfg), params=to_numpy_tree(jq.params),
                 model_kw=dict(scene_token_len=jq.scene_token_len, max_out_len=16,
                               repetition_penalty=1.5),
                 cfg=_qlora_cfg(root / "unused"), batches=_global_batches())
    job = dict(kind="quant", layers=list(cases.values()), forward=forward,
               ids=_llama()[3], mask=_llama()[4], generate=generate, requests=_requests(),
               generate_kw=generate_kw, engines=engines, qlora=qlora)
    ranks = dpw.run_ranks(job, root / "ranks", world=2, script=torch_quant_tp_worker.__file__)

    jax_dir = root / "jax"
    jtrainer = JaxLeoTrainer(
        config_from_dict(_qlora_cfg(jax_dir / "qlora")),
        loaders={"msr3d_train": {"train": dpw.RowsLoader(_global_batches(), 0, 4)}},
        evaluators={}, model=jq)
    assert jtrainer.mesh.shape["tp"] == 2
    jtrainer.train_one_epoch(0)
    trained = {n: t.numpy() for n, t in jax_to_torch_state_dict(
        to_numpy_tree(jtrainer.state.params))[0].items()}
    initial = {n: t.numpy() for n, t in jax_to_torch_state_dict(jq.params)[0].items()}
    with one_torch_thread():
        whole = {name: _whole_layer(case) for name, case in cases.items()}
    return dict(root=root, ranks=ranks, cases=cases, whole=whole, jax_forward=jax_forward,
                forward=forward, engines_one=engines_one,
                jax_tokens=jax_tokens, jax_dir=jax_dir, trained=trained, initial=initial)


def _layer_outputs(runs, name):
    """Each rank's whole output of layer case ``name``: a row-parallel
    layer's, reduced; a column-parallel one's, the ranks' columns joined."""
    i = list(runs["cases"]).index(name)
    outs = [np.asarray(r["layers"][i], np.float32) for r in runs["ranks"]]
    if runs["cases"][name]["mode"] == "col":
        return [np.concatenate(outs, axis=-1)]
    return outs


@pytest.mark.parametrize("name", [n for n in LAYER_CASES if n.startswith("s8s8")])
def test_s8s8_at_tp2_is_bit_equal_to_tp1(runs, name):
    """The rank's absmax, maxed over tp, is the whole row's, so its int8
    activations are a slice of tp = 1's; the int32 partial products sum
    exactly over tp: the output is tp = 1's bit for bit, on both ranks."""
    for got in _layer_outputs(runs, name):
        np.testing.assert_array_equal(got, runs["whole"][name])


def test_s8s8_with_lora_at_tp2_matches_tp1(runs):
    """With LoRA the row-parallel LoRA partial sums are reduced apart from
    the exact s8×s8 base: within fp32 rounding of tp = 1."""
    for got in _layer_outputs(runs, LORA_CASE[0]):
        np.testing.assert_allclose(got, runs["whole"][LORA_CASE[0]], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", [n for n in LAYER_CASES if not n.startswith("s8s8")])
def test_int4_and_int8_layers_at_tp2_match_tp1(runs, name):
    """int4 with groups of 32 over a row-parallel rank's 32 rows (nibble
    halves of 16: each half holds half a group) and the per-channel modes,
    within 1e-6 of tp = 1 in fp32."""
    for got in _layer_outputs(runs, name):
        np.testing.assert_allclose(got, runs["whole"][name], rtol=0, atol=1e-6)


def test_replicated_group_scale_at_tp4_matches_tp1():
    """in 192, groups of 32: 6 groups do not divide by tp = 4, so the scale
    replicates (JAX's fallback) while the packed rows split; each rank reads
    its 48 rows' scales by global row (its halves of 24 cut groups). The four
    ranks' partial products sum to tp = 1's within 2e-6 (outputs up to
    |y| ≈ 4, where an fp32 ulp is 4.8e-7, and four partial sums added in
    another order)."""
    case = _layer_case(10, 4, 32, False, "row", d_in=192, tp=4)
    assert not case["scale_split"]
    cfg = LlamaConfig.tiny(intermediate_size=192, quantize=True, quantize_bits=4,
                           quantize_group=32, tp_size=4)
    llm_tp_dims.cache_clear()
    dims = llm_tp_dims(cfg)
    assert dims["layer.0.mlp.down_proj.weight_q"] == PACKED_ROWS
    assert "layer.0.mlp.down_proj.weight_scale" not in dims
    from msr3d_tpu_torch.parallel.sharding import shard_tensor

    x = torch.from_numpy(case["x"])
    total = 0
    with torch.no_grad():
        for r in range(4):
            mod = LoraDense(192, case["d_out"], dataclasses.replace(case["cfg"], tp_size=4,
                                                                   tp_rank=r),
                            use_lora=False, tp_mode="row", scale_split=False)
            mod.load_state_dict({k: shard_tensor(torch.from_numpy(v), case["specs"].get(k), r, 4)
                                 for k, v in case["state"].items()})
            assert tuple(mod.weight_scale.shape) == (6, case["d_out"])
            total = total + mod.base_forward(x.chunk(4, dim=-1)[r])
    np.testing.assert_allclose(total.numpy(), _whole_layer(case), rtol=0, atol=2e-6)


@pytest.mark.parametrize("tp,d_in,mode", [
    (1, 256, None),    # halves of 4 whole groups: scaled by broadcasting over groups
    (2, 256, "col"),   # the same rows, the rank's columns
    (2, 256, "row"),   # a rank's halves of 64 rows: 2 whole groups each
    (2, 192, "row"),   # halves of 48 rows cut a group: each row's scale by its index
    (4, 192, "row"),   # halves of 24 rows over a replicated scale of 6 groups
])
def test_group_dequant_scales_each_row_by_its_global_group(tp, d_in, mode):
    """Every rank's int4 dequant by groups of 32, in bf16, bit-equal to its
    unpacked rows times the scale of each row's global group: the broadcast
    over whole groups and the scale by row index round alike."""
    from msr3d_tpu_torch.parallel.sharding import shard_tensor

    case = _layer_case(11, 4, 32, False, mode or "col", d_in=d_in, d_out=48, tp=tp)
    full_q = torch.from_numpy(case["state"]["weight_q"])
    full_s = torch.from_numpy(case["state"]["weight_scale"])
    rows = unpack_int4(full_q).to(torch.bfloat16) * full_s.to(torch.bfloat16)[
        torch.arange(d_in) // 32]
    cfg = dataclasses.replace(case["cfg"], dtype=torch.bfloat16, tp_size=tp)
    for r in range(tp):
        mod = LoraDense(d_in, 48, dataclasses.replace(cfg, tp_rank=r), use_lora=False,
                        tp_mode=mode, scale_split=case["scale_split"])
        mod.load_state_dict({k: shard_tensor(torch.from_numpy(v), case["specs"].get(k), r, tp)
                             for k, v in case["state"].items()})
        with torch.no_grad():
            got = torch.cat(mod._dequant_kernels(), dim=0)
        want = (rows.chunk(tp, dim=0)[r] if mode == "row"
                else rows.chunk(tp, dim=1)[r])
        assert torch.equal(got, want), r


@pytest.mark.parametrize("name", list(FORWARD_CONFIGS))
def test_quantized_forward_at_tp2_matches_jax_sharded(runs, name):
    ranks = runs["ranks"]
    assert [(r["dp"], r["tp"], r["tp_rank"]) for r in ranks] == [(1, 2, 0), (1, 2, 1)]
    shapes = ranks[0]["shapes"][name]
    quant = FORWARD_CONFIGS[name]
    rows = 64 // 2 // (2 if quant.get("quantize_bits") == 4 else 1)
    assert shapes["layer.0.attn.o_proj.weight_q"] == [rows, 64]  # its 32 input rows
    assert shapes["layer.0.attn.q_proj.weight_q"][1] == 32  # its 2 of 4 heads
    for r in ranks:
        np.testing.assert_allclose(r["forward"][name], runs["jax_forward"][name], atol=2e-4)
        if "one" in runs["forward"][name]:  # s8×s8: exact products, whole-head attention
            np.testing.assert_array_equal(np.asarray(r["forward"][name], np.float32),
                                          runs["forward"][name]["one"])
    np.testing.assert_array_equal(ranks[0]["forward"][name], ranks[1]["forward"][name])


@pytest.mark.parametrize("name", list(GENERATE_CONFIGS))
def test_quantized_greedy_at_tp2_equals_jax_sharded(runs, name):
    for r in runs["ranks"]:
        assert r["generate"][name] == runs["jax_tokens"][name], (r["rank"], name)


@pytest.mark.parametrize("engine", ["continuous", "beam", "pool"])
def test_quantized_engines_at_tp2_equal_tp1(runs, engine):
    """The engines over int4 with groups of 32 and the int8 KV cache (its
    scales split with the heads) at tp = 2 emit tp = 1's tokens, on both
    ranks."""
    want = runs["engines_one"][engine]
    assert len(want) == (6 if engine == "pool" else 4)
    for r in runs["ranks"]:
        assert {int(k): v for k, v in r["engines"][engine].items()} == want, (r["rank"], engine)


class _Holder(torch.nn.Module):
    """The ``llm`` and ``tp_dims`` the loaders overlay, as ``MSR3DNetwork``
    has them."""

    def __init__(self, cfg):
        super().__init__()
        self.llm = LlamaModel(cfg)

    def tp_dims(self):
        return {f"llm.{n}": d for n, d in self.llm.tp_dims().items()}


@pytest.mark.parametrize("quant", [dict(quantize=True),
                                   dict(quantize=True, quantize_bits=4, quantize_group=32)],
                         ids=["int8", "int4-g32"])
def test_load_llm_weights_quantizes_into_a_ranks_shards(tmp_path, quant):
    """Quantize-on-load at tp = 2: each rank's buffers and parameters are its
    shards (int4 rows repacked) of the whole model's load."""
    from msr3d_tpu_torch.models.llm.convert import config_from_hf
    from test_torch_quant import HF_CFG, _write_checkpoint

    _write_checkpoint(tmp_path, seed=1)
    cfg = config_from_hf(HF_CFG, dtype=torch.float32, **quant)
    whole = _Holder(cfg)
    load_llm_weights(whole, tmp_path, cfg)
    full = whole.state_dict()
    for r in range(2):
        holder = _Holder(dataclasses.replace(cfg, tp_size=2, tp_rank=r))
        load_llm_weights(holder, tmp_path, holder.llm.cfg)
        want = shard_state_dict(full, r, 2, int4=cfg.quantize_bits == 4)
        got = holder.state_dict()
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            assert torch.equal(got[name], value), name
    assert holder.llm.cfg.tp_vocab  # the vocab of 64 splits too


def test_qlora_dp1_tp2_step_matches_jax(runs):
    ranks, root = runs["ranks"], runs["root"]
    got_runs = [r["qlora"] for r in ranks]
    assert [g["steps"] for g in got_runs] == [2, 2]
    assert got_runs[0]["losses"] == got_runs[1]["losses"]
    assert all(g["buffers_unchanged"] for g in got_runs)
    assert "llm.layer.0.mlp.down_proj.weight_q" in got_runs[0]["sharded"]
    want = _metrics(runs["jax_dir"] / "qlora")
    got = _metrics(root / "ranks" / "qlora")
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2]
    np.testing.assert_allclose(got_runs[0]["losses"], [m["train/loss"] for m in want],
                               rtol=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["train/grad_norm"], w["train/grad_norm"], rtol=1e-4)
    params = torch.load(root / "ranks" / "qlora_params.pt")
    trained = runs["trained"]
    _assert_params_close({n: t.numpy() for n, t in params.items()},
                         {n: trained[n] for n in params}, [m["train/lr"] for m in got],
                         rtol=1e-4, atol=2e-5, initial=runs["initial"])
