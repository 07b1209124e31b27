"""The port's tp layout (``msr3d_tpu_torch/parallel/sharding.py``,
``mesh.MeshConfig``, the shard shapes of ``models/llm/llama.py``) against the
JAX package's ``parallel/sharding.py`` and ``parallel/mesh.py``, in one
process:

* ``MeshConfig.resolve`` and the rank layout against JAX's ``MeshConfig``
  and ``make_mesh`` (tp the fastest-varying index at pp = 1; the pp layout
  is ``tests/test_torch_pp.py``'s); sp raises, naming ROADMAP.md, and so
  does a split inside a head;
* ``llama_param_spec`` / ``network_param_spec`` against JAX's
  ``llama_param_spec`` / ``network_param_specs`` on every leaf of the tiny
  MSR3D (its quantized base's names too), and the divisibility fallback
  against JAX's ``shard_variables`` on the 8 CPU devices (the ByteTokenizer's
  vocab of 263 at tp = 2): the leaves a tp = 2 model holds whole are the
  ones JAX replicates, with one warning at its build;
* ``shard_state_dict`` → ``gather_state_dict`` bit-equal at tp 2 and 4, the
  shards of a model built at tp = 2 equal to them, and ``init_params`` at tp
  = 2 drawing the shards of the tp = 1 draw.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from msr3d_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from msr3d_tpu.parallel.mesh import make_mesh
from msr3d_tpu.parallel.sharding import llama_param_spec as jax_llama_param_spec
from msr3d_tpu.parallel.sharding import network_param_specs, shard_variables
from msr3d_tpu_torch.convert import jax_to_torch_state_dict, torch_name
from msr3d_tpu_torch.models.llm.llama import LlamaConfig, LlamaModel
from msr3d_tpu_torch.models.msr3d import MSR3D
from msr3d_tpu_torch.parallel import mesh
from msr3d_tpu_torch.parallel.sharding import (
    gather_state_dict,
    llama_param_spec,
    llm_tp_dims,
    network_param_spec,
    shard_dims,
    shard_state_dict,
)

from test_torch_train import _jax_model
from torch_parity_utils import torch_network_config


def _port_dim(spec, ndim: int, transposed: bool):
    """A JAX PartitionSpec of a flax leaf → the port's split dim."""
    axes = list(spec) + [None] * (ndim - len(spec))
    if "tp" not in axes:
        return None
    dim = axes.index("tp")
    return ndim - 1 - dim if transposed and ndim == 2 else dim


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, _jax_model(flash=False, window=False).params)


@pytest.mark.parametrize("n,tp", [(1, 1), (2, 2), (4, 2), (8, 2), (8, 4), (6, 3), (4, 1)])
def test_mesh_resolves_and_lays_out_ranks_as_jax(n, tp, cpu_devices):
    got = mesh.MeshConfig(tp=tp).resolve(n)
    assert got == JaxMeshConfig(dp=-1, tp=tp).resolve(n)
    # the port's tp groups are the rows of JAX's (dp, tp) device array, its
    # dp groups the columns (rank r is device r)
    ids = np.vectorize(lambda d: d.id)(
        make_mesh(JaxMeshConfig(dp=-1, tp=tp), devices=jax.devices("cpu")[:n]).devices)
    groups = mesh.mesh_groups(got[0], tp)
    assert groups["tp"] == groups["mp"] == ids[:, :, 0, 0].tolist()
    assert groups["dp"] == ids[:, :, 0, 0].T.tolist()


def test_mesh_refusals():
    with pytest.raises(ValueError, match="not divisible"):
        mesh.MeshConfig(tp=2).resolve(3)
    with pytest.raises(ValueError, match="!= 4 ranks"):
        mesh.MeshConfig(dp=3, tp=2).resolve(4)
    # pp x sp raises, as JAX's pipeline asserts
    with pytest.raises(NotImplementedError, match="pp × sp composition not supported"):
        mesh.MeshConfig(pp=2, sp=2).resolve(4)
    # pp, sp and a quantized base under tp are ported
    assert mesh.MeshConfig(pp=2).resolve(4) == (2, 1, 2, 1)
    assert mesh.MeshConfig(sp=2).resolve(4) == (2, 1, 1, 2)
    LlamaConfig.tiny(quantize=True, tp_size=2, tp_rank=0)
    with pytest.raises(NotImplementedError, match="inside a head"):
        LlamaModel(LlamaConfig.tiny(num_attention_heads=2, hidden_size=64, tp_size=4,
                                    tp_rank=0), device="meta")
    with pytest.raises(ValueError, match="tp_rank"):
        LlamaConfig.tiny(tp_size=2, tp_rank=2)


def test_specs_equal_jax_on_every_leaf(jax_params):
    specs = network_param_specs(jax_params)
    flat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    spec_of = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    n_split = 0
    for path, leaf in flat:
        key = "/".join(str(k.key) for k in path)
        name, transposed = torch_name(key)
        want = _port_dim(spec_of[path], leaf.ndim, transposed)
        assert network_param_spec(name, leaf.ndim) == want, key
        n_split += want is not None
    assert n_split == 2 * 7 * 2 + 2  # 2 layers x 7 projections x (weight, LoRA) + vocab
    # the quantized base keeps JAX's (in, out) layout: the same spec as JAX's
    for proj, want in (("q_proj", 1), ("o_proj", 0), ("gate_proj", 1), ("down_proj", 0)):
        path = f"['params']['llm']['layer_0']['attn']['{proj}']['kernel_q']"
        assert _port_dim(jax_llama_param_spec(path), 2, False) == want
        assert llama_param_spec(f"llm.layer.0.attn.{proj}.weight_q") == want


def test_fallback_replicates_the_leaves_jax_replicates(jax_params, cpu_devices, caplog):
    jmesh = make_mesh(JaxMeshConfig(dp=4, tp=2))
    with jmesh:
        placed = shard_variables(jmesh, jax_params)
    # the layout a tp = 2 model builds, with its one warning (the layout of
    # a config is decided once: forget earlier builds')
    llm_tp_dims.cache_clear()
    with caplog.at_level(logging.WARNING, logger="msr3d_tpu_torch.sharding"):
        net = _tp_model(_jax_model(flash=False, window=False), 0).network
        _tp_model(_jax_model(flash=False, window=False), 0)
    warnings = [r for r in caplog.records if r.name == "msr3d_tpu_torch.sharding"]
    assert len(warnings) == 1 and "2 leaves fell back" in warnings[0].getMessage()
    dims = net.tp_dims()
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name, _ = torch_name("/".join(str(k.key) for k in path))
        assert (name not in dims) == leaf.sharding.is_fully_replicated, name
    # the vocab of 263 is prime: the embeddings and the head replicate
    assert net.llm.cfg.vocab_size == 263 and not net.llm.cfg.tp_vocab
    assert net.llm.embed_tokens.weight.shape[0] == net.llm.lm_head.weight.shape[0] == 263
    # and shard_state_dict follows the same rule
    state = jax_to_torch_state_dict(jax_params)[0]
    assert {n for n, d in shard_dims({n: tuple(t.shape) for n, t in state.items()}, 2).items()
            if d is not None} == set(dims)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_gives_the_same_bits(jax_params, tp):
    full = jax_to_torch_state_dict(jax_params)[0]
    shards = [shard_state_dict(full, r, tp) for r in range(tp)]
    dims = shard_dims({n: tuple(t.shape) for n, t in full.items()}, tp)
    back = gather_state_dict(shards, dims)
    assert back.keys() == full.keys()
    for name, value in full.items():
        assert torch.equal(back[name], value), name
    q = "llm.layer.0.attn.q_proj.weight"
    assert shards[1][q].shape == (full[q].shape[0] // tp, full[q].shape[1])


def _tp_model(jmodel, tp_rank: int, tp: int = 2) -> MSR3D:
    cfg = torch_network_config(jmodel.cfg)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, tp_size=tp, tp_rank=tp_rank))
    return MSR3D(cfg, device="cpu", scene_token_len=6)


def test_model_shards_and_init_equal_the_sharded_tp1(jax_params):
    jmodel = _jax_model(flash=False, window=False)
    full = jax_to_torch_state_dict(jax_params)[0]
    one = MSR3D(torch_network_config(jmodel.cfg), device="cpu", scene_token_len=6)
    one.init_params(seed=3)
    one_init = one.network.state_dict()
    inits = []
    for r in range(2):
        model = _tp_model(jmodel, r)
        net = model.network
        # the model's split dims are JAX's layout with its fallback
        dims = shard_dims({n: tuple(t.shape) for n, t in full.items()}, 2)
        assert net.tp_dims() == {n: d for n, d in dims.items() if d is not None}
        want = shard_state_dict(full, r, 2)
        assert model.load_jax_params(jax_params) == []
        for name, value in net.state_dict().items():
            assert torch.equal(value, want[name]), name
        model.init_params(seed=3)
        inits.append(net.state_dict())
    joined = gather_state_dict(inits, net.tp_dims())
    for name, value in one_init.items():
        assert torch.equal(joined[name], value), name



def test_lamb_trust_ratio_of_a_split_parameter_is_the_whole_tensors(monkeypatch):
    """Lamb scales a parameter's update by ‖p‖ / ‖u‖ of the whole tensor: a
    rank that holds the first half of ``w`` (the tp sum of its square sums
    adds the other half's) steps its half as tp = 1 steps the whole; with
    its own half's norms it steps otherwise."""
    from msr3d_tpu_torch.optim.build import Lamb
    from msr3d_tpu_torch.parallel import tensor_parallel

    g = torch.Generator().manual_seed(0)
    p1, p2, g1, g2 = (torch.randn(3, 4, generator=g) for _ in range(4))

    def step(param, grad, split=False):
        param = torch.nn.Parameter(param.clone())
        opt = Lamb({"w": param}, lambda count: 0.1, weight_decay=0.01)
        if split:
            opt.tp_sharded = frozenset({"w"})
        opt.step({"w": grad})
        return param.detach()

    whole = step(torch.cat([p1, p2]), torch.cat([g1, g2]))
    other = Lamb({"w": torch.nn.Parameter(p2.clone())}, lambda count: 0.1, weight_decay=0.01)
    other.count = 1
    u2 = other._direction("w", p2, g2)
    extra = [p2.square().sum(), u2.square().sum()]  # the other rank's ‖p‖², ‖u‖²
    monkeypatch.setattr(tensor_parallel, "sum_over_tp_", lambda t: t.add_(extra.pop(0)))
    torch.testing.assert_close(step(p1, g1, split=True), whole[:3], rtol=1e-6, atol=1e-7)
    assert not extra
    assert not torch.allclose(step(p1, g1), whole[:3], rtol=1e-6, atol=1e-7)
