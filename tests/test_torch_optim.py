"""The port's optimizers against optax through the JAX package's
``build_optim``: AdamW, Adam and SGD (with momentum) under each of the three
schedules, with gradient clipping that triggers and that does not, on a
small tree of parameters over four steps.

Both sides compute in fp32; the schedules are evaluated in fp64 by the port
and in fp32 by optax, so each update agrees within 1e-6 of its size (updates
are ~lr = 1e-2 here), and the parameter it lands on within a few fp32 ulps
of its value (4 steps, each rounding once: rtol 2.4e-7 = 4·2⁻²⁴)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msr3d_tpu.config import config_from_dict
from msr3d_tpu.optim.build import build_optim as jax_build_optim
from msr3d_tpu_torch.optim.build import build_optim, clip_by_global_norm, global_norm

SHAPES = {"w": (4, 3), "b": (3,), "lora_a": (2, 5)}
STEPS = 4


def _cfg(name, sched):
    args = {"lr": 1e-2}
    if name in ("AdamW", "Adam"):
        args["betas"] = [0.9, 0.98]
    if name == "AdamW":
        args["weight_decay"] = 0.05
    if name == "SGD":
        args["momentum"] = 0.9
    return {
        "solver": {
            "grad_norm": 5.0,
            "optim": {"name": name, "args": args},
            "sched": {"name": sched, "args": {"warmup_steps": 2}},
        }
    }


@pytest.mark.parametrize("clip", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("sched", ["warmup_cosine", "warmup_exp", "warmup_cosine_instructblip"])
@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD"])
def test_optimizer_steps_match_optax(name, sched, clip):
    r = np.random.default_rng(0)
    init = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    # global norms ~30 (clipped to 5) or ~0.3 (left alone)
    scale = 10.0 if clip else 0.1
    grads = [{k: (r.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]

    tx, _ = jax_build_optim(config_from_dict(_cfg(name, sched)), total_steps=6)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)

    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt, schedule, max_norm = build_optim(_cfg(name, sched), total_steps=6, params=params)
    assert max_norm == 5.0

    for step, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        before = {k: np.asarray(v) for k, v in jparams.items()}
        jparams = optax.apply_updates(jparams, updates)

        tg = [torch.from_numpy(g[k]) for k in params]
        norm = global_norm(tg)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
        assert bool(norm >= max_norm) == clip
        opt.step(dict(zip(params, clip_by_global_norm(tg, max_norm, norm))))
        for k in params:
            want = np.asarray(jparams[k])
            size = np.abs(want - before[k]).max()
            np.testing.assert_allclose(params[k].detach().numpy(), want,
                                       atol=1e-6 * max(size, 1e-3), rtol=4 * 2.0 ** -24,
                                       err_msg=f"{k} after step {step}")
    assert opt.count == STEPS and schedule(0) == pytest.approx(
        1e-2 * (1e-3 if sched == "warmup_cosine_instructblip" else 0.0))


def test_clip_matches_optax_formula():
    """(g / ‖g‖)·c, no epsilon: exactly what optax computes."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]  # ‖g‖ = 13
    clipped = clip_by_global_norm(g, 6.5)
    want = optax.clip_by_global_norm(6.5).update(
        [jnp.asarray([3.0, 4.0]), jnp.asarray([12.0])], optax.EmptyState())[0]
    for a, b in zip(clipped, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # under the bound the gradients are kept as they are
    assert all(torch.equal(a, b) for a, b in zip(clip_by_global_norm(g, 14.0), g))
    assert jax.tree_util.tree_leaves(want)
