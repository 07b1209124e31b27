"""Data parallelism of the port (``msr3d_tpu_torch/parallel/mesh.py``, the
sharded loaders, ``TrainStep``'s all-reduce, ``LeoTrainer`` over ranks)
against one process and against the JAX package.

Every multi-process case is a real gloo group of separate processes on the
CPU (``tests/torch_dp_worker.py``), each rank with its own timeout and its
group's. The tiny model runs at dropout 0 (so the ranks' dropout masks do
not matter) and in fp32:

1. the collectives: ``process_allgather_objects`` with payloads of
   different sizes in rank order, a dp mean, the replica digest check,
   ``initialize_distributed_from_env`` (as ``tests/test_distributed.py``
   does for the JAX package); ``data_parallel_size`` against JAX's
   ``MeshConfig`` and the backend rule;
2. two ranks of ``LeoTrainer``, each on half of the global batch, with
   ``fixed_text_buckets``: 2 optimizer steps (a group of 2 micro-batches and
   a tail of 1) against the port's one process on the global batch (1e-6)
   and the JAX trainer's (JAX's own two-process tolerance,
   ``tests/test_multihost.py``: rtol 1e-4, atol 2e-5);
3. a two-rank ``eval_task`` over a split of 5 samples (the last batch of
   rank 1 ends in a wrap-around duplicate), blocking and ``eval_engine:
   continuous``: ``results.json`` written once, every sample once, equal to
   the one-process run's and to JAX's ``eval_task``'s;
4. ``fixed_text_buckets`` in one process: JAX's widths and steps.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

from msr3d_tpu.config import config_from_dict
from msr3d_tpu.data.build import DataLoader as JaxDataLoader
from msr3d_tpu.evaluator.msqa_eval import MSQAEval as JaxMSQAEval
from msr3d_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from msr3d_tpu.trainer.leo_trainer import LeoTrainer as JaxLeoTrainer
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.parallel import mesh

import torch_dp_worker as worker
from test_torch_train import SCENE_TOKENS, _data, _jax_model, _metrics, _trainer_cfg
from torch_parity_utils import one_torch_thread, torch_network_config

N_EVAL = 5  # odd: two ranks at batch 2 take 3 samples each, one a duplicate
ENGINE_OPTS = {"num_slots": 2, "refill_group": 1, "chunk_steps": 4}
ANSWERS = [("a chair", "yes", "the red lamp", "no"), ("two", "behind me", "yes", "a chair"),
           ("no", "the red lamp", "two", "yes")]


# ---------------------------------------------------------------------------
# 1. the mesh and the collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_data_parallel_size_resolves_as_jax(n, monkeypatch):
    # dp is what tp leaves of the ranks, as JAX's MeshConfig(dp=-1) resolves
    # it; a rank count tp does not divide raises as JAX's assert does
    monkeypatch.setattr(mesh, "world_size", lambda: n)
    assert mesh.data_parallel_size({}) == JaxMeshConfig(dp=-1).resolve(n)[0] == n
    assert mesh.data_parallel_size({"tp": 1, "pp": 1, "sp": 1}) == n
    for tp in (2, 4):
        if n % tp == 0:
            assert mesh.data_parallel_size({"tp": tp}) == JaxMeshConfig(
                dp=-1, tp=tp).resolve(n)[0] == n // tp
        else:
            with pytest.raises(AssertionError):
                JaxMeshConfig(dp=-1, tp=tp).resolve(n)
            with pytest.raises(ValueError, match="not divisible by tp"):
                mesh.data_parallel_size({"tp": tp})
    # pp and sp resolve as JAX's; pp and sp together raise, as JAX's pipeline
    # asserts
    if n % 2 == 0:
        assert mesh.data_parallel_size({"pp": 2}) == JaxMeshConfig(
            dp=-1, pp=2).resolve(n)[0] == n // 2
        assert mesh.data_parallel_size({"sp": 2}) == JaxMeshConfig(
            dp=-1, sp=2).resolve(n)[0] == n // 2
    if n % 4 == 0:
        with pytest.raises(NotImplementedError, match="pp × sp composition not supported"):
            mesh.data_parallel_size({"pp": 2, "sp": 2})


def test_backend_rule_and_env_contract(monkeypatch):
    # a card a rank: nccl; ranks sharing a card, or the CPU: gloo
    assert mesh.backend_for("cuda", 1, 1) == mesh.backend_for("cuda", 4, 4) == "nccl"
    assert mesh.backend_for("cuda", 2, 1) == mesh.backend_for("cuda", 1, 0) == "gloo"
    assert mesh.backend_for("cpu", 1, 8) == "gloo"
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert mesh.initialize_distributed_from_env("cpu") is False
    assert (mesh.world_size(), mesh.rank(), mesh.is_main_process()) == (1, 0, True)
    assert mesh.process_allgather_objects([1, "a"]) == [1, "a"]  # the identity
    assert mesh.all_reduce_max([3, -3]) == [3, -3]
    assert mesh.rank_device(torch.device("cpu")) == torch.device("cpu")


def test_two_ranks_gather_mean_and_replica_check(tmp_path):
    outs = worker.run_ranks({"kind": "collectives"}, tmp_path)
    for r, out in enumerate(outs):
        assert (out["rank"], out["world"], out["backend"]) == (r, 2, "gloo")
        # rank 0's objects first, payloads of different sizes
        assert [g["rank"] for g in out["gathered"]] == [0, 1]
        assert [len(g["items"]) for g in out["gathered"]] == [1, 2]
        assert out["mean"] == pytest.approx(1.5, abs=1e-6)
        assert out["max"] == [1, 0, 7]
        assert out["differing"] and "differ between ranks" in out["differing"]
    assert outs[0]["digest"] == outs[1]["digest"]


# ---------------------------------------------------------------------------
# 2-4. LeoTrainer over two ranks, one process and JAX
# ---------------------------------------------------------------------------


def _global_batches():
    """3 global batches of 4 rows (two tiny data dicts each)."""
    batches = []
    for i, answers in enumerate(ANSWERS):
        a, b = _data(10 + 2 * i, answers[:2]), _data(11 + 2 * i, answers[2:])
        batches.append({k: a[k] + b[k] if isinstance(a[k], list)
                        else np.concatenate([a[k], b[k]]) for k in a})
    return batches


def _eval_samples():
    """N_EVAL single samples; prompts of one length, so a batch's prompt
    width does not depend on which samples it holds."""
    samples = []
    for i in range(N_EVAL):
        data = _data(30 + i)
        row = {k: v[i % 2] for k, v in data.items() if isinstance(v, np.ndarray)}
        row.update(msr3d_prompt=f"You are in a scene: 景. What is object {i} on the table?",
                   prompt=f"What is object {i}?", answer_list="a chair[answer_seq]chair",
                   text_output="a chair", index=i, source="synthetic", scan_id=f"scene{i}")
        samples.append(row)
    return samples


def _cfg(exp_dir):
    return dict(_trainer_cfg(exp_dir, accum=2), fixed_text_buckets=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same job three ways: two port ranks, the port in one process,
    the JAX trainer in one process. Each evaluates first (the initial
    weights), then trains one epoch."""
    root = tmp_path_factory.mktemp("dp")
    jmodel = _jax_model(flash=False, window=True)
    job = dict(kind="train_eval", network_cfg=torch_network_config(jmodel.cfg),
               params=jax.tree_util.tree_map(np.array, jmodel.params),
               model_kw=dict(scene_token_len=SCENE_TOKENS, max_out_len=16,
                             repetition_penalty=1.5),
               cfg=_cfg(root / "unused"), batches=_global_batches(), global_rows=4,
               eval_samples=_eval_samples(), eval_batch=2, engine_opts=ENGINE_OPTS)
    ranks = worker.run_ranks(copy.deepcopy(job), root / "two")
    with one_torch_thread():
        one = worker.train_eval(copy.deepcopy(job), root / "one")

    jax_dir = root / "jax"
    jtrainer = JaxLeoTrainer(
        config_from_dict(_cfg(jax_dir / "exp")),
        loaders={"msr3d_train": {"train": worker.RowsLoader(_global_batches(), 0, 4)},
                 "msqa": {"test": JaxDataLoader(worker.SampleDataset(_eval_samples()),
                                                batch_size=2, collate_fn=worker.collate,
                                                prefetch=0)}},
        evaluators={"msqa": JaxMSQAEval(task_name="msqa", save_dir=jax_dir / "eval")},
        model=jmodel)
    jax_eval = {}
    for engine in ("blocking", "continuous"):
        if engine == "continuous":
            jtrainer.cfg.eval_engine, jtrainer.cfg.eval_engine_opts = "continuous", ENGINE_OPTS
        results = jtrainer.eval_task("msqa", "test")
        jax_eval[engine] = (results, json.loads((jax_dir / "eval" / "results.json").read_text()))
    jtrainer.train_one_epoch(0)
    return dict(root=root, ranks=ranks, one=one, jtrainer=jtrainer, jax_eval=jax_eval)


def _params(path):
    return {n: t.numpy() for n, t in torch.load(path).items()}


def _assert_params_close(got, want, lrs, rtol, atol, initial):
    for name in want:
        tol = atol
        if name.endswith("self_attn.w_ks.bias"):
            # the key bias's true gradient is 0: each side holds rounding
            # noise that Adam scales up to O(lr) (ROADMAP.md section 3); held
            # to the size of the two updates, as in tests/test_torch_train.py
            tol = max(atol, 2 * sum(lrs) * (1 + 0.05 * float(np.abs(initial[name]).max())))
        np.testing.assert_allclose(got[name], want[name], rtol=rtol, atol=tol, err_msg=name)


def test_two_ranks_train_like_one_process(runs):
    ranks, one, root = runs["ranks"], runs["one"], runs["root"]
    assert [r["dp"] for r in ranks] == [2, 2] and one["dp"] == 1
    assert all(r["fixed"] for r in ranks) and one["fixed"]
    assert [r["steps"] for r in ranks] == [2, 2] == [one["steps"]] * 2
    # the loss every rank reports is the global batch's
    assert ranks[0]["step_losses"] == ranks[1]["step_losses"]
    np.testing.assert_allclose(ranks[0]["step_losses"], one["step_losses"], rtol=1e-6)
    # the ranks' trainable parameters are bit-equal, and the one process's
    assert ranks[0]["digest"] == ranks[1]["digest"]
    two = _params(root / "two" / "params_rank0.pt")
    assert all(np.array_equal(two[n], v) for n, v in
               _params(root / "two" / "params_rank1.pt").items())
    initial = jax_to_torch_state_dict(_jax_model(flash=False, window=True).params)[0]
    lrs = [m["train/lr"] for m in _metrics(root / "one" / "exp")]
    _assert_params_close(two, _params(root / "one" / "params_rank0.pt"), lrs, rtol=1e-6,
                         atol=1e-6, initial={n: t.numpy() for n, t in initial.items()})
    # rank 0 alone wrote the metrics: one line a logged step
    assert [m["step"] for m in _metrics(root / "two" / "exp")] == [1, 2]


def test_two_ranks_train_like_jax(runs):
    ranks, root, jtrainer = runs["ranks"], runs["root"], runs["jtrainer"]
    want = _metrics(root / "jax" / "exp")
    assert [m["step"] for m in want] == [1, 2]
    np.testing.assert_allclose(ranks[0]["step_losses"], [m["train/loss"] for m in want],
                               rtol=1e-4)
    trained = {n: t.numpy() for n, t in jax_to_torch_state_dict(jtrainer.state.params)[0].items()}
    two = _params(root / "two" / "params_rank0.pt")
    assert set(two) <= set(trained)
    for name, value in two.items():
        # tests/test_multihost.py's tolerance for JAX's own two processes
        np.testing.assert_allclose(value, trained[name], rtol=1e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("engine", ["blocking", "continuous"])
def test_two_rank_eval_scores_each_sample_once_as_jax(runs, engine):
    ranks, root = runs["ranks"], runs["root"]
    assert [r["padded_tail"] for r in ranks] == [0, 1]
    two = json.loads((root / "two" / f"results_{engine}_rank0.json").read_text())
    # rank 0 alone wrote results.json; its records hold every rank's samples
    assert not (root / "two" / f"results_{engine}_rank1.json").exists()
    assert not (root / "two" / "eval_rank1").exists()
    assert sorted(r["index"] for r in two) == list(range(N_EVAL))
    one = json.loads((root / "one" / f"results_{engine}_rank0.json").read_text())
    want_results, want = runs["jax_eval"][engine]
    by_index = lambda records: sorted(records, key=lambda r: r["index"])  # noqa: E731
    assert [r["index"] for r in one] == [r["index"] for r in want] == list(range(N_EVAL))
    assert by_index(two) == one == want
    assert all(r["response_pred"] for r in two)
    for got in (ranks[0]["eval"][engine], ranks[1]["eval"][engine], runs["one"]["eval"][engine]):
        assert got.keys() == want_results.keys()
        for key, value in want_results.items():
            assert got[key] == pytest.approx(float(value), rel=1e-9, abs=1e-12), key


def test_one_rank_runs_no_collective(monkeypatch, tmp_path):
    """Without a process group the trainer trains, saves and evaluates
    without calling any collective, so its step is the single-process one."""
    import torch.distributed as dist
    from msr3d_tpu_torch.data.build import DataLoader
    from msr3d_tpu_torch.evaluator.msqa_eval import MSQAEval
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    from test_torch_train import _port_model

    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran at one rank")

    for name in ("all_reduce", "all_gather_object", "barrier", "new_group"):
        monkeypatch.setattr(dist, name, refuse)
    loader = DataLoader(worker.SampleDataset(_eval_samples()[:2]), batch_size=2,
                        collate_fn=worker.collate, prefetch=0)
    trainer = LeoTrainer(dict(_trainer_cfg(tmp_path), save_frequency=1),
                         loaders={"msr3d_train": {"train": worker.RowsLoader(
                             _global_batches()[:1], 0, 2)}, "msqa": {"val": loader}},
                         evaluators={"msqa": MSQAEval(task_name="msqa", save_dir=tmp_path)},
                         model=_port_model(_jax_model(flash=False, window=False)))
    assert (trainer.dp, trainer.fixed_text_buckets, trainer._train_step.data_parallel) == (
        1, False, 1)
    with one_torch_thread():
        trainer._run_train()
    assert trainer.step == 1 and (tmp_path / "results.json").exists()
    assert trainer.ckpt.latest_step() == 1 and trainer.ckpt.has_weights("latest")


def test_fixed_text_buckets_one_process_as_jax(runs, tmp_path):
    """``fixed_text_buckets`` in one process: the widths are JAX's
    (``prompt_pad_to`` and ``max_out_len`` rounded up to 32) whatever the
    batch, and the two steps JAX's."""
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    from test_torch_train import _port_model

    root, jtrainer = runs["root"], runs["jtrainer"]
    jmodel = _jax_model(flash=False, window=True)
    data = _data(5)
    port = LeoTrainer(_cfg(tmp_path), loaders={}, evaluators={}, model=_port_model(jmodel))
    jax_side = JaxLeoTrainer(config_from_dict(_cfg(tmp_path / "jax")), loaders={},
                             evaluators={}, model=jmodel)
    with one_torch_thread():
        (got,) = port._device_batch([data])
    want = jax_side._device_batch([data])
    assert got["input_ids"].shape[1] == want["input_ids"].shape[1] == 256
    assert got["output_ids"].shape[1] == want["output_ids"].shape[1] == 32
    for key in ("input_ids", "attention_mask", "output_ids", "output_mask"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    loose = LeoTrainer(dict(_cfg(tmp_path / "b"), fixed_text_buckets=False), loaders={},
                       evaluators={}, model=_port_model(jmodel))
    assert loose._device_batch([data])[0]["input_ids"].shape[1] < 256

    got = _metrics(root / "one" / "exp")
    want = _metrics(root / "jax" / "exp")
    for g, w in zip(got, want):
        for key in ("train/loss", "train/grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)
    initial = jax_to_torch_state_dict(jmodel.params)[0]
    trained = {n: t.numpy() for n, t in jax_to_torch_state_dict(jtrainer.state.params)[0].items()}
    one = _params(root / "one" / "params_rank0.pt")
    _assert_params_close(one, {n: trained[n] for n in one}, [m["train/lr"] for m in got],
                         rtol=0, atol=1e-6, initial={n: t.numpy() for n, t in initial.items()})
