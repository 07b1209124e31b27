"""The port's evaluation against the JAX package's.

* Every evaluator (``MSQAEval``, ``GenerationEval``, ``SQA3DEval``,
  ``SQA3DInstructionEval``, ``ObjNavEval``, ``OneStepNavInstructionEval``)
  on the same records: the results of each ``record`` equal JAX's exactly
  (``==``) and the ``results.json`` it writes equals JAX's byte for byte;
  ``offline_msqa`` scores a saved ``results.json`` as JAX does.
* The SQA3D and MSNN datasets (``ScanNetSQA3D``, ``SQA3DScanNet``,
  ``ScanNetSQA3DInstruction``, ``MSR3DMSNN``, and ``MSR3DMix`` over each)
  give batches bit-equal to JAX's on the synthetic tree, train split
  (rotation on) and val split, with the global generators seeded alike.
* ``LeoTrainer.eval_task`` on ``configs/debug_synthetic.yaml``,
  ``debug_synthetic_sqa3d.yaml``, ``debug_synthetic_msnn.yaml`` and
  ``debug_synthetic_leo.yaml`` (the ``as_object`` prompter), each
  trainer built from the YAML by both packages and the port's model holding
  the JAX params: the beam-5 ``output_text`` equal string for string, the
  metrics equal. In fp32: in bf16 XLA's and PyTorch's CPU kernels round in
  other orders, and a random tiny model's beams part after a few tokens.
* Retrieval: ``MSR3D.predict_answers`` gives JAX's ``answers_id`` and its
  ``answer_scores`` within 1e-5 relative (fp32), alone and through
  ``eval_task`` with ``SQA3DEval``.
* ``mode: test`` through ``python -m msr3d_tpu_torch.run`` loads ``best``,
  trains nothing and logs the test metrics JAX logs from the same weights.
"""

import dataclasses
import json
import random
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msr3d_tpu.models.build as jax_build
from msr3d_tpu.config import load_config as jax_load_config
from msr3d_tpu.data.build import build_dataloader_leo as jax_build_dataloader_leo
from msr3d_tpu.data.scan_loader import ScanCache as JaxScanCache
from msr3d_tpu.evaluator import msqa_eval as jax_msqa_eval
from msr3d_tpu.evaluator import offline_msqa as jax_offline
from msr3d_tpu.evaluator import one_step_eval as jax_one_step_eval
from msr3d_tpu.evaluator import sqa3d_eval as jax_sqa3d_eval
from msr3d_tpu.data.datasets.sqa3d import SQA3DAnswerVocab as JaxSQA3DAnswerVocab
from msr3d_tpu.trainer.leo_trainer import LeoTrainer as JaxLeoTrainer
import msr3d_tpu_torch.models.build as port_build
from msr3d_tpu_torch import run as port_run
from msr3d_tpu_torch.config import load_config
from msr3d_tpu_torch.convert import jax_to_torch_state_dict
from msr3d_tpu_torch.data import synthetic
from msr3d_tpu_torch.data.build import build_dataloader_leo
from msr3d_tpu_torch.data.datasets.sqa3d import SQA3DAnswerVocab
from msr3d_tpu_torch.data.scan_loader import ScanCache
from msr3d_tpu_torch.evaluator import msqa_eval, offline_msqa, one_step_eval, sqa3d_eval
from msr3d_tpu_torch.models.msr3d import MSR3D
from msr3d_tpu_torch.trainer.checkpoint import CheckpointManager
from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

from torch_parity_utils import one_torch_thread, to_numpy_tree

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"
# fp32 on both sides: the losses of a tiny network summed in other orders
# differ by a few ulps (1e-7 relative); 1e-5 leaves room for its depth
SCORE_RTOL = 1e-5


def _seed_globals(seed: int = 0) -> None:
    random.seed(seed)
    np.random.seed(seed)


def _clear_scan_caches() -> None:
    JaxScanCache.clear()
    ScanCache.clear()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_tree")
    synthetic.build_full_tree(root, np.random.default_rng(7))
    return root


def _data_overrides(root: Path):
    return [f"data.scan_family_base={root}/scan_family", f"data.rscan_base={root}/rscan",
            f"data.ARkit_base={root}/arkit", f"data.msr3d_base={root}/msr3d",
            f"data.msnn_base={root}/msnn"]


# ---------------------------------------------------------------------------
# the evaluators on the same records
# ---------------------------------------------------------------------------

_ANSWERS = ["red", "the red one", "two", "2", "three", "left", "a chair", "no", "yes",
            "turn left", "the table near the window"]
_TYPES = ["counting", "existence", "attribute-color", "spatial relationship", "navigation",
          "refer", "description"]


def _msqa_records(rng, n: int, b: int):
    """``n`` batches of ``b`` MSQA-style records: answer lists joined by
    ``[answer_seq]``, predictions that match exactly, by containment, by
    number words, or not at all."""
    out = []
    for k in range(n):
        answers = [list(rng.choice(_ANSWERS, size=rng.integers(1, 3), replace=False))
                   for _ in range(b)]
        preds = []
        for a in answers:
            pick = rng.integers(4)
            preds.append([a[0], f"I think {a[0]}", "Three", str(rng.choice(_ANSWERS))][pick])
        out.append({
            "output_text": preds,
            "answer_list": ["[answer_seq]".join(a) for a in answers],
            "text_output": [a[0] for a in answers],
            "source": ["msqa_scannet"] * b,
            "scan_id": [f"scene{k:04d}_{i:02d}" for i in range(b)],
            "prompt": [f"USER: question {k}-{i}? ASSISTANT:" for i in range(b)],
            "index": np.arange(k * b, (k + 1) * b, dtype=np.int64),
            "type": [str(t) for t in rng.choice(_TYPES, size=b)],
        })
    return out


def _sqa3d_vocab_records(rng, n: int, b: int, a: int):
    out = []
    for _ in range(n):
        labels = np.zeros((b, a), np.int64)
        labels[np.arange(b), rng.integers(0, a, size=b)] = 1
        rec = {
            "answer_scores": rng.normal(size=(b, a)).astype(np.float32),
            "answers_id": rng.integers(0, a, size=b),
            "answer_label": labels,
            "sqa_type": rng.integers(0, 6, size=b).astype(np.int64),
            "obj_labels": rng.integers(0, 4, size=(b, 5)),
            "obj_masks": rng.random(size=(b, 5)) > 0.3,
            "obj_cls_raw_logits": rng.normal(size=(b, 5, 4)).astype(np.float32),
        }
        rec["obj_masks"][:, 0] = True
        out.append(rec)
    return out


def _sqa3d_instruction_records(rng, n: int, b: int, qa_pool):
    ids = sorted(qa_pool)
    out = []
    for _ in range(n):
        q = rng.choice(ids, size=b)
        preds = [qa_pool[int(i)]["answers"][0] if rng.random() < 0.5 else str(rng.choice(_ANSWERS))
                 for i in q]
        out.append({"output_text": preds, "data_idx": q.astype(np.int64),
                    "sqa_type": rng.integers(0, 6, size=b).astype(np.int64)})
    return out


def _navi_records(rng, n: int, b: int):
    tokens = ["给", "弘", "收", "왕", "黃", "还", "边", "べ"]
    out = []
    for _ in range(n):
        gts = list(rng.choice(tokens, size=b))
        preds = [g if rng.random() < 0.4 else str(rng.choice(tokens + ["hello", "go"]))
                 for g in gts]
        out.append({"output_text": preds, "text_output": gts})
    return out


def _qa_pool():
    return {100 + i: {"answers": [str(a)]} for i, a in enumerate(_ANSWERS)}


def _evaluator_cases(tree_root: Path):
    """name → (JAX evaluator factory, port evaluator factory, batches of
    two val rounds and a test round). A factory takes the save dir."""
    rng = np.random.default_rng(3)
    vocab_jax = JaxSQA3DAnswerVocab(_ANSWERS)
    vocab = SQA3DAnswerVocab(_ANSWERS)
    cfg = {"data": {"scan_family_base": str(tree_root / "scan_family")},
           "eval": {"save": True}}
    cases = {
        "MSQAEval": (jax_msqa_eval.MSQAEval, msqa_eval.MSQAEval, {},
                     [_msqa_records(rng, 3, 4) for _ in range(3)]),
        "GenerationEval": (jax_msqa_eval.GenerationEvalFull, msqa_eval.GenerationEvalFull, {},
                           [_msqa_records(rng, 2, 3) for _ in range(3)]),
        "SQA3DEval": (lambda cfg, **kw: jax_sqa3d_eval.SQA3DEval(cfg, answer_vocab=vocab_jax, **kw),
                      lambda cfg, **kw: sqa3d_eval.SQA3DEval(cfg, answer_vocab=vocab, **kw), {},
                      [_sqa3d_vocab_records(rng, 2, 5, len(_ANSWERS)) for _ in range(3)]),
        "SQA3DInstructionEval": (
            lambda cfg, **kw: jax_sqa3d_eval.SQA3DInstructionEval(cfg, qa_pool=_qa_pool(), **kw),
            lambda cfg, **kw: sqa3d_eval.SQA3DInstructionEval(cfg, qa_pool=_qa_pool(), **kw), {},
            [_sqa3d_instruction_records(rng, 2, 4, _qa_pool()) for _ in range(3)]),
        # the qa pool read from the tree's balanced annotations (question ids
        # 1000-1002, answer "chair")
        "SQA3DInstructionEval-tree": (
            jax_sqa3d_eval.SQA3DInstructionEval, sqa3d_eval.SQA3DInstructionEval, cfg,
            [_sqa3d_instruction_records(rng, 2, 3, {1000 + i: {"answers": ["chair"]}
                                                    for i in range(3)}) for _ in range(3)]),
        "ObjNavEval": (jax_one_step_eval.ObjNavEval, one_step_eval.ObjNavEval, {},
                       [_navi_records(rng, 2, 4) for _ in range(3)]),
        "OneStepNavInstructionEval": (jax_one_step_eval.OneStepNavInstructionEval,
                                      one_step_eval.OneStepNavInstructionEval, {},
                                      [_navi_records(rng, 2, 4) for _ in range(3)]),
    }
    return cases


def _drive(evaluator, rounds):
    """val, val, test over the rounds' batches → each record's output and
    the ``results.json`` bytes after it (None while none is written)."""
    out = []
    for split, batches in zip(("val", "val", "test"), rounds):
        evaluator.reset()
        for batch in batches:
            evaluator.update({k: (list(v) if isinstance(v, list) else v.copy())
                              for k, v in batch.items()})
        is_best, results = evaluator.record(split)
        path = evaluator.save_dir / "results.json"
        out.append((is_best, results, path.read_bytes() if path.exists() else None))
    return out


@pytest.mark.parametrize("name", ["MSQAEval", "GenerationEval", "SQA3DEval",
                                  "SQA3DInstructionEval", "SQA3DInstructionEval-tree",
                                  "ObjNavEval", "OneStepNavInstructionEval"])
def test_evaluator_equals_jax(name, tree, tmp_path):
    jax_cls, port_cls, cfg, rounds = _evaluator_cases(tree)[name]
    want = _drive(jax_cls(cfg or None, task_name=name, save_dir=tmp_path / "jax"), rounds)
    got = _drive(port_cls(cfg or None, task_name=name, save_dir=tmp_path / "port"), rounds)
    assert len(got) == 3
    # the navigation evaluators write no results.json, in either package
    assert any(w[2] is not None for w in want) == ("Nav" not in name)
    for (g_best, g_res, g_file), (w_best, w_res, w_file) in zip(got, want):
        assert g_best == w_best
        assert g_res == w_res
        assert list(g_res) == list(w_res)
        assert g_file == w_file


def test_generation_eval_registered_as_in_jax():
    from msr3d_tpu_torch.evaluator.build import build_eval_leo
    from msr3d_tpu_torch.evaluator.sentence_sim import HashingSentenceEncoder

    ev = build_eval_leo(None, "GenerationEval", "gen")
    assert type(ev) is msqa_eval.GenerationEvalFull
    assert type(ev.sentence_encoder) is HashingSentenceEncoder
    assert type(jax_msqa_eval.GenerationEvalFull(None).sentence_encoder).__name__ == \
        "HashingSentenceEncoder"


def test_offline_msqa_scores_like_jax(tmp_path):
    rng = np.random.default_rng(5)
    ev = msqa_eval.MSQAEval(None, task_name="msqa", save_dir=tmp_path / "scannet")
    for batch in _msqa_records(rng, 3, 4):
        ev.update(batch)
    ev.record("test")
    rscan = [{"response_pred": "turn right", "response_gt": ["turn right"], "type": "navigation",
              "instruction": "USER: Where to? ASSISTANT:"},
             {"response_pred": "sofa", "response_gt": ["couch"], "type": "refer",
              "instruction": "USER: What is it? ASSISTANT:"}]
    (tmp_path / "rscan.json").write_text(json.dumps(rscan))
    paths = {"scannet": tmp_path / "scannet" / "results.json", "rscan": tmp_path / "rscan.json"}
    assert offline_msqa.evaluate_results_files(paths) == jax_offline.evaluate_results_files(paths)

    def judge(messages):
        return f"Score: {len(messages[-1]['content']) % 5 + 1}"

    results = {k: json.loads(Path(p).read_text()) for k, p in paths.items()}
    got = offline_msqa.score_results(results, offline_msqa.make_gpt_scorer(judge, []))
    want = jax_offline.score_results(results, jax_offline.make_gpt_scorer(judge, []))
    assert got == want and "GPT-Score_overall" in got
    args = [f"{k}={p}" for k, p in paths.items()]
    offline_msqa.main(args + ["--out", str(tmp_path / "port.json")])
    jax_offline.main(args + ["--out", str(tmp_path / "jax.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


# ---------------------------------------------------------------------------
# SQA3D and MSNN batches
# ---------------------------------------------------------------------------

DATASET_CASES = {
    # name: (config, dataset, split)
    "ScanNetSQA3D-train": ("debug_synthetic_sqa3d.yaml", "ScanNetSQA3D", "train"),
    "ScanNetSQA3D-val": ("debug_synthetic_sqa3d.yaml", "ScanNetSQA3D", "val"),
    "SQA3DScanNet-train": ("debug_synthetic_sqa3d.yaml", "SQA3DScanNet", "train"),
    "SQA3DScanNet-val": ("debug_synthetic_sqa3d.yaml", "SQA3DScanNet", "val"),
    "ScanNetSQA3DInstruction-val": ("debug_synthetic_sqa3d.yaml", "ScanNetSQA3DInstruction",
                                    "val"),
    "MSR3DMSNN-train": ("debug_synthetic_msnn.yaml", "MSR3DMSNN", "train"),
    "MSR3DMSNN-val": ("debug_synthetic_msnn.yaml", "MSR3DMSNN", "val"),
    "MSR3DMix-sqa3d": ("debug_synthetic_sqa3d.yaml", "MSR3DMix", "train"),
    "MSR3DMix-msnn": ("debug_synthetic_msnn.yaml", "MSR3DMix", "train"),
}


def _assert_batches_equal(got, want) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
                assert np.array_equal(g[key], w[key]), key
            else:
                assert type(g[key]) is type(w[key]) and g[key] == w[key], key


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_sqa3d_and_msnn_batches_bit_equal_to_jax(case, tree):
    config, dataset, split = DATASET_CASES[case]
    ovs = _data_overrides(tree)
    _clear_scan_caches()

    def batches(load, build):
        cfg = load(CONFIGS / config, ovs)
        task = cfg.task.msr3d_train
        loader = build(cfg, dataset, task.dataset_wrapper, task.dataset_wrapper_args,
                       {"batchsize": 2}, split)
        _seed_globals(5)
        return [b for _ in range(2) for b in loader], loader

    want, _ = batches(jax_load_config, jax_build_dataloader_leo)
    got, loader = batches(load_config, build_dataloader_leo)
    _assert_batches_equal(got, want)
    if "SQA3D" in dataset:
        assert loader.dataset.dataset.answer_cands == ["chair", "one", "red", "two", "zero"]
    _clear_scan_caches()


# ---------------------------------------------------------------------------
# eval_task from the YAML, both packages
# ---------------------------------------------------------------------------


def _switch_to_fp32(mp) -> None:
    """The compute dtypes the YAML cannot set (the LLM's and the point
    encoder's), switched to fp32 the same way in both builders."""
    for module, dtype in ((jax_build, jnp.float32), (port_build, torch.float32)):
        llm = module.build_llm_config
        prompter = module.OSE3DConfig
        mp.setattr(module, "build_llm_config",
                   lambda c, t, _llm=llm, _d=dtype: _llm(c, t, dtype=_d))
        mp.setattr(module, "OSE3DConfig", SimpleNamespace(
            from_config=lambda c, _p=prompter: dataclasses.replace(
                _p.from_config(c), obj_encoder_dtype="float32")))


def _trainers(config: str, tree_root: Path, out: Path, fp32: bool):
    """The JAX trainer and the port's, each built from ``config`` with its
    own loaders and evaluators; the port's model holds the JAX params."""
    ovs = _data_overrides(tree_root)
    _clear_scan_caches()
    with pytest.MonkeyPatch.context() as mp:
        if fp32:
            _switch_to_fp32(mp)
        jcfg = jax_load_config(CONFIGS / config, ovs + ["model.llm.param_dtype=fp32"] * fp32
                               + [f"exp_dir={out / 'jax'}"])
        # the JAX trainer initialises from a batch it peeks; without
        # prefetch the peek leaves no thread drawing from the generators
        from msr3d_tpu.data.build import build_task_loaders as jax_build_task_loaders

        jloaders = jax_build_task_loaders(jcfg)
        jtrain = jloaders["msr3d_train"]["train"]
        jtrain.prefetch = 0
        jtrainer = JaxLeoTrainer(jcfg, loaders=jloaders)
        jtrain.prefetch = 2
        jparams = to_numpy_tree(jtrainer.model.params)
        mp.setattr(MSR3D, "init_params", lambda self, seed=None: self.load_jax_params(jparams))
        trainer = LeoTrainer(load_config(
            CONFIGS / config, ovs + ["device=cpu"] + ["model.llm.param_dtype=fp32"] * fp32
            + [f"exp_dir={out / 'port'}"]))
    return jtrainer, trainer, jparams


@pytest.fixture(scope="module")
def msqa(tree, tmp_path_factory):
    return _trainers("debug_synthetic.yaml", tree, tmp_path_factory.mktemp("msqa"), fp32=True)


@pytest.fixture(scope="module")
def leo(tree, tmp_path_factory):
    return _trainers("debug_synthetic_leo.yaml", tree, tmp_path_factory.mktemp("leo"),
                     fp32=True)


@pytest.fixture(scope="module")
def sqa3d(tree, tmp_path_factory):
    return _trainers("debug_synthetic_sqa3d.yaml", tree, tmp_path_factory.mktemp("sqa3d"),
                     fp32=True)


@pytest.fixture(scope="module")
def msnn(tree, tmp_path_factory):
    return _trainers("debug_synthetic_msnn.yaml", tree, tmp_path_factory.mktemp("msnn"),
                     fp32=True)


def _port_prompter_cfg(jtrainer):
    from torch_parity_utils import torch_prompter_config

    return torch_prompter_config(jtrainer.model.cfg.prompter)


def _eval(trainer, task: str, split: str):
    """``eval_task`` with the records the evaluator received."""
    evaluator = trainer.evaluators[task]
    seen = []

    def update(record):
        seen.append(record)
        type(evaluator).update(evaluator, record)

    evaluator.update = update
    try:
        _seed_globals(1)
        results = trainer.eval_task(task, split)
    finally:
        del evaluator.update
    return results, seen


@pytest.mark.parametrize("setup, task, split", [
    ("msqa", "msqa_scannet", "val"), ("msqa", "msqa_scannet", "test"),
    ("sqa3d", "sqa3d", "val"), ("msnn", "one_step_navi", "val"),
    ("leo", "msqa_scannet", "val"), ("leo", "msqa_scannet", "test"),
])
def test_eval_task_equals_jax(setup, task, split, request):
    jtrainer, trainer, _ = request.getfixturevalue(setup)
    if setup == "leo":  # the anchor is a scene token: N objects give N + 1
        assert trainer.model.network.visual_prompter.prepend_anchor
        assert trainer.model.cfg.prompter == _port_prompter_cfg(jtrainer)
    assert type(trainer.evaluators[task]).__name__ == type(jtrainer.evaluators[task]).__name__
    assert trainer.model.num_beams == jtrainer.model.num_beams == 5
    want, want_records = _eval(jtrainer, task, split)
    got, got_records = _eval(trainer, task, split)
    assert len(got_records) == len(want_records) == 1  # num_batch_eval: 1
    for g, w in zip(got_records, want_records):
        assert list(g) == list(w)
        assert g["output_text"] == w["output_text"]
        assert all(isinstance(t, str) for t in g["output_text"])
    assert got == want
    saved = [t.exp_dir / "eval" / task / "results.json" for t in (trainer, jtrainer)]
    if task == "one_step_navi":  # its evaluator saves nothing, in either package
        assert not saved[0].exists() and not saved[1].exists()
    else:
        assert saved[0].read_bytes() == saved[1].read_bytes()


def test_eval_task_trims_a_padded_tail_as_jax_does(msqa):
    """A loader whose last batch ends in wrap-around duplicates
    (``padded_tail``, a sharded loader's) has them dropped before the
    evaluator sees the batch, in both packages."""
    jtrainer, trainer, _ = msqa
    for t in (jtrainer, trainer):
        loader = t.loaders["msqa_scannet"]["val"]

        class Padded:
            padded_tail = 1

            def __len__(self, _loader=loader):
                return 1

            def __iter__(self, _loader=loader):
                return iter(_loader)

        t.loaders["padded"] = {"val": Padded()}
        t.evaluators["padded"] = t.evaluators["msqa_scannet"]
    try:
        want, want_records = _eval(jtrainer, "padded", "val")
        got, got_records = _eval(trainer, "padded", "val")
    finally:
        for t in (jtrainer, trainer):
            del t.loaders["padded"], t.evaluators["padded"]
    assert len(got_records[0]["output_text"]) == len(want_records[0]["output_text"]) == 1
    assert got_records[0]["output_text"] == want_records[0]["output_text"]
    assert len(got_records[0]["index"]) == 1 and got == want


@pytest.mark.parametrize("beams", [5, 1], ids=["beam5", "greedy"])
def test_eval_continuous_equals_jax(msqa, beams):
    """``eval_engine: continuous``: the val split through the slot-refill
    engines (beam with 5 beams, greedy with 1) with one slot, so that the
    second request refills it; the texts the evaluator receives and its
    results equal JAX's. The blocking route's texts do not depend on
    ``eval_pipeline_depth`` (0 against the default 3)."""
    jtrainer, trainer, _ = msqa
    opts = {"num_slots": 1, "refill_group": 1, "chunk_steps": 3}
    saved = jtrainer.model.num_beams
    try:
        for t in (jtrainer, trainer):
            t.model.num_beams = beams
        blocking = [_eval(trainer, "msqa_scannet", "val")[1][0]["output_text"]]
        trainer.cfg["eval_pipeline_depth"] = 0
        blocking.append(_eval(trainer, "msqa_scannet", "val")[1][0]["output_text"])
        jtrainer.cfg.eval_engine, jtrainer.cfg.eval_engine_opts = "continuous", opts
        trainer.cfg.update(eval_engine="continuous", eval_engine_opts=opts)
        want, want_records = _eval(jtrainer, "msqa_scannet", "val")
        got, got_records = _eval(trainer, "msqa_scannet", "val")
    finally:
        for t in (jtrainer, trainer):
            t.model.num_beams = saved
        jtrainer.cfg.eval_engine = ""
        for key in ("eval_engine", "eval_engine_opts", "eval_pipeline_depth"):
            trainer.cfg.pop(key, None)
    assert blocking[0] == blocking[1]
    assert len(got_records) == len(want_records) == 1
    assert len(got_records[0]["output_text"]) == 2
    assert got_records[0]["output_text"] == want_records[0]["output_text"]
    assert list(got_records[0]) == list(want_records[0]) and got == want


@pytest.mark.parametrize("beams", [5, 1], ids=["beam5", "greedy"])
def test_eval_prefix_pool_equals_jax(msqa, beams):
    """``eval_engine: continuous`` with ``eval_engine_opts.prefix_pool``: the
    val split through the prefix-pool engines (beam 5, or greedy), one slot
    so that the second request refills it, two blocks; the texts the
    evaluator receives and its results equal JAX's, and greedy's equal the
    blocking route's."""
    jtrainer, trainer, _ = msqa
    opts = {"prefix_pool": True, "num_slots": 1, "refill_group": 1, "chunk_steps": 3,
            "num_prefixes": 2, "suffix_len": 96}
    saved = jtrainer.model.num_beams
    try:
        for t in (jtrainer, trainer):
            t.model.num_beams = beams
        with one_torch_thread():
            if beams == 1:
                blocking = _eval(trainer, "msqa_scannet", "val")[1][0]["output_text"]
            jtrainer.cfg.eval_engine, jtrainer.cfg.eval_engine_opts = "continuous", dict(opts)
            trainer.cfg.update(eval_engine="continuous", eval_engine_opts=dict(opts))
            want, want_records = _eval(jtrainer, "msqa_scannet", "val")
            got, got_records = _eval(trainer, "msqa_scannet", "val")
    finally:
        for t in (jtrainer, trainer):
            t.model.num_beams = saved
        jtrainer.cfg.eval_engine = ""
        for key in ("eval_engine", "eval_engine_opts"):
            trainer.cfg.pop(key, None)
    assert len(got_records) == len(want_records) == 1
    assert len(got_records[0]["output_text"]) == 2
    assert got_records[0]["output_text"] == want_records[0]["output_text"]
    assert list(got_records[0]) == list(want_records[0]) and got == want
    if beams == 1:
        assert got_records[0]["output_text"] == blocking


def test_eval_grouped_equals_jax(msqa):
    """``eval_engine: grouped`` through the scene-grouped batcher with JAX's
    defaults (4 scenes x 8 questions, pipeline depth 3) and the config's
    beam 5: the texts the evaluator receives, in loader order, and its
    results equal JAX's."""
    jtrainer, trainer, _ = msqa
    try:
        jtrainer.cfg.eval_engine, jtrainer.cfg.eval_engine_opts = "grouped", {}
        trainer.cfg.update(eval_engine="grouped", eval_engine_opts={})
        want, want_records = _eval(jtrainer, "msqa_scannet", "val")
        got, got_records = _eval(trainer, "msqa_scannet", "val")
    finally:
        jtrainer.cfg.eval_engine = ""
        for key in ("eval_engine", "eval_engine_opts"):
            trainer.cfg.pop(key, None)
    assert trainer.model.num_beams == 5
    assert len(got_records) == len(want_records) == 1
    assert len(got_records[0]["output_text"]) == 2
    assert got_records[0]["output_text"] == want_records[0]["output_text"]
    assert list(got_records[0]) == list(want_records[0]) and got == want


def _sqa3d_labels(loader, vocab):
    """The loader's batches with ``answer_label`` (multi-hot over ``vocab``)
    added; ``dataset`` leads to the answer vocabulary as the loader's does."""

    class Labelled:
        dataset = loader

        def __len__(self):
            return len(loader)

        def __iter__(self):
            for batch in loader:
                label = np.zeros((len(batch["answer_list"]), len(vocab)), np.int64)
                for i, answers in enumerate(batch["answer_list"]):
                    for a in answers.split("[answer_seq]"):
                        label[i, vocab.index(a)] = 1
                yield dict(batch, answer_label=label)

    return Labelled()


def test_predict_answers_equals_jax(sqa3d):
    """Retrieval through ``eval_task`` (``SQA3DEval`` on both sides, the
    SQA3D val batch with its multi-hot ``answer_label``): ``answers_id``
    equal, ``answer_scores`` within ``SCORE_RTOL``, the metrics equal."""
    jtrainer, trainer, _ = sqa3d
    cands = trainer.loaders["sqa3d"]["val"].dataset.dataset.answer_cands
    for t, evaluator in ((jtrainer, jax_sqa3d_eval.SQA3DEval), (trainer, sqa3d_eval.SQA3DEval)):
        t.loaders["sqa3d_retrieval"] = {"val": _sqa3d_labels(t.loaders["sqa3d"]["val"], cands)}
        t.evaluators["sqa3d_retrieval"] = evaluator(None, "sqa3d_retrieval",
                                                    save_dir=t.exp_dir / "retrieval")
        t.inference_mode = "retrieval"
    try:
        want, want_records = _eval(jtrainer, "sqa3d_retrieval", "val")
        got, got_records = _eval(trainer, "sqa3d_retrieval", "val")
    finally:
        for t in (jtrainer, trainer):
            t.inference_mode = "generation"
            del t.loaders["sqa3d_retrieval"], t.evaluators["sqa3d_retrieval"]
    g, w = got_records[0], want_records[0]
    assert g["answer_scores"].shape == (len(g["answer_list"]), len(cands))
    np.testing.assert_array_equal(g["answers_id"], w["answers_id"])
    np.testing.assert_allclose(g["answer_scores"], np.asarray(w["answer_scores"]),
                               rtol=SCORE_RTOL)
    assert (g["answer_scores"] > -1e9).all()  # 5 candidates: every one scored
    assert got == want and np.isfinite([got["ans1_acc"], got["ans10_acc"]]).all()

    _seed_globals(1)
    batch = next(iter(trainer.loaders["sqa3d"]["val"]))
    out = trainer.model.predict_answers(dict(batch), cands)
    np.testing.assert_array_equal(out["answers_id"], g["answers_id"])
    assert out["answers"] == [cands[int(i)] for i in g["answers_id"]]


def test_mode_test_loads_best_and_logs_jax_metrics(msqa, tree, tmp_path, monkeypatch):
    """``mode=test`` through the entry (fp32): ``best`` (the JAX params with every
    LoRA B drawn nonzero) is loaded, no step is taken, and the test metrics
    equal those the JAX trainer's ``run()`` logs in mode test from the same
    ``best``."""
    import jax

    jtrainer, trainer, jparams = msqa
    rng = np.random.default_rng(9)

    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['lora_b']"):
            return rng.normal(scale=0.05, size=leaf.shape).astype(leaf.dtype)
        return leaf

    best_tree = jax.tree_util.tree_map_with_path(draw, jparams)
    best = jax_to_torch_state_dict(best_tree)[0]
    lora_b = [n for n in trainer.trainable_names if "lora_b" in n]
    assert lora_b and all(bool(best[n].any()) for n in lora_b)
    exp = tmp_path / "port"
    CheckpointManager(exp / "ckpt").save_weights(
        "best", {n: best[n] for n in trainer.trainable_names})
    monkeypatch.setattr(MSR3D, "init_params", lambda self, seed=None:
                        self.load_jax_params(jparams))
    _switch_to_fp32(monkeypatch)
    _seed_globals(1)
    _clear_scan_caches()
    tested = port_run.main(["--config", str(CONFIGS / "debug_synthetic.yaml"), "device=cpu",
                            *_data_overrides(tree), "model.llm.param_dtype=fp32", "mode=test",
                            f"exp_dir={exp}"])
    assert tested.step == 0 and not list((exp / "ckpt").glob("state/*"))
    params = dict(tested.model.network.named_parameters())
    assert all(torch.equal(params[n].detach(), best[n]) for n in lora_b)
    with open(exp / "metrics.jsonl") as fh:
        got = [json.loads(line) for line in fh]
    assert len(got) == 1 and got[0]["step"] == 0
    assert sorted(got[0]) == sorted(["step", "ts"] + [f"test/msqa_scannet/{k}" for k in (
        "target_metric", "ans1_acc_llm", "cider", "bleu", "meteor", "rouge")])

    # JAX: the same weights saved as its `best`, then its run() in mode test
    original, state = jtrainer.model.params, jtrainer.state
    try:
        jtrainer.state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, best_tree))
        jtrainer._save_learnable("best")
        jtrainer.ckpt.wait()
        jtrainer.state = state
        jtrainer.mode = "test"
        _seed_globals(1)
        _clear_scan_caches()
        jtrainer.run()  # closes its metric log: the last use of this trainer
        loaded = jax_to_torch_state_dict(to_numpy_tree(jtrainer.model.params))[0]
        assert all(torch.equal(loaded[n], best[n]) for n in lora_b)  # JAX loaded best
    finally:
        jtrainer.model.params, jtrainer.state, jtrainer.mode = original, state, "train"
    with open(jtrainer.exp_dir / "metrics.jsonl") as fh:
        want = json.loads(fh.readlines()[-1])
    assert {k: v for k, v in got[0].items() if k != "ts"} == \
        {k: v for k, v in want.items() if k != "ts"}
    _clear_scan_caches()


def test_sqa3d_eval_config_evaluates_without_a_train_task(tree, tmp_path):
    """``configs/sqa3d_eval.yaml`` (``mode: eval``, no train task) through
    the entry, at the debug sizes: no train loader and no optimizer, the
    test split of its SQA3D task evaluated, ``results.json`` written."""
    _clear_scan_caches()
    exp = tmp_path / "eval"
    trainer = port_run.main([
        "--config", str(CONFIGS / "sqa3d_eval.yaml"), "device=cpu", *_data_overrides(tree),
        f"exp_dir={exp}", "debug.flag=true", "solver.num_batch_eval=1",
        "model.vision_2d.args.backbone_name=convnext_test",
        "dataset_wrapper.args.msr3d_max_img_num=2",
        "data.process_args.img_process_args.tgt_img_size=[32,32]",
        "data.sqa3d.args.num_points=64", "model.llm.max_out_len=4"])
    assert trainer.mode == "eval" and trainer.train_loader is None
    assert trainer.optimizer is None and trainer.step == 0
    assert list(trainer.loaders) == ["sqa3d"] and list(trainer.loaders["sqa3d"]) == ["val", "test"]
    with open(exp / "metrics.jsonl") as fh:
        logged = [json.loads(line) for line in fh]
    assert len(logged) == 1 and "test/sqa3d/target_metric" in logged[0]
    assert not any(k.startswith("val/") for k in logged[0])
    records = json.loads((exp / "eval" / "sqa3d" / "results.json").read_text())
    assert sorted(r["question_id"] for r in records) == [1000, 1001, 1002]  # one batch
    _clear_scan_caches()
