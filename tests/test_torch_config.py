"""The port's config loader and tokenizers against the JAX package's.

* ``msr3d_tpu_torch.config`` parses the YAML subset of ``configs/*.yaml``
  by itself (the GPU host has no PyYAML); every shipped config, with and
  without overrides, loads to the tree JAX's PyYAML-based ``load_config``
  gives (``cfg2dict``, exact), and a saved config loads back alike in both.
* ``SPTokenizer`` on the miniature BPE model of ``tests/test_sentencepiece.py``
  gives JAX's ids, decodes and special ids exactly, and ``build_tokenizer``
  resolves each path layout to the same backend.
"""

import glob
import math
from pathlib import Path

import numpy as np
import pytest

from msr3d_tpu import config as jax_config
from msr3d_tpu.models.llm import tokenizer as jax_tokenizer
from msr3d_tpu.models.llm.sentencepiece import serialize_model_proto
from msr3d_tpu_torch import config as port_config
from msr3d_tpu_torch.models.llm import tokenizer as port_tokenizer
from msr3d_tpu_torch.models.llm.sentencepiece import (
    SentencePieceModel,
    serialize_model_proto as port_serialize_model_proto,
)

from test_sentencepiece import _mini_bpe_pieces

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(Path(p).name for p in glob.glob(str(REPO / "configs" / "*.yaml")))

# a float without a dot, a flow list, an empty list, an interpolation, a new
# nested key, a quoted string, null, a YAML 1.1 boolean and a flow mapping
OVERRIDES = [
    "solver.optim.args.lr=3e-5",
    "solver.optim.args.betas=[0.8, 0.99]",
    "task.msr3d_train.mode=[]",
    "dataset_wrapper.args.max_obj_len=${solver.epochs}",
    "new.nested.key=yes",
    "note='a quoted: note'",
    "data.obj_img_base=",
    "parallel={sp: 1, tp: 1}",
]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("overrides", [False, True], ids=["plain", "overrides"])
@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_matches_jax(name, overrides):
    path = REPO / "configs" / name
    ovs = OVERRIDES if overrides else None
    want = jax_config.cfg2dict(jax_config.load_config(path, ovs))
    got = port_config.cfg2dict(port_config.load_config(path, ovs))
    assert got == want
    if overrides:
        assert got["solver"]["optim"]["args"]["lr"] == 3e-5
        assert got["task"]["msr3d_train"]["mode"] == []
        assert got["dataset_wrapper"]["args"]["max_obj_len"] == got["solver"]["epochs"]


@pytest.mark.parametrize("text", [
    "3", "3e-5", "1e5", "-1.5", ".5", "1.", "0x1F", "010", "0b101", "+7", "1_000", "null",
    "~", "", "yes", "No", "on", "True", "abc", "a b c", "[]", "[1, 2, [3, 4]]",
    "['a, b', \"c\"]", "{a: 1, b: [2]}", "{}", ".inf", "-.inf", ".nan", "'quoted'",
    '"dq\\n\\tx\\u00e9"', "a: b", "foo #comment", "'it''s'", "-foo", "1.0e+16",
    "http://a.b/c", "a:b", "key=val", "图", "[a b, c]",
])
def test_override_values_parse_as_in_jax(text):
    assert _same(port_config._parse_scalar(text), jax_config._parse_scalar(text))


@pytest.mark.parametrize("name", ["msr3d.yaml", "debug_synthetic.yaml"])
def test_saved_config_loads_back_alike_in_both(name, tmp_path):
    """The port's snapshot reads back to the resolved tree in both loaders,
    and so does the JAX package's (block lists, ``3.0e-05``, ``''``)."""
    path = REPO / "configs" / name
    cfg = port_config.load_config(path, OVERRIDES)
    want = port_config.cfg2dict(cfg)
    port_config.save_config(cfg, tmp_path / "port.yaml")
    assert port_config.cfg2dict(port_config.load_config(tmp_path / "port.yaml")) == want
    assert jax_config.cfg2dict(jax_config.load_config(tmp_path / "port.yaml")) == want
    jax_config.save_config(jax_config.load_config(path, OVERRIDES), tmp_path / "jax.yaml")
    assert port_config.cfg2dict(port_config.load_config(tmp_path / "jax.yaml")) == want


def test_strings_and_floats_round_trip(tmp_path):
    data = {
        "s": ["", " lead", "yes", "010", "3e-5", "a: b", "#x", "it's", "图 物", "a\nb", "-foo",
              "${x}", "null", "- item"],
        "f": [3e-5, 1e16, -0.0, 0.1, float("inf"), 1.5e-300],
        "nested": [{"a": 1, "b": [1, [2]]}, [], {}, None, True],
        7: "an int key",
    }
    (tmp_path / "c.yaml").write_text(port_config.yaml_dump(data))
    assert port_config.yaml_load((tmp_path / "c.yaml").read_text()) == data
    assert jax_config.yaml_load(open(tmp_path / "c.yaml")) == data


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: 1\nc: *alias\n", 2),
    ("a: !!str 1\n", 1),
    ("a: 1\nb: |\n  block\n", 2),
    ("---\na: 1\n", 1),
    ("a: 1\nwhen: 2001-12-14\n", 2),
    ("a:\n  b: 1\n c: 2\n", 3),
    ("a: [1, 2\n", 1),
])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(port_config.YamlSubsetError, match=f"line {line}:"):
        port_config.yaml_load(text)


def test_interpolation_is_lazy_and_typed():
    cfg = port_config.config_from_dict(
        {"a": {"b": 3, "path": "${c}/x"}, "c": "root", "d": "${a.b}", "e": ["${a.b}"]})
    assert cfg.d == 3 and cfg.a.path == "root/x" and cfg.e == [3]
    cfg.c = "other"
    assert cfg.a.path == "other/x"
    with pytest.raises(KeyError):
        port_config.config_from_dict({"a": "${missing}"}).a


# ---------------------------------------------------------------------------
# the SentencePiece tokenizer
# ---------------------------------------------------------------------------

PROMPTS = [
    "the cat on the cat.",
    "景景景 USER: What is on 图 and 图? ASSISTANT:",
    "the 物 sat, then the 景.",
    "thé 🤖 café",
    "",
    "  leading and trailing  ",
    "图",
    "ths onon es.",
]


@pytest.fixture(scope="module")
def sp_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("sp") / "tokenizer.model"
    path.write_bytes(serialize_model_proto(_mini_bpe_pieces()))
    return path


def test_serialize_model_proto_is_jax_s():
    assert port_serialize_model_proto(_mini_bpe_pieces()) == serialize_model_proto(
        _mini_bpe_pieces())


def test_sp_tokenizer_matches_jax(sp_model):
    want = jax_tokenizer.SPTokenizer(str(sp_model))
    got = port_tokenizer.SPTokenizer(str(sp_model))
    for key in ("pad_id", "bos_id", "eos_id", "unk_id", "img_token_id", "obj_token_id",
                "scene_token_id", "vocab_size"):
        assert getattr(got, key) == getattr(want, key), key
    for text in PROMPTS:
        ids = got._encode_one(text)
        assert ids == want._encode_one(text), text
        for skip in (True, False):
            assert got.decode(ids, skip) == want.decode(ids, skip)
            with_specials = [got.bos_id] + ids + [got.eos_id, got.pad_id]
            assert got.decode(with_specials, skip) == want.decode(with_specials, skip)
    for kw in (dict(padding_side="left"), dict(padding_side="right", add_eos=True),
               dict(max_length=5, truncation_side="left"), dict(pad_to=64)):
        a, b = got.encode_batch(PROMPTS, **kw), want.encode_batch(PROMPTS, **kw)
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
        np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
        assert got.decode_batch(a.input_ids) == want.decode_batch(b.input_ids)


def test_sp_tokenizer_needs_the_placeholders(tmp_path):
    pieces = [p for p in _mini_bpe_pieces() if p[0] not in ("图", "物", "景")]
    path = tmp_path / "tokenizer.model"
    path.write_bytes(serialize_model_proto(pieces))
    for module in (jax_tokenizer, port_tokenizer):
        with pytest.raises(ValueError, match="placeholder"):
            module.SPTokenizer(str(path))
    assert SentencePieceModel.load(path).pieces == [p for p, _, _ in pieces]


def _layouts(root: Path, sp_model: Path):
    blob = sp_model.read_bytes()
    (root / "sp_dir").mkdir()
    (root / "sp_dir" / "tokenizer.model").write_bytes(blob)
    (root / "fast_dir").mkdir()
    (root / "fast_dir" / "tokenizer.model").write_bytes(blob)
    (root / "fast_dir" / "tokenizer.json").write_text("{}")
    (root / "empty_dir").mkdir()
    (root / "file.model").write_bytes(blob)
    return {"": "ByteTokenizer", "sp_dir": "SPTokenizer", "file.model": "SPTokenizer",
            "fast_dir": "HFTokenizer", "empty_dir": "HFTokenizer"}


def test_build_tokenizer_resolves_as_jax(sp_model, tmp_path, monkeypatch):
    """The same backend for each layout; where JAX picks its HF fast
    tokenizer (which needs ``transformers``) the port raises."""

    class JaxHF:
        def __init__(self, path, truncation_side="right"):
            self.path = path

    monkeypatch.setattr(jax_tokenizer, "HFTokenizer", JaxHF)
    for rel, backend in _layouts(tmp_path, sp_model).items():
        path = str(tmp_path / rel) if rel else ""
        want = jax_tokenizer.build_tokenizer(path)
        assert (type(want).__name__ if not isinstance(want, JaxHF) else "HFTokenizer") == backend
        if backend == "HFTokenizer":
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                port_tokenizer.build_tokenizer(path)
        else:
            assert type(port_tokenizer.build_tokenizer(path)).__name__ == backend
