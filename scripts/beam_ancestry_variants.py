"""Two ways to read the generated KV of a beam step through the ancestry
map, held against the reordered cache at the flagship width on one GPU.

    python3 scripts/beam_ancestry_variants.py [--new-tokens 32]

The flagship of ``chip_smoke.py`` (Vicuna-7B geometry, bf16, random weights
from seed 0, LoRA rank 0) runs beam-5 ``MSR3D.generate`` with repetition
penalty 3.0 on phase 8's four requests, with a bf16 KV cache and then,
after ``quantize_llm``, with int8 weights and the int8 KV cache, three ways:

* ``reorder``: the generated cache's rows are reordered after each re-rank;
* ``gather``: the port's ``decode_step_beam_anc``: rows never move, and each
  layer gathers every query's history into a row before attending;
* ``pairs``: the JAX package's formulation (``llama.py:592-647`` there):
  each query attends over all K rows' slots of its request as one (K·S_g)
  pair segment, with a bias that admits the (row, slot) pairs on its path.

For each it prints the tokens' agreement with ``reorder`` and, decode step
by decode step, the relative L2 and max |Δ| of its logits against those of
``reorder``. Nothing here is used by the port.
"""

import argparse
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
import msr3d_tpu_torch.models.llm.llama as llama  # noqa: E402


def pairs_decode_shared(self, x, positions, attn_bias, prompt, gen, gen_index, num_beams):
    """The JAX pair-segment attention: the generated segment of the K rows
    of a request read as one (K·S_g) segment shared by its K queries."""
    q, k, v = self._qkv(x, positions)
    llama._cache_write(gen, k, v, gen_index)
    gen = {key: val.reshape((val.shape[0] // num_beams, -1) + val.shape[2:])
           for key, val in gen.items()}
    segments = (prompt, gen)
    weights = torch.softmax(
        torch.cat([self._seg_scores(q, seg) for seg in segments], dim=-1) + attn_bias, dim=-1)
    out, start = 0, 0
    for seg in segments:
        width = seg["k"].shape[1]
        out = out + self._seg_out(weights[..., start:start + width], seg)
        start += width
    return self._out(out)


def pairs_step(self, inputs_embeds, positions, prompt_kv, prompt_mask, gen_kv, gen_index,
               gen_mask, anc, num_beams):
    """``LlamaModel.decode_step_beam_anc`` as the JAX package computes it."""
    bk, s_g = gen_mask.shape
    rows = torch.arange(num_beams, device=anc.device)[None, :, None]
    visible = gen_mask.bool()[:, None, :] & (anc[:, None, :] == rows)
    bias = self._attn_bias(inputs_embeds, prompt_kv, prompt_mask, gen_mask)
    bias = torch.cat([bias[..., :-s_g],
                      llama._bias(visible.reshape(bk, num_beams * s_g))[:, None, None, :]],
                     dim=-1)
    x = inputs_embeds.to(self.cfg.dtype)
    for i, block in enumerate(self.layer):
        h = pairs_decode_shared(block.attn, block.input_norm(x), positions, bias,
                                {key: val[i] for key, val in prompt_kv.items()},
                                {key: val[i] for key, val in gen_kv.items()}, gen_index,
                                num_beams)
        x = block._mlp_residual(x + h)
    return self.logits(self.final_norm(x))


def run(model, data, way):
    """Beam tokens and each decode step's logits of one way."""
    net = model.network
    model.beam_ancestry = way != "reorder"
    logits = []
    patches = {}
    for name in ("decode_step_shared", "decode_step_beam_anc"):
        fn = getattr(net, name)
        if way == "pairs" and name == "decode_step_beam_anc":
            def fn(token_ids, *args):
                return pairs_step(net.llm, net.llm.embed(token_ids), *args)

        def recorded(*args, _fn=fn, **kw):
            out = _fn(*args, **kw)
            logits.append(out[:, -1].float())
            return out
        patches[name] = recorded
    with mock.patch.multiple(net, **patches):
        tokens = model.generate(dict(data), use_beam=True)["output_tokens"]
    return tokens, logits


def compare(model, data, label):
    ref_tokens, ref_logits = run(model, data, "reorder")
    for way in ("gather", "pairs"):
        tokens, logits = run(model, data, way)
        rows = [bool(np.array_equal(a, b)) for a, b in zip(tokens, ref_tokens)]
        print(f"{label}, {way} against reorder: rows with equal tokens {rows}")
        for step, (a, b) in enumerate(zip(logits, ref_logits), start=1):
            if a.shape != b.shape:
                break
            rel = ((a - b).norm() / b.norm()).item()
            print(f"  decode step {step}: relative L2 {rel:.3e}, max |Δ| "
                  f"{(a - b).abs().max().item():.3e}, max |logit| {b.abs().max().item():.3e}")
            if rel > 0.1:  # the beams have parted
                break


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--new-tokens", type=int, default=cs.NEW_TOKENS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("beam_ancestry_variants: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    model = cs.build_flagship_model(torch.device("cuda", 0), lora_rank=0,
                                    what="the flagship, LoRA rank 0, bf16 from seed 0")
    model.num_beams, model.max_out_len = cs.BEAMS, args.new_tokens
    data = cs.make_requests(seed=0)
    with torch.no_grad():
        compare(model, data, "bf16 KV")
        model.quantize_llm(bits=8, kv_quantize=True)
        compare(model, data, "int8 weights, int8 KV")
    return 0


if __name__ == "__main__":
    sys.exit(main())
