"""Cost of the int4 dequant over groups at tp = 1, on one GPU, for the port
found under ``--root``.

    python3 scripts/int4_group_cost.py [--root DIR] [--label NAME] [--repeats N]

With ``chip_smoke.py``'s helpers (this checkout's) and the package under
``--root`` (default: this checkout) it builds the flagship (Vicuna-7B
geometry, random weights from seed 0) and measures:

- phase 8 (c) of ``chip_smoke.py``: the LLM quantized to int4 with group
  128 and an int8 KV cache, greedy ``MSR3D.generate`` of 4 requests (32 new
  tokens), ``--repeats`` times after a warm-up: generate ms, prefill ms,
  decode ms a token (generate less prefill, over the decode steps) and the
  peak allocated GiB of each generate;
- a QLoRA micro-batch, as phase 17 (c) takes its peaks: one forward and
  backward of a batch of 4 (through ``_QuantizedBase``) over an int4 base
  per channel (phase 17 (c)'s) and one with group 128, ``--repeats`` times
  after a warm-up: ms and peak allocated GiB of each.

Prints the card's name and power limit, then one JSON line. To compare two
checkouts, run it on each on one card in one session, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load_smoke():
    """``chip_smoke.py`` of this checkout, whatever ``--root`` holds."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serving(cs, torch, dev, repeats: int) -> dict:
    model = cs.build_flagship_model(dev, what="the flagship of phase 8 (c)")
    model.quantize_llm(bits=4, group=128, kv_quantize=True)
    data = cs.make_requests(seed=0, b=4)
    model.generate(dict(data), use_beam=False)  # warm-up
    rows = []
    for _ in range(repeats):
        torch.cuda.reset_peak_memory_stats()
        gen_ms = cs.wall_ms(lambda: data.update(model.generate(dict(data), use_beam=False)))
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, st = cs.generate_stages(model, data, gen_ms, data["output_tokens"], dev)
        rows.append(dict(gen_ms=gen_ms, prefill_ms=st["prefill_ms"], decode_ms=st["decode_ms"],
                         steps=st["steps"], peak_gib=peak))
    tokens = data["output_tokens"].tolist()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=rows, tokens=tokens)


def qlora(cs, torch, dev, group, repeats: int) -> dict:
    from msr3d_tpu_torch.models.llm.llama import LlamaConfig
    from msr3d_tpu_torch.models.llm.tokenizer import ByteTokenizer
    from msr3d_tpu_torch.models.msr3d import MSR3D, MSR3DNetworkConfig
    from msr3d_tpu_torch.models.ose3d_situation import OSE3DConfig
    from msr3d_tpu_torch.trainer.leo_trainer import LeoTrainer

    llm = LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
        num_attention_heads=32, lora_rank=16, dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, flash_attention=True, quantize=True, quantize_bits=4,
        quantize_group=group)
    cfg = MSR3DNetworkConfig(prompter=OSE3DConfig(), llm=llm, answer_window_loss=True)
    model = MSR3D(cfg, ByteTokenizer(), scene_token_len=60, max_out_len=cs.NEW_TOKENS,
                  repetition_penalty=cs.REP_PENALTY, device=dev)
    model.init_params(seed=0)
    loader = cs.make_train_batches(1)
    trainer = LeoTrainer(cs.trainer_cfg(Path(cs.__file__).parent / "build" / "int4_group_cost",
                                        accum=1, lr=3e-5, warmup=400),
                         loaders={"t": {"train": loader}}, model=model)
    batch = trainer._device_batch(loader)[0]
    net = model.network  # eval mode, as phase 17 (c) takes its peaks: no dropout draws
    rows = []
    for i in range(repeats + 1):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = net(**batch)["loss"].mean()
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if i:  # the first is the warm-up
            rows.append(dict(ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             loss=float(loss)))
        for p in net.parameters():
            p.grad = None
    del model, trainer, net
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE), help="the checkout whose package is measured")
    ap.add_argument("--label", default="", help="a name for the checkout in the JSON line")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("int4_group_cost.py needs a CUDA device", file=sys.stderr)
        return 1
    cs = load_smoke()
    import msr3d_tpu_torch

    package = Path(msr3d_tpu_torch.__file__).resolve().parent
    if package.parent != root:
        print(f"msr3d_tpu_torch came from {package}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    out = dict(label=args.label, root=str(root),
               serving_int4_g128=serving(cs, torch, dev, args.repeats),
               qlora_int4=qlora(cs, torch, dev, None, args.repeats),
               qlora_int4_g128=qlora(cs, torch, dev, 128, args.repeats))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
