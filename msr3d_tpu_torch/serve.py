"""The serve entry: an MSR3D model over HTTP.

    # on the GPU, learnable weights from a training run of the port:
    python -m msr3d_tpu_torch.serve --config configs/msr3d.yaml --port 8080 \
        --slots 32 --learnable <exp_dir>/ckpt [key=value overrides...]

    # the tiny synthetic config, random weights, on the CPU:
    python -m msr3d_tpu_torch.serve --device cpu \
        --config configs/debug_synthetic.yaml --random-init

Counterpart of the JAX package's root ``serve.py``, with its flags: the
config (the port's YAML reader, ``msr3d_tpu_torch/config.py``) builds the
model (``models/build.py``) on ``--device`` (default ``cuda``); weights come
from a seed, then from the checkpoints the config names
(``load_pretrained_from_config``) unless ``--random-init``, then from
``--learnable``: the port's own ``best``/``latest`` learnable weights, as
``trainer/checkpoint.py`` saves them (not an orbax directory). The engine
(``--engine continuous``, the default, with ``--spec-k`` drafts a verify
window; ``beam``; ``grouped``, the scene-grouped batcher of
``--group-scenes`` scenes x ``--group-questions`` questions; or ``pool`` and
``pool-beam``, slot refill over a pool of ``--num-prefixes`` scene-prefix KV
blocks of ``--prefix-len`` tokens with question windows of ``--suffix-len``,
``pool`` with ``--spec-k`` too) runs behind the stdlib HTTP front end
(``serving_http.py``). SIGINT or SIGTERM drains every accepted request,
then exits 0.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True, help="YAML config (reference schema)")
    p.add_argument("opts", nargs="*", help="dotlist config overrides (key=value)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda; cpu for tests)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="0 = ephemeral")
    p.add_argument("--slots", type=int, default=32, help="continuous-batching decode slots")
    p.add_argument("--refill-group", type=int, default=4,
                   help="requests per prefill (refill group)")
    p.add_argument("--chunk-steps", type=int, default=8, help="decode steps per chunk")
    p.add_argument("--lookahead", type=int, default=1,
                   help="decode chunks run before a chunk's flags are read")
    p.add_argument("--engine", choices=["continuous", "beam", "grouped", "pool", "pool-beam"],
                   default="continuous",
                   help="greedy slot-refill engine, per-slot beam search, the "
                   "scene-grouped batcher, or the prefix-pool engines (slot refill over "
                   "shared scene-prefix KV blocks), greedy or beam")
    p.add_argument("--num-prefixes", type=int, default=8,
                   help="pool engines: prefix KV blocks (G)")
    p.add_argument("--prefix-len", type=int, default=None,
                   help="pool engines: prefix bucket (default: model prompt_pad_to)")
    p.add_argument("--suffix-len", type=int, default=48,
                   help="pool engines: question bucket incl. trailing bos")
    p.add_argument("--group-scenes", type=int, default=4,
                   help="grouped engine: scene groups per batch")
    p.add_argument("--group-questions", type=int, default=8,
                   help="grouped engine: questions per scene group")
    p.add_argument("--max-new-tokens", type=int, default=None,
                   help="engine-wide decode budget (default: model max_out_len)")
    p.add_argument("--prompt-len", type=int, default=None,
                   help="prompt width, trailing bos included (default: model prompt_pad_to)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="continuous and pool engines: n-gram speculative drafts per verify "
                   "window")
    p.add_argument("--learnable", default=None,
                   help="checkpoint directory of a training run of the port (its ckpt/); "
                   "loads the learnable weights 'best', else 'latest', or --learnable-name")
    p.add_argument("--learnable-name", default=None)
    p.add_argument("--random-init", action="store_true",
                   help="seed weights only, no checkpoint the config names")
    p.add_argument("--num-obj", type=int, default=None,
                   help="accepted as in serve.py; the port's init needs no sample batch")
    p.add_argument("--num-points", type=int, default=None,
                   help="accepted as in serve.py; the port's init needs no sample batch")
    p.add_argument("--request-timeout", type=float, default=600.0)
    return p.parse_args(argv)


def create_frontend(args, cfg=None):
    """Build the model, the engine and the HTTP front end (not started)."""
    from msr3d_tpu_torch.config import load_config
    from msr3d_tpu_torch.models.build import build_model
    from msr3d_tpu_torch.serving import (
        ContinuousBatchingServer,
        ContinuousBeamBatchingServer,
        PrefixPoolContinuousBatchingServer,
        PrefixPoolContinuousBeamBatchingServer,
        SceneGroupBatchingServer,
    )
    from msr3d_tpu_torch.serving_http import ServingFrontend

    if cfg is None:
        cfg = load_config(args.config, overrides=list(args.opts))
    model = build_model(cfg, device=args.device)
    print(f"[serve] init params on {model.device} ...", flush=True)
    model.init_params()
    if not args.random_init:
        from msr3d_tpu_torch.models.load_weights import load_pretrained_from_config

        for src in load_pretrained_from_config(model, cfg):
            print(f"[serve] loaded {src}", flush=True)
    if args.learnable:
        from msr3d_tpu_torch.trainer.checkpoint import CheckpointManager
        from msr3d_tpu_torch.trainer.train_state import merge_learnable

        ckpt = CheckpointManager(args.learnable)
        names = [args.learnable_name] if args.learnable_name else ["best", "latest"]
        for name in names:
            if ckpt.has_weights(name):
                merge_learnable(model.network, ckpt.load_weights(name))
                print(f"[serve] loaded learnable weights '{name}' from {args.learnable}",
                      flush=True)
                break
        else:
            raise FileNotFoundError(f"no weights {names} under {args.learnable}")

    if args.engine == "grouped":
        engine = SceneGroupBatchingServer(model, scenes_per_batch=args.group_scenes,
                                          questions_per_scene=args.group_questions,
                                          max_new_tokens=args.max_new_tokens)
    else:
        kw = dict(num_slots=args.slots, refill_group=min(args.refill_group, args.slots),
                  chunk_steps=args.chunk_steps, lookahead=args.lookahead,
                  max_new_tokens=args.max_new_tokens)
        if args.engine == "pool":
            engine = PrefixPoolContinuousBatchingServer(
                model, num_prefixes=args.num_prefixes, prefix_len=args.prefix_len,
                suffix_len=args.suffix_len, spec_k=args.spec_k, **kw)
        elif args.engine == "pool-beam":
            engine = PrefixPoolContinuousBeamBatchingServer(
                model, num_prefixes=args.num_prefixes, prefix_len=args.prefix_len,
                suffix_len=args.suffix_len, **kw)
        elif args.engine == "continuous":
            engine = ContinuousBatchingServer(model, spec_k=args.spec_k,
                                              prompt_len=args.prompt_len, **kw)
        else:
            engine = ContinuousBeamBatchingServer(model, prompt_len=args.prompt_len, **kw)
    return ServingFrontend(engine, host=args.host, port=args.port,
                           request_timeout=args.request_timeout)


def main(argv=None) -> int:
    args = parse_args(argv)
    frontend = create_frontend(args)
    frontend.start()
    print(f"[serve] listening on http://{frontend.host}:{frontend.port} "
          f"(engine={args.engine}, slots={args.slots})", flush=True)

    stop = threading.Event()

    def _signal(signum, frame):
        print(f"[serve] signal {signum}: draining and shutting down", flush=True)
        stop.set()

    signal.signal(signal.SIGINT, _signal)
    signal.signal(signal.SIGTERM, _signal)
    stop.wait()
    pending = frontend.stream.pending
    if pending:
        print(f"[serve] draining {pending} queued requests ...", flush=True)
    frontend.close(timeout=None)  # every accepted request gets an answer
    print("[serve] drained, bye", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
