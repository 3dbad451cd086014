"""Batched serving driver: prefill a prompt batch, then decode tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Serving architecture: a fixed-capacity KV cache allocated once per batch
(``max_len = prompt + gen``), prefill fills it with teacher-forced decode
steps, then greedy decoding runs one token a sequence a step.  Steps run
eagerly under ``torch.inference_mode()``; the caches are written in place.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .. import configs
from .. import device as device_lib
from ..data.tokens import TokenStream
from ..models import model as M


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prefill_into_cache(model, params, tokens, max_len):
    """Teacher-forced prefill: run decode_step over the prompt positions.

    (The forward keeps no per-layer caches; sequential prefill is exact and
    shares the decode step — production would use a chunked prefill.)
    Returns the last position's logits, the cache and the prompt length.
    """
    b, plen = tokens.shape
    cache = model.init_cache(b, max_len)
    step = M.make_decode_step(model)
    logits = None
    for pos in range(plen):
        logits, cache = step(params, cache, tokens[:, pos:pos + 1], pos)
    return logits, cache, plen


def greedy_decode(model, params, cache, logits, pos: int, gen: int):
    """``gen`` greedy tokens: the first from ``logits``, then ``gen - 1``
    decode steps from position ``pos``.  Tokens stay on the device (no
    host sync a step).  Returns int32 tokens [B, gen] and the last
    logits."""
    step = M.make_decode_step(model)
    toks = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [toks]
    for i in range(gen - 1):
        logits, cache = step(params, cache, toks, pos + i)
        toks = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(toks)
    return torch.cat(out, dim=1), logits


def serve(args) -> dict:
    cfg = configs.get_reduced(args.arch)
    if cfg.family == "audio":
        raise SystemExit("encoder-only arch has no decode loop")
    dev = device_lib.resolve(getattr(args, "device", None))
    model = M.build_model(cfg, model_axis=1)
    params = M.init_params(model, seed=args.seed, device=dev)

    stream = TokenStream(cfg.vocab_size, args.batch, args.prompt_len,
                         seed=args.seed)
    prompts = torch.from_numpy(stream.next_batch()).to(dev)
    max_len = args.prompt_len + args.gen

    with torch.inference_mode():
        t0 = time.time()
        logits, cache, pos = prefill_into_cache(model, params, prompts, max_len)
        _sync(dev)
        prefill_s = time.time() - t0

        t1 = time.time()
        gen, _ = greedy_decode(model, params, cache, logits, pos, args.gen)
        gen = gen.cpu().numpy()
        decode_s = time.time() - t1

    report = {
        "arch": args.arch, "batch": args.batch,
        "prompt_len": args.prompt_len, "generated": int(gen.shape[1]),
        "prefill_s": round(prefill_s, 3),
        "decode_s": round(decode_s, 3),
        "decode_tok_per_s": round(args.batch * (args.gen - 1) / max(decode_s, 1e-9), 1),
        "sample_tokens": gen[0, :10].tolist(),
        "device": str(dev),
    }
    print(json.dumps(report, indent=1))
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    serve(args)


if __name__ == "__main__":
    main()
