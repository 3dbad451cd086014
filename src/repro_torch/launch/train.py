"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --preset reduced --steps 50 --batch 8 --seq 128 \\
        --ckpt-dir run1 --ckpt-every 20 [--device cpu]

The JAX package's driver (``repro/launch/train.py``), run eagerly in
PyTorch on ``cuda`` unless ``--device cpu`` is given:
  * resume from the latest checkpoint on restart (the same data order
    through the checkpointable token stream),
  * atomic checkpoints with retention, optional NeurLZ-compressed weights
    (``--lossy-ckpt-eb``),
  * a straggler watchdog whose overrun asks for an early checkpoint,
  * deterministic failure injection (``--fail-at-step``) for restart drills.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from .. import configs
from .. import device as device_lib
from ..checkpoint.checkpoint import CheckpointManager
from ..checkpoint.fault_tolerance import FailureInjector, StepWatchdog
from ..data.tokens import TokenStream
from ..models import model as M
from ..optim import warmup_cosine


def build(args):
    cfg = (configs.get_reduced(args.arch) if args.preset == "reduced"
           else configs.get_config(args.arch))
    model = M.build_model(cfg, model_axis=1)
    return cfg, model


def train(args) -> dict:
    dev = device_lib.resolve(getattr(args, "device", None))
    cfg, model = build(args)
    params, opt_state = M.init_train_state(model, seed=args.seed, device=dev)
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep=args.keep,
                             lossy_weights_eb=args.lossy_ckpt_eb, device=dev)
    start_step = 0
    latest = ckpt.latest_step()
    if args.resume and latest is not None:
        params, opt_state, meta = ckpt.restore(latest, params, opt_state)
        params = model.load_params(params)
        stream.restore(meta["extra"]["stream"])
        start_step = latest
        print(f"[train] resumed from step {latest}")

    lr_fn = warmup_cosine(args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    step_fn = M.make_train_step(model, lr_fn=lr_fn, microbatch=args.microbatch)
    injector = FailureInjector(args.fail_at_step)
    want_early_ckpt = []
    watchdog = StepWatchdog(args.step_deadline,
                            on_straggler=lambda i: want_early_ckpt.append(i))

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        # The stream advances on every step, as the JAX package's does, so a
        # checkpoint's stream position is the same whichever family it holds.
        batch = {"tokens": torch.from_numpy(stream.next_batch()).to(dev)}
        if cfg.family == "audio":
            batch = M.demo_batch(cfg, args.batch, args.seq, seed=step, device=dev)
        elif cfg.family == "vlm":
            batch = M.demo_batch(cfg, args.batch, args.seq + cfg.frontend_tokens,
                                 seed=step, device=dev)
        with watchdog.step(step):
            params, opt_state, metrics = step_fn(params, opt_state, batch, step)
            loss = float(metrics["loss"])     # the step's end, on the host
        losses.append(loss)
        injector.maybe_fail(step)
        if args.log_every and step % args.log_every == 0:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        if ((step + 1) % args.ckpt_every == 0 or step + 1 == args.steps
                or want_early_ckpt):
            want_early_ckpt.clear()
            ckpt.save(step + 1, params, opt_state,
                      extra={"stream": stream.checkpoint(), "loss": loss})
    wall = time.time() - t0
    report = {
        "arch": args.arch, "steps": args.steps,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": wall,
        "watchdog": watchdog.stats(),
        "resumed_from": start_step,
        "device": str(dev),
    }
    print(json.dumps(report, indent=1))
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.ARCHS)
    ap.add_argument("--preset", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--lossy-ckpt-eb", type=float, default=None)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--step-deadline", type=float, default=120.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    train(args)


if __name__ == "__main__":
    main()
