"""Train the reduced qwen3-family model on the PyTorch port: checkpoints
(optionally NeurLZ-compressed through the Lorenzo kernels), resume, the
straggler watchdog, and a failure drill under ``run_with_restarts``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --lossy-ckpt
    PYTHONPATH=src python examples/train_lm_torch.py --fail-at-step 30 --device cpu
"""
import argparse
import os
import tempfile
from types import SimpleNamespace

from repro_torch.checkpoint import run_with_restarts
from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_lm_run"))
    ap.add_argument("--lossy-ckpt", action="store_true",
                    help="NeurLZ error-bounded checkpoint weights (eb=1e-5)")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="fail once at this step; the run resumes from its "
                         "latest checkpoint")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    attempts = []

    def run():
        attempts.append(1)
        return train(SimpleNamespace(
            arch=args.arch, preset="reduced", steps=args.steps, batch=args.batch,
            seq=args.seq, lr=3e-3, seed=0, microbatch=1,
            ckpt_dir=args.ckpt_dir, ckpt_every=25, keep=3, resume=True,
            lossy_ckpt_eb=1e-5 if args.lossy_ckpt else None,
            fail_at_step=args.fail_at_step if len(attempts) == 1 else None,
            step_deadline=300.0, log_every=20, device=args.device))
    run_with_restarts(run)


if __name__ == "__main__":
    main()
