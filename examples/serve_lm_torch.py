"""Batched serving example on the PyTorch port: prefill a prompt batch,
decode new tokens (the reduced preset of the arch).

    PYTHONPATH=src python examples/serve_lm_torch.py --batch 4 --gen 32
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
from types import SimpleNamespace

from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    serve(SimpleNamespace(arch=args.arch, batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen, seed=0,
                          device=args.device))


if __name__ == "__main__":
    main()
