"""Device selection and the process-wide determinism settings of the port.

Entry points run on ``cuda`` unless the caller passes another device; a
missing GPU is an error, never a silent CPU run.  Strict mode stores the
encoder's outlier mask, so decode must reproduce encode's enhancement bit
for bit: on CUDA the port turns TF32 off, asks for deterministic
algorithms and a fixed cuBLAS workspace.
"""
from __future__ import annotations

import os

import torch
import torch.utils.deterministic


def set_deterministic() -> None:
    """TF32 off, deterministic algorithms, fixed cuBLAS workspace.

    ``CUBLAS_WORKSPACE_CONFIG`` takes effect only if set before cuBLAS first
    starts in the process.  Uninitialized-memory filling is turned off: every
    kernel of the port writes all of its outputs, and the fill would double
    the traffic of each allocation.
    """
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def resolve(device=None) -> torch.device:
    """The device to run on: ``cuda`` by default.  CUDA devices get the
    determinism settings; a missing GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain PyTorch path")
        set_deterministic()
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    return dev
