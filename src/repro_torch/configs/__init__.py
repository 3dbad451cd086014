"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from . import (deepseek_moe_16b, gemma3_4b, gemma_2b, granite_moe_3b_a800m,
               hubert_xlarge, llava_next_34b, qwen3_4b, qwen3_8b, xlstm_350m,
               zamba2_7b)
from .base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "qwen3-4b": qwen3_4b,
    "gemma3-4b": gemma3_4b,
    "gemma-2b": gemma_2b,
    "qwen3-8b": qwen3_8b,
    "zamba2-7b": zamba2_7b,
    "xlstm-350m": xlstm_350m,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "deepseek-moe-16b": deepseek_moe_16b,
    "hubert-xlarge": hubert_xlarge,
    "llava-next-34b": llava_next_34b,
}

ARCHS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _MODULES[name].reduced()


def cells():
    """All (arch, shape) dry-run cells with skip rules (the JAX package's
    dry-run grid)."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if cfg.family == "audio" and shape in ("decode_32k", "long_500k"):
                continue  # encoder-only: no autoregressive step
            if shape == "long_500k" and cfg.family not in ("hybrid", "ssm"):
                continue  # needs sub-quadratic attention
            out.append((arch, shape))
    return out
