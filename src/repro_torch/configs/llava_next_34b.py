"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling; the vision tower is a STUB (input_specs provides
precomputed patch embeddings, 1152 image positions = 2 anyres tiles x 576)
[hf:llava-hf/llava-v1.6-34b family; unverified]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    act="silu", rope_theta=5e6, input_kind="multimodal", frontend_tokens=1152,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=128,
                               vocab_size=256, frontend_tokens=8,
                               dtype="float32")
