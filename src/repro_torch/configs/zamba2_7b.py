"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 blocks + ONE shared attention block applied every 6th
position (weight sharing is zamba2's signature)  [arXiv:2411.15242; unverified]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584, n_heads=32,
    n_kv_heads=32, d_ff=14336, vocab_size=32000, act="gelu",
    hybrid_attn_every=6, ssm_state=64, ssm_expand=2, ssm_headdim=64,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=7, d_model=64, n_heads=4,
                               n_kv_heads=4, d_ff=128, vocab_size=256,
                               hybrid_attn_every=3, ssm_state=16,
                               ssm_headdim=16, dtype="float32")
