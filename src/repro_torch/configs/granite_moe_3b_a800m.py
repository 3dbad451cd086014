"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff_expert=512
vocab=49155, MoE 40 experts top-8  [hf:ibm-granite/granite-3.0-3b-a800m-base;
hf]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512, vocab_size=49155,
    act="silu", rope_theta=1e4, tie_embeddings=True,
    moe=True, n_experts=40, top_k=8, d_ff_expert=512,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=64,
                               vocab_size=256, n_experts=8, top_k=2,
                               d_ff_expert=64, moe_group_size=64,
                               dtype="float32")
