"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) d_ff_expert=1408
vocab=102400, 64 routed top-6 + 2 shared experts, first layer dense
(d_ff=10944) — fine-grained expert segmentation  [arXiv:2401.06066; hf]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=102400,
    act="silu", rope_theta=1e4,
    moe=True, n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    first_dense_layers=1, d_ff_dense=10944,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=3, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, d_ff=64,
                               vocab_size=256, n_experts=8, top_k=2,
                               n_shared_experts=1, d_ff_expert=32,
                               first_dense_layers=1, d_ff_dense=128,
                               moe_group_size=64, dtype="float32")
