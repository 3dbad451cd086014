"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
— 5:1 local:global interleave, 128k context, head_dim=256, qk-norm
[hf:google/gemma-3-4b-pt family; unverified]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560, n_heads=8,
    n_kv_heads=4, head_dim=256, d_ff=10240, vocab_size=262144, act="gelu",
    qk_norm=True, rope_theta=1e4, tie_embeddings=True, embed_scale=True,
    window_size=1024, pattern_local=5, pattern_global=1,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=8, d_model=64, n_heads=4,
                               n_kv_heads=2, head_dim=16, d_ff=128,
                               vocab_size=256, window_size=16,
                               pattern_local=3, pattern_global=1,
                               dtype="float32")
