"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
— GeGLU, head_dim=256, tied embeddings scaled by sqrt(d)  [arXiv:2403.08295; hf]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048, n_heads=8,
    n_kv_heads=1, head_dim=256, d_ff=16384, vocab_size=256000, act="gelu",
    rope_theta=1e4, tie_embeddings=True, embed_scale=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=1, head_dim=16, d_ff=192,
                               vocab_size=256, dtype="float32")
