"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — mLSTM blocks
with an sLSTM every 6th position (paper-style interleave)  [arXiv:2405.04517;
unverified]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab_size=50304, act="gelu",
    xlstm_slstm_every=6, xlstm_proj_factor=4.0 / 3.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=6, d_model=64, n_heads=2,
                               n_kv_heads=2, vocab_size=256,
                               xlstm_slstm_every=3, dtype="float32")
