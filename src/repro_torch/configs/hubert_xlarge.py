"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only (bidirectional), masked-prediction objective; the conv waveform
frontend is a STUB (input_specs provides precomputed frame embeddings)
[arXiv:2106.07447; unverified]"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, head_dim=80, d_ff=5120, vocab_size=504,
    act="gelu", causal=False, input_kind="embeddings", mask_ratio=0.08,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(CONFIG, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, d_ff=128,
                               vocab_size=64, dtype="float32")
