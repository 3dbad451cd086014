"""Model configuration schema covering all 10 assigned architectures.

The port's copy of the JAX package's schema, field for field; only
``params_dtype`` differs: it is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | hybrid | ssm | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d)
    causal: bool = True              # False for encoder-only (hubert)

    # sliding-window / local:global interleave (gemma3)
    window_size: Optional[int] = None
    pattern_local: int = 0           # e.g. 5 local then 1 global per unit
    pattern_global: int = 0

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    d_ff_dense: int = 0              # d_ff of the dense first layers
    moe_group_size: int = 2048       # GShard routing group (tokens)
    capacity_factor: float = 1.25

    # hybrid (zamba2): mamba2 blocks + one SHARED attention block every unit
    hybrid_attn_every: int = 0       # 0 = no hybrid; else unit = (k-1) mamba + 1 attn
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4

    # xLSTM: pattern of mLSTM with an sLSTM every unit
    xlstm_slstm_every: int = 0
    xlstm_proj_factor: float = 2.0

    # modality stubs
    input_kind: str = "tokens"       # tokens | embeddings (audio) | multimodal (vlm)
    frontend_tokens: int = 0         # vlm: image-patch positions per sample
    mask_ratio: float = 0.0          # audio: masked-prediction ratio

    # perf toggles (§Perf hillclimbing)
    attn_skip_uncausal: bool = False   # enumerate only causal chunk pairs
    sp_residual: bool = False          # sequence-parallel residual stream
                                       # (Korthikanti SP: AR -> AG+RS halves
                                       # TP collective traffic)
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def params_dtype(self):
        import torch
        return getattr(torch, self.dtype)

    def n_params_estimate(self) -> int:
        """Rough dense-equivalent parameter count (reported in docs)."""
        d, l = self.d_model, self.n_layers
        attn = l * (d * self.hd * (self.n_heads + 2 * self.n_kv_heads) +
                    self.n_heads * self.hd * d)
        if self.moe:
            ff_per = 3 * d * self.d_ff_expert
            ff = l * (self.n_experts + self.n_shared_experts) * ff_per
        else:
            ff = l * 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return attn + ff + emb

    def n_active_params(self) -> int:
        """Active (per-token) parameter count — MODEL_FLOPS uses this.

        For zamba2 the shared attention block executes once per unit (its
        weights are reused), and the remaining layers are Mamba2 blocks; for
        xLSTM the cells replace attention+FFN entirely."""
        d, l = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid":
            units = l // max(self.hybrid_attn_every, 1)
            attn_block = (d * self.hd * (self.n_heads + 2 * self.n_kv_heads)
                          + self.n_heads * self.hd * d + 3 * d * self.d_ff)
            di = self.ssm_expand * d
            nh = di // max(self.ssm_headdim, 1)
            mamba_block = (d * (2 * di + 2 * self.ssm_state + nh) + di * d)
            return units * attn_block + (l - units) * mamba_block + emb
        if self.family == "ssm":
            units = l // max(self.xlstm_slstm_every, 1)
            du = 2 * d
            mlstm = d * 2 * du + 3 * du * du + du * 2 * self.n_heads + du * d
            dff = int(self.xlstm_proj_factor * d)
            slstm = d * 4 * d + 3 * d * dff
            return (l - units) * mlstm + units * slstm + emb
        if not self.moe:
            return self.n_params_estimate()
        d, l = self.d_model, self.n_layers
        attn = l * (d * self.hd * (self.n_heads + 2 * self.n_kv_heads) +
                    self.n_heads * self.hd * d)
        ff = l * (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff_expert
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return attn + ff + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
