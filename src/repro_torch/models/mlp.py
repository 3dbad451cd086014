"""Gated MLP (SwiGLU / GeGLU)."""
from __future__ import annotations

from ..distributed.sharding import constrain, gather_fsdp
from .layers import activation, dense_init


def init(gen, d_model: int, d_ff: int, dtype, device, lead: tuple = ()):
    return {
        "w_gate_in": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
        "w_up_in": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
        "w_down_out": dense_init(gen, d_ff, d_model, dtype, device, lead=lead),
    }


def forward(p, x, act: str = "silu"):
    g = activation(act)(x @ gather_fsdp(p["w_gate_in"]))
    h = g * (x @ gather_fsdp(p["w_up_in"]))
    h = constrain(h, ("batch", None, "model"))
    return h @ gather_fsdp(p["w_down_out"])
