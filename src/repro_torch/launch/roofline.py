"""Roofline terms of one step on the H100, from the dry run's counts.

The port of the JAX package's ``repro/launch/roofline.py``.  Three terms
per (arch × shape × mesh), in seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS        (bf16 dense),
                 its float32 products at PEAK_FLOPS_F32
    memory     = bytes_per_device / HBM_BW            (HBM bandwidth)
    collective = Σ wire_bytes of each collective / its group's link

The constants are the H100 SXM5 80GB (700 W) data sheet's and the DGX
H100's layout, not measurements: a group whose ranks all sit in one node
of ``NODE_SIZE`` consecutive ranks runs over NVLink (``NVLINK_BW`` a
direction), a group that spans nodes over the network (``NET_BW``, one
400 Gb/s NIC a GPU).  The production mesh's 16-wide ``model`` axis spans
two nodes, so its collectives take the network's rate.

The JAX package parses XLA's HLO text for collectives
(``collective_bytes(hlo_text)``); the port has no HLO, and
:func:`collective_bytes` summarises the collectives that
``launch.op_cost`` counted under the same keys.  Wire bytes use the ring
algorithm's factors (:func:`wire_factor`):

    all-gather        result × (n−1)/n
    reduce-scatter    result × (n−1)          (operand = result × n)
    all-reduce        result × 2(n−1)/n
    all-to-all        result × (n−1)/n
    collective-permute result × 1

``model_flops`` (6·N_active·D for training, 2·N_active·D for inference)
over the counted FLOPs is the "useful-compute" ratio: it exposes remat
and dispatch waste.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12      # bf16 dense, tensor cores / GPU
PEAK_FLOPS_F32 = 67e12   # float32 outside the tensor cores (TF32 off) / GPU
HBM_BW = 3.35e12         # bytes/s / GPU
HBM_BYTES = 80e9         # bytes / GPU
NVLINK_BW = 450e9        # bytes/s a direction / GPU, inside a node
NET_BW = 50e9            # bytes/s / GPU across nodes (one 400 Gb/s NIC)
NODE_SIZE = 8            # GPUs a node, consecutive ranks


def wire_factor(kind: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind == "all-to-all":
        return (n - 1) / n
    return 1.0  # collective-permute


def link_of(ranks) -> str:
    """``"nvlink"`` for a group inside one node of NODE_SIZE consecutive
    ranks, else ``"net"``."""
    return "nvlink" if len({r // NODE_SIZE for r in ranks}) <= 1 else "net"


def collective_bytes(collectives) -> dict:
    """Per-device collective traffic from ``op_cost``'s records (each a
    dict with ``kind``, ``result_bytes``, ``wire_bytes`` and ``link``),
    under the JAX package's keys, plus the wire bytes by link."""
    per_kind: dict[str, float] = {}
    raw_result_bytes: dict[str, int] = {}
    count: dict[str, int] = {}
    by_link: dict[str, float] = {}
    for c in collectives:
        kind = c["kind"]
        per_kind[kind] = per_kind.get(kind, 0.0) + c["wire_bytes"]
        raw_result_bytes[kind] = raw_result_bytes.get(kind, 0) + c["result_bytes"]
        count[kind] = count.get(kind, 0) + 1
        by_link[c["link"]] = by_link.get(c["link"], 0.0) + c["wire_bytes"]
    return {"wire_bytes": sum(per_kind.values()), "per_kind_wire": per_kind,
            "per_kind_result_bytes": raw_result_bytes, "per_kind_count": count,
            "wire_by_link": by_link}


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   wire_bytes_per_device: float, *,
                   nvlink_wire_bytes: float = 0.0,
                   f32_flops: float = 0.0) -> dict:
    """The three terms; ``f32_flops`` of the FLOPs are float32 products
    (PEAK_FLOPS_F32), the rest run at PEAK_FLOPS; ``nvlink_wire_bytes`` of
    the wire bytes ran inside a node (NVLINK_BW), the rest across nodes
    (NET_BW)."""
    compute = ((flops_per_device - f32_flops) / PEAK_FLOPS
               + f32_flops / PEAK_FLOPS_F32)
    memory = bytes_per_device / HBM_BW
    coll = ((wire_bytes_per_device - nvlink_wire_bytes) / NET_BW
            + nvlink_wire_bytes / NVLINK_BW)
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", coll), key=lambda kv: kv[1])[0]
    bound = max(compute, memory, coll)
    return {
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "dominant": dominant,
        # fraction of roofline-limited time spent on useful compute
        "compute_fraction_of_bound": compute / bound if bound else 0.0,
    }


def model_flops(cfg, shape, n_chips: int) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference), per chip."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence per step
        total = 2.0 * n_active * shape.global_batch
    return total / n_chips
