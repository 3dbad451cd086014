"""Hand-written CUDA kernels for Hopper, beside their plain PyTorch versions.
The device of the tensors picks the route: CUDA tensors launch the kernel,
CPU tensors take the plain version.

Each wrapper counts the calls that launched its kernel in a module-level
integer, under one lock (``_build.COUNT_LOCK``: kernels launch from a
server's dispatcher thread too), so a run can show that its path went
through the kernels.
Each wrapper also tells an operation counter its work
(``kernels.cost``), and on fake or meta tensors takes a shape-only branch.
``KERNELS`` maps each kernel to its module and the name of its counter
there (``conv2d3x3`` holds the forward and the backward, single-field
and grouped, ``lorenzo3d`` the encode and the decode).
"""
from . import _build, conv2d3x3, fused_enhance, lorenzo3d

KERNELS = {"conv2d3x3": (conv2d3x3, "launches"),
           "conv2d3x3_bwd": (conv2d3x3, "bwd_launches"),
           "conv2d3x3_grouped": (conv2d3x3, "grouped_launches"),
           "conv2d3x3_grouped_bwd": (conv2d3x3, "grouped_bwd_launches"),
           "fused_enhance": (fused_enhance, "launches"),
           "lorenzo3d_fwd": (lorenzo3d, "fwd_launches"),
           "lorenzo3d_inv": (lorenzo3d, "inv_launches")}


def launch_counts() -> dict[str, int]:
    with _build.COUNT_LOCK:
        return {name: getattr(mod, attr)
                for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    with _build.COUNT_LOCK:
        for mod, attr in KERNELS.values():
            setattr(mod, attr, 0)
