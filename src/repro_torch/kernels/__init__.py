"""Hand-written CUDA kernels for Hopper, one module each, beside their plain
PyTorch versions.  The device of the tensors picks the route: CUDA tensors
launch the kernel, CPU tensors take the plain version.

Each wrapper counts its kernel launches in a module-level ``launches``
integer, so a run can show that its main path went through the kernels.
"""
from . import conv2d3x3, fused_enhance

KERNELS = {"conv2d3x3": conv2d3x3, "fused_enhance": fused_enhance}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
