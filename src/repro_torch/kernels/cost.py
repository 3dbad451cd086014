"""The work a kernel call does, told to whoever counts it.

A hand-written kernel runs outside PyTorch's dispatcher (a ``ctypes``
launch), so an operation counter (``launch.op_cost``) cannot see it.  Each
wrapper therefore calls :func:`report` with the kernel's operations and
the bytes of its bound (each input read once, each output written once)
where it launches the kernel, and where it takes its shape-only branch.

A shape-only call is one on a ``FakeTensor`` or on the meta device, of
whatever device it claims: the wrapper computes nothing and returns empty
outputs of the kernel's shapes and dtypes (:func:`shape_only`).  It is a
shape function for a dry run, not a fallback: a real CUDA tensor still
launches the kernel or raises, a real CPU tensor still takes the plain
version (whose own operations the counter sees).
"""
from __future__ import annotations

import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

_sinks: list = []
_lock = threading.Lock()


def shape_only(*ts) -> bool:
    """Whether a call on these tensors is a dry run's: any of them a
    ``FakeTensor`` or on the meta device."""
    return any(isinstance(t, FakeTensor) or t.device.type == "meta"
               for t in ts if isinstance(t, torch.Tensor))


def add_sink(sink) -> None:
    """``sink(name, flops, nbytes, dtype)`` hears every report until
    removed."""
    with _lock:
        _sinks.append(sink)


def remove_sink(sink) -> None:
    with _lock:
        _sinks.remove(sink)


def listening() -> bool:
    """Whether any sink hears reports (a wrapper skips reckoning its cost
    when none does)."""
    return bool(_sinks)


def report(name: str, flops: float, nbytes: float, dtype: torch.dtype) -> None:
    """A call of kernel ``name``: ``flops`` product operations on operands
    of ``dtype``, ``nbytes`` of its bound."""
    for sink in list(_sinks):
        sink(name, flops, nbytes, dtype)


def nbytes(*ts) -> int:
    """Bytes of the given tensors (``None`` skipped), each once."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)
