"""Meshes: the production mesh's shape, and the host mesh a process runs on.

The port of the JAX package's ``repro/launch/mesh.py``.  A function each,
never a module-level constant: importing this module touches no device
and no process group.

``make_production_mesh`` gives the 256- or 512-device TPU mesh's *shape*
only (``.shape`` maps axis names to sizes): the sharding rules read
nothing else, and those ranks do not exist here.  ``make_host_mesh`` gives
a real 1×1 ``DeviceMesh`` with the axes ``("data", "model")`` over the
current process group.  The device picks the backend: NCCL for ``cuda``,
gloo for ``cpu``; a CUDA mesh on a group of another backend is an error,
never a quiet switch to gloo.

``make_fake_world`` gives the production mesh as a real ``DeviceMesh`` of
256 or 512 ranks over torch's ``fake`` process-group backend, as rank 0:
collectives return at once and move nothing, so one process can run a
rank's share of a step (the dry run, ``launch.dryrun``).  A fake world is
the default group: it cannot live beside a real one, so a dry run is a
process of its own (or destroys the world when done).
"""
from __future__ import annotations

import dataclasses
import socket

import torch
import torch.distributed as dist

AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes (``shape``), without devices."""

    shape: dict


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """``{data: 16, model: 16}``, or ``{pod: 2, data: 16, model: 16}``."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = MULTI_POD_AXES if multi_pod else AXES
    return MeshShape(dict(zip(axes, sizes)))


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU; a CUDA device
    without NCCL raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: a CUDA mesh needs it")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for {dev}")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device, *, rank: int = 0, world_size: int = 1,
               init_method: str | None = None) -> None:
    """Initialize the default process group for ``device``'s backend:
    ``init_method`` (``tcp://localhost:<a free port>`` unless given), its
    rank and world size given here, as nothing on the machine announces a
    cluster.  A CUDA rank's current device is ``cuda:rank`` modulo the
    cards."""
    dev = torch.device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://localhost:{_free_port()}",
        rank=rank, world_size=world_size)


def check_backend(device) -> None:
    """Raise unless the default process group runs the backend ``device``
    needs."""
    want = backend_for(device)
    have = str(dist.get_backend())           # "nccl", or "cpu:gloo,cuda:nccl"
    if want not in have:
        raise RuntimeError(f"a {torch.device(device).type} mesh needs {want}; "
                           f"the process group runs {have}")


def make_host_mesh(device="cuda"):
    """A 1×1 ``DeviceMesh`` (``data``, ``model``) of this rank alone.

    With no process group yet, a one-rank world is initialized for
    ``device``.  In a world of several ranks every rank calls this
    together, and each gets its own 1×1 mesh (a group of one rank each)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = torch.device(device)
    if not dist.is_initialized():
        init_world(dev)
    check_backend(dev)
    if dist.get_world_size() == 1:
        group = dist.group.WORLD
    else:
        group, _ = dist.new_subgroups(group_size=1)
    rank = dist.get_rank()
    return DeviceMesh.from_group([group, group], dev.type,
                                 mesh=torch.tensor([[rank]]),
                                 mesh_dim_names=AXES)


def make_fake_world(*, multi_pod: bool = False, sizes: dict | None = None):
    """A ``DeviceMesh`` of the production shape (or ``sizes``, axis name ->
    size) over a fake process group of as many ranks, this process rank 0.

    Raises if a process group already exists.  ``dist.destroy_process_group``
    ends it."""
    from torch.distributed.device_mesh import DeviceMesh
    # Ships with torch: the fake backend's store, used by torch's own tests.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already: a fake world "
                           "runs in a process of its own")
    shape = dict(sizes) if sizes is not None else make_production_mesh(
        multi_pod=multi_pod).shape
    n = 1
    for v in shape.values():
        n *= int(v)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    ranks = torch.arange(n).reshape(tuple(int(v) for v in shape.values()))
    return DeviceMesh("cpu", ranks, mesh_dim_names=tuple(shape))
