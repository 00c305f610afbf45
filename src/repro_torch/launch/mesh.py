"""Meshes of the port: ``torch.distributed`` device meshes.

Port of ``repro.launch.mesh``.  One process per device: a mesh's ranks
are the processes of the default process group, which
:func:`init_distributed` joins (``torchrun``'s environment) or starts
(one process, world size 1).  The backend follows the device: NCCL for
the card, gloo for the CPU (the tests); nothing falls back from one to
the other.  Functions only, never a module-level mesh, as in the
reference.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def init_distributed(device=None) -> str:
    """Join the default process group, or start one, for ``device``
    (default: the card); returns its backend.  Under ``torchrun``
    (``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` set) the group is joined
    through that environment and the process takes card ``LOCAL_RANK``;
    otherwise a one-process group on an in-process store.  An existing
    group is used as it is."""
    device = resolve_device(device)
    if not dist.is_initialized():
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_backend()


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over every
    rank of the process group (joined or started for ``device``);
    raises ``ValueError`` unless the shape holds exactly those ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    init_distributed(device)
    n = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != n:
        raise ValueError(f"a {shape} mesh needs {size} processes; the "
                         f"process group has {n}")
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``; raises unless the process group has
    that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_lane_mesh(n: int | None = None, device=None) -> list:
    """The devices the lane-sharded batched SpGEMM path
    (``distributed/spgemm_shard.py``) spreads its lanes over: the first
    ``n`` cards (default: every one), or ``n`` (default 1) entries of
    the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        n = n or torch.cuda.device_count()
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cpu")] * (n or 1)


def make_host_mesh(model_axis: int | None = None, device=None):
    """The (data, model) mesh over every rank of the process group
    (tests, examples, the trainer): model = ``model_axis``, else 4 when
    the rank count divides by 4, else 1."""
    init_distributed(device)
    n = dist.get_world_size()
    model = model_axis or (4 if n % 4 == 0 and n >= 4 else 1)
    return make_mesh((n // model, model), ("data", "model"), device)
