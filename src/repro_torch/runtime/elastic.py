"""Elastic scaling: rebuild the mesh at a new size and reshard state.

Port of ``repro.runtime.elastic``.  The mechanism is thin because the
substrate makes it cheap:

  * checkpoints are mesh-agnostic (host numpy, ``checkpoint/ckpt.py``),
  * shardings are derived from (config, mesh), not stored,
  * the data pipeline is deterministic in (seed, step, shard),

so scaling from N to M devices is: build the new mesh (:func:`remesh`)
-> derive the shardings -> restore the latest checkpoint with them
(:func:`reshard_restore`) -> continue at the saved step.
``remesh_lanes`` partitions the SpGEMM service's device lanes over
worker processes (``runtime/coordinator.py``).
"""
from __future__ import annotations

from torch import nn

from repro_torch.checkpoint import ckpt
from repro_torch.distributed import sharding as shd


def reshard_restore(ckpt_dir: str, target_tree, mesh, *, fsdp: bool,
                    step=None):
    """Restore parameters onto ``mesh`` (any size), each placed by the
    rules.  ``target_tree``: a dict of name -> tensor (the structure and
    names to restore), or a model, whose parameters are then replaced by
    the restored DTensors and which is returned."""
    names = (dict(target_tree.named_parameters())
             if isinstance(target_tree, nn.Module) else target_tree)
    with shd.use_mesh(mesh):
        shardings = shd.param_shardings(names, fsdp)
        got = ckpt.restore(ckpt_dir, names, step=step, shardings=shardings)
    if not isinstance(target_tree, nn.Module):
        return got
    for name, t in got.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = target_tree.get_submodule(mod_name) if mod_name else target_tree
        mod._parameters[leaf] = nn.Parameter(
            t, requires_grad=mod._parameters[leaf].requires_grad)
    return target_tree


def remesh(n_devices: int, *, multi_pod: bool = False, device=None):
    """The production mesh when the process group has its size, else the
    largest (data, model) mesh on ``n_devices`` ranks, holding the model
    axis at min(16, n) and scaling the data axis — the policy a resize
    controller would use when pods join or leave."""
    from repro_torch.launch import mesh as lm  # lazy

    try:
        return lm.make_production_mesh(multi_pod=multi_pod, device=device)
    except ValueError:
        model = min(16, n_devices)
        return lm.make_mesh((n_devices // model, model), ("data", "model"),
                            device)


def remesh_lanes(n_lanes: int, n_workers: int) -> list[range]:
    """Partition ``n_lanes`` device lanes over ``n_workers`` processes.

    Used by the process coordinator (``runtime/coordinator.py``) to
    (re)assign lane ownership when workers join or leave: contiguous
    slices, sizes differing by at most one, earlier workers taking the
    remainder.  With more workers than lanes, the surplus workers share
    lane 0 (every worker must own at least one lane to be schedulable —
    a lane-less worker could never run a flush).  Deterministic in
    (n_lanes, n_workers), so every process computes the same partition
    without coordination."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    if n_workers > n_lanes:
        # surplus workers share lane 0 rather than idling
        return [range(0, 1) if i >= n_lanes else range(i, i + 1)
                for i in range(n_workers)]
    base, rem = divmod(n_lanes, n_workers)
    out, lo = [], 0
    for i in range(n_workers):
        hi = lo + base + (1 if i < rem else 0)
        out.append(range(lo, hi))
        lo = hi
    return out
