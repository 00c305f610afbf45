"""Checkpoints: atomic, async-capable, keep-k.

Port of ``repro.checkpoint.ckpt`` over nested dicts of tensors (the
trainer's state: ``{"params": {name: tensor}, "opt": {"step", "m",
"v"}}``, parameter names the port's).  The on-disk layout is the
reference's: ``<dir>/step_<n>/arrays.npz`` (leaves ``a0``, ``a1``, ...)
plus ``tree.json`` (the step, each leaf's path — keys joined with
``/`` — and dtype), committed by renaming a ``.tmp_step_<n>`` directory,
so a torn write is never taken for a checkpoint.  bfloat16 leaves are
stored as their uint16 bits (npz has no bfloat16).

``restore`` matches leaves by path, not by order, and places them on
the caller's ``device``, or with ``shardings`` on the current mesh
(reshard-on-restore: every rank reads the same file and keeps its block
of each array, cut on the host, so the saving mesh is irrelevant and no
card holds a whole array).

In a group of several processes ``save`` and ``restore`` are
collectives that every rank calls: ``save`` gathers each DTensor to
rank 0 alone, rank 0 writes, and every rank learns whether the step was
committed (a failed write raises on every rank, so the ranks go on
alike); ``restore`` of the latest step takes rank 0's latest step on
every rank.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd


def _flatten(tree, prefix=""):
    """[(path, tensor), ...] of a nested dict, keys in sorted order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_flatten(v, f"{prefix}{k}/"))
        else:
            out.append((prefix + k, v))
    return out


def _to_host(t: torch.Tensor, root: bool):
    """(a numpy copy that npz can hold, the tensor's dtype name) on the
    writing rank (``root``), None elsewhere; a DTensor is gathered to
    rank 0 first (a collective)."""
    t = t.detach()
    if shd.is_dtensor(t):
        t = shd.gather_to_root(t)
    if not root:
        return None
    t = t.to("cpu", copy=True)
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dtype
    return t.numpy(), dtype


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         blocking: bool = True) -> Optional[threading.Thread]:
    """Save a nested dict of tensors as step ``step``, then drop all but
    the newest ``keep`` steps.  The device-to-host copy happens before
    this returns (training may change the tensors after); with
    ``blocking=False`` the disk write runs on a thread, which is
    returned.  In a group of several processes rank 0 writes and the
    save blocks whatever ``blocking`` says: every rank returns None once
    the step is committed, or raises if rank 0's write failed."""
    flat = _flatten(tree)
    paths = [p for p, _ in flat]
    group = dist.is_initialized() and dist.get_world_size() > 1
    root = not group or dist.get_rank() == 0
    host = [_to_host(t, root) for _, t in flat]

    def commit():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, (a, _) in enumerate(host)})
        meta = {"step": step, "paths": paths,
                "dtypes": [dt for _, dt in host]}
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if group:
        failed, err = None, None
        if root:
            try:
                os.makedirs(ckpt_dir, exist_ok=True)
                commit()
            except Exception as e:  # every rank must hear of it
                failed, err = f"{type(e).__name__}: {e}", e
        status = [failed]
        dist.broadcast_object_list(status, src=0)
        if err is not None:
            raise err
        if status[0] is not None:
            raise RuntimeError(f"checkpoint step {step} was not saved: "
                               f"rank 0 failed ({status[0]})")
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    if blocking:
        commit()
        return None
    t = threading.Thread(target=commit, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int):
    for s in sorted(all_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    """The committed steps in ``ckpt_dir`` (never a ``.tmp`` one)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest committed step in ``ckpt_dir``, or None; in a group of
    several processes rank 0's, on every rank (a collective)."""
    steps = all_steps(ckpt_dir)
    s = max(steps) if steps else None
    if dist.is_initialized() and dist.get_world_size() > 1:
        got = [s]
        dist.broadcast_object_list(got, src=0)
        s = got[0]
    return s


def restore(ckpt_dir: str, target_tree: Any, *, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Any:
    """A new nested dict of the structure of ``target_tree`` holding step
    ``step`` (default: the latest) on ``device`` (default: the CPU, or
    with ``shardings`` the current mesh's device).  ``shardings``: a
    nested dict of the same structure whose leaves are
    ``distributed.sharding.Sharding`` (or DTensor placements); each
    array becomes a DTensor on the current mesh with its leaf's
    placements.  The checkpoint is the source of shapes and dtypes; its
    paths must be the target's.  Reads every array before returning
    any."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "tree.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        host = [z[f"a{i}"] for i in range(len(meta["paths"]))]
    arrays = {}
    for path, a, dt in zip(meta["paths"], host, meta["dtypes"]):
        arrays[path] = (torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16) if dt == "bfloat16" else torch.from_numpy(a))
    want = [p for p, _ in _flatten(target_tree)]
    if sorted(want) != sorted(arrays):
        raise ValueError(f"checkpoint step {step} holds {len(arrays)} "
                         f"leaves that are not the target's {len(want)}: "
                         f"{sorted(set(want) ^ set(arrays))[:4]}")

    if shardings is not None:
        mesh = shd.get_mesh()
        device = device or mesh.device_type
        plc = {p: getattr(sh, "placements", sh) for p, sh in
               _flatten(shardings)}

    def leaf(path):
        if shardings is not None:  # cut on the host, the block moved
            return shd.distribute(arrays[path], plc[path], device=device)
        return arrays[path].to(device or "cpu")

    def build(tree, prefix=""):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict)
                else leaf(prefix + k) for k, v in tree.items()}
    return build(target_tree)
