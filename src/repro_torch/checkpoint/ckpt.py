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
the caller's ``device``; the reference's resharding onto a new mesh
waits for the sharding slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


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


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(a numpy copy that npz can hold, the tensor's dtype name)."""
    t = t.detach().to("cpu", copy=True)
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
    returned."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    paths = [p for p, _ in flat]
    host = [_to_host(t) for _, t in flat]

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
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, target_tree: Any, *, step: Optional[int] = None,
            device=None) -> Any:
    """A new nested dict of the structure of ``target_tree`` holding step
    ``step`` (default: the latest) on ``device`` (default: the CPU).  The
    checkpoint is the source of shapes and dtypes; its paths must be the
    target's.  Reads every array before returning any."""
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

    def build(tree, prefix=""):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict)
                else arrays[prefix + k].to(device or "cpu")
                for k, v in tree.items()}
    return build(target_tree)
