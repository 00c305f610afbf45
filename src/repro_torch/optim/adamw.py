"""AdamW with dtype-configurable moments, decoupled weight decay,
global-norm clipping, and a linear-warmup cosine schedule.

Port of ``repro.optim.adamw`` over a flat dict of named tensors (a
module's ``named_parameters()``, or the names of the reference's tree
paths).  Step count, bias corrections and schedule are computed in
float32 as the reference computes them, and leaves whose name holds
``bias``, ``norm``, ``scale``, ... are not decayed.  ``torch.optim.AdamW``
differs from it in three ways: its decay is ``p * (1 - lr * wd)``
before the step, its clip divides by ``norm + 1e-6``, and it has no
per-name mask.  Functional: ``apply_updates`` returns new tensors and
never modifies its inputs.

On a mesh the parameters, gradients and moments are DTensors of the
same placements.  Every op of the update is elementwise, so it runs on
each rank's local shards and is exact; only the global norm crosses
ranks: each rank adds the squares of the shards it owns
(``sharding.owns``), and the sum is all-reduced once per mesh axis.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import sharding as shd


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    # the moments' and the update's arithmetic (the reference's float32)
    compute_dtype: str = "float32"
    # schedule
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # distributed tricks
    grad_accum: int = 1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(cfg: AdamWConfig, params: dict) -> dict:
    dt = getattr(torch, cfg.state_dtype)
    dev = next(iter(params.values())).device

    def zeros():  # each moment in its parameter's layout (a DTensor's too)
        return {k: torch.zeros_like(p, dtype=dt, requires_grad=False)
                for k, p in params.items()}
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": zeros(), "v": zeros()}


def global_norm(tensors: dict, dtype=torch.float32) -> torch.Tensor:
    """The 2-norm of all of ``tensors`` together (DTensors: over every
    rank, see the module docstring), a plain scalar."""
    plain = [x for x in tensors.values() if not shd.is_dtensor(x)]
    shards = [x for x in tensors.values() if shd.is_dtensor(x)]
    sq = sum(torch.sum(torch.square(x.to(dtype))) for x in plain)
    if shards:
        own = [x.to_local() for x in shards if shd.owns(x)]
        part = torch.zeros((), dtype=dtype, device=shards[0].device)
        for x in own:
            part = part + torch.sum(torch.square(x.to(dtype)))
        sq = sq + shd.mesh_sum_(part, shards[0].device_mesh)
    return torch.sqrt(sq)


def clip_by_global_norm(grads: dict, max_norm: float, dtype=torch.float32):
    norm = global_norm(grads, dtype)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: shd.like((shd.local(g).to(dtype) * scale).to(g.dtype), g)
            for k, g in grads.items()}, norm


_NO_DECAY = ("norm", "scale", "bias", "a_param", "dt_bias", "d_skip")


def _decay_mask(name: str) -> bool:
    return not any(t in name for t in _NO_DECAY)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, opt_state: dict,
                  grads: dict):
    """One AdamW step. Returns (params, opt_state, metrics)."""
    cdt = getattr(torch, cfg.compute_dtype)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, cdt)
    step = shd.local(opt_state["step"]) + 1  # replicated: a plain scalar
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    step32 = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=step.device), step32)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=step.device), step32)
    sdt = getattr(torch, cfg.state_dtype)
    new_p, new_m, new_v = {}, {}, {}
    for name, pd in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        p = shd.local(pd)
        g32 = shd.local(grads[name]).to(cdt)
        m32 = b1 * shd.local(m).to(cdt) + (1 - b1) * g32
        v32 = b2 * shd.local(v).to(cdt) + (1 - b2) * g32 * g32
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if _decay_mask(name):
            u = u + cfg.weight_decay * p.to(cdt)
        new_p[name] = shd.like((p.to(cdt) - lr * u).to(p.dtype), pd)
        new_m[name] = shd.like(m32.to(sdt), m)
        new_v[name] = shd.like(v32.to(sdt), v)
    return new_p, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}
