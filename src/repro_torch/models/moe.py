"""Mixture-of-Experts with zipper dispatch, on one card.

Port of ``repro.models.moe`` without a mesh.  Token→expert routing is a
key-value stream problem: keys = expert ids, values = token slots.  The
stream is sorted by key (``kernels.ops.sort_tokens_by_key``, duplicates
kept), each assignment takes its rank inside its expert as its position,
assignments past the expert's capacity are dropped, and the kept ones
are packed into a capacity-padded (E, cap, D) buffer.  The three expert
products run over that buffer as one grouped matmul each (K7,
``kernels.grouped_matmul``, in its counts layout: group g's kept rows
are the first ``counts[g]`` of its ``cap``, so an expert that holds no
kept token is never read); the outputs are weighted by the router and
summed back per token.

The reference's production path (``_shardmap_moe``: sequence-sharded
tokens, an all_to_all over the expert-parallel axis) waits for the
sharding slice; without a mesh the reference takes ``_einsum_moe`` for
every ``dispatch``, and so does the port.

Parameters mirror the reference tree: ``router.w`` (D, E) in float32,
``experts.w1``/``w3`` (E, D, F) and ``experts.w2`` (E, F, D), and
``shared.*`` / ``dense_mlp.*`` (SwiGLU MLPs) when the config has them.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models.layers import MLP, Dense, mlp


def _expert_normal(shape, scale, dtype, *, generator, device=None):
    """(E, a, b) standard-normal draws times ``scale`` stored as ``dtype``,
    drawn one expert at a time in float32: a whole float32 draw at
    Arctic's width would be 17.9 GB of transient memory."""
    device = device or generator.device
    w = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        w[e] = torch.randn(shape[1:], generator=generator,
                           device=generator.device,
                           dtype=torch.float32) * scale
    return nn.Parameter(w)


class Experts(nn.Module):
    """w1, w3: (E, D, F); w2: (E, F, D)."""

    def __init__(self, E, D, F_, dtype, *, generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.w1 = _expert_normal((E, D, F_), D ** -0.5, dtype, **kw)
        self.w3 = _expert_normal((E, D, F_), D ** -0.5, dtype, **kw)
        self.w2 = _expert_normal((E, F_, D), F_ ** -0.5, dtype, **kw)


class MoE(nn.Module):
    """router (float32 always), experts, and the optional shared experts
    and dense residual MLP."""

    def __init__(self, cfg, dtype, *, generator, device=None):
        super().__init__()
        E, D, F_ = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        kw = dict(generator=generator, device=device)
        self.router = Dense(D, E, torch.float32, **kw)
        self.experts = Experts(E, D, F_, dtype, **kw)
        self.shared = (MLP(D, F_ * cfg.num_shared_experts, dtype, **kw)
                       if cfg.num_shared_experts else None)
        self.dense_mlp = (MLP(D, cfg.d_ff, dtype, **kw)
                          if cfg.dense_residual else None)


def moe_init(cfg, dtype, *, generator, device=None) -> MoE:
    return MoE(cfg, dtype, generator=generator, device=device)


def _router(p: MoE, x, cfg):
    """x: (..., D) -> (top-k ids (..., k) int32, weights (..., k) float32,
    logits (..., E) float32)."""
    logits = torch.einsum("...d,de->...e", x.float(), p.router.w)
    w, ids = torch.topk(logits, cfg.top_k, dim=-1)
    return ids.to(torch.int32), torch.softmax(w, dim=-1), logits


def _expert_ffn(we: Experts, xe, counts, *, gmm=None):
    """xe: (E, C, D) with expert e's kept rows first, ``counts`` (E,)
    int32 of them -> (E, C, D): the SwiGLU of each expert over its kept
    rows, zeros in the rest; each product one grouped matmul in the
    counts layout (group stride C).  ``gmm`` is K7's wrapper (this
    module's ``grouped_matmul``, looked up at the call);
    ``kernels.grouped_matmul.grouped_matmul_plain`` gives the same block
    through the plain version (the card's checks).  Under autograd K7's
    wrapper takes its backward pass (``kernels.grouped_matmul``)."""
    gmm = gmm or grouped_matmul
    E, C, D = xe.shape
    xt = xe.reshape(E * C, D)
    h = F.silu(gmm(xt, we.w1.to(xe.dtype), counts, cap=C))
    h = h * gmm(xt, we.w3.to(xe.dtype), counts, cap=C)
    return gmm(h, we.w2.to(xe.dtype), counts, cap=C).reshape(E, C, D)


def _capacity(T, k, E, cf):
    """Per-expert capacity. Small token counts (decode steps, smoke tests)
    get a dropless capacity so decode matches the full forward exactly."""
    if T * k <= 256:
        return T * k
    return -(-max(8, int(cf * T * k / E)) // 8) * 8


def _aux_loss(logits, ids, cfg):
    """Switch-style load-balance loss."""
    E = cfg.num_experts
    probs = torch.softmax(logits, dim=-1).reshape(-1, E)
    hot = F.one_hot(ids.reshape(-1).long(), E).float()
    return E * torch.sum(hot.mean(0) * probs.mean(0))


def moe_block(p: MoE, x, cfg, *, gmm=None):
    """x: (B, S, D) -> (out (B, S, D), aux_loss float32 scalar).  The
    parts add in the reference's order: dense MLP, shared experts,
    routed experts.  On one card the routed part always takes the einsum
    dispatch, whatever ``cfg.moe_dispatch`` says (the reference does so
    without a mesh); ``gmm`` as in :func:`_expert_ffn`."""
    out_parts = []
    if cfg.dense_residual:
        out_parts.append(mlp(p.dense_mlp, x))
    if cfg.num_shared_experts:
        out_parts.append(mlp(p.shared, x))
    routed, aux = _einsum_moe(p, x, cfg, gmm=gmm)
    out_parts.append(routed)
    return functools.reduce(torch.add, out_parts), aux


def _assign(p: MoE, xt, cfg):
    """Route the (T, D) tokens and place each of the T·k assignments in
    its expert: (ids (T, k), weights (T, k), logits, cap, pos (T·k,),
    keep (T·k,)).  An assignment's position is its rank among its
    expert's assignments in packed-key order (expert, then slot);
    positions at or past the capacity are dropped."""
    E = cfg.num_experts
    T = xt.shape[0]
    ids, w, logits = _router(p, xt, cfg)
    cap = _capacity(T, cfg.top_k, E, cfg.capacity_factor)
    flat_ids = ids.reshape(-1)
    _, perm = kops.sort_tokens_by_key(flat_ids, backend="torch")
    perm = perm.long()
    sorted_ids = flat_ids[perm].long()
    hot = F.one_hot(sorted_ids, E).to(torch.int32)
    pos_sorted = (torch.cumsum(hot, dim=0) - hot).gather(
        1, sorted_ids[:, None])[:, 0]
    pos = torch.empty_like(pos_sorted)
    pos[perm] = pos_sorted
    return ids, w, logits, cap, pos, pos < cap


def _einsum_moe(p: MoE, x, cfg, *, gmm=None):
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    ids, w, logits, cap, pos, keep = _assign(p, xt, cfg)
    flat_ids = ids.reshape(-1).long()
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    # kept assignments own distinct (expert, pos) slots; dropped ones are
    # written to one spare row past the buffer, which is cut off
    slot = torch.where(keep, flat_ids * cap + pos, E * cap)
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, xt[tok])
    # kept rows per expert, on the device (integer adds: any order gives
    # the same counts; bincount would read its max to the host)
    counts = torch.zeros(E, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, flat_ids, keep.to(torch.int32))
    ye = _expert_ffn(p.experts, buf[:E * cap].view(E, cap, D), counts,
                     gmm=gmm)
    yt = ye.reshape(E * cap, D)[torch.where(keep, slot, 0)]
    yt = torch.where(keep[:, None], yt, 0) * w.reshape(-1)[:, None].to(x.dtype)
    # each token's k outputs summed in order from zero, in x's dtype (the
    # reference's scatter-add; index_add_ adds in no fixed order on CUDA)
    yt = yt.view(T, k, D)
    out = torch.zeros_like(xt)
    for j in range(k):
        out = out + yt[:, j]
    return out.reshape(B, S, D), _aux_loss(logits, ids, cfg)
