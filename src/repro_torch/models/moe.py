"""Mixture-of-Experts with **zipper dispatch**.

Port of ``repro.models.moe``.  Token→expert routing is a key-value
stream problem: keys = expert ids, values = token slots.  The stream is
sorted by key (``kernels.ops.sort_tokens_by_key``, duplicates kept),
each assignment takes its rank inside its expert as its position,
assignments past the expert's capacity are dropped, and the kept ones
are packed into a capacity-padded (E, cap, D) buffer.  The three expert
products run over that buffer as one grouped matmul each (K7,
``kernels.grouped_matmul``, in its counts layout: group g's kept rows
are the first ``counts[g]`` of its ``cap``, so an expert that holds no
kept token is never read); the outputs are weighted by the router and
summed back per token.

Two paths, as in the reference (``moe_block`` picks one):

  zipper (production, ``_shardmap_moe``): on a mesh.  Each rank's tokens
    are its block of the sequence over the model axis when the sequence
    divides (the reference's ``shard_map`` partition: under ``"tp"`` the
    residual's block, which the block takes as it is), routed and
    zipper-sorted locally into per-expert capacity bins, exchanged with
    one all_to_all over the model axis (the experts are model-sharded),
    run through the rank's experts and sent back by the inverse
    exchange, then combined through the inverse permutation.
    FSDP-sharded expert weights are all-gathered over the data axis.
  einsum (``_einsum_moe``): every token's assignments into one (E, cap,
    D) buffer; without a mesh every ``dispatch`` takes it, as in the
    reference; on a mesh over the global batch.

:func:`record_kept` collects each zipper call's tokens and the experts
their assignments kept (the kept set the capacity leaves).

Parameters mirror the reference tree: ``router.w`` (D, E) in float32,
``experts.w1``/``w3`` (E, D, F) and ``experts.w2`` (E, F, D), and
``shared.*`` / ``dense_mlp.*`` (SwiGLU MLPs) when the config has them.
"""
from __future__ import annotations

import contextlib
import functools
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models.layers import MLP, Dense, mlp


def _expert_normal(shape, scale, dtype, *, generator, device=None):
    """(E, a, b) standard-normal draws times ``scale`` stored as ``dtype``,
    drawn one expert at a time in float32: a whole float32 draw at
    Arctic's width would be 17.9 GB of transient memory.  On the
    ``meta`` device nothing is drawn."""
    device = device or generator.device
    w = torch.empty(shape, dtype=dtype, device=device)
    if w.is_meta:
        return nn.Parameter(w)
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


def moe_block(p: MoE, x, cfg, *, dispatch=None, gmm=None, seq=None):
    """x: (B, S, D) -> (out (B, S, D), aux_loss float32 scalar); under
    ``"tp"`` x is the residual's block of a sequence of ``seq``
    positions (default S: all of it), and so is out.  The parts add in
    the reference's order: dense MLP, shared experts, routed experts.
    The routed part takes the einsum dispatch when ``dispatch`` (default
    ``cfg.moe_dispatch``) is "einsum" or there is no mesh, else the
    zipper dispatch over the mesh (:func:`_shardmap_moe`); ``gmm`` as in
    :func:`_expert_ffn`."""
    dispatch = dispatch or cfg.moe_dispatch
    out_parts = []
    if cfg.dense_residual:
        out_parts.append(mlp(p.dense_mlp, x, seq))
    if cfg.num_shared_experts:
        out_parts.append(mlp(p.shared, x, seq))
    if dispatch == "einsum" or shd.get_mesh() is None:
        routed, aux = _einsum_moe(p, x, cfg, gmm=gmm, seq=seq)
    else:
        routed, aux = _shardmap_moe(p, x, cfg, gmm=gmm,
                                    own_tokens=shd.tp(cfg))
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


def _einsum_moe(p: MoE, x, cfg, *, gmm=None, seq=None):
    """The einsum dispatch over every token of the batch.  On a mesh
    each rank's block of the batch is all-gathered over the axes it is
    split over, and its block of a sequence of ``seq`` positions over
    the model axis (``"tp"``; the reference's GSPMD runs this dispatch
    on the global batch, whose capacity depends on its token count);
    the batch runs with the whole expert weights, and the rank keeps
    its block."""
    if shd.get_mesh() is None:
        return _einsum_moe_local(p, p.experts, x, cfg, gmm=gmm)
    s = x.shape[1]
    x = shd.seq_gather(x, seq or s)
    axes = shd.batch_split()
    for a in reversed(axes):
        x = shd.all_gather(x, a, 0)
    out, aux = _einsum_moe_local(p, _expert_weights(p), x, cfg, gmm=gmm)
    return shd.seq_part(shd.batch_block(out) if axes else out, s), aux


def _expert_weights(p: MoE, keep=()):
    """The experts' w1, w3, w2 as plain tensors (``sharding.local_view``:
    on a mesh gathered over every axis but ``keep``): the MoE block reads
    them itself, outside the layer's gathered weights."""
    return types.SimpleNamespace(**{
        n: shd.local_view(getattr(p.experts, n), keep) for n in ("w1", "w3",
                                                                 "w2")})


def _einsum_moe_local(p: MoE, we, x, cfg, *, gmm=None):
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
    ye = _expert_ffn(we, buf[:E * cap].view(E, cap, D), counts, gmm=gmm)
    yt = ye.reshape(E * cap, D)[torch.where(keep, slot, 0)]
    yt = torch.where(keep[:, None], yt, 0) * w.reshape(-1)[:, None].to(x.dtype)
    # each token's k outputs summed in order from zero, in x's dtype (the
    # reference's scatter-add; index_add_ adds in no fixed order on CUDA)
    yt = yt.view(T, k, D)
    out = torch.zeros_like(xt)
    for j in range(k):
        out = out + yt[:, j]
    return out.reshape(B, S, D), _aux_loss(logits, ids, cfg)


_KEPT = None


@contextlib.contextmanager
def record_kept():
    """Within the block, each :func:`_shardmap_moe` call appends to the
    list this yields {"tokens": (T, D) the tokens it routed, "kept": (T,
    k) int32 the expert of each assignment the capacity kept, -1 for a
    dropped one}."""
    global _KEPT
    prev, _KEPT = _KEPT, []
    try:
        yield _KEPT
    finally:
        _KEPT = prev


def _shardmap_moe(p: MoE, x, cfg, *, gmm=None, own_tokens=False):
    """The zipper dispatch on a mesh, the body of the reference's
    ``shard_map`` as each rank's program.  x: (B, S, D), the rank's block
    of the batch -> (out (B, S, D), aux float32 scalar, the same on
    every rank).

    The rank routes its tokens.  With ``own_tokens`` (``"tp"``) they
    are ``x``: the residual's block of the sequence, which is the
    reference's partition (or the whole sequence, when it does not
    divide, as the reference's routing is then replicated over the
    model axis).  Else (``"sp"``) all of ``x`` when the batch is split
    over the model axis (``sharding.batch_split``: a departure from the
    reference, whose ranks route sequence blocks), else its 1/n_model of
    the sequence when that divides (the reference's rule), else all of
    them.  It zipper-sorts the (expert, slot) stream
    and packs each expert's kept assignments into an (E, cap, D) buffer,
    cap = ``_capacity(T_loc, ...)``.  One all_to_all over the model axis
    sends expert e's bin to the rank that holds e: (E, cap, D) ->
    (E_loc, n_model * cap, D), each expert's rows by source rank.  The
    kept counts travel the same way (E int32 per rank), and each
    expert's kept rows are moved first, so K7's counts layout reads them
    alone (with one rank on the axis the move is the identity).  The
    inverse exchange brings the outputs back; the combine runs the
    inverse permutation and the top-k weights, and split sequence blocks
    are all-gathered over the model axis."""
    n_model = shd.model_axis_size()
    E, k = cfg.num_experts, cfg.top_k
    B, S, D = x.shape
    # the model axis's ranks hold different rows (training), or split the
    # sequence when the shape allows it (prefill); decode (S < n_model)
    # replicates routing over the model axis; the experts stay sharded
    seq_shard = (not own_tokens and "model" not in shd.batch_split()
                 and S % n_model == 0 and S >= n_model)
    s_loc = S // n_model if seq_shard else S
    xl = x.narrow(1, shd.get_mesh().get_local_rank("model") * s_loc, s_loc) \
        if seq_shard else x
    xt = xl.reshape(-1, D)
    T = xt.shape[0]
    cap = _capacity(T, k, E, cfg.capacity_factor)
    if E % n_model:
        raise ValueError(f"{E} experts do not split over a model axis of "
                         f"{n_model}")
    E_loc = E // n_model
    # the rank's experts, all-gathered over the data axis under FSDP
    we = _expert_weights(p, keep=("model",))
    logits = xt.float() @ p.router.w
    wk, ids = torch.topk(logits, k, dim=-1)
    wk = torch.softmax(wk, dim=-1)
    flat_ids = ids.reshape(-1).to(torch.int32)
    # ---- zipper sort (mssortk/mssortv semantics, group-not-merge) ----
    _, perm = kops.sort_tokens_by_key(flat_ids, backend="torch")
    perm = perm.long()
    sorted_ids = flat_ids[perm].long()
    hot = F.one_hot(sorted_ids, E).to(torch.int32)
    pos_sorted = (torch.cumsum(hot, dim=0) - hot).gather(
        1, sorted_ids[:, None])[:, 0]
    keep = pos_sorted < cap
    if _KEPT is not None:
        kept = torch.empty_like(flat_ids)
        kept[perm] = torch.where(keep, sorted_ids, -1).to(kept.dtype)
        _KEPT.append({"tokens": xt.detach(), "kept": kept.view(T, k)})
    tok_sorted = perm // k
    # kept assignments own distinct (expert, pos) slots; dropped ones go
    # to one spare row past the buffer, which is cut off
    slot = torch.where(keep, sorted_ids * cap + pos_sorted, E * cap)
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, xt[tok_sorted])
    counts = torch.zeros(E, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, sorted_ids, keep.to(torch.int32))
    # ---- EP exchange: (E, cap, D) -> (E_loc, n_model * cap, D) ----
    xe = shd.all_to_all(buf[:E * cap].view(n_model, E_loc * cap * D),
                        "model").view(n_model, E_loc, cap, D)
    got = shd.all_to_all(counts.view(n_model, E_loc), "model")  # (src, e)
    C = n_model * cap
    # each expert's kept rows first: row (src, c < got[src, e]) of expert
    # e goes to row (kept rows of earlier sources) + c
    c_idx = torch.arange(cap, device=x.device)
    kept = c_idx[None, None, :] < got[:, :, None]              # (src, e, c)
    before = torch.cumsum(got, dim=0) - got                    # (src, e)
    e_idx = torch.arange(E_loc, device=x.device)[None, :, None]
    dest = torch.where(kept, e_idx * C + before[:, :, None] + c_idx, E_loc * C)
    rows = torch.zeros((E_loc * C + 1, D), dtype=x.dtype, device=x.device)
    rows.index_copy_(0, dest.reshape(-1), xe.reshape(-1, D))
    ye = _expert_ffn(we, rows[:E_loc * C].view(E_loc, C, D), got.sum(0),
                     gmm=gmm)
    ye = ye.reshape(E_loc * C, D)[torch.where(kept, dest, 0).reshape(-1)]
    ye = torch.where(kept.reshape(-1, 1), ye, 0).view(n_model, E_loc * cap * D)
    # ---- reverse exchange (exact inverse of the first) ----
    ye = shd.all_to_all(ye, "model").view(E * cap, D)
    y_sorted = ye[torch.where(keep, slot, 0)]
    y_sorted = torch.where(keep[:, None], y_sorted, 0)
    # ---- combine: inverse zipper permutation + top-k weighting ----
    y_flat = torch.empty_like(y_sorted)
    y_flat[perm] = y_sorted
    yt = y_flat.view(T, k, D) * wk[..., None].to(x.dtype)
    y = torch.zeros_like(xt)
    for j in range(k):
        y = y + yt[:, j]
    y = y.view(B, s_loc, D)
    if seq_shard:
        y = shd.all_gather(y, "model", 1)
    # aux loss: the rank's estimate, averaged over the model and batch axes
    probs = torch.softmax(logits, dim=-1)
    frac_t = F.one_hot(ids.reshape(-1).long(), E).float().mean(0)
    aux = E * torch.sum(frac_t * probs.mean(0))
    axes = ("model",) + shd.batch_axes()
    aux = shd.all_reduce(aux, axes) / shd.world_size()
    return y, aux
