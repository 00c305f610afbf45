"""Attention: GQA (grouped-query, optional QKV bias, local windows) and
MLA (DeepSeek-V2's multi-head latent attention).

Port of ``repro.models.attention``.  The full-sequence GQA
self-attention (prefill) runs one of two attentions, picked by
``cfg.attn_impl``:

  ``"pallas"``  K6, the hand-written flash-attention kernel
                (``kernels.flash_attention``; its plain version on CPU
                tensors), causal, windowed or bidirectional;
  otherwise     :func:`blocked_attention`, the plain blocked
                online-softmax attention in torch (memory O(S · block)),
                with the reference's static causal block skip, bf16
                probabilities and query offset.

Cross attention (``gqa_forward(..., kv_override=enc)``: queries from
the decoder, keys and values from the encoder's states, no rope) always
runs :func:`blocked_attention`, bidirectional, whatever
``cfg.attn_impl`` says: the reference's cross path never reaches its
kernel.  The MLA forward always runs :func:`blocked_attention` (the
reference runs its kernel only for GQA): its scale is (nope + rope) ** -0.5 and
its value head dim differs from the query/key one.  Decode attends the
whole cache in plain torch, as the reference does (it has no kernel
there); MLA decodes in the absorbed form, scores and context in the
compressed space.

On a mesh (``distributed/sharding.py``) decode reads its cache in
local form: a cache DTensor's sequence (or ring-slot) dim is split
over the model axis, so each rank scores the positions of its block,
writes the new token's entry only where that position lies in its
block, and the softmax is combined across the axis (the max and the
sums all-reduced: flash-decoding's partial softmax, which the reference
leaves to GSPMD).

Under ``layer_layout="tp"`` the projections hold the rank's block of
heads over the model axis (where the heads divide it; else all of
them, as the reference's rules leave them): the forward runs the
rank's query heads, with its own KV heads when those split too, else
the whole KV heads that its query heads group onto (:func:`kv_group`);
``wo`` is row-parallel, so the output is the rank's share of a sum
(``out_partial``).  Decode, whose cache is split by sequence, gathers
the step's query heads (B·H·hd values) and, when the KV heads split,
the new token's K/V over the model axis, attends every head on the
rank's positions, combines the partial softmax, and keeps the rank's
heads for ``wo``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import Dense, RMSNorm, normal, rmsnorm, rope

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class OutProj(nn.Module):
    """w: (num_heads, head_dim, d_model), normal init scaled by
    (num_heads * head_dim) ** -0.5."""

    def __init__(self, num_heads, head_dim, d_model, dtype, *, generator,
                 device=None):
        super().__init__()
        self.w = normal((num_heads, head_dim, d_model),
                        (num_heads * head_dim) ** -0.5, dtype,
                        generator=generator, device=device)


class GQA(nn.Module):
    """wq (D, H, hd), wk/wv (D, KVH, hd) with optional biases, wo."""

    def __init__(self, cfg, dtype, *, generator, device=None):
        super().__init__()
        hd = cfg.resolved_head_dim
        kw = dict(generator=generator, device=device, bias=cfg.qkv_bias)
        self.wq = Dense(cfg.d_model, (cfg.num_heads, hd), dtype, **kw)
        self.wk = Dense(cfg.d_model, (cfg.num_kv_heads, hd), dtype, **kw)
        self.wv = Dense(cfg.d_model, (cfg.num_kv_heads, hd), dtype, **kw)
        self.wo = OutProj(cfg.num_heads, hd, cfg.d_model, dtype,
                          generator=generator, device=device)


def gqa_init(cfg, dtype, *, generator, device=None) -> GQA:
    return GQA(cfg, dtype, generator=generator, device=device)


class MLA(nn.Module):
    """w_dq (D, q_lora), q_norm, w_uq (q_lora, H, nope + rope), w_dkv (D,
    kv_lora + rope), kv_norm, w_uk (kv_lora, H, nope), w_uv (kv_lora, H,
    v_head_dim), wo (H, v_head_dim, D)."""

    def __init__(self, cfg, dtype, *, generator, device=None):
        super().__init__()
        device = device or generator.device
        H, r = cfg.num_heads, cfg.kv_lora_rank
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        kw = dict(generator=generator, device=device)
        self.w_dq = Dense(cfg.d_model, cfg.q_lora_rank, dtype, **kw)
        self.q_norm = RMSNorm(cfg.q_lora_rank, dtype, device=device)
        self.w_uq = Dense(cfg.q_lora_rank, (H, qk), dtype, **kw)
        self.w_dkv = Dense(cfg.d_model, r + cfg.qk_rope_dim, dtype, **kw)
        self.kv_norm = RMSNorm(r, dtype, device=device)
        self.w_uk = Dense(r, (H, cfg.qk_nope_dim), dtype, **kw)
        self.w_uv = Dense(r, (H, cfg.v_head_dim), dtype, **kw)
        self.wo = OutProj(H, cfg.v_head_dim, cfg.d_model, dtype, **kw)


def mla_init(cfg, dtype, *, generator, device=None) -> MLA:
    return MLA(cfg, dtype, generator=generator, device=device)


# ---------------------------------------------------------------------------
# blocked online-softmax attention (prefill; training later)
# ---------------------------------------------------------------------------

def _attend_block(q, k, v, qpos, kpos, causal, window, scale, p_bf16=False):
    """q: (B,qb,H,hd) k/v: (B,kb,KVH,hd) -> partial (acc, m, l)."""
    B, qb, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, qb, KVH, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    dpos = qpos[:, None] - kpos[None, :]
    mask = torch.ones((qb, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= dpos >= 0
    if window:
        mask &= dpos < window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                       # (B,KVH,G,qb)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if p_bf16:
        # flash-attention-2 numerics: bf16 probabilities (and values)
        # into the PV product, accumulated in float32
        p = p.to(torch.bfloat16).float()
        v = v.to(torch.bfloat16)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return acc, m, l


def blocked_attention(q, k, v, *, causal=True, window=0, q_block=2048,
                      kv_block=1024, block_skip=False, q_offset=0,
                      scale=None, p_bf16=False):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KVH,hd). Returns (B,Sq,H,hd).

    q_offset: global position of q[0] minus position of k[0] (prefill: 0
    when Sq == Skv; decode chunks: cache_len).  Key padding is masked
    only through the causal test, as in the reference: with
    ``causal=False`` and Skv no multiple of the key block, the padded
    keys (zero keys and values) take part in the softmax with score 0."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    dev = q.device
    scale = scale if scale is not None else hd ** -0.5
    qb = min(q_block, Sq)
    kb = min(kv_block, Skv)
    nq = -(-Sq // qb)
    nk = -(-Skv // kb)
    pad_q = nq * qb - Sq
    pad_k = nk * kb - Skv
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    valid_k = torch.arange(nk * kb, device=dev) < Skv
    G = H // KVH
    hd_v = v.shape[-1]
    outs = []
    for i in range(nq):
        qi = q[:, i * qb:(i + 1) * qb]
        qpos = i * qb + torch.arange(qb, device=dev) + q_offset
        acc = torch.zeros((B, KVH, G, qb, hd_v), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, KVH, G, qb), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KVH, G, qb), dtype=torch.float32, device=dev)
        hi = nk
        if block_skip and causal:
            # skip kv blocks wholly after the block's last query
            hi = min(nk, -(-((i + 1) * qb + q_offset) // kb))
        for j in range(hi):
            sl = slice(j * kb, (j + 1) * kb)
            kpos = j * kb + torch.arange(kb, device=dev)
            kpos = torch.where(valid_k[sl], kpos, Sq + Skv + 10**9)
            a2, m2, l2 = _attend_block(qi, k[:, sl], v[:, sl], qpos, kpos,
                                       causal, window, scale, p_bf16)
            mn = torch.maximum(m, m2)
            c1 = torch.exp(m - mn)
            c2 = torch.exp(m2 - mn)
            acc = acc * c1[..., None] + a2 * c2[..., None]
            l = l * c1 + l2 * c2
            m = mn
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.reshape(B, KVH * G, qb, hd_v).transpose(1, 2))
    out = torch.cat(outs, dim=1)[:, :Sq]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block forward
# ---------------------------------------------------------------------------

def out_partial(p, cfg) -> bool:
    """Whether the attention's output is the rank's share of a sum over
    the model axis: its ``wo`` holds a block of the heads (``"tp"``)."""
    return p.wo.w.shape[0] < cfg.num_heads


def kv_group(k, n_q: int, cfg):
    """The KV heads of ``k`` (B, S, KVl, hd) that the rank's ``n_q``
    query heads attend, as many whole groups of ``H / KVH`` query heads
    per KV head: all of ``k`` when the query heads are all there or the
    KV heads are the rank's own block (split with them); else (the query
    heads split, the KV heads whole: fewer than the model axis) the
    slice they group onto."""
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    if n_q == H or k.shape[2] < KVH:
        return k
    G = H // KVH
    if n_q % G and G % n_q:
        raise ValueError(f"the rank's {n_q} query heads straddle groups "
                         f"of {G}")
    lo = shd.block_offset(n_q, H)
    return k[:, :, lo // G:(lo + n_q - 1) // G + 1]


def gqa_forward(p: GQA, x, pos, cfg, *, causal=True, window=0,
                kv_override=None):
    """Full-sequence (prefill) GQA self-attention, causal or not, over a
    ``window`` of keys when it is not 0.  x: (B, S, D); pos: (B, S)
    positions.  With ``kv_override`` (B, Senc, D), the encoder's states,
    it is cross attention instead: keys and values are projected from
    ``kv_override``, nothing is roped, and every query attends every key
    through :func:`blocked_attention`.  Returns (out (B, S, D), k, v),
    k/v (B, Skv, KVl, hd) as projected (after rope), for the prefill
    cache: every KV head, or the rank's block of them under ``"tp"``
    (module docstring), whose ``out`` is a share of the sum when
    :func:`out_partial`."""
    q = p.wq(x)
    src = kv_override if kv_override is not None else x
    k = p.wk(src)
    v = p.wv(src)
    if kv_override is not None:
        out = blocked_attention(q, kv_group(k, q.shape[2], cfg),
                                kv_group(v, q.shape[2], cfg), causal=False,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block)
        return torch.einsum("bshd,hdo->bso", out, p.wo.w.to(x.dtype)), k, v
    if cfg.pos_emb == "rope":
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    ka, va = kv_group(k, q.shape[2], cfg), kv_group(v, q.shape[2], cfg)
    if cfg.attn_impl == "pallas":
        out = flash_attention(q, ka, va, causal=causal, window=window)
    else:
        out = blocked_attention(q, ka, va, causal=causal, window=window,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block,
                                block_skip=cfg.attn_block_skip,
                                p_bf16=cfg.attn_p_bf16)
    return torch.einsum("bshd,hdo->bso", out, p.wo.w.to(x.dtype)), k, v


def all_heads(t, cfg, dim=2, full=None):
    """``t`` with its ``dim`` holding the rank's block of ``full``
    (default ``cfg.num_heads``) heads -> every head, all-gathered over
    the model axis; ``t`` itself when it holds them all."""
    full = full or cfg.num_heads
    return t if t.shape[dim] == full else shd.all_gather(t, "model", dim)


def all_kv_heads(k, v, cfg):
    """``k``, ``v`` (B, S, KVl, hd) with every KV head: as they are, or
    all-gathered over the model axis (one exchange for both) when they
    hold the rank's block of them (``"tp"``)."""
    if k.shape[2] == cfg.num_kv_heads:
        return k, v
    kv = all_heads(torch.stack([k, v]), cfg, 3, cfg.num_kv_heads)
    return kv[0], kv[1]


def own_heads(t, n: int, cfg, dim=2):
    """The rank's block of ``n`` heads of ``t``, which holds every head
    along ``dim`` (the heads' order)."""
    if n == t.shape[dim]:
        return t
    return t.narrow(dim, shd.block_offset(n, cfg.num_heads), n)


def seq_block(c):
    """A cache tensor in local form: (its local tensor, the position of
    the block's first entry along dim 1, whether dim 1 is split over the
    model axis, and a function that wraps a new local tensor in the
    cache's placement).  A plain tensor is its own whole block."""
    if not shd.is_dtensor(c):
        return c, 0, False, lambda t: t
    from torch.distributed.tensor import DTensor

    dim, off, _ = shd.model_shard(c)
    if dim not in (None, 1):
        raise ValueError(f"a cache split over the model axis along dim "
                         f"{dim}: attention reads dim 1 split only")
    return (c.to_local(), off, dim is not None,
            lambda t: DTensor.from_local(t, c.device_mesh, c.placements,
                                         run_check=False))


def attend(s, av, split: bool):
    """softmax(s) over the last dim, then ``av`` of the probabilities: s
    float32 scores of one block of positions (masked ones NEG_INF).
    When ``split`` the positions are split over the model axis: the
    block's max, exponent sums and ``av`` are combined over the axis."""
    if not split:
        return av(torch.softmax(s, dim=-1))
    m = shd.all_reduce_max(s.amax(dim=-1, keepdim=True), ("model",))
    e = torch.exp(s - m)
    den = shd.all_reduce(e.sum(dim=-1, keepdim=True), ("model",))
    return shd.all_reduce(av(e), ("model",)) / den


def gqa_decode(p: GQA, x, cache_k, cache_v, cache_len: int, cfg, *,
               window=0):
    """One-token decode.  x: (B, 1, D); cache_k/v: (B, Smax, KVH, hd);
    the new token sits at position ``cache_len``.  Returns (out, new_k,
    new_v).  The default cache update is the reference's one-hot blend
    (a new cache, touching all of it); ``cfg.decode_dus`` writes the one
    slot in place in the given cache instead."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q = p.wq(x)
    if cfg.pos_emb == "rope":
        q = rope(q, pos, cfg.rope_theta)
    k_new = p.wk(x)
    if cfg.pos_emb == "rope":
        k_new = rope(k_new, pos, cfg.rope_theta)
    v_new = p.wv(x)
    n_q = q.shape[2]  # the rank's query heads (``"tp"``: a block)
    q = all_heads(q, cfg)
    k_new, v_new = all_kv_heads(k_new, v_new, cfg)
    ba = shd.batch_axes() or None
    cache_k = shd.constrain(cache_k, ba, "model", None, None)
    cache_v = shd.constrain(cache_v, ba, "model", None, None)
    (ck, off, split, wrap), (cv, _, _, _) = seq_block(cache_k), seq_block(
        cache_v)
    Sl = ck.shape[1]  # this block's positions: off, ..., off + Sl - 1
    if cfg.decode_dus:
        if off <= cache_len < off + Sl:
            ck[:, cache_len - off:cache_len - off + 1] = k_new.to(ck.dtype)
            cv[:, cache_len - off:cache_len - off + 1] = v_new.to(cv.dtype)
    else:
        onehot = (torch.arange(off, off + Sl, device=x.device) == cache_len
                  ).to(ck.dtype)[None, :, None, None]
        ck = ck * (1 - onehot) + k_new.to(ck.dtype) * onehot
        cv = cv * (1 - onehot) + v_new.to(cv.dtype) * onehot
    KVH = ck.shape[2]
    G = cfg.num_heads // KVH
    qg = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), ck.float()) * hd ** -0.5
    kpos = torch.arange(off, off + Sl, device=x.device)
    valid = kpos <= cache_len
    if window:
        valid &= kpos > cache_len - window
    s = torch.where(valid, s, NEG_INF)
    out = attend(s, lambda pr: torch.einsum("bkgs,bskd->bkgd", pr,
                                            cv.float()), split)
    out = own_heads(out.reshape(B, 1, cfg.num_heads, hd), n_q, cfg)
    y = torch.einsum("bshd,hdo->bso", out.to(x.dtype), p.wo.w.to(x.dtype))
    return y, wrap(ck), wrap(cv)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV cache + absorbed decode
# ---------------------------------------------------------------------------

def _mla_kv(p: MLA, x, pos, cfg):
    """The compressed KV of x: (c_kv (B, S, kv_lora) after kv_norm, k_rope
    (B, S, rope) after rope), what the cache holds."""
    dkv = p.w_dkv(x)
    c_kv = rmsnorm(dkv[..., :cfg.kv_lora_rank], p.kv_norm.scale, cfg.norm_eps)
    k_rope = rope(dkv[..., None, cfg.kv_lora_rank:], pos, cfg.rope_theta)
    return c_kv, k_rope[..., 0, :]


def _mla_q(p: MLA, x, pos, cfg):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope) after rope)."""
    cq = rmsnorm(p.w_dq(x), p.q_norm.scale, cfg.norm_eps)
    q = p.w_uq(cq)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, rope(q_rope, pos, cfg.rope_theta)


def mla_forward(p: MLA, x, pos, cfg):
    """Full-sequence causal MLA.  x: (B, S, D); pos: (B, S).  Returns (out
    (B, S, D), c_kv, k_rope) for the prefill cache.  Under ``"tp"`` the
    up-projections and ``wo`` hold the rank's heads (the compressed KV
    is every rank's whole), and ``out`` is a share of the sum."""
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, pos, cfg)
    c_kv, k_rope = _mla_kv(p, x, pos, cfg)
    k_nope = p.w_uk(c_kv)  # (B, S, H, nope): the rank's heads under "tp"
    v = p.w_uv(c_kv)       # (B, S, H, v_head_dim)
    H = k_nope.shape[2]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H,
                                                     cfg.qk_rope_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = blocked_attention(q, k, v, causal=True,
                            scale=(cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5,
                            q_block=cfg.attn_q_block,
                            kv_block=cfg.attn_kv_block,
                            block_skip=cfg.attn_block_skip,
                            p_bf16=cfg.attn_p_bf16)
    y = torch.einsum("bshd,hdo->bso", out, p.wo.w.to(x.dtype))
    return y, c_kv, k_rope


def mla_decode(p: MLA, x, cache_c, cache_kr, cache_len: int, cfg):
    """Absorbed MLA decode: scores and context in the compressed space.
    x: (B, 1, D); cache_c: (B, Smax, kv_lora); cache_kr: (B, Smax, rope).
    Returns (out, new_c, new_kr); the cache update is as in
    :func:`gqa_decode`."""
    B = x.shape[0]
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope = (t[:, 0] for t in _mla_q(p, x, pos, cfg))  # (B, H, .)
    c_new, kr_new = _mla_kv(p, x, pos, cfg)                     # (B, 1, .)
    ba = shd.batch_axes() or None
    cache_c = shd.constrain(cache_c, ba, "model", None)
    cache_kr = shd.constrain(cache_kr, ba, "model", None)
    (cc, off, split, wrap), (ckr, _, _, _) = seq_block(cache_c), seq_block(
        cache_kr)
    Sl = cc.shape[1]
    if cfg.decode_dus:
        if off <= cache_len < off + Sl:
            cc[:, cache_len - off:cache_len - off + 1] = c_new.to(cc.dtype)
            ckr[:, cache_len - off:cache_len - off + 1] = kr_new.to(ckr.dtype)
    else:
        onehot = (torch.arange(off, off + Sl, device=x.device) == cache_len
                  ).to(cc.dtype)[None, :, None]
        cc = cc * (1 - onehot) + c_new * onehot
        ckr = ckr * (1 - onehot) + kr_new * onehot
    # absorb w_uk into q: q' = q_nope @ w_uk^T -> (B, H, kv_lora); the
    # rank's heads under "tp", every head gathered for the cache's block
    qc = torch.einsum("bhn,rhn->bhr", q_nope, p.w_uk.w.to(x.dtype))
    n_q = qc.shape[1]
    if n_q < cfg.num_heads:
        qq = all_heads(torch.cat([qc, q_rope], -1), cfg, 1)
        qc, q_rope = qq[..., :qc.shape[-1]], qq[..., qc.shape[-1]:]
    s = torch.einsum("bhr,bsr->bhs", qc.float(), cc.float())
    s = s + torch.einsum("bhe,bse->bhs", q_rope.float(), ckr.float())
    s = s * (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    valid = torch.arange(off, off + Sl, device=x.device) <= cache_len
    s = torch.where(valid, s, NEG_INF)
    ctx = attend(s, lambda pr: torch.einsum("bhs,bsr->bhr", pr, cc.float()),
                 split)
    ctx = own_heads(ctx, n_q, cfg, 1)
    v = torch.einsum("bhr,rhv->bhv", ctx.to(x.dtype), p.w_uv.w.to(x.dtype))
    y = torch.einsum("bhv,hvo->bo", v, p.wo.w.to(x.dtype))
    return y[:, None], wrap(cc), wrap(ckr)
