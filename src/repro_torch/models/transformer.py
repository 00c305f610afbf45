"""Transformer sublayers: init, full-sequence apply, cache, decode.

Port of ``repro.models.transformer``:

  attn        pre-norm residual block of self-attention (GQA, or MLA when
              ``cfg.mla``) and an FFN: a SwiGLU MLP or, when ``cfg.moe``
              and the layer uses it, the MoE block (``models/moe.py``)
  local_attn  the same with sliding-window GQA over ``cfg.local_window``
              keys, decoded from a ring buffer of that many slots
  cross_attn  the attn block with cross attention to the encoder's
              states between self-attention and the FFN:
              x + xattn(normx(x), enc)
  rglru       the RG-LRU recurrent block (``models/ssm.py``) and an FFN
  ssd         the Mamba-2 SSD block alone (no norm2, no FFN)

Cache entries per kind (compute dtype unless named):

  attn        k, v: (B, Smax, KVH, hd); MLA: c (B, Smax, kv_lora),
              kr (B, Smax, rope)
  cross_attn  as attn, and the encoder's enc_k, enc_v: (B, Senc, KVH, hd)
  local_attn  k, v: (B, W, KVH, hd) ring, slot_pos (B, W) int32
  rglru       h (B, w) float32, conv (B, cw-1, w)
  ssd         h (B, H, P, N) float32, conv (B, cw-1, conv_ch)

Functions take the block module ``p`` where the reference takes its
parameter subtree, and return what the reference returns.

On a mesh (``distributed/sharding.py``) a cache of DTensors
(``launch.steps.cache_shardings``) is read and written in local form:
each rank writes the prompt positions (or ring slots) of its block of
the sequence dim.  The recurrent blocks' state is split over the model
axis along its width: under ``"sp"`` it is all-gathered for the step
and cut back to the rank's block after it; under ``"tp"`` the rank's
recurrent block runs its own channels, and the state stays split.

Under ``layer_layout="tp"`` (the reference's Megatron-SP) ``x`` is the
residual's block of the sequence (``sharding.residual_len``): each
sublayer norms its block, all-gathers the sequence, runs its mixer and
FFN on the rank's weight shards and reduce-scatters their partial sums
back onto the block (``sharding.seq_gather``, ``seq_scatter``); the
MoE block routes the block's tokens.  A prefill whose K/V are the
rank's heads moves them to the cache's sequence blocks in one
all_to_all (``sharding.heads_to_seq``), which is where the reference's
``prefill_cache_seqshard`` pins them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import MLP, RMSNorm, mlp, rmsnorm, rope

KINDS = ("attn", "local_attn", "cross_attn", "rglru", "ssd")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_kind(kind) -> None:
    """Raise ``ValueError`` for an unknown layer kind."""
    if kind not in KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# sublayer init / apply
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """norm1 and the kind's mixer; for ``cross_attn`` normx and xattn
    (GQA) too; but for ``ssd``, norm2 and an ffn (SwiGLU MLP, or MoE when
    ``cfg.moe and use_moe``)."""

    def __init__(self, kind, cfg, *, generator, device=None, use_moe=True):
        super().__init__()
        check_kind(kind)
        device = device or generator.device
        dt = _dtype(cfg)
        D = cfg.d_model
        kw = dict(generator=generator, device=device)
        self.kind = kind
        self.use_moe = use_moe
        self.norm1 = RMSNorm(D, dt, device=device)
        if kind == "ssd":
            self.mixer = ssm.ssd_init(cfg, dt, **kw)
            return
        if kind == "rglru":
            self.mixer = ssm.rglru_init(cfg, dt, **kw)
        elif cfg.mla:
            self.mixer = attn.mla_init(cfg, dt, **kw)
        else:
            self.mixer = attn.gqa_init(cfg, dt, **kw)
        if kind == "cross_attn":
            self.normx = RMSNorm(D, dt, device=device)
            self.xattn = attn.gqa_init(cfg, dt, **kw)
        self.norm2 = RMSNorm(D, dt, device=device)
        self.ffn = (moe_mod.moe_init(cfg, dt, **kw) if cfg.moe and use_moe
                    else MLP(D, cfg.d_ff, dt, **kw))


def sublayer_init(kind, cfg, *, generator, device=None, use_moe=True):
    return Block(kind, cfg, generator=generator, device=device,
                 use_moe=use_moe)


def _ffn_apply(p: Block, x, cfg, seq):
    """The block's FFN on x, the residual's block of a sequence of
    ``seq`` positions: (y on that block, MoE aux loss or 0.0)."""
    if cfg.moe and p.use_moe:
        return moe_mod.moe_block(p.ffn, x, cfg, seq=seq)
    return mlp(p.ffn, x, seq), 0.0


def _with_ffn(p: Block, x, cfg, seq):
    """x + FFN(norm2(x)), and the FFN's aux loss."""
    y, aux = _ffn_apply(p, rmsnorm(x, p.norm2.scale, cfg.norm_eps), cfg,
                        seq)
    return x + y, aux


def _mixer_partial(p: Block, kind, cfg) -> bool:
    """Whether the mixer's output is the rank's share of a sum over the
    model axis (its output projection row-parallel, ``"tp"``)."""
    if kind in ("rglru", "ssd"):
        return ssm.out_partial(p.mixer, kind, cfg)
    return attn.out_partial(p.mixer, cfg)


def sublayer_apply(p: Block, kind, x, pos, cfg, *, enc=None, causal=True,
                   cache=None):
    """Full-sequence forward, its self-attention causal unless ``causal``
    is False (the encoder's).  ``enc`` (B, Senc, D): the encoder's
    states, which a ``cross_attn`` layer attends.  Returns (x, aux,
    cache): ``aux`` is the MoE load-balance loss (0.0 for a dense FFN);
    ``cache`` is the populated prefill cache when a (zeroed) cache is
    passed, else None.  ``x`` is the residual's block of the ``pos``
    sequence under ``"tp"`` (module docstring)."""
    S, s = pos.shape[1], x.shape[1]
    h = shd.seq_gather(rmsnorm(x, p.norm1.scale, cfg.norm_eps), S)
    if kind == "ssd":
        y, hstate, conv_tail = ssm.ssd_forward(p.mixer, h, cfg)
        if cache is not None:
            cache = _recurrent_cache(cache, hstate, conv_tail, cfg)
        return x + shd.seq_scatter(y, s, _mixer_partial(p, kind, cfg)), \
            0.0, cache
    if kind == "rglru":
        y, hstate, conv_tail = ssm.rglru_forward(p.mixer, h, cfg)
        if cache is not None:
            cache = _recurrent_cache(cache, hstate, conv_tail, cfg)
    elif cfg.mla:
        y, c_kv, kr = attn.mla_forward(p.mixer, h, pos, cfg)
        if cache is not None:
            cache = dict(cache, c=_write_prefix(cache["c"], c_kv),
                         kr=_write_prefix(cache["kr"], kr))
    else:
        window = cfg.local_window if kind == "local_attn" else 0
        y, k, v = attn.gqa_forward(p.mixer, h, pos, cfg, causal=causal,
                                   window=window)
        if cache is not None:
            cache = (_ring_prefill(cache, *attn.all_kv_heads(k, v, cfg),
                                   pos, window) if window
                     else _prefill_kv(cache, k, v, cfg))
    x = x + shd.seq_scatter(y, s, _mixer_partial(p, kind, cfg))
    if kind == "cross_attn":
        hx = shd.seq_gather(rmsnorm(x, p.normx.scale, cfg.norm_eps), S)
        # without enc the reference attends hx itself, with rope, through
        # xattn; the model refuses that case (model.forward)
        yx, ek, ev = attn.gqa_forward(p.xattn, hx, pos, cfg, kv_override=enc)
        if cache is not None and enc is not None:
            # the entries are replaced, as the reference's are, whatever
            # enc_len the cache was made with
            dt = cache["enc_k"].dtype
            cache = dict(cache, **{
                n: _kv_to_cache(t.to(dt), cache[n], cfg)
                for n, t in (("enc_k", ek), ("enc_v", ev))})
        x = x + shd.seq_scatter(yx, s, attn.out_partial(p.xattn, cfg))
    x, aux = _with_ffn(p, x, cfg, S)
    return x, aux, cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def sublayer_cache(kind, cfg, batch, smax, enc_len=0):
    """{name: (shape, dtype)} of one sublayer's cache; a ``cross_attn``
    layer's holds ``enc_len`` encoder positions."""
    check_kind(kind)
    dt = _cdtype(cfg)
    D = cfg.d_model
    KVH, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if kind in ("attn", "cross_attn", "local_attn"):
        if cfg.mla and kind != "local_attn":
            c = {"c": ((batch, smax, cfg.kv_lora_rank), dt),
                 "kr": ((batch, smax, cfg.qk_rope_dim), dt)}
        else:
            W = cfg.local_window if kind == "local_attn" else smax
            c = {"k": ((batch, W, KVH, hd), dt),
                 "v": ((batch, W, KVH, hd), dt)}
        if kind == "local_attn":
            c["slot_pos"] = ((batch, W), torch.int32)
        if kind == "cross_attn":
            c["enc_k"] = c["enc_v"] = ((batch, enc_len, KVH, hd), dt)
        return c
    if kind == "rglru":
        w = cfg.rnn_width or D
        return {"h": ((batch, w), torch.float32),
                "conv": ((batch, cfg.conv_width - 1, w), dt)}
    inner = cfg.ssm_expand * D
    H = inner // cfg.ssm_head_dim
    return {"h": ((batch, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, inner + 2 * cfg.ssm_state),
                     dt)}


# ---------------------------------------------------------------------------
# decode-step sublayer
# ---------------------------------------------------------------------------

def sublayer_decode(p: Block, kind, x, cache, cache_len, cfg):
    """One token through the sublayer.  Returns (x, cache, aux).  ``x``
    (B, 1, D) is whole on every rank of the model axis; under ``"tp"``
    the mixer's and FFN's partial sums are all-reduced over it."""
    h = rmsnorm(x, p.norm1.scale, cfg.norm_eps)
    if kind in ("rglru", "ssd"):
        step = ssm.rglru_decode if kind == "rglru" else ssm.ssd_decode
        own = shd.tp(cfg)  # the rank's channels: the state stays split
        y, hs, conv = step(p.mixer, h, shd.from_cache(cache["h"], own),
                           shd.from_cache(cache["conv"], own), cfg)
        cache = dict(cache, h=shd.to_cache(hs, cache["h"], own),
                     conv=shd.to_cache(conv, cache["conv"], own))
    elif kind == "local_attn":
        y, cache = _local_ring_decode(p.mixer, h, cache, cache_len, cfg)
    elif cfg.mla:
        y, c, kr = attn.mla_decode(p.mixer, h, cache["c"], cache["kr"],
                                   cache_len, cfg)
        cache = dict(cache, c=c, kr=kr)
    else:
        y, ck, cv = attn.gqa_decode(p.mixer, h, cache["k"], cache["v"],
                                    cache_len, cfg)
        cache = dict(cache, k=ck, v=cv)
    x = x + shd.seq_scatter(y, 1, _mixer_partial(p, kind, cfg))
    if kind == "ssd":
        return x, cache, 0.0
    if kind == "cross_attn":
        hx = rmsnorm(x, p.normx.scale, cfg.norm_eps)
        x = x + shd.seq_scatter(
            _cross_decode(p.xattn, hx, cache["enc_k"], cache["enc_v"], cfg),
            1, attn.out_partial(p.xattn, cfg))
    x, aux = _with_ffn(p, x, cfg, 1)
    return x, cache, aux


def _cross_decode(p: attn.GQA, x, enc_k, enc_v, cfg):
    """One token's cross attention to the encoder's cached K/V (B, Senc,
    KVH, hd): no rope, float32 scores and softmax over every encoder
    position, no mask."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = p.wq(x)  # (B, 1, H, hd): the rank's heads under "tp"
    n_q = q.shape[2]
    q = attn.all_heads(q, cfg)
    (ek, _, split, _), (ev, _, _, _) = (attn.seq_block(enc_k),
                                        attn.seq_block(enc_v))
    KVH = ek.shape[2]
    G = cfg.num_heads // KVH
    qg = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), ek.float()) * hd ** -0.5
    out = attn.attend(s, lambda pr: torch.einsum("bkgs,bskd->bkgd", pr,
                                                 ev.float()), split)
    out = attn.own_heads(out.reshape(B, 1, cfg.num_heads, hd), n_q, cfg)
    return torch.einsum("bshd,hdo->bso", out.to(x.dtype), p.wo.w.to(x.dtype))


def _local_ring_decode(p: attn.GQA, x, cache, cache_len: int, cfg):
    """Sliding-window decode with a ring buffer of ``local_window`` slots:
    the new token's K/V go to slot ``cache_len % W`` (a one-hot blend, as
    in the reference), and a slot is attended while its position lies in
    the window."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    W = cfg.local_window
    dev = x.device
    pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=dev)
    q = rope(p.wq(x), pos, cfg.rope_theta)
    k_new = rope(p.wk(x), pos, cfg.rope_theta)
    v_new = p.wv(x)
    n_q = q.shape[2]  # the rank's query heads (``"tp"``: a block)
    q = attn.all_heads(q, cfg)
    k_new, v_new = attn.all_kv_heads(k_new, v_new, cfg)
    (ck, off, split, wrap), (cv, _, _, wv), (sp, _, _, ws) = (
        attn.seq_block(cache["k"]), attn.seq_block(cache["v"]),
        attn.seq_block(cache["slot_pos"]))
    Wl = ck.shape[1]  # this block's slots: off, ..., off + Wl - 1
    hot = torch.arange(off, off + Wl, device=dev) == cache_len % W
    dt = ck.dtype
    onehot = hot.to(dt)[None, :, None, None]
    ck = ck * (1 - onehot) + k_new.to(dt) * onehot
    cv = cv * (1 - onehot) + v_new.to(dt) * onehot
    ihot = hot.to(torch.int32)[None]
    spos = sp * (1 - ihot) + cache_len * ihot
    valid = (spos <= cache_len) & (spos > cache_len - W)
    KVH = ck.shape[2]
    G = cfg.num_heads // KVH
    qg = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), ck.float()) * hd ** -0.5
    s = torch.where(valid[:, None, None], s, attn.NEG_INF)
    out = attn.attend(s, lambda pr: torch.einsum("bkgs,bskd->bkgd", pr,
                                                 cv.float()), split)
    out = attn.own_heads(out.reshape(B, 1, cfg.num_heads, hd), n_q, cfg)
    y = torch.einsum("bshd,hdo->bso", out.to(x.dtype), p.wo.w.to(x.dtype))
    return y, dict(cache, k=wrap(ck), v=wv(cv), slot_pos=ws(spos))


# ---------------------------------------------------------------------------
# prefill-time cache population
# ---------------------------------------------------------------------------

def _prefill_kv(cache, k, v, cfg):
    """An attention cache after the prompt's K/V (B, S, KVl, hd): when
    they hold the rank's block of heads and the cache's positions split
    over the model axis (``"tp"``), moved from heads to the cache's
    sequence blocks in one all_to_all (the prompt padded to the cache's
    length: ``sharding.heads_to_seq``), each rank writing its block;
    else :func:`sublayer_prefill_cache` with every head."""
    if k.shape[2] == cfg.num_kv_heads or not attn.seq_block(cache["k"])[2]:
        return sublayer_prefill_cache(cache, *attn.all_kv_heads(k, v, cfg))
    S, smax = k.shape[1], cache["k"].shape[1]
    kv = torch.stack([k, v]).flatten(0, 1)
    kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, smax - S))
    kv = shd.heads_to_seq(kv).unflatten(0, (2, -1))
    return dict(cache, k=_write_prefix(cache["k"], kv[0], S),
                v=_write_prefix(cache["v"], kv[1], S))


def _kv_to_cache(val, like, cfg):
    """``val`` (B, L, KVl, hd), the encoder's K/V as projected, as the
    cross-attention cache entry ``like`` (every head at the rank's block
    of positions)."""
    if val.shape[2] == cfg.num_kv_heads:
        return shd.to_cache(val, like)
    _, _, split, _ = attn.seq_block(like)
    if split:
        return shd.to_cache(shd.heads_to_seq(val), like, block=True)
    return shd.to_cache(attn.all_heads(val, cfg, 2, cfg.num_kv_heads), like)


def sublayer_prefill_cache(cache, k, v):
    """Populate a zeroed cache from the full prompt's K/V (after rope),
    as the forward computed them.  The reference projects them a second
    time here and leaves XLA to merge the two; eager torch would run
    both, so the forward hands its own over."""
    return dict(cache, k=_write_prefix(cache["k"], k),
                v=_write_prefix(cache["v"], v))


def _ring_prefill(cache, k, v, pos, W):
    """A local-attention ring after the prompt, in place: the last
    min(W, S) positions' K/V in their slots (position % W), their
    positions in ``slot_pos``, -10**9 (never in a window) elsewhere.  A
    rank of a mesh writes the slots of its block.  The prompt's
    positions are 0 .. S - 1 (``pos`` of the prefill), so which of them
    land in the rank's slots is worked out on the host: the device is
    not read (a boolean mask would be), and a traced run on ``meta``
    tensors gets the same writes."""
    S = k.shape[1]
    take = min(W, S)
    blocks = {n: attn.seq_block(cache[n]) for n in ("k", "v", "slot_pos")}
    local, off, _, _ = blocks["k"]
    last = torch.arange(S - take, S)
    slots = last % W
    mine = torch.nonzero((slots >= off) & (slots < off + local.shape[1]))[:, 0]
    dst = (slots[mine] - off).to(k.device)
    src = last[mine].to(k.device)
    for name, val in (("k", k), ("v", v)):
        buf = blocks[name][0]
        buf.zero_()
        buf[:, dst] = val[:, src].to(buf.dtype)
    sp = blocks["slot_pos"][0]
    sp.fill_(-10**9)
    sp[:, dst] = pos[0, src].to(torch.int32)
    return cache


def _recurrent_cache(cache, hstate, conv_tail, cfg):
    """A recurrent block's cache after the prompt: its final state and
    the last cw - 1 inputs of its conv (under ``"tp"`` the rank's
    channels: its block of the cache)."""
    own = shd.tp(cfg)
    return dict(cache, h=shd.to_cache(hstate, cache["h"], own),
                conv=shd.to_cache(conv_tail.to(cache["conv"].dtype),
                                  cache["conv"], own))


def _write_prefix(buf, val, length=None):
    """Write ``val``, the prompt's entries, into the first positions of
    ``buf``, in place; a rank of a mesh writes the positions of its
    block.  With ``length`` ``val`` is already the rank's block of the
    cache's positions, of a prompt of ``length``."""
    local, off, split, _ = attn.seq_block(buf)
    if length is not None:
        n = max(0, min(length - off, local.shape[1]))
        local[:, :n] = val[:, :n].to(local.dtype)
        return buf
    n = (max(0, min(val.shape[1] - off, local.shape[1])) if split
         else val.shape[1])
    local[:, :n] = val[:, off:off + n].to(local.dtype)
    return buf
