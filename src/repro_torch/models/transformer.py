"""Transformer sublayers: init, full-sequence apply, KV cache, decode.

Port of ``repro.models.transformer`` for the kind the port builds:
``"attn"``, a pre-norm residual block of GQA self-attention and an FFN,
a SwiGLU MLP or, when ``cfg.moe`` and the layer uses it, the MoE block
(``models/moe.py``).  Its cache is ``{"k", "v"}``, each (B, Smax, KVH,
hd) in the compute dtype.  The other kinds (``local_attn``,
``cross_attn``, ``rglru``, ``ssd``) and MLA raise
``NotImplementedError`` naming the ROADMAP item they wait for.

Functions take the block module ``p`` where the reference takes its
parameter subtree, and return what the reference returns.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import MLP, RMSNorm, mlp, rmsnorm

_WAITING = {
    "local_attn": "local attention (ROADMAP queue 1 item 12)",
    "cross_attn": "cross attention and the encoder (ROADMAP queue 1 item 12)",
    "rglru": "the RG-LRU block (ROADMAP queue 1 item 12, ssm.py)",
    "ssd": "the Mamba-2 SSD block (ROADMAP queue 1 item 12, ssm.py)",
}


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_ported(kind, cfg) -> None:
    """Raise ``NotImplementedError`` unless the port builds this
    sublayer: kind "attn" with GQA."""
    if kind in _WAITING:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet: "
                                  f"{_WAITING[kind]}")
    if kind != "attn":
        raise ValueError(kind)
    if cfg.mla:
        raise NotImplementedError("MLA attention is not ported yet (ROADMAP "
                                  "queue 1 item 12)")


# ---------------------------------------------------------------------------
# sublayer init / apply
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """norm1, mixer (GQA), norm2, ffn (SwiGLU MLP, or MoE when
    ``cfg.moe and use_moe``)."""

    def __init__(self, kind, cfg, *, generator, device=None, use_moe=True):
        super().__init__()
        check_ported(kind, cfg)
        device = device or generator.device
        dt = _dtype(cfg)
        D = cfg.d_model
        kw = dict(generator=generator, device=device)
        self.kind = kind
        self.use_moe = use_moe
        self.norm1 = RMSNorm(D, dt, device=device)
        self.mixer = attn.gqa_init(cfg, dt, **kw)
        self.norm2 = RMSNorm(D, dt, device=device)
        self.ffn = (moe_mod.moe_init(cfg, dt, **kw) if cfg.moe and use_moe
                    else MLP(D, cfg.d_ff, dt, **kw))


def sublayer_init(kind, cfg, *, generator, device=None, use_moe=True):
    return Block(kind, cfg, generator=generator, device=device,
                 use_moe=use_moe)


def _ffn_apply(p: Block, x, cfg):
    """The block's FFN on x: (y, MoE aux loss or 0.0)."""
    if cfg.moe and p.use_moe:
        return moe_mod.moe_block(p.ffn, x, cfg)
    return mlp(p.ffn, x), 0.0


def sublayer_apply(p: Block, kind, x, pos, cfg, *, cache=None):
    """Full-sequence causal forward.  Returns (x, aux, cache): ``aux`` is
    the MoE load-balance loss (0.0 for a dense FFN); ``cache`` is the
    populated prefill cache when a (zeroed) cache is passed, else
    None."""
    h = rmsnorm(x, p.norm1.scale, cfg.norm_eps)
    y, k, v = attn.gqa_forward(p.mixer, h, pos, cfg)
    if cache is not None:
        cache = sublayer_prefill_cache(cache, k, v)
    x = x + y
    h2 = rmsnorm(x, p.norm2.scale, cfg.norm_eps)
    y2, aux = _ffn_apply(p, h2, cfg)
    return x + y2, aux, cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def sublayer_cache(kind, cfg, batch, smax):
    """{name: (shape, dtype)} of one sublayer's cache."""
    check_ported(kind, cfg)
    shape = (batch, smax, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": (shape, _cdtype(cfg)), "v": (shape, _cdtype(cfg))}


# ---------------------------------------------------------------------------
# decode-step sublayer
# ---------------------------------------------------------------------------

def sublayer_decode(p: Block, kind, x, cache, cache_len, cfg):
    """One token through the sublayer.  Returns (x, cache, aux)."""
    h = rmsnorm(x, p.norm1.scale, cfg.norm_eps)
    y, ck, cv = attn.gqa_decode(p.mixer, h, cache["k"], cache["v"],
                                cache_len, cfg)
    cache = dict(cache, k=ck, v=cv)
    x = x + y
    h2 = rmsnorm(x, p.norm2.scale, cfg.norm_eps)
    y2, aux = _ffn_apply(p, h2, cfg)
    return x + y2, cache, aux


# ---------------------------------------------------------------------------
# prefill-time cache population
# ---------------------------------------------------------------------------

def sublayer_prefill_cache(cache, k, v):
    """Populate a zeroed cache from the full prompt's K/V (after rope),
    as the forward computed them.  The reference projects them a second
    time here and leaves XLA to merge the two; eager torch would run
    both, so the forward hands its own over."""
    return dict(cache, k=_write_prefix(cache["k"], k),
                v=_write_prefix(cache["v"], v))


def _write_prefix(buf, val):
    """Write ``val`` into the first positions of ``buf``, in place."""
    buf[:, :val.shape[1]] = val.to(buf.dtype)
    return buf
