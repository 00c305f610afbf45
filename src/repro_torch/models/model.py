"""Model assembly: init / forward / prefill / decode.

Port of ``repro.models.model`` for decoder-only stacks of ported
sublayers.  The reference's stacked parameter groups ``g{j}/s{k}``
(repeat dim leading, run with ``lax.scan``) become one ``ModuleList`` of
per-layer blocks, run in a Python loop in the same order (each group's
repeats in turn, each repeat's pattern in turn); the leading
``first_k_dense`` units come first.  Module paths mirror the reference's
parameter paths:

  embed.w              (V, D)
  layers.{i}.…         one block per layer (models/transformer.py)
  norm.scale
  lm_head.w            (D, V)

A block's FFN is the MoE block (``models/moe.py``) when ``cfg.moe`` and
the layer is not one of the leading dense units; ``forward`` sums the
MoE load-balance losses into ``aux`` as the reference does.  The
layers of every group run in order, a tail group (RecurrentGemma's
trailing recurrent pair) after the body.  The cache is a list with one
dict per layer, each kind's entries in their own dtypes
(``transformer.sublayer_cache``: float32 recurrent state, int32 ring
positions).  forward, prefill and decode run under
``torch.inference_mode()``.  The training
loss (``loss_fn``, the chunked cross-entropy) and the whisper encoder
wait for their slices.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import transformer as tf
from repro_torch.models.layers import (Dense, Embed, RMSNorm, embed_lookup,
                                       logits_head, rmsnorm)


def _groups(cfg):
    """[(name, pattern, reps), ...] for the decoder stack (reps None for
    an unscanned lead unit)."""
    out = []
    for i in range(cfg.first_k_dense):
        out.append((f"lead{i}", cfg.group_pattern, None))
    for gi, (pattern, reps) in enumerate(cfg.groups):
        out.append((f"g{gi}", pattern, reps))
    return out


def layer_kinds(cfg):
    """[(kind, use_moe), ...], one per layer, in execution order."""
    out = []
    for name, pattern, reps in _groups(cfg):
        for _ in range(reps or 1):
            out.extend((kind, not name.startswith("lead")) for kind in pattern)
    return out


class Model(nn.Module):
    """A decoder-only model of ported sublayers (see module docstring)."""

    def __init__(self, cfg, *, generator: torch.Generator, device=None):
        super().__init__()
        if cfg.encoder_layers:
            raise NotImplementedError("the whisper encoder is not ported yet "
                                      "(ROADMAP queue 1 item 9.3)")
        if cfg.pos_emb != "rope":
            raise NotImplementedError(f"pos_emb {cfg.pos_emb!r} is not "
                                      f"ported yet (ROADMAP queue 1 item 9.3)")
        device = device or generator.device
        dt = getattr(torch, cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dt, **kw)
        self.norm = RMSNorm(cfg.d_model, dt, device=device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dt, **kw)
        self.layers = nn.ModuleList(
            tf.sublayer_init(kind, cfg, use_moe=use_moe, **kw)
            for kind, use_moe in layer_kinds(cfg))


def init_params(cfg, generator: torch.Generator, device=None) -> Model:
    """A model with random weights drawn from ``generator`` (on its
    device), stored on ``device`` (default: the generator's)."""
    return Model(cfg, generator=generator, device=device)


@torch.inference_mode()
def forward(params: Model, cfg, tokens, *, cache=None):
    """Full-sequence forward.  tokens: (B, S) int.  Returns (logits
    (B, S, V), aux, cache-or-None); with a zeroed ``cache`` each layer's
    prefill state (K/V, ring, recurrent state) is written into it."""
    cdt = getattr(torch, cfg.dtype)
    B, S = tokens.shape
    x = embed_lookup(params.embed, tokens, cdt)
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    aux_total = 0.0
    new_cache = [] if cache is not None else None
    for i, layer in enumerate(params.layers):
        x, aux, c = tf.sublayer_apply(
            layer, layer.kind, x, pos, cfg,
            cache=cache[i] if cache is not None else None)
        aux_total += aux
        if cache is not None:
            new_cache.append(c)
    x = rmsnorm(x, params.norm.scale, cfg.norm_eps)
    return logits_head(params.lm_head, x), aux_total, new_cache


# ---------------------------------------------------------------------------
# serving: cache shapes / prefill / decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg, batch, smax):
    """[{name: (shape, dtype)}, ...], one per layer."""
    return [tf.sublayer_cache(kind, cfg, batch, smax)
            for kind, _ in layer_kinds(cfg)]


@torch.inference_mode()
def init_cache(cfg, batch, smax, device=None):
    return [{n: torch.zeros(shape, dtype=dt, device=device)
             for n, (shape, dt) in c.items()}
            for c in cache_shapes(cfg, batch, smax)]


@torch.inference_mode()
def prefill(params: Model, cfg, tokens, cache):
    """Process the prompt; returns (last-token logits (B, V), populated
    cache)."""
    logits, _, cache = forward(params, cfg, tokens, cache=cache)
    return logits[:, -1], cache


@torch.inference_mode()
def decode_step(params: Model, cfg, token, cache, cache_len: int):
    """token: (B, 1) at position ``cache_len``.  Returns (logits (B, V),
    new_cache)."""
    x = embed_lookup(params.embed, token, getattr(torch, cfg.dtype))
    new_cache = []
    for layer, c in zip(params.layers, cache):
        x, c, _ = tf.sublayer_decode(layer, layer.kind, x, c, cache_len, cfg)
        new_cache.append(c)
    x = rmsnorm(x, params.norm.scale, cfg.norm_eps)
    return logits_head(params.lm_head, x)[:, -1], new_cache
