"""Model assembly: init / forward / prefill / decode.

Port of ``repro.models.model``.  The reference's stacked parameter
groups ``g{j}/s{k}`` (repeat dim leading, run with ``lax.scan``) become
one ``ModuleList`` of per-layer blocks, run in a Python loop in the same
order (each group's repeats in turn, each repeat's pattern in turn); the
leading ``first_k_dense`` units come first.  Module paths mirror the
reference's parameter paths:

  embed.w              (V, D)
  encoder.{i}.…        the encoder's blocks (whisper; ``enc_g/s0``)
  enc_norm.scale
  layers.{i}.…         one block per layer (models/transformer.py)
  norm.scale
  lm_head.w            (D, V)

A model with ``cross_attn`` layers attends ``enc_inp`` (B, Senc, D), the
stub frontend's embeddings: through the encoder (``cfg.encoder_layers``
bidirectional ``attn`` blocks over the embeddings plus a sinusoid, then
``enc_norm``) when the config has one, else as they are (the vision
backbone's patch embeddings).  Called without ``enc_inp`` it raises
``ValueError``, where the reference runs a second self-attention through
the cross-attention weights in the forward and attends a zero cache in
decode.  ``pos_emb="sinusoid"`` adds the sinusoid embedding of each
position to the decoder's token embeddings, as it does to the
encoder's.

A block's FFN is the MoE block (``models/moe.py``) when ``cfg.moe`` and
the layer is not one of the leading dense units; ``forward`` sums the
MoE load-balance losses into ``aux`` as the reference does.  The
layers of every group run in order, a tail group (RecurrentGemma's
trailing recurrent pair) after the body.  The cache is a list with one
dict per layer, each kind's entries in their own dtypes
(``transformer.sublayer_cache``: float32 recurrent state, int32 ring
positions).  prefill, decode_step and init_cache run under
``torch.inference_mode()``; ``forward`` runs under whatever mode its
caller set, so that ``loss_fn`` trains through it.

Training: ``loss_fn`` is the reference's, cross-entropy (chunked over
the sequence when ``cfg.ce_chunk``, each chunk's head and loss
recomputed in the backward) plus ``AUX_LOSS_COEF`` times the MoE aux
loss.  ``cfg.remat == "block"`` wraps each decoder layer in one
``torch.utils.checkpoint`` (non-reentrant), where the reference wraps
each scanned unit in ``jax.checkpoint``: the backward recomputes a
layer's forward from its input.  A model trains with
``attn_impl="xla"``: K6 has no backward pass and raises under autograd
(``kernels/flash_attention.py``).

On a mesh (``distributed/sharding.py``; parameters placed by
``sharding.shard_model``) the functions take the batch inputs as the
global batch (a plain tensor, the same on every rank) or as DTensors,
run each rank's block of it (``sharding.local_batch``), read each
layer's weights in the layout ``cfg.layer_layout`` names (``"tp"``: the
rank's model shard; ``"sp"``: gathered on use; ``sharding.gathered``),
and return the logits as a DTensor placed by the batch rule (under
``"tp"`` split by vocabulary over the model axis;
``sharding.vocab_argmax`` picks a token from it); ``loss_fn``'s loss is
the global batch's, the same on every rank.  Under ``"tp"`` the
residual between the embedding and the final norm is each rank's block
of the sequence (``sharding.residual_len``), the embedding's partial
lookup reduce-scattered onto it and the final norm's output all-gathered
for the vocab-parallel head.  ``prefill`` and ``decode_step`` take the
cache as DTensors placed by ``launch.steps.cache_shardings`` (a plain
cache is placed so first) and return it so.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (Dense, Embed, RMSNorm, cross_entropy,
                                       embed_lookup, logits_head, rmsnorm)

AUX_LOSS_COEF = 0.01


def _groups(cfg):
    """[(name, pattern, reps), ...] for the decoder stack (reps None for
    an unscanned lead unit)."""
    out = []
    for i in range(cfg.first_k_dense):
        out.append((f"lead{i}", cfg.group_pattern, None))
    for gi, (pattern, reps) in enumerate(cfg.groups):
        out.append((f"g{gi}", pattern, reps))
    return out


def _sinusoid(pos, d, dtype):
    """Sinusoid position embedding (..., d) of positions ``pos`` (...):
    sin then cos of pos * 10000 ** (-i / (d // 2)), computed op for op as
    the reference computes it, in float32, then cast to ``dtype``."""
    half = d // 2
    lg = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    freq = torch.exp(-lg.to(pos.device) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / half)
    ang = pos[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def layer_kinds(cfg):
    """[(kind, use_moe), ...], one per layer, in execution order."""
    out = []
    for name, pattern, reps in _groups(cfg):
        for _ in range(reps or 1):
            out.extend((kind, not name.startswith("lead")) for kind in pattern)
    return out


class Model(nn.Module):
    """A model of ported sublayers (see module docstring)."""

    def __init__(self, cfg, *, generator: torch.Generator, device=None):
        super().__init__()
        device = device or generator.device
        dt = getattr(torch, cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dt, **kw)
        self.norm = RMSNorm(cfg.d_model, dt, device=device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dt, **kw)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(
                tf.sublayer_init("attn", cfg, use_moe=False, **kw)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = RMSNorm(cfg.d_model, dt, device=device)
        self.layers = nn.ModuleList(
            tf.sublayer_init(kind, cfg, use_moe=use_moe, **kw)
            for kind, use_moe in layer_kinds(cfg))


def _weights(cfg, *modules):
    """``sharding.gathered`` over ``modules`` in ``cfg``'s layout."""
    return shd.gathered(*modules, keep=shd.weight_keep(cfg))


def _vocab_offset(params: Model, cfg):
    """Where the rank's block of the vocabulary starts when the head is
    split by it (``"tp"``), else None; within :func:`_weights` of
    ``lm_head``."""
    n = params.lm_head.w.shape[1]
    return shd.block_offset(n, cfg.vocab_size) if n < cfg.vocab_size \
        else None


def _embed(params: Model, cfg, tokens, s: int):
    """The embedding of ``tokens`` (B, S), the residual's block of ``s``
    positions: under ``"tp"`` each rank looks up its block of the
    vocabulary and the partial rows are reduce-scattered onto the block
    (all-reduced when it holds every position)."""
    with _weights(cfg, params.embed):
        x = embed_lookup(params.embed, tokens, getattr(torch, cfg.dtype),
                         cfg.vocab_size)
        split = params.embed.w.shape[0] < cfg.vocab_size
    return shd.seq_scatter(x, s, split)


def init_params(cfg, generator: torch.Generator, device=None) -> Model:
    """A model with random weights drawn from ``generator`` (on its
    device), stored on ``device`` (default: the generator's)."""
    return Model(cfg, generator=generator, device=device)


def _encode(params: Model, cfg, enc_inp):
    """The whisper encoder over stub frame embeddings (B, Senc, D): cast
    to the compute dtype, plus the sinusoid (in that dtype), the
    bidirectional ``attn`` blocks, ``enc_norm``."""
    x = enc_inp.to(getattr(torch, cfg.dtype))
    B, S = x.shape[:2]
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    x = shd.seq_part(x + _sinusoid(pos, cfg.d_model, x.dtype),
                     shd.residual_len(S, cfg))
    for blk in params.encoder:
        with _weights(cfg, blk):
            x, _, _ = tf.sublayer_apply(blk, "attn", x, pos, cfg,
                                        causal=False)
    with _weights(cfg, params.enc_norm):
        return shd.seq_gather(rmsnorm(x, params.enc_norm.scale,
                                      cfg.norm_eps), S)


def forward(params: Model, cfg, tokens, *, enc_inp=None, cache=None,
            return_hidden=False):
    """The model over ``tokens`` (see :func:`_forward`); on a mesh the
    batch inputs are the global batch or DTensors, and the logits (or
    hidden states) come back as a DTensor of the global batch."""
    B = tokens.shape[0]
    # "sp" without a cache: the model axis splits rows too
    rows = cache is None and not shd.tp(cfg)
    out, aux, cache = _forward(params, cfg, shd.local_batch(tokens, rows),
                               enc_inp=shd.local_batch(enc_inp, rows),
                               cache=_placed(cache),
                               return_hidden=return_hidden)
    split = not return_hidden and out.shape[-1] < cfg.vocab_size
    return shd.from_local_batch(out, B, split), aux, cache


def _placed(cache):
    """On a mesh, a plain cache placed by the cache rules."""
    if cache is None or shd.get_mesh() is None or all(
            shd.is_dtensor(t) for c in cache for t in c.values()):
        return cache
    from repro_torch.launch.steps import place_cache
    return place_cache(cache)


def _forward(params: Model, cfg, tokens, *, enc_inp=None, cache=None,
             return_hidden=False):
    """Full-sequence forward.  tokens: (B, S) int; ``enc_inp`` (B, Senc,
    D): the frontend's embeddings, which a model with ``cross_attn``
    layers needs.  Returns (logits (B, S, V), aux, cache-or-None), or
    the final normed hidden states (B, S, D) in place of the logits with
    ``return_hidden``; with a zeroed ``cache`` each layer's prefill
    state (K/V, ring, recurrent state, the encoder's K/V) is written
    into it.  Under ``cfg.remat == "block"`` with autograd recording and
    no cache, each decoder layer runs in one ``torch.utils.checkpoint``.
    Under ``"tp"`` the logits are the rank's block of the vocabulary."""
    cdt = getattr(torch, cfg.dtype)
    B, S = tokens.shape
    s = shd.residual_len(S, cfg)
    x = _embed(params, cfg, tokens, s)
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    if cfg.pos_emb == "sinusoid":
        x = x + _sinusoid(shd.seq_part(pos, s), cfg.d_model, cdt)
    enc = None
    if enc_inp is not None:
        enc = (_encode(params, cfg, enc_inp) if cfg.encoder_layers
               else enc_inp.to(cdt))
    elif cfg.encoder_layers or any(kind == "cross_attn"
                                   for kind, _ in layer_kinds(cfg)):
        raise ValueError(f"{cfg.name} attends the frontend's embeddings: "
                         f"pass enc_inp (B, {cfg.num_frontend_tokens}, "
                         f"{cfg.d_model})")
    aux_total = 0.0
    new_cache = [] if cache is not None else None
    remat = (cfg.remat == "block" and cache is None
             and torch.is_grad_enabled())
    for i, layer in enumerate(params.layers):
        if remat:
            x, aux = checkpoint(_layer, layer, x, pos, cfg, enc,
                                use_reentrant=False)
        else:
            with _weights(cfg, layer):
                x, aux, c = tf.sublayer_apply(
                    layer, layer.kind, x, pos, cfg, enc=enc,
                    cache=cache[i] if cache is not None else None)
            if cache is not None:
                new_cache.append(c)
        aux_total += aux
    with _weights(cfg, params.norm, params.lm_head):
        x = shd.seq_gather(rmsnorm(x, params.norm.scale, cfg.norm_eps), S)
        if return_hidden:
            return x, aux_total, new_cache
        return logits_head(params.lm_head, x), aux_total, new_cache


def _layer(layer, x, pos, cfg, enc):
    """One decoder layer without a cache: (x, aux), the unit that
    ``remat="block"`` checkpoints (its weights read again in the
    recompute)."""
    with _weights(cfg, layer):
        x, aux, _ = tf.sublayer_apply(layer, layer.kind, x, pos, cfg,
                                      enc=enc)
    return x, aux


def _chunked_ce(params: Model, cfg, x, labels):
    """Vocab head + cross-entropy in sequence chunks of ``cfg.ce_chunk``:
    the (B, C, V) logits of one chunk (and their float32 softmax temps)
    exist at a time, and the backward recomputes each chunk's logits
    (``torch.utils.checkpoint``) instead of saving them.  Each chunk's
    mean is weighted back by its label count, then the sum divided by the
    total count, in the reference's order."""
    B, S, D = x.shape
    C = min(cfg.ce_chunk, S)
    if S % C:
        raise ValueError(f"sequence {S} is no multiple of ce_chunk {C}")

    def one(x_blk, l_blk):
        n = (l_blk != -1).float().sum()
        with _weights(cfg, params.lm_head):
            ce = cross_entropy(logits_head(params.lm_head, x_blk), l_blk,
                               vocab_offset=_vocab_offset(params, cfg))
        return ce * torch.clamp(n, min=1.0), n

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // C):
        s, n = checkpoint(one, x[:, c * C:(c + 1) * C],
                          labels[:, c * C:(c + 1) * C], use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return _batch_mean(tot, cnt)


def _batch_mean(tot, cnt):
    """tot / cnt over the global batch: on a mesh both are all-reduced
    over every axis first (ranks that hold the same rows add the same
    sums to both, which leaves the ratio and its gradient as they are)."""
    mesh = shd.get_mesh()
    if mesh is not None:
        tot = shd.all_reduce(tot, mesh.mesh_dim_names)
        cnt = shd.all_reduce(cnt, mesh.mesh_dim_names)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params: Model, cfg, batch):
    """batch: {"tokens": (B, S), "labels": (B, S)} integer tensors (plus
    "enc_inp" (B, Senc, D) for a model with cross attention).  Returns
    (loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}), float32
    scalars (on a mesh: the global batch's, on every rank)."""
    rows = not shd.tp(cfg)  # "sp": the model axis splits rows too
    tokens, labels = (shd.local_batch(batch[k], over_model=rows)
                      for k in ("tokens", "labels"))
    enc_inp = shd.local_batch(batch.get("enc_inp"), over_model=rows)
    if cfg.ce_chunk:
        x, aux, _ = _forward(params, cfg, tokens, enc_inp=enc_inp,
                             return_hidden=True)
        loss = _chunked_ce(params, cfg, x, labels)
    else:
        logits, aux, _ = _forward(params, cfg, tokens, enc_inp=enc_inp)
        voff = (shd.block_offset(logits.shape[-1], cfg.vocab_size)
                if logits.shape[-1] < cfg.vocab_size else None)
        loss = cross_entropy(logits, labels, vocab_offset=voff)
        if shd.get_mesh() is not None:
            n = (labels != -1).float().sum()
            loss = _batch_mean(loss * torch.clamp(n, min=1.0), n)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + AUX_LOSS_COEF * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache shapes / prefill / decode
# ---------------------------------------------------------------------------

def cache_shapes(cfg, batch, smax, enc_len=0):
    """[{name: (shape, dtype)}, ...], one per layer; ``enc_len`` encoder
    positions in a ``cross_attn`` layer's."""
    return [tf.sublayer_cache(kind, cfg, batch, smax, enc_len)
            for kind, _ in layer_kinds(cfg)]


@torch.inference_mode()
def init_cache(cfg, batch, smax, device=None, *, enc_len=0):
    return [{n: torch.zeros(shape, dtype=dt, device=device)
             for n, (shape, dt) in c.items()}
            for c in cache_shapes(cfg, batch, smax, enc_len)]


@torch.inference_mode()
def prefill(params: Model, cfg, tokens, cache, *, enc_inp=None):
    """Process the prompt (and ``enc_inp``, see :func:`forward`); returns
    (last-token logits (B, V), populated cache)."""
    logits, _, cache = _forward(params, cfg, shd.local_batch(tokens),
                                enc_inp=shd.local_batch(enc_inp),
                                cache=_placed(cache))
    return shd.from_local_batch(logits[:, -1], tokens.shape[0],
                                logits.shape[-1] < cfg.vocab_size), cache


@torch.inference_mode()
def decode_step(params: Model, cfg, token, cache, cache_len: int):
    """token: (B, 1) at position ``cache_len``.  Returns (logits (B, V),
    new_cache)."""
    cdt = getattr(torch, cfg.dtype)
    B = token.shape[0]
    token, cache = shd.local_batch(token), _placed(cache)
    x = _embed(params, cfg, token, 1)
    if cfg.pos_emb == "sinusoid":
        pos = torch.full(token.shape, cache_len, dtype=torch.int32,
                         device=token.device)
        x = x + _sinusoid(pos, cfg.d_model, cdt)
    new_cache = []
    for layer, c in zip(params.layers, cache):
        with _weights(cfg, layer):
            x, c, _ = tf.sublayer_decode(layer, layer.kind, x, c, cache_len,
                                         cfg)
        new_cache.append(c)
    with _weights(cfg, params.norm, params.lm_head):
        x = rmsnorm(x, params.norm.scale, cfg.norm_eps)
        logits = logits_head(params.lm_head, x)[:, -1]
    return shd.from_local_batch(logits, B,
                                logits.shape[-1] < cfg.vocab_size), new_cache
