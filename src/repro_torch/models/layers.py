"""Elementary layers: plain functions on tensors and the modules that
hold their parameters.

Port of ``repro.models.layers``.  Parameters keep the reference's
layouts and names (a dense weight is ``w`` of shape ``(in, *out)``, its
bias ``b``; a norm's gain is ``scale``; the embedding table ``w`` is
``(V, D)``), so a module's ``state_dict`` keys are the reference's
parameter paths joined with dots.  Initialisers draw from an explicit
``torch.Generator`` on the generator's device and store the result on
``device`` in ``dtype``; every parameter is trainable (serving runs
under ``torch.inference_mode()``).  The reference's activation sharding
constraints have no counterpart: on a mesh the port runs each rank's
block as a plain tensor (``distributed/sharding.py``), which has no
layout to pin.  Under ``layer_layout="tp"`` the MLP, the embedding and
the head run on the rank's weight shards (hidden units, vocabulary
rows) and exchange activations instead (:func:`mlp`,
:func:`embed_lookup`, :func:`cross_entropy`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding as shd


def normal(shape, scale: float, dtype, *, generator: torch.Generator,
           device=None) -> nn.Parameter:
    """A parameter of standard-normal draws times ``scale``, drawn in
    float32 on the generator's device, stored as ``dtype`` on ``device``
    (default: the generator's device).  On the ``meta`` device nothing
    is drawn or allocated: the parameter has the shape and dtype alone
    (``launch.steps.train_state_shapes``)."""
    device = device or generator.device
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                        device="meta"))
    w = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32) * scale
    return nn.Parameter(w.to(device=device, dtype=dtype))


def dense(x, w, b=None):
    """Contract the last axis of ``x`` with the first of ``w``; ``w``
    (and ``b``) are cast to ``x``'s dtype on every call."""
    y = torch.tensordot(x, w.to(x.dtype), dims=([x.ndim - 1], [0]))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


class Dense(nn.Module):
    """w: (in_dim, *out_shape), fan-in scaled normal init; b zeros."""

    def __init__(self, in_dim: int, out_shape: Union[int, Sequence[int]],
                 dtype, *, generator: torch.Generator, device=None,
                 bias: bool = False, scale: Optional[float] = None):
        super().__init__()
        if isinstance(out_shape, int):
            out_shape = (out_shape,)
        scale = scale if scale is not None else in_dim ** -0.5
        self.w = normal((in_dim, *out_shape), scale, dtype,
                        generator=generator, device=device)
        self.b = (nn.Parameter(torch.zeros(tuple(out_shape), dtype=dtype,
                                           device=self.w.device))
                  if bias else None)

    def forward(self, x):
        return dense(x, self.w, self.b)


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMS norm in float32, cast back to ``x``'s dtype once."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))


def rope(x, positions, theta: float = 10000.0):
    """Rotate-half rotary embedding.  x: (..., S, H, hd); positions:
    (..., S).  Angles, cos and sin in float32; the result is cast back
    to ``x``'s dtype once."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    """GELU in its tanh approximation, the reference's (``jax.nn.gelu``
    defaults to ``approximate=True``; torch's default is the erf form),
    op for op in ``x``'s dtype with its constants rounded to that dtype,
    as the reference computes it: ``F.gelu`` rounds once, and in bf16
    differs from the reference by one rounding in ~40% of elements."""
    c = torch.tensor([(2 / math.pi) ** 0.5, 0.044715], dtype=x.dtype,
                     device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c[0] * (x + c[1] * (x * x * x)))))


def silu(x):
    """x * sigmoid(x) with the sigmoid as 1 / (1 + e^-x), op for op in
    ``x``'s dtype, as the reference computes ``jax.nn.silu`` on the CPU
    (``F.silu`` rounds once, and in bf16 differs from it by one rounding
    in ~40% of elements).  The SSM blocks use it; the MLP keeps
    ``F.silu``."""
    return x * torch.reciprocal(1 + torch.exp(-x))


class MLP(nn.Module):
    """SwiGLU MLP: w2(silu(w1 x) * w3 x); ``d_ff`` its hidden width."""

    def __init__(self, d_model: int, d_ff: int, dtype, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.d_ff = d_ff
        self.w1 = Dense(d_model, d_ff, dtype, **kw)
        self.w2 = Dense(d_ff, d_model, dtype, **kw)
        self.w3 = Dense(d_model, d_ff, dtype, **kw)


def mlp(p: MLP, x, seq=None):
    """x: (B, s, D), the residual's block of a sequence of ``seq``
    positions (default s: all of it).  With the hidden width split over
    the model axis (``"tp"``: w1 and w3 column-parallel, w2
    row-parallel) the input's sequence is all-gathered and w2's partial
    sums reduce-scattered onto the block (``sharding.seq_gather``,
    ``seq_scatter``); with whole weights both are the identity."""
    xg = shd.seq_gather(x, seq or x.shape[1])
    h = F.silu(p.w1(xg)) * p.w3(xg)
    return shd.seq_scatter(p.w2(h), x.shape[1], p.w2.w.shape[0] < p.d_ff)


class Embed(nn.Module):
    """w: (vocab, d_model), normal init scaled by d_model ** -0.5."""

    def __init__(self, vocab: int, d_model: int, dtype, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.w = normal((vocab, d_model), d_model ** -0.5, dtype,
                        generator=generator, device=device)


def embed_lookup(p: Embed, ids, compute_dtype, vocab=None):
    """Rows ``ids`` of the table in ``compute_dtype`` (gathered, then
    cast: the same numbers as the reference's cast-then-gather).  When
    the table holds the rank's block of the ``vocab`` rows (``"tp"``)
    an id outside the block reads zeros: the result is the rank's share
    of a sum over the model axis, one term of which is the row."""
    w = p.w
    if vocab is None or w.shape[0] == vocab:
        return w[ids].to(compute_dtype)
    local = ids - shd.block_offset(w.shape[0], vocab)
    hit = (local >= 0) & (local < w.shape[0])
    rows = w[torch.where(hit, local, 0)]
    return torch.where(hit[..., None], rows, 0).to(compute_dtype)


def logits_head(p: Dense, x):
    """x: (B, S, D) -> (B, S, V), or the rank's block of V when the head
    is split by vocabulary (``"tp"``)."""
    return p(x)


def cross_entropy(logits, labels, *, ignore_id: int = -1,
                  vocab_offset=None):
    """Mean cross-entropy over the labels that are not ``ignore_id``, in
    float32: logits (B, S, V), labels (B, S) integer.  The label's logit
    is taken by a masked reduction over the vocab, as the reference takes
    it (a gather there would all-gather vocab-sharded logits); a mask of
    no label gives 0.  With ``vocab_offset`` the logits are the rank's
    block of the vocabulary from that id on (``"tp"``): the max, the sum
    of exponentials and the label's logit are each reduced over the
    model axis."""
    logits = logits.float()
    split = vocab_offset is not None
    m = logits.amax(dim=-1, keepdim=True)
    if split:
        m = shd.all_reduce_max(m, ("model",))
    se = torch.sum(torch.exp(logits - m), dim=-1)
    if split:
        se = shd.all_reduce(se, ("model",))
    lse = m[..., 0] + torch.log(se)
    vocab = torch.arange(logits.shape[-1], device=logits.device) + (
        vocab_offset or 0)
    hit = vocab == labels.clamp(min=0)[..., None]
    ll = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    if split:
        ll = shd.all_reduce(ll, ("model",))
    mask = (labels != ignore_id).float()
    return torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)
