"""State-space blocks: Mamba-2 SSD and RG-LRU (RecurrentGemma/Griffin).

Port of ``repro.models.ssm``.  Both blocks have a full-sequence form
(prefill) and a one-token form (decode), and keep their recurrent state
``h`` in float32.  Their float32 parameters (``a_param``, ``dt_bias``,
``d_skip``) stay float32 whatever ``param_dtype`` is, as in the
reference.

What differs in form, not in result:

- SSD's scan over chunks (``lax.scan``) is a Python loop over the
  chunks, and its three-operand contractions run pairwise, so that no
  (B, chunks, Q, Q, H, P) intermediate is formed.
- RG-LRU's ``lax.associative_scan`` is a log-depth doubling scan of the
  pairs (a, b) with the reference's combine: ceil(log2 S) steps over the
  whole sequence, not a loop over S.

Under ``layer_layout="tp"`` (``distributed/sharding.py``) a block runs
on the rules' model dimension: ``in_proj`` (f, model), ``conv`` (None,
model), the per-channel or per-head parameters (model) and ``out_proj``
(model, f) hold the rank's block where their dim divides the model axis
(else all of it).  The conv and the scan then run per channel (RG-LRU)
or per head (SSD) on the rank's block, the recurrent state is the
rank's block of the cache's, and ``out_proj`` is row-parallel
(:func:`out_partial`).  What a rank's channels need from other ranks is
all-gathered over the model axis along the width: RG-LRU's gates read
every channel of the conv's output (``a_gate``/``x_gate`` split by
output channel); SSD's ``in_proj`` and conv split its concatenated
(z, x, B, C, dt) width evenly, not by head, so both outputs are
gathered and each rank takes its heads' channels and the shared B, C.
With whole weights every gather and cut is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import (Dense, RMSNorm, dense, gelu, normal,
                                       silu)


def _f32(value, shape, device):
    """A float32 parameter filled with ``value``, whatever the model's
    parameter dtype."""
    return nn.Parameter(torch.full(shape, value, dtype=torch.float32,
                                   device=device))


def softplus(x):
    """log(1 + e^x), as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# causal depthwise conv1d (width w): shared by SSD and RG-LRU branches
# ---------------------------------------------------------------------------

class Conv1d(nn.Module):
    """w: (width, channels), normal init scaled by width ** -0.5."""

    def __init__(self, width, channels, dtype, *, generator, device=None):
        super().__init__()
        self.w = normal((width, channels), width ** -0.5, dtype,
                        generator=generator, device=device)


def conv1d(p: Conv1d, x):
    """x: (B, S, C), causal depthwise.  Shift and add in the reference's
    order (its bf16 roundings follow that order)."""
    w = p.w.to(x.dtype)
    width = w.shape[0]
    out = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[-1 - i]
    return out


def conv1d_step(p: Conv1d, x_t, conv_cache):
    """x_t: (B, 1, C); conv_cache: (B, width-1, C) past inputs.  Returns
    (y_t, new_cache)."""
    w = p.w.to(x_t.dtype)
    window = torch.cat([conv_cache, x_t], dim=1)  # (B, width, C)
    y = torch.einsum("bwc,wc->bc", window, w)[:, None]
    return y, window[:, 1:]


def _conv_tail(x, cw):
    """The last cw - 1 inputs of x (B, S, C), zero-padded on the left when
    S is shorter: the conv cache after a prefill."""
    return F.pad(x, (0, 0, max(0, cw - 1 - x.shape[1]), 0))[:, -(cw - 1):]


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

class SSD(nn.Module):
    """in_proj (D, 2 inner + 2 N + H), conv over inner + 2 N channels,
    a_param / dt_bias / d_skip (H,) float32, out_proj, norm."""

    def __init__(self, cfg, dtype, *, generator, device=None):
        super().__init__()
        device = device or generator.device
        D = cfg.d_model
        inner = cfg.ssm_expand * D
        H = inner // cfg.ssm_head_dim
        N = cfg.ssm_state
        kw = dict(generator=generator, device=device)
        self.in_proj = Dense(D, 2 * inner + 2 * N + H, dtype, **kw)
        self.conv = Conv1d(cfg.conv_width, inner + 2 * N, dtype, **kw)
        self.a_param = _f32(0.0, (H,), device)     # A = -exp(a_param)
        self.dt_bias = _f32(0.0, (H,), device)
        self.d_skip = _f32(1.0, (H,), device)
        self.out_proj = Dense(inner, D, dtype, **kw)
        self.norm = RMSNorm(inner, dtype, device=device)


def ssd_init(cfg, dtype, *, generator, device=None) -> SSD:
    return SSD(cfg, dtype, generator=generator, device=device)


def _whole(t, full: int):
    """``t`` with its last dim holding the rank's block of ``full``
    channels -> every channel (all-gathered over the model axis); ``t``
    when it holds them all."""
    return t if t.shape[-1] == full else shd.all_gather(t, "model",
                                                        t.ndim - 1)


def out_partial(p, kind, cfg) -> bool:
    """Whether the block's output is the rank's share of a sum over the
    model axis: its ``out_proj`` holds a block of its rows."""
    D = cfg.d_model
    width = (cfg.rnn_width or D) if kind == "rglru" else cfg.ssm_expand * D
    return p.out_proj.w.shape[0] < width


def _ssd_split(p: SSD, x, cfg):
    """(z, xbc, dt, inner, N, H) of x: every channel (``in_proj``'s block
    all-gathered under ``"tp"``)."""
    D = cfg.d_model
    inner = cfg.ssm_expand * D
    N = cfg.ssm_state
    H = inner // cfg.ssm_head_dim
    zxbcdt = _whole(p.in_proj(x), 2 * inner + 2 * N + H)
    z = zxbcdt[..., :inner]
    xbc = zxbcdt[..., inner:inner + inner + 2 * N]
    dt = zxbcdt[..., -H:]
    return z, xbc, dt, inner, N, H


def _ssd_conv_in(p: SSD, xbc):
    """The conv's block of ``xbc``'s channels: the rank's under ``"tp"``
    (``conv.w`` holds a block of them), else all."""
    n = p.conv.w.shape[1]
    return xbc.narrow(-1, shd.block_offset(n, xbc.shape[-1]), n)


def _ssd_heads(p: SSD, H: int):
    """(first head, heads) of the rank's block (``a_param``'s)."""
    n = p.a_param.shape[0]
    return shd.block_offset(n, H), n


def _ssd_out(p: SSD, y, z, lo: int, P_: int, cfg):
    """The gated, scaled output of the rank's heads ``y`` (B, S, Hl·P)
    (channels lo·P on of the inner width) through ``out_proj``: whole
    (then so are the heads: H divides the model axis only if H·P does),
    or its block of rows, which y holds (all heads, or the same block)."""
    c0 = lo * P_
    n = y.shape[-1]
    y = y * silu(z[..., c0:c0 + n])
    y = y * p.norm.scale[c0:c0 + n].to(y.dtype)  # gated RMS-ish scale
    w = p.out_proj.w
    rows = w.shape[0]
    if rows < n:
        y = y.narrow(-1, shd.block_offset(rows, n), rows)
    return dense(y, w)


def ssd_forward(p: SSD, x, cfg):
    """Chunked SSD over the full sequence.  x: (B, S, D).  Returns (y,
    final_state (B, H, P, N) float32, conv_tail (B, cw-1, conv_ch))."""
    B, S, D = x.shape
    z, xbc, dt, inner, N, H = _ssd_split(p, x, cfg)
    xbc_own = _ssd_conv_in(p, xbc)
    conv_tail = _conv_tail(xbc_own, cfg.conv_width)
    xbc = _whole(silu(conv1d(p.conv, xbc_own)), xbc.shape[-1])
    P_ = cfg.ssm_head_dim
    lo, H = _ssd_heads(p, H)  # the rank's heads
    xs = xbc[..., lo * P_:(lo + H) * P_].reshape(B, S, H, P_)
    Bm = xbc[..., inner:inner + N]
    Cm = xbc[..., inner + N:]
    dt = softplus(dt[..., lo:lo + H].float() + p.dt_bias)
    A = -torch.exp(p.a_param)             # (H,) negative
    adt = A * dt                          # (B, S, H) log-decay per step
    dtx = xs.float() * dt[..., None]
    Q = min(cfg.ssm_chunk, S)
    S_orig = S
    pad = (-S) % Q
    if pad:
        # padded steps carry dt = 0: a = 1 (no decay), dtx = 0 (no input),
        # so the final state is exactly the state after step S_orig
        adt = F.pad(adt, (0, 0, 0, pad))
        dtx = F.pad(dtx, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nC = S // Q
    adt_c = adt.reshape(B, nC, Q, H)
    cum = torch.cumsum(adt_c, dim=2)      # s_t within chunk
    dtx_c = dtx.reshape(B, nC, Q, H, P_)
    B_c = Bm.reshape(B, nC, Q, N).float()
    C_c = Cm.reshape(B, nC, Q, N).float()
    # intra-chunk (quadratic within Q): M_ij = C_i.B_j e^{s_i - s_j} [j<=i];
    # above the diagonal e^{s_i - s_j} may overflow, and where() drops it
    li = cum[..., :, None, :] - cum[..., None, :, :]        # (B,nC,Q,Q,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[..., None]
    decay = torch.where(causal, torch.exp(li), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", C_c, B_c)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay,
                           dtx_c)
    # chunk-final states: S_c = sum_j e^{s_Q - s_j} dtx_j B_j^T
    tail = torch.exp(cum[..., -1:, :] - cum)                # (B,nC,Q,H)
    S_c = torch.einsum("bcjhp,bcjn->bchpn", tail[..., None] * dtx_c, B_c)
    # inter-chunk scan: H_c = e^{sum chunk} H_{c-1} + S_{c-1}
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nC,H)
    h = torch.zeros((B, H, P_, N), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nC):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                     # (B,nC,H,P,N)
    y_inter = torch.einsum("bcin,bchpn->bcihp", C_c, h_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P_)[:, :S_orig]
    y = y + p.d_skip[None, None, :, None] * xs.float()
    y = y.reshape(B, S_orig, H * P_).to(x.dtype)
    return _ssd_out(p, y, z, lo, P_, cfg), h, conv_tail


def ssd_decode(p: SSD, x, state, conv_cache, cfg):
    """x: (B, 1, D); state: (B, H, P, N) float32; conv_cache: (B, cw-1,
    conv_ch) (under ``"tp"`` the rank's heads and conv channels).
    Returns (y, state, conv_cache)."""
    B = x.shape[0]
    z, xbc, dt, inner, N, H = _ssd_split(p, x, cfg)
    xbc_own, conv_cache = conv1d_step(p.conv, _ssd_conv_in(p, xbc),
                                      conv_cache)
    xbc = _whole(silu(xbc_own), xbc.shape[-1])
    P_ = cfg.ssm_head_dim
    lo, H = _ssd_heads(p, H)  # the rank's heads
    xs = xbc[..., lo * P_:(lo + H) * P_].reshape(B, H, P_)
    Bm = xbc[:, 0, inner:inner + N].float()
    Cm = xbc[:, 0, inner + N:].float()
    dt = softplus(dt[:, 0, lo:lo + H].float() + p.dt_bias)  # (B, H)
    a = torch.exp(-torch.exp(p.a_param) * dt)               # (B, H)
    dtx = xs.float() * dt[..., None]
    state = state * a[..., None, None] + \
        torch.einsum("bhp,bn->bhpn", dtx, Bm)
    y = torch.einsum("bhpn,bn->bhp", state, Cm)
    y = y + p.d_skip[None, :, None] * xs.float()
    y = y.reshape(B, 1, H * P_).to(x.dtype)
    return _ssd_out(p, y, z, lo, P_, cfg), state, conv_cache


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


class RGLRU(nn.Module):
    """gate_proj (gelu branch) and in_proj (recurrent branch) D -> w, conv,
    a_gate / x_gate w -> w with biases, a_param (w,) float32 (Λ),
    out_proj w -> D."""

    def __init__(self, cfg, dtype, *, generator, device=None):
        super().__init__()
        device = device or generator.device
        D = cfg.d_model
        w = cfg.rnn_width or D
        kw = dict(generator=generator, device=device)
        self.gate_proj = Dense(D, w, dtype, **kw)
        self.in_proj = Dense(D, w, dtype, **kw)
        self.conv = Conv1d(cfg.conv_width, w, dtype, **kw)
        self.a_gate = Dense(w, w, dtype, bias=True, **kw)
        self.x_gate = Dense(w, w, dtype, bias=True, **kw)
        self.a_param = _f32(0.5, (w,), device)
        self.out_proj = Dense(w, D, dtype, **kw)


def rglru_init(cfg, dtype, *, generator, device=None) -> RGLRU:
    return RGLRU(cfg, dtype, generator=generator, device=device)


def _rglru_gate(p: RGLRU, x):
    """gelu(gate_proj x) on the rank's channels (``gate_proj`` is whole
    on every rank: the rules leave it replicated)."""
    w, n = p.gate_proj.w, p.in_proj.w.shape[1]
    if n < w.shape[1]:
        w = w.narrow(1, shd.block_offset(n, w.shape[1]), n)
    return gelu(dense(x, w))


def _gate_dense(g: Dense, xr_all, n: int):
    """``g`` (w -> w, its weight split by output channel under ``"tp"``)
    on every channel ``xr_all``, for the rank's ``n`` output channels."""
    b = g.b
    if n < b.shape[0]:
        b = b.narrow(0, shd.block_offset(n, b.shape[0]), n)
    return dense(xr_all, g.w, b)


def _rglru_gates(p: RGLRU, xr):
    """(a, b) of h_t = a_t h_{t-1} + b_t, both float32, on the channels
    of ``xr`` (the rank's under ``"tp"``: the gates read every channel,
    all-gathered)."""
    xr_all = _whole(xr, p.a_gate.b.shape[0])
    n = xr.shape[-1]
    r = torch.sigmoid(_gate_dense(p.a_gate, xr_all, n).float())
    i = torch.sigmoid(_gate_dense(p.x_gate, xr_all, n).float())
    log_a = -RGLRU_C * softplus(p.a_param) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xr.float())
    return a, gated


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, over dim 1 of (B, S, ...)
    tensors: a doubling scan of the pairs (a, b) with the reference's
    combine ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 + b2), ceil(log2 S)
    steps, each one pass over the sequence."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_lo, b_lo = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_lo + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_lo * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_forward(p: RGLRU, x, cfg):
    """x: (B, S, D) -> (y, final_state (B, w) float32, conv_tail); under
    ``"tp"`` the state and the tail are the rank's channels, and y a
    share of the sum."""
    gate = _rglru_gate(p, x)
    xr_raw = p.in_proj(x)
    conv_tail = _conv_tail(xr_raw, cfg.conv_width)
    xr = conv1d(p.conv, xr_raw)
    a, b = _rglru_gates(p, xr)
    h = linear_scan(a, b)
    y = h.to(x.dtype) * gate
    return p.out_proj(y), h[:, -1], conv_tail


def rglru_decode(p: RGLRU, x, state, conv_cache, cfg):
    """x: (B, 1, D); state: (B, w) float32 (the rank's channels under
    ``"tp"``).  Returns (y, state, conv_cache)."""
    gate = _rglru_gate(p, x)
    xr, conv_cache = conv1d_step(p.conv, p.in_proj(x), conv_cache)
    a, b = _rglru_gates(p, xr)
    state = a[:, 0] * state + b[:, 0]
    y = state[:, None].to(x.dtype) * gate
    return p.out_proj(y), state, conv_cache
