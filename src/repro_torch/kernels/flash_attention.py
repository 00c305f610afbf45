"""K6, flash attention: CUDA kernel wrapper and its plain version.

Port of the Pallas kernel
``repro.kernels.flash_attention.flash_attention_pallas``: blocked
causal / windowed / bidirectional GQA attention with an online softmax,
in the reference's layout (q (B, Sq, H, hd), k/v (B, Skv, KVH, hd)).
The kernel is ``csrc/flash_attention.cu``; its plain version is
``ref.flash_attention_ref`` (float32 softmax over whole rows).  The two
agree to float32 rounding (the kernel sums a row tile by tile), not bit
for bit.

The kernel has two routes, chosen by dtype: bfloat16 inputs take the
``wgmma`` route (TMA loads, tensor-core products, P split into three
bf16 parts for the PV product), float32 inputs the ``fma`` route
(CUDA-core FMAs).  Both take any head dim up to ``MAX_HEAD_DIM`` (256,
the widest of the reference's configs); one that is not a multiple of 8
is first copied into a zero-padded head dim.

:func:`flash_attention` takes the plain version only for tensors on the
CPU; on CUDA tensors it launches the kernel (counting the launch in
``flash_attention.launches`` and its route in ``flash_attention.routes``)
or raises.  On ``meta`` tensors (the dry run, ``launch/dryrun.py``) it
launches nothing: it returns the output the kernel would write (shape,
dtype, device) and adds the kernel's FLOPs (:func:`card_flops`) to
``flash_attention.traced_flops`` and one to
``flash_attention.traced_calls``.

K6 has no backward pass: the reference's Pallas kernel has none either
(``jax.grad`` through it fails), and the reference trains with
``attn_impl="xla"``.  Called while autograd records on an input that
requires a gradient, :func:`flash_attention` raises
``NotImplementedError`` on every device, never returning a result that
would carry no gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels._build import stream_of
from repro_torch.kernels.ref import flash_attention_ref

flash_attention_plain = flash_attention_ref

MAX_HEAD_DIM = 256
# query tiles run on grid.y: at most 65,535 of 64 rows (fma route)
MAX_QUERY_TILES = 65535


def wgmma_tiles(hd: int) -> tuple[int, int]:
    """(query rows, keys) of one tile of the wgmma route at head dim hd:
    128 query rows per CTA; 128-key tiles up to hd = 64, 64-key tiles up
    to 128 and 32-key tiles above (the output accumulator takes hd / 2
    registers a thread)."""
    return 128, (128 if hd <= 64 else 64 if hd <= 128 else 32)


def card_flops(B: int, Sq: int, Skv: int, H: int, hd: int, *, causal: bool,
               window: int, route: str) -> int:
    """The multiply-adds, as FLOPs (2 per multiply-add), that one launch
    of K6 performs.  From ``csrc/flash_attention.cu``: each CTA takes
    one head of one sequence and a tile of query rows, and visits the
    key tiles ``[kt_lo, kt_hi)`` that any of its rows can see (causal:
    up to the tile of its last row's position; windowed: from the tile
    of its first row's position - window + 1); each visited tile costs
    S = Q Kᵀ and O += P V at the instantiation's head dim.  The fma route
    takes 64 query rows and 64 keys at head dims 32, 64, 128 or 256, one
    product each; the wgmma route 128 query rows and ``wgmma_tiles``'
    keys at head dims 64, 128 or 256, with P V issued once per bf16 part
    of P (three)."""
    if route == "wgmma":
        bq, bk = wgmma_tiles(hd)
        dim, pv_parts = (64 if hd <= 64 else 128 if hd <= 128 else 256), 3
    else:
        bq, bk, pv_parts = 64, 64, 1
        dim = next(d for d in (32, 64, 128, 256) if hd <= d)
    off, n_kt = Skv - Sq, -(-Skv // bk)
    tiles = 0
    for q0 in range(0, Sq, bq):
        lo, hi = 0, n_kt
        if causal:
            last = min(q0 + bq, Sq) - 1 + off
            hi = 0 if last < 0 else min(n_kt, last // bk + 1)
        if window:
            lo = max(0, q0 + off - window + 1) // bk
        tiles += max(0, hi - lo)
    return B * H * tiles * 2 * bq * bk * dim * (1 + pv_parts)


def tma_ready(strides, data_ptr: int) -> bool:
    """Whether a bf16 (B, S, heads, hd) tensor with these element strides
    can be read by TMA in place: unit stride on hd, 16-byte-aligned base,
    and batch, sequence and head strides positive multiples of 16 bytes."""
    return (strides[3] == 1 and data_ptr % 16 == 0
            and all(s > 0 and s % 8 == 0 for s in strides[:3]))


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KVH, hd) -> (B, Sq, H, hd) in
    q's dtype.  float32 or bfloat16 (all three alike); hd up to 256; H a
    multiple of KVH.  Inputs are read in place through their strides; one
    the kernel cannot read so (a head dim that is not contiguous; for
    bf16 also a base or stride TMA refuses) is copied.  An hd that is not
    a multiple of 8 is copied once into zero columns up to the next
    multiple of 8 (a zero column adds nothing to a score); the scale
    comes from the true hd and the output is cut back to it.  Raises
    ``NotImplementedError`` under autograd (module docstring)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention (K6) has no backward pass: the reference's "
            "Pallas kernel has no gradient either; train with "
            "attn_impl=\"xla\" (the plain blocked attention)")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, KVH, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, Sq, H, hd) and k, v "
                         f"(B, Skv, KVH, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} is outside [1, {MAX_HEAD_DIM}]")
    if KVH == 0 or H % KVH:
        raise ValueError(f"{H} query heads do not group over {KVH} KV heads")
    if -(-Sq // 64) > MAX_QUERY_TILES:
        raise ValueError(f"Sq = {Sq} exceeds the grid's {MAX_QUERY_TILES} "
                         f"query tiles of 64 rows")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, not {q.dtype}, {k.dtype}, {v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"inputs on {q.device} and {t.device}")
    route = "wgmma" if q.dtype == torch.bfloat16 else "fma"
    scale = scale if scale is not None else hd ** -0.5
    if hd % 8:
        pad = -hd % 8
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
        o = flash_attention(q, k, v, causal=causal, window=window,
                            scale=scale)
        return o[..., :hd].contiguous()
    if route == "wgmma":
        q, k, v = (t if tma_ready(t.stride(), t.data_ptr())
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    else:
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if B and Sq and q.is_meta:  # the dry run: no data, the card's work
        flash_attention.traced_flops += card_flops(
            B, Sq, Skv, H, hd, causal=causal, window=window, route=route)
        flash_attention.traced_calls += 1
    elif B and Sq:
        launch(q, k, v, o, causal=causal, window=window, scale=scale)
        flash_attention.launches += 1
        flash_attention.routes[route] += 1
    return o


flash_attention.launches = 0
flash_attention.routes = {"wgmma": 0, "fma": 0}
flash_attention.traced_flops = 0
flash_attention.traced_calls = 0


def launch(q, k, v, o, *, causal, window, scale) -> None:
    """Launch K6 on checked CUDA tensors (``o`` allocated by the caller)
    on the current stream; the route follows the dtype.  Raise on a
    launch error."""
    lib = _build.LIBS.get("flash_attention")
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = lib.zipper_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, KVH, Sq, Skv, hd, *strides,
        float(scale), int(bool(causal)), int(window), stream_of(q))
    _build.check(lib, err, "flash_attention")
