"""The port's attention against the JAX reference, on the CPU.

K6's plain version (``repro_torch.kernels.flash_attention`` on CPU
tensors) against the reference's Pallas kernel in interpret mode and
its ``mha_ref`` oracle on the sweep of ``tests/test_kernels_attn.py``;
a plain-torch emulation of the kernel's bf16 (wgmma) route against the
Pallas kernel; the plain blocked attention; and the GQA forward and
decode with the reference's weights carried across by
``params_from_jax``.  Inputs come
from a seeded numpy generator and go to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (binds the reference's kernels package)
from repro.configs import base as jcb
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import mha_ref as jax_mha_ref
from repro.models import attention as jattn
from repro.models import model as JM
from repro_torch.configs import base as tcb
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention, tma_ready,
                                                 wgmma_tiles)
from repro_torch.models import attention as tattn
from repro_torch.models.convert import params_from_jax

SWEEP = [
    (2, 64, 64, 4, 2, 16, True, 0),
    (1, 96, 96, 8, 1, 32, True, 32),
    (2, 48, 64, 4, 4, 16, True, 0),     # q shorter than kv (chunked prefill)
    (1, 64, 64, 2, 2, 8, False, 0),     # bidirectional (encoder)
    (1, 128, 128, 4, 1, 64, True, 0),   # MQA
]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BF16_ULP = 2.0 ** -7   # one bf16 rounding, relative


def _qkv(B, Sq, Skv, H, KVH, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KVH, hd)).astype(np.float32))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window", SWEEP)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_plain_matches_pallas_and_mha_ref(
        B, Sq, Skv, H, KVH, hd, causal, window, dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(B, Sq, Skv, H, KVH, hd)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, Sq, H, hd)
    got = _np(got)
    pallas = _np(flash_attention_pallas(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        window=window, bq=32, bk=16, interpret=True))
    want = _np(jax_mha_ref(*(jnp.asarray(a) for a in (q, k, v)),
                           causal=causal, window=window))
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    else:  # both round one float32 result to bf16 once
        np.testing.assert_allclose(got, pallas, rtol=BF16_ULP, atol=1e-6)


# head dims past the sweep's: RecurrentGemma-9B's 256 (windowed, as its
# local attention is), and 20, which the kernel takes padded to 24
HEAD_DIMS = [(1, 96, 96, 4, 1, 256, True, 32), (1, 64, 64, 2, 2, 256, False, 0),
             (2, 48, 64, 4, 2, 20, True, 0), (1, 40, 40, 3, 1, 20, True, 16)]


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window", HEAD_DIMS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_plain_head_dims(B, Sq, Skv, H, KVH, hd, causal,
                                         window, dtype):
    """The plain version at hd = 256 and hd = 20 against the Pallas
    kernel (interpret mode), at the sweep's tolerances: 1e-5 in float32,
    one bf16 rounding plus 1e-6 in bf16."""
    tdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(B, Sq, Skv, H, KVH, hd, seed=hd)
    got = flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                          causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (B, Sq, H, hd)
    pallas = _np(flash_attention_pallas(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        window=window, bq=32, bk=16, interpret=True))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), pallas, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), pallas, rtol=BF16_ULP,
                                   atol=1e-6)


def test_zero_padded_head_dim_changes_nothing():
    """What the wrapper does for an hd that is not a multiple of 8: zero
    columns up to 24 with the scale of the true hd, then the output cut
    back, gives the unpadded result (float32, to rounding)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 40, 4, 2, 20))
    want = tref.flash_attention_ref(q, k, v, window=8)
    pad = [torch.nn.functional.pad(t, (0, 4)) for t in (q, k, v)]
    got = tref.flash_attention_ref(*pad, window=8, scale=20 ** -0.5)
    torch.testing.assert_close(got[..., :20], want, rtol=1e-6, atol=1e-6)
    assert not got[..., 20:].any()


def _wgmma_route(q, k, v, *, causal, window, parts=3):
    """K6's bf16 (wgmma) route in plain torch: bf16 operands, float32
    scores and accumulators tile by tile at the kernel's (BQ, BK), the
    tiles each query block visits in the kernel's order (causal and
    window skips; KV tails zero-filled and masked), the softmax in base 2
    (scores scaled by float32 scale * log2(e)), and P split into
    ``parts`` bf16 parts (the kernel's three) for the PV product, each
    the rounding of what the parts before it leave."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    BQ, BK = wgmma_tiles(hd)
    scale = torch.tensor(hd ** -0.5) * torch.tensor(1.4426950408889634)
    off, n_kt = Skv - Sq, -(-Skv // BK)
    pad = n_kt * BK - Skv
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
              .repeat_interleave(H // KVH, dim=2) for t in (k, v))
    out = torch.empty((B, Sq, H, hd), dtype=torch.bfloat16)
    for q0 in range(0, Sq, BQ):
        qb = q[:, q0:q0 + BQ].float()
        qpos = torch.arange(q0, q0 + qb.shape[1])[:, None] + off
        kt_lo, kt_hi = 0, n_kt
        if causal:
            q_last = int(qpos[-1])
            kt_hi = 0 if q_last < 0 else min(n_kt, q_last // BK + 1)
        if window:
            kt_lo = max(0, q0 + off - window + 1) // BK
        m = torch.full((B, H, qb.shape[1]), tref.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, H, qb.shape[1], hd))
        for kt in range(kt_lo, kt_hi):
            keys = slice(kt * BK, (kt + 1) * BK)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kf[:, keys]) * scale
            kpos = torch.arange(kt * BK, (kt + 1) * BK)[None, :]
            ok = kpos < Skv
            if causal:
                ok = ok & (qpos >= kpos)
            if window:
                ok = ok & (qpos - kpos < window)
            s = torch.where(ok, s, tref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp2(s - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            pieces, rest = [], p
            for _ in range(parts):
                pieces.append(rest.to(torch.bfloat16).float())
                rest = rest - pieces[-1]
            acc = acc * alpha[..., None] + sum(
                torch.einsum("bhqk,bkhd->bhqd", piece, vf[:, keys])
                for piece in pieces)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q0 + BQ] = o.permute(0, 2, 1, 3).to(torch.bfloat16)
    return out


# hd 64 (one swizzle atom, 128-key tiles), 128 (two atoms, 64-key tiles)
# and 256 (four atoms, 32-key tiles); causal, windowed (whole tiles below the window for some rows of
# a block: wiped by the next valid tile), bidirectional, ragged Sq and Skv
WGMMA_CASES = [
    (1, 256, 256, 4, 2, 64, True, 0),
    (1, 256, 256, 2, 1, 64, True, 32),
    (1, 200, 330, 4, 1, 128, True, 0),
    (2, 130, 130, 4, 4, 128, False, 0),
    (1, 160, 160, 2, 1, 128, True, 40),
    (1, 100, 100, 2, 2, 96, True, 0),
    (1, 130, 130, 2, 1, 256, True, 0),   # four atoms, 32-key tiles
    (1, 96, 96, 2, 2, 256, True, 40),
]


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window", WGMMA_CASES)
def test_wgmma_route_arithmetic_matches_pallas(B, Sq, Skv, H, KVH, hd,
                                               causal, window):
    """The bf16 route's arithmetic (P in three bf16 parts) stays within
    the card's gate for that route, one bf16 rounding plus 1e-6, of the
    Pallas kernel and of the plain version."""
    q, k, v = _qkv(B, Sq, Skv, H, KVH, hd, seed=3)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _np(_wgmma_route(qt, kt, vt, causal=causal, window=window))
    pallas = _np(flash_attention_pallas(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=causal, window=window, interpret=True))
    plain = _np(flash_attention(qt, kt, vt, causal=causal, window=window))
    for want in (pallas, plain):
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("H,KVH,hd", [(32, 4, 64), (56, 8, 128)])
def test_wgmma_route_arithmetic_at_serving_shapes(H, KVH, hd):
    """TinyLlama's and Arctic's prefill (B = 4, S = 512, causal): millions
    of outputs, rows that see few keys among them.  Three bf16 parts of P
    keep the gate, one bf16 rounding plus 1e-6; two parts miss it (the
    reason the kernel takes three)."""
    q, k, v = _qkv(4, 512, 512, H, KVH, hd, seed=0)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    want = _np(flash_attention(qt, kt, vt))
    beyond = {}
    for parts in (2, 3):
        got = _np(_wgmma_route(qt, kt, vt, causal=True, window=0,
                               parts=parts))
        beyond[parts] = (np.abs(got - want) - BF16_ULP * np.abs(want)).max()
    assert beyond[3] <= 1e-6 < beyond[2]


def test_wgmma_tiles_and_tma_ready():
    assert wgmma_tiles(64) == (128, 128) and wgmma_tiles(8) == (128, 128)
    assert wgmma_tiles(96) == (128, 64) and wgmma_tiles(128) == (128, 64)
    assert wgmma_tiles(136) == (128, 32) and wgmma_tiles(256) == (128, 32)
    # TinyLlama's q (4, 512, 32, 64), contiguous, and k, v sliced from one
    # packed (.., 40, 64) projection: strides of 8 values, 16-byte bases
    assert tma_ready((512 * 32 * 64, 32 * 64, 64, 1), 2 ** 20)
    assert tma_ready((512 * 40 * 64, 40 * 64, 64, 1), 2 ** 20 + 32 * 128)
    assert not tma_ready((512 * 32 * 64, 32 * 64, 64, 1), 2 ** 20 + 8)
    assert not tma_ready((512 * 32 * 64, 32 * 64, 1, 32), 2 ** 20)
    assert not tma_ready((512 * 32 * 60, 32 * 60, 60, 1), 2 ** 20)
    assert not tma_ready((0, 32 * 64, 64, 1), 2 ** 20)


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window", SWEEP)
def test_mha_ref_port_matches_reference(B, Sq, Skv, H, KVH, hd, causal,
                                        window):
    q, k, v = _qkv(B, Sq, Skv, H, KVH, hd, seed=1)
    got = tref.mha_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                       causal=causal, window=window)
    want = jax_mha_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                       window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# (Sq, Skv, causal, window, block_skip, p_bf16, q_offset, dtype)
BLOCKED = [
    (48, 48, True, 0, False, False, 0, "float32"),
    (40, 56, True, 0, True, False, 16, "float32"),    # skip + offset
    (40, 56, True, 0, True, True, 16, "float32"),     # bf16 probabilities
    (48, 48, True, 20, False, False, 0, "float32"),   # window
    (48, 50, False, 0, False, False, 0, "float32"),   # ragged kv, no mask
    (40, 56, True, 0, True, True, 16, "bfloat16"),
]


@pytest.mark.parametrize("Sq,Skv,causal,window,block_skip,p_bf16,q_offset,"
                         "dtype", BLOCKED)
def test_blocked_attention_matches_reference(Sq, Skv, causal, window,
                                             block_skip, p_bf16, q_offset,
                                             dtype):
    tdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(2, Sq, Skv, 4, 2, 16, seed=2)
    kw = dict(causal=causal, window=window, q_block=16, kv_block=16,
              block_skip=block_skip, q_offset=q_offset, p_bf16=p_bf16)
    got = tattn.blocked_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    want = jattn.blocked_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), **kw)
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP,
                                   atol=1e-6)


def _layer0(arch, **overrides):
    """The smoke config of ``arch`` in both packages, the reference's
    parameters, and its first layer's attention in each."""
    jcfg = dataclasses.replace(jcb.get_smoke_config(arch), **overrides)
    tcfg = dataclasses.replace(tcb.get_smoke_config(arch), **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    jmix = jax.tree_util.tree_map(lambda a: a[0], jp["g0"]["s0"]["mixer"])
    return jcfg, tcfg, jmix, model.layers[0].mixer


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen1_5_0_5b"])
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_gqa_forward_matches_reference(arch, attn_impl):
    jcfg, tcfg, jmix, tmix = _layer0(arch, dtype="float32",
                                     attn_impl=attn_impl)
    rng = np.random.default_rng(4)
    B, S = 2, 12
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S) + 3, (B, S)).astype(np.int32)
    want = jattn.gqa_forward(jmix, jnp.asarray(x), jnp.asarray(pos), jcfg)
    with torch.no_grad():  # K6 (attn_impl "pallas") has no backward pass
        got, k, v = tattn.gqa_forward(tmix, torch.from_numpy(x),
                                      torch.from_numpy(pos), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
    hd, KVH = jcfg.resolved_head_dim, jcfg.num_kv_heads
    assert tuple(k.shape) == tuple(v.shape) == (B, S, KVH, hd)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen1_5_0_5b"])
@pytest.mark.parametrize("decode_dus", [False, True])
@pytest.mark.parametrize("window", [0, 5])
def test_gqa_decode_matches_reference(arch, decode_dus, window):
    jcfg, tcfg, jmix, tmix = _layer0(arch, dtype="float32",
                                     decode_dus=decode_dus)
    rng = np.random.default_rng(5)
    B, Smax, L = 2, 16, 9
    hd, KVH = jcfg.resolved_head_dim, jcfg.num_kv_heads
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, Smax, KVH, hd)).astype(np.float32)
    cv = rng.standard_normal((B, Smax, KVH, hd)).astype(np.float32)
    want = jattn.gqa_decode(jmix, jnp.asarray(x), jnp.asarray(ck),
                            jnp.asarray(cv), jnp.int32(L), jcfg,
                            window=window)
    got = tattn.gqa_decode(tmix, torch.from_numpy(x),
                           torch.from_numpy(ck.copy()),
                           torch.from_numpy(cv.copy()), L, tcfg,
                           window=window)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-5)
