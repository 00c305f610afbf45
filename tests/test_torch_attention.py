"""The port's attention against the JAX reference, on the CPU.

K6's plain version (``repro_torch.kernels.flash_attention`` on CPU
tensors) against the reference's Pallas kernel in interpret mode and
its ``mha_ref`` oracle on the sweep of ``tests/test_kernels_attn.py``;
the plain blocked attention; and the GQA forward and decode with the
reference's weights carried across by ``params_from_jax``.  Inputs come
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
from repro_torch.kernels.flash_attention import flash_attention
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
        return t.float().numpy()
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
