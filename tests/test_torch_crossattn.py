"""The port's cross attention and whisper encoder against the JAX
reference, on the CPU.

``repro_torch.models`` against ``repro.models``: the sinusoid position
embedding (``model._sinusoid``); the full-sequence cross attention
(``attention.gqa_forward(..., kv_override=enc)``: no rope, the plain
blocked attention whatever ``attn_impl`` says, Sq != Skv, in one key
block and in blocks of 8 whose zero-padded keys take part in the
softmax, as in the reference) and the K/V it hands the prefill cache;
the decode step's cross attention (``transformer._cross_decode``); the
encoder (``model._encode``: cast, plus the sinusoid, bidirectional
blocks, ``enc_norm``) on both ``attn_impl``s, the reference's Pallas
kernel in interpret mode against K6's plain version; a prefill into a
cache made with no encoder positions, whose entries are replaced as the
reference's are; and the one place the port departs from the reference:
a model with cross attention called without ``enc_inp`` raises
``ValueError``.  Parameters come from the reference's initialisers
(Whisper's and Llama-3.2-Vision's smoke configs); inputs from a seeded
numpy generator, to both packages.  Float32 agrees within 1e-5 of the
result's scale; bf16 within one bf16 rounding (2**-7) of it, the
encoder's two blocks within the whole-model tests' 0.15.  The sinusoid's
bound is set out in its test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (binds the reference's kernels package)
from repro.configs import base as jcb
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import transformer as jtf
from repro.models.layers import dense as jdense
from repro_torch.configs import base as tcb
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import _flat, _np32, params_from_jax
from repro_torch.serving import engine as TE

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BF16_ULP = 2.0 ** -7   # one bf16 rounding, relative
CROSS = ["whisper_small", "llama_3_2_vision_11b"]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, dtype):
    """Within 1e-5 (float32) or one bf16 rounding (bf16) of the
    reference's scale, in the reference's shape and dtype."""
    assert str(got.dtype)[6:] == str(want.dtype)
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    rel = 1e-5 if dtype == "float32" else BF16_ULP
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _xattn(arch, dtype, **overrides):
    """(reference config, port config, the reference's cross-attention
    parameters, the port's GQA holding them) for ``arch``'s smoke
    config."""
    jcfg = dataclasses.replace(jcb.get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype, **overrides)
    tcfg = dataclasses.replace(tcb.get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype, **overrides)
    tdt, jdt = DTYPES[dtype]
    jp = jattn.gqa_init(jax.random.PRNGKey(0), jcfg, jdt)
    mod = tattn.gqa_init(tcfg, tdt, generator=torch.Generator().manual_seed(0))
    mod.load_state_dict({k: torch.from_numpy(_np32(v))
                         for k, v in _flat(jax.tree_util.tree_map(
                             np.asarray, jp))}, strict=True)
    return jcfg, tcfg, jp, mod


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


@pytest.fixture(scope="module")
def whisper():
    """Whisper's smoke model: the reference's parameters and the port's
    model holding them (float32 parameters)."""
    cfg = jcb.get_smoke_config("whisper_small")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               tcb.get_smoke_config("whisper_small"))


@pytest.mark.parametrize("S,d", [(1500, 768), (20, 64)])
def test_sinusoid_matches_reference(S, d):
    """Whisper's 1,500 frames at its width (angles up to ~1,500 rad),
    and the smoke shape.  The frequencies agree within one float32 ulp:
    XLA's float32 exp and torch's differ in the last bit of 43 of
    Whisper's 384.  A one-bit difference in a frequency moves the angle
    of position p by up to ~p ulps of the frequency, so the embedding of
    position p is held within 1e-6 + 2**-22 * p (1e-6 up to the smoke
    shape's 20 positions; 3.6e-4 at position 1,499, one ulp of its
    angle being 1.2e-4).  In bf16 it is the float32 result rounded
    once."""
    half = d // 2
    want_f = np.asarray(jnp.exp(-jnp.log(10000.0) * jnp.arange(half) / half))
    lg = torch.log(torch.tensor(10000.0))
    got_f = torch.exp(-lg * torch.arange(half, dtype=torch.float32) / half)
    np.testing.assert_array_max_ulp(got_f.numpy(), want_f, maxulp=1)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    pt, pj = torch.from_numpy(pos.copy()), jnp.asarray(pos)
    want = np.asarray(JM._sinusoid(pj, d, jnp.float32))
    got = TM._sinusoid(pt, d, torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = 1e-6 + 2.0 ** -22 * pos[..., None]
    assert (np.abs(got.numpy() - want) <= bound).all()
    if S <= 20:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(TM._sinusoid(pt, d, torch.bfloat16),
                       got.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch,kv_block", [("whisper_small", 1024),
                                           ("llama_3_2_vision_11b", 8)])
def test_cross_forward_matches_reference(dtype, arch, kv_block):
    """12 decoder positions against the encoder's 20 (Whisper: one key
    block, 4 / 4 heads) or 17 (Vision: blocks of 8, the last padded with
    7 zero keys that enter the softmax, 4 / 2 heads); attn_impl "pallas"
    changes nothing here."""
    jcfg, tcfg, jp, mod = _xattn(arch, dtype, attn_kv_block=kv_block,
                                 attn_impl="pallas")
    B, S, Senc = 2, 12, jcfg.num_frontend_tokens
    xt, xj = _x((B, S, jcfg.d_model), dtype)
    et, ej = _x((B, Senc, jcfg.d_model), dtype, seed=2)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    want = jattn.gqa_forward(jp, xj, jnp.asarray(pos), jcfg, kv_override=ej)
    with torch.inference_mode():
        got, k, v = tattn.gqa_forward(mod, xt, torch.from_numpy(pos.copy()),
                                      tcfg, kv_override=et)
    _close(got, want, dtype)
    # the encoder's K/V as the reference's prefill caches them
    _close(k, jdense(jp["wk"], ej), dtype)
    _close(v, jdense(jp["wv"], ej), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_decode_matches_reference(dtype):
    """One token per sequence against 17 cached encoder positions (4 /
    2 heads)."""
    jcfg, tcfg, jp, mod = _xattn("llama_3_2_vision_11b", dtype)
    B, Senc, KVH, hd = 2, jcfg.num_frontend_tokens, jcfg.num_kv_heads, \
        jcfg.resolved_head_dim
    xt, xj = _x((B, 1, jcfg.d_model), dtype)
    kt, kj = _x((B, Senc, KVH, hd), dtype, seed=3)
    vt, vj = _x((B, Senc, KVH, hd), dtype, seed=4)
    want = jtf._cross_decode(jp, xj, kj, vj, jcfg)
    with torch.inference_mode():
        got = ttf._cross_decode(mod, xt, kt, vt, tcfg)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_encode_matches_reference(whisper, dtype, attn_impl):
    """The encoder over 20 stub frames: bidirectional, on K6's plain
    version (against the reference's Pallas kernel, interpreted) or the
    blocked attention; in bf16 the frames are rounded before the
    sinusoid is added, as the reference rounds them.  Two whole blocks
    and a norm: float32 within 1e-5 of the scale, bf16 within the 0.15
    of the whole-model tests (tests/test_archs.py)."""
    jp, model = whisper
    jcfg = dataclasses.replace(jcb.get_smoke_config("whisper_small"),
                               dtype=dtype, attn_impl=attn_impl)
    tcfg = dataclasses.replace(tcb.get_smoke_config("whisper_small"),
                               dtype=dtype, attn_impl=attn_impl)
    et, ej = _x((2, jcfg.num_frontend_tokens, jcfg.d_model), "float32")
    want = JM._encode(jp, jcfg, ej)
    with torch.inference_mode():
        got = TM._encode(model, tcfg, et)
    if dtype == "float32":
        _close(got, want, dtype)
    else:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert float(np.abs(_np(got) - _np(want)).max()) < 0.15


@pytest.mark.parametrize("arch", CROSS)
def test_prefill_replaces_an_empty_encoder_cache(arch):
    """A cache made with enc_len = 0: the prefill replaces its encoder
    entries with the encoder's whole K/V (the reference replaces the
    entries, ``transformer.sublayer_prefill_cache``), so the prefill and
    the decode step give what a cache made with the encoder's length
    gives."""
    cfg = dataclasses.replace(tcb.get_smoke_config(arch), dtype="float32")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    B, S, Senc = 2, 9, cfg.num_frontend_tokens
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1)))
    enc, _ = _x((B, Senc, cfg.d_model), "float32")
    out = {}
    for enc_len in (0, Senc):
        cache = TM.init_cache(cfg, B, S + 4, enc_len=enc_len)
        assert cache[0]["enc_k"].shape == (B, enc_len, cfg.num_kv_heads,
                                           cfg.resolved_head_dim)
        first, cache = TM.prefill(model, cfg, toks[:, :S], cache,
                                  enc_inp=enc)
        assert cache[0]["enc_v"].shape[1] == Senc
        out[enc_len] = first, TM.decode_step(model, cfg, toks[:, S:], cache,
                                             S)[0]
    for a, b in zip(out[0], out[Senc]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", CROSS)
def test_cross_attn_model_without_enc_inp_raises(arch):
    """Where the reference, given no enc_inp, runs a second self-attention
    through the cross-attention weights in prefill and attends a zero
    cache in decode (Whisper's encoder fails on None), the port refuses;
    an unknown layer kind raises too."""
    cfg = tcb.get_smoke_config(arch)
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="enc_inp"):
        TM.forward(model, cfg, toks)
    with pytest.raises(ValueError, match="enc_inp"):
        TM.prefill(model, cfg, toks, TM.init_cache(
            cfg, 1, 8, enc_len=cfg.num_frontend_tokens))
    eng = TE.Engine(cfg, model, max_batch=1, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="enc_inp"):
        eng.generate([TE.Request(prompt=np.ones(4, np.int32),
                                 max_new_tokens=2)])
    with pytest.raises(ValueError):
        ttf.check_kind("conv")
    for kind in ttf.KINDS:
        ttf.check_kind(kind)
