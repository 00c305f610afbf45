"""The port's MLA and local attention against the JAX reference, on the
CPU.

``repro_torch.models.attention`` against ``repro.models.attention``:
MLA's full-sequence forward (the plain blocked attention with scale
(nope + rope) ** -0.5 and a value head dim other than the query/key one)
and its absorbed decode with either cache update (``decode_dus``);
windowed GQA on both ``attn_impl``s (the reference's Pallas kernel in
interpret mode against K6's plain version); and the local-attention
ring of ``repro_torch.models.transformer`` (prefill into the ring, then
decode steps across its wrap) against the reference's
``sublayer_prefill_cache`` and ``_local_ring_decode``.  Parameters come
from the reference's initialisers (MLA: DeepSeek-V2's smoke config; the
ring: RecurrentGemma's); inputs from a seeded numpy generator, to both
packages.  Float32 agrees within 1e-5 of the result's scale; bf16 within
one bf16 rounding (2**-7) of it.
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
from repro.models import transformer as jtf
from repro_torch.configs import base as tcb
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.convert import _flat, _np32

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BF16_ULP = 2.0 ** -7   # one bf16 rounding, relative


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, dtype):
    """Within 1e-5 (float32) or one bf16 rounding (bf16) of the
    reference's scale, in the reference's shape and dtype; integers
    equal."""
    assert str(got.dtype)[6:] == str(want.dtype)
    if not got.is_floating_point():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    rel = 1e-5 if dtype == "float32" else BF16_ULP
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _mixer(arch, init, dtype, seed=0, **overrides):
    """(reference config, port config, the reference's mixer parameters,
    the port's mixer holding them) for ``arch``'s smoke config."""
    jcfg = dataclasses.replace(jcb.get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype, **overrides)
    tcfg = dataclasses.replace(tcb.get_smoke_config(arch), dtype=dtype,
                               param_dtype=dtype, **overrides)
    tdt, jdt = DTYPES[dtype]
    jp = getattr(jattn, init)(jax.random.PRNGKey(seed), jcfg, jdt)
    mod = getattr(tattn, init)(tcfg, tdt,
                               generator=torch.Generator().manual_seed(0))
    mod.load_state_dict({k: torch.from_numpy(_np32(v))
                         for k, v in _flat(jax.tree_util.tree_map(
                             np.asarray, jp))}, strict=True)
    return jcfg, tcfg, jp, mod


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _pos(B, S, offset=0):
    pos = np.broadcast_to(np.arange(S) + offset, (B, S)).astype(np.int32)
    return torch.from_numpy(pos.copy()), jnp.asarray(pos)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S,q_block,kv_block", [(12, 2048, 1024),
                                                (20, 8, 8)])
def test_mla_forward_matches_reference(dtype, S, q_block, kv_block):
    """The whole prompt in one block, and in blocks of 8 (a ragged last
    one) through the blocked attention's online softmax."""
    jcfg, tcfg, jp, mod = _mixer("deepseek_v2_236b", "mla_init", dtype,
                                 attn_q_block=q_block,
                                 attn_kv_block=kv_block)
    assert tcfg.v_head_dim != tcfg.qk_nope_dim + tcfg.qk_rope_dim
    xt, xj = _x((2, S, tcfg.d_model), dtype)
    pt, pj = _pos(2, S, offset=3)
    want = jattn.mla_forward(jp, xj, pj, jcfg)
    with torch.inference_mode():
        got, c_kv, kr = tattn.mla_forward(mod, xt, pt, tcfg)
    _close(got, want, dtype)
    # the compressed cache entries, as the reference's prefill writes them
    cache = jtf.sublayer_prefill_cache(
        {"mixer": jp}, "attn", xj, pj, jcfg,
        {"c": jnp.zeros((2, S, jcfg.kv_lora_rank), xj.dtype),
         "kr": jnp.zeros((2, S, jcfg.qk_rope_dim), xj.dtype)})
    _close(c_kv, cache["c"], dtype)
    _close(kr, cache["kr"], dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("decode_dus", [False, True])
def test_mla_decode_matches_reference(dtype, decode_dus):
    jcfg, tcfg, jp, mod = _mixer("deepseek_v2_236b", "mla_init", dtype,
                                 decode_dus=decode_dus)
    B, Smax = 2, 16
    ct, cj = _x((B, Smax, tcfg.kv_lora_rank), dtype, seed=2)
    kt, kj = _x((B, Smax, tcfg.qk_rope_dim), dtype, seed=3)
    for step, L in enumerate((9, 10, 15)):
        xt, xj = _x((B, 1, tcfg.d_model), dtype, seed=4 + step)
        yj, cj, kj = jattn.mla_decode(jp, xj, cj, kj, jnp.int32(L), jcfg)
        with torch.inference_mode():
            yt, ct, kt = tattn.mla_decode(mod, xt, ct, kt, L, tcfg)
        for g, w in ((yt, yj), (ct, cj), (kt, kj)):
            _close(g, w, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("window", [5, 32])
def test_gqa_forward_windowed_matches_reference(dtype, attn_impl, window):
    """RecurrentGemma's local attention (4 heads over 1 KV head): a window
    shorter than the prompt of 40 tokens, on the plain blocked attention
    and on K6 (its plain version here; the reference's Pallas kernel in
    interpret mode)."""
    jcfg, tcfg, jp, mod = _mixer("recurrentgemma_9b", "gqa_init", dtype,
                                 attn_impl=attn_impl, attn_q_block=16,
                                 attn_kv_block=16)
    S = 40
    xt, xj = _x((2, S, tcfg.d_model), dtype)
    pt, pj = _pos(2, S)
    want = jattn.gqa_forward(jp, xj, pj, jcfg, window=window)
    with torch.inference_mode():
        got, k, v = tattn.gqa_forward(mod, xt, pt, tcfg, window=window)
    _close(got, want, dtype)
    # and the window matters: without it the output is another
    with torch.inference_mode():
        full, _, _ = tattn.gqa_forward(mod, xt, pt, tcfg)
    assert float((full.float() - got.float()).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S", [20, 45])
def test_local_ring_prefill_and_decode_match_reference(dtype, S):
    """The ring after a prompt shorter (20) and longer (45) than the
    window of 32, then decode steps at positions S.. S + 19, which wrap
    the ring (every slot is rewritten at least once for S = 45)."""
    jcfg, tcfg, jp, mod = _mixer("recurrentgemma_9b", "gqa_init", dtype)
    W, B = tcfg.local_window, 2
    xt, xj = _x((B, S, tcfg.d_model), dtype)
    pt, pj = _pos(B, S)
    shapes = ttf.sublayer_cache("local_attn", tcfg, B, 64)
    assert shapes["slot_pos"] == ((B, W), torch.int32)
    tc = {n: torch.zeros(shape, dtype=dt) for n, (shape, dt) in
          shapes.items()}
    jc = {n: jnp.zeros(shape, getattr(jnp, str(dt)[6:])) for n, (shape, dt)
          in shapes.items()}
    jc = jtf.sublayer_prefill_cache({"mixer": jp}, "local_attn", xj, pj, jcfg,
                                    jc)
    with torch.inference_mode():
        _, k, v = tattn.gqa_forward(mod, xt, pt, tcfg, window=W)
        tc = ttf._ring_prefill(tc, k, v, pt, W)
    for n in tc:
        _close(tc[n], jc[n], dtype)
    for t in range(S, S + 20):
        xt, xj = _x((B, 1, tcfg.d_model), dtype, seed=t)
        yj, jc = jtf._local_ring_decode(jp, xj, jc, jnp.int32(t), jcfg)
        with torch.inference_mode():
            yt, tc = ttf._local_ring_decode(mod, xt, tc, t, tcfg)
        _close(yt, yj, dtype)
        for n in tc:
            _close(tc[n], jc[n], dtype)
    assert int(tc["slot_pos"].min()) > S + 19 - W
