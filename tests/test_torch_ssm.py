"""The port's state-space blocks against the JAX reference, on the CPU.

``repro_torch.models.ssm`` against ``repro.models.ssm``: the causal
depthwise conv and its one-step form, Mamba-2's chunked SSD (a prompt
shorter than a chunk, a whole number of chunks, and a ragged last
chunk, with the final state and the conv tail) and its decode step,
RG-LRU's full-sequence form (the port's doubling scan against
``lax.associative_scan``) and its decode step; and ``params_from_jax``
keeping the float32 leaves float32 under a bf16 ``param_dtype``.  The
reference's parameters, with its constant float32 leaves redrawn at
random, are loaded into the port's modules; inputs come from a seeded
numpy generator and go to both packages.  Float32 agrees within 1e-5
of the result's scale, bf16 within one bf16 rounding (2**-7) of it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.configs import base as tcb
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import _flat, _np32, params_from_jax

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BF16_ULP = 2.0 ** -7   # one bf16 rounding, relative
F32_LEAVES = ("a_param", "dt_bias", "d_skip")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, dtype):
    """Within 1e-5 (float32) or one bf16 rounding (bf16) of the
    reference's scale, in the reference's shape."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    rel = 1e-5 if dtype == "float32" else BF16_ULP
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _cfg(arch, **overrides):
    return (dataclasses.replace(jcb.get_smoke_config(arch), **overrides),
            dataclasses.replace(tcb.get_smoke_config(arch), **overrides))


def _load(module, tree, seed=0):
    """The reference's parameter subtree ``tree`` with its float32 leaves
    redrawn (so that no constant hides an error), loaded into the port's
    ``module``; returns the tree as the reference should use it."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    for name in F32_LEAVES:
        if name in tree:
            tree[name] = rng.uniform(-0.5, 0.5, tree[name].shape).astype(
                np.float32)
    module.load_state_dict({k: torch.from_numpy(_np32(v))
                            for k, v in _flat(tree)}, strict=True)
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_conv1d_and_step_match_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    conv = tssm.Conv1d(4, 12, tdt, generator=torch.Generator().manual_seed(0))
    jp = _load(conv, jssm.conv1d_init(jax.random.PRNGKey(0), 4, 12, jdt))
    xt, xj = _x((2, 10, 12), dtype)
    _close(tssm.conv1d(conv, xt), jssm.conv1d(jp, xj), dtype)
    cache_t, cache_j = _x((2, 3, 12), dtype, seed=2)
    for t in range(3):
        yt, cache_t = tssm.conv1d_step(conv, xt[:, t:t + 1], cache_t)
        yj, cache_j = jssm.conv1d_step(jp, xj[:, t:t + 1], cache_j)
        _close(yt, yj, dtype)
        _close(cache_t, cache_j, dtype)


def test_conv1d_step_continues_the_full_conv():
    """Stepping from the prefill's conv tail gives the full conv's next
    outputs (float32: the sum runs in another order)."""
    conv = tssm.Conv1d(4, 6, torch.float32,
                       generator=torch.Generator().manual_seed(3))
    x = torch.randn((2, 9, 6), generator=torch.Generator().manual_seed(4))
    full = tssm.conv1d(conv, x)
    cache = tssm._conv_tail(x[:, :5], 4)
    for t in range(5, 9):
        y, cache = tssm.conv1d_step(conv, x[:, t:t + 1], cache)
        torch.testing.assert_close(y[:, 0], full[:, t], rtol=1e-5, atol=1e-6)


def _ssd(dtype, **overrides):
    jcfg, tcfg = _cfg("mamba2_780m", dtype=dtype, param_dtype=dtype,
                      **overrides)
    tdt, jdt = DTYPES[dtype]
    mod = tssm.ssd_init(tcfg, tdt, generator=torch.Generator().manual_seed(0))
    jp = _load(mod, jssm.ssd_init(jax.random.PRNGKey(0), jcfg, jdt))
    return jcfg, tcfg, jp, mod


@pytest.mark.parametrize("S", [5, 16, 13])   # < chunk, 2 chunks, ragged
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_forward_matches_reference(S, dtype):
    jcfg, tcfg, jp, mod = _ssd(dtype)
    assert tcfg.ssm_chunk == 8
    xt, xj = _x((2, S, tcfg.d_model), dtype)
    want = jssm.ssd_forward(jp, xj, jcfg)
    with torch.inference_mode():
        got = tssm.ssd_forward(mod, xt, tcfg)
    assert got[1].dtype == torch.float32 and got[2].dtype == xt.dtype
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_decode_matches_reference(dtype):
    jcfg, tcfg, jp, mod = _ssd(dtype)
    inner = tcfg.ssm_expand * tcfg.d_model
    H = inner // tcfg.ssm_head_dim
    rng = np.random.default_rng(5)
    state = rng.standard_normal((2, H, tcfg.ssm_head_dim,
                                 tcfg.ssm_state)).astype(np.float32)
    conv_t, conv_j = _x((2, tcfg.conv_width - 1, inner + 2 * tcfg.ssm_state),
                        dtype, seed=6)
    xt, xj = _x((2, 1, tcfg.d_model), dtype)
    want = jssm.ssd_decode(jp, xj, jnp.asarray(state), conv_j, jcfg)
    with torch.inference_mode():
        got = tssm.ssd_decode(mod, xt, torch.from_numpy(state), conv_t, tcfg)
    assert got[1].dtype == torch.float32
    for g, w in zip(got, want):
        _close(g, w, dtype)


def test_ssd_prefill_then_decode_continues_the_forward():
    """The final state and conv tail of a ragged prefill carry on as the
    forward over the longer sequence does (float32)."""
    _, tcfg, _, mod = _ssd("float32")
    x = torch.randn((2, 15, tcfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        full, _, _ = tssm.ssd_forward(mod, x, tcfg)
        _, h, conv = tssm.ssd_forward(mod, x[:, :11], tcfg)
        for t in range(11, 15):
            y, h, conv = tssm.ssd_decode(mod, x[:, t:t + 1], h, conv, tcfg)
            torch.testing.assert_close(y[:, 0], full[:, t], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_linear_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (2, S, 5)).astype(np.float32)
    b = rng.standard_normal((2, S, 5)).astype(np.float32)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    got = tssm.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want, "float32")
    # and the recurrence itself, step by step in float64
    h, ref = np.zeros((2, 5)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(ref, 1), rtol=1e-5,
                               atol=1e-5)


def _rglru(dtype):
    jcfg, tcfg = _cfg("recurrentgemma_9b", dtype=dtype, param_dtype=dtype)
    tdt, jdt = DTYPES[dtype]
    mod = tssm.rglru_init(tcfg, tdt,
                          generator=torch.Generator().manual_seed(0))
    jp = _load(mod, jssm.rglru_init(jax.random.PRNGKey(1), jcfg, jdt))
    return jcfg, tcfg, jp, mod


@pytest.mark.parametrize("S", [1, 11, 40])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_forward_matches_reference(S, dtype):
    jcfg, tcfg, jp, mod = _rglru(dtype)
    xt, xj = _x((2, S, tcfg.d_model), dtype)
    want = jssm.rglru_forward(jp, xj, jcfg)
    with torch.inference_mode():
        got = tssm.rglru_forward(mod, xt, tcfg)
    assert got[1].dtype == torch.float32 and got[2].dtype == xt.dtype
    for g, w in zip(got, want):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_decode_matches_reference(dtype):
    jcfg, tcfg, jp, mod = _rglru(dtype)
    w = tcfg.rnn_width
    state = np.random.default_rng(8).standard_normal((2, w)).astype(
        np.float32)
    conv_t, conv_j = _x((2, tcfg.conv_width - 1, w), dtype, seed=9)
    xt, xj = _x((2, 1, tcfg.d_model), dtype)
    want = jssm.rglru_decode(jp, xj, jnp.asarray(state), conv_j, jcfg)
    with torch.inference_mode():
        got = tssm.rglru_decode(mod, xt, torch.from_numpy(state), conv_t,
                                tcfg)
    assert got[1].dtype == torch.float32
    for g, w_ in zip(got, want):
        _close(g, w_, dtype)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_780m"])
def test_params_from_jax_keeps_float32_leaves(arch):
    """Under param_dtype bfloat16 the reference keeps a_param, dt_bias and
    d_skip float32; so does the port, leaf for leaf, every value equal."""
    jcfg, tcfg = _cfg(arch, param_dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(10)
    # (the reference's subtree of each port layer, its repeat or None)
    units = [(tree[name][f"s{s}"], r if reps else None)
             for name, pattern, reps in JM._groups(jcfg)
             for r in range(reps or 1) for s in range(len(pattern))]
    for sub, _ in units:
        for leaf in F32_LEAVES:
            if leaf in sub["mixer"]:
                sub["mixer"][leaf] = rng.uniform(
                    -1, 1, sub["mixer"][leaf].shape).astype(np.float32)
    model = params_from_jax(tree, tcfg)
    assert model.embed.w.dtype == torch.bfloat16
    n32 = 0
    for layer, (sub, r) in zip(model.layers, units, strict=True):
        got = dict(layer.named_parameters())
        for key, arr in _flat(sub):
            want = arr if r is None else arr[r]
            assert str(got[key].dtype) == f"torch.{want.dtype}", key
            np.testing.assert_array_equal(_np(got[key]), _np32(want))
            n32 += got[key].dtype == torch.float32
    assert n32 == sum(leaf in sub["mixer"] for sub, _ in units
                      for leaf in F32_LEAVES) > 0
