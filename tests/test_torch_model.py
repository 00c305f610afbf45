"""The port's LLM path against the JAX reference, on the CPU.

For the smoke configs of the reference's ten architectures (the dense
TinyLlama, Qwen1.5, Granite-3 and Phi4-mini, the MoE Arctic, DeepSeek-V2
with MLA, the hybrid RecurrentGemma with RG-LRU and local attention, the
SSM Mamba2, and Whisper and Llama-3.2-Vision with cross attention, the
former behind its encoder): the configs themselves, the elementary layers,
``forward`` / ``prefill`` / ``decode_step`` with the reference's weights
carried across by ``params_from_jax``, and the serving engine's greedy
tokens.  In float32 the logits agree within 1e-4; with the bf16 default
within 0.15, the bound ``tests/test_archs.py`` allows for bf16
reorderings.  RecurrentGemma's prompt is longer than its local window
(32), so the prefill's window and the decode ring both wrap; Mamba2's is
no multiple of its SSD chunk (8).  The cross-attention models take stub
frontend embeddings (``_enc``), as ``tests/test_archs.py`` gives them.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.serving import engine as JE
from repro_torch.configs import base as tcb
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import engine as TE
from repro_torch.serving import sampler as tsampler

ARCHS = tcb.ARCH_IDS
BF16_ULP = 2.0 ** -7   # one bf16 rounding, relative
# prompt length of the forward / prefill / decode test: past the local
# window (RecurrentGemma) and no multiple of the SSD chunk (Mamba2)
PROMPT = {"recurrentgemma_9b": 40, "mamba2_780m": 13}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _enc(cfg, B, seed=5):
    """Stub frontend embeddings (B, num_frontend_tokens, D) float32 for a
    model with cross attention, else None."""
    if not cfg.num_frontend_tokens:
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)


def _models(arch, seed=0, **overrides):
    """(reference config, port config, reference params, port model) for
    the smoke config of ``arch`` with ``overrides``."""
    jcfg = dataclasses.replace(jcb.get_smoke_config(arch), **overrides)
    tcfg = dataclasses.replace(tcb.get_smoke_config(arch), **overrides)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(tcb, get)(arch), getattr(jcb, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.groups == j.groups
        assert t.param_count() == j.param_count()
        assert t.resolved_head_dim == j.resolved_head_dim
    assert tcb.get_config(arch.replace("_", "-")) == tcb.get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(arch, dtype):
    jcfg, tcfg, jp, model = _models(arch)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(1)
    B, S, D = 2, 8, jcfg.d_model
    H, hd = jcfg.num_heads, jcfg.resolved_head_dim
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    scale = rng.standard_normal(D).astype(np.float32)
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=BF16_ULP, atol=1e-6)
    got = tlayers.rmsnorm(xt, torch.from_numpy(scale), jcfg.norm_eps)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, xj, jcfg.norm_eps)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    xh = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S) + 5, (B, S)).astype(np.int32)
    got = tlayers.rope(torch.from_numpy(xh).to(tdt), torch.from_numpy(pos),
                       jcfg.rope_theta)
    want = jlayers.rope(jnp.asarray(xh).astype(jdt), jnp.asarray(pos),
                        jcfg.rope_theta)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    got = tlayers.gelu(xt)
    want = jax.nn.gelu(xj)  # the tanh approximation, jax's default
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    else:  # the reference's bf16 ops, rounded where it rounds
        np.testing.assert_array_equal(_np(got), _np(want))
    # a SwiGLU MLP: the first layer's FFN, the leading dense layer's
    # (DeepSeek-V2), or the MoE block's dense residual MLP (Arctic;
    # test_torch_moe.py holds the block); Mamba2's SSD layers have none
    if jcfg.first_k_dense:
        jffn, ffn = jp["lead0"]["s0"]["ffn"], model.layers[0].ffn
    elif jcfg.moe:
        jffn = jax.tree_util.tree_map(lambda a: a[0],
                                      jp["g0"]["s0"]["ffn"]["dense_mlp"])
        ffn = model.layers[0].ffn.dense_mlp
    elif "ssd" in jcfg.group_pattern:
        return
    else:
        jffn = jax.tree_util.tree_map(lambda a: a[0], jp["g0"]["s0"]["ffn"])
        ffn = model.layers[0].ffn
    got = tlayers.mlp(ffn, xt)
    want = jlayers.mlp(jffn, xj)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-5)
    else:  # three bf16 matmuls, rounded at other places
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,attn_impl", [("float32", "xla"),
                                             ("float32", "pallas"),
                                             ("bfloat16", "xla"),
                                             ("bfloat16", "pallas")])
def test_forward_prefill_decode_match_reference(arch, dtype, attn_impl):
    """In bf16 the Arctic reference runs eagerly, as the port does: under
    jit, XLA's fusions round bf16 elsewhere, and for Arctic that flips one
    token's top-2 experts (the jitted reference's logits differ from its
    own eager ones by 1.99 at that token, where the port's and the eager
    reference's differ by less than 0.06).  DeepSeek-V2's routing flips
    no expert, and its reference runs as the others' do."""
    eager = arch == "arctic_480b" and dtype == "bfloat16"
    with jax.disable_jit() if eager else contextlib.nullcontext():
        _forward_prefill_decode(arch, dtype, attn_impl)


def _forward_prefill_decode(arch, dtype, attn_impl):
    jcfg, tcfg, jp, model = _models(arch, dtype=dtype, attn_impl=attn_impl)
    tol = 1e-4 if dtype == "float32" else 0.15
    B, S = 2, PROMPT.get(arch, 16)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S + 2))

    enc = _enc(jcfg, B)
    jenc = None if enc is None else jnp.asarray(enc)
    tenc = None if enc is None else torch.from_numpy(enc)

    def close(got, want):
        assert tuple(got.shape) == want.shape
        assert np.abs(_np(got) - _np(want)).max() < tol

    want, _, _ = JM.forward(jp, jcfg, jnp.asarray(toks, jnp.int32),
                            enc_inp=jenc)
    with torch.no_grad():  # K6 (attn_impl "pallas") has no backward pass
        got, _, _ = TM.forward(model, tcfg, torch.from_numpy(toks),
                               enc_inp=tenc)
    close(got, want)
    enc_len = jcfg.num_frontend_tokens
    jc = JM.init_cache(jcfg, B, S + 8, enc_len=enc_len)
    tc = TM.init_cache(tcfg, B, S + 8, enc_len=enc_len)
    want, jc = JM.prefill(jp, jcfg, jnp.asarray(toks[:, :S], jnp.int32), jc,
                          enc_inp=jenc)
    got, tc = TM.prefill(model, tcfg, torch.from_numpy(toks[:, :S]), tc,
                         enc_inp=tenc)
    close(got, want)
    for t in (S, S + 1):
        want, jc = JM.decode_step(jp, jcfg,
                                  jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                  jc, jnp.int32(t))
        got, tc = TM.decode_step(model, tcfg,
                                 torch.from_numpy(toks[:, t:t + 1]), tc, t)
        close(got, want)
    # the last layer's cache, entry by entry, in its own dtype
    name, pattern, reps = TM._groups(tcfg)[-1]
    want = jc[name][f"s{len(pattern) - 1}"]
    assert sorted(tc[-1]) == sorted(want)
    for key, got in tc[-1].items():
        w = want[key] if reps is None else want[key][-1]
        assert got.dtype == getattr(torch, str(w.dtype))
        assert tuple(got.shape) == w.shape
        # a recurrent state h sums bf16 inputs over the whole prompt in
        # float32: its bound scales with its size (SSD's reaches ~5)
        scale = max(1.0, float(np.abs(_np(w)).max())) if key == "h" else 1.0
        assert np.abs(_np(got) - _np(w)).max() < tol * scale


def _requests(module, vocab, lengths=((5, 4), (9, 3))):
    """(prompt length, new tokens) per request."""
    rng = np.random.default_rng(3)
    return [module.Request(prompt=rng.integers(0, vocab, n).astype(np.int32),
                           max_new_tokens=m)
            for n, m in lengths]


# the engine's requests: RecurrentGemma's longer prompt, left-padded with
# the shorter one's, wraps the local window of 32 in prefill and decode
ENGINE_REQUESTS = {"recurrentgemma_9b": (((37, 4), (9, 3)), 48)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_engine_greedy_tokens_match_reference(arch, attn_impl):
    jcfg, tcfg, jp, model = _models(arch, dtype="float32",
                                    attn_impl=attn_impl)
    lengths, max_seq = ENGINE_REQUESTS.get(arch, (((5, 4), (9, 3)), 32))
    enc = _enc(jcfg, len(lengths))
    want = JE.Engine(jcfg, jp, max_batch=2, max_seq=max_seq).generate(
        _requests(JE, jcfg.vocab_size, lengths),
        enc_inp=None if enc is None else jnp.asarray(enc))
    eng = TE.Engine(tcfg, model, max_batch=2, max_seq=max_seq, device="cpu")
    got = eng.generate(_requests(TE, tcfg.vocab_size, lengths), enc_inp=enc)
    for g, w in zip(got, want):
        assert g.out.dtype == np.int32
        np.testing.assert_array_equal(g.out, w.out)
    assert len(eng.stats["decode_s"]) == 3 and eng.stats["prefill_s"] > 0


def test_engine_defaults_to_the_card():
    cfg = tcb.get_smoke_config("tinyllama_1_1b")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        assert TE.Engine(cfg, model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TE.Engine(cfg, model)
    eng = TE.Engine(cfg, model, max_batch=1, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        eng.generate([TE.Request(prompt=np.zeros(6, np.int32),
                                 max_new_tokens=4)])


def test_engine_topk_sampling_is_seeded():
    cfg = tcb.get_smoke_config("granite_3_2b")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    outs = []
    for seed in (7, 7, 8):
        eng = TE.Engine(cfg, model, max_batch=2, max_seq=32, greedy=False,
                        seed=seed, device="cpu")
        reqs = eng.generate(_requests(TE, cfg.vocab_size))
        outs.append([r.out.tolist() for r in reqs])
        assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out)
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_samplers():
    logits = torch.tensor([[0.0, 3.0, 3.0, -1.0], [5.0, 1.0, 2.0, 4.9]])
    assert tsampler.greedy(logits).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    picks = {int(tsampler.topk_sample(logits, k=2, generator=g)[1])
             for _ in range(50)}
    assert picks == {0, 3}
    logits[0, 2] = 2.5
    assert tsampler.topk_sample(logits, k=1).tolist() == [1, 0]


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "6", "--new-tokens",
                 "3", "--max-seq", "16"])
    out = capsys.readouterr().out
    assert "6 tokens in" in out and out.count("req") == 2


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "recurrentgemma-9b",
                                  "mamba2-780m", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_serve_cli_new_families_on_cpu(arch, capsys):
    """The --arch ids of MLA, local attention, the recurrent blocks and
    cross attention through the serving CLI (smoke configs;
    RecurrentGemma's prompt past its window of 32; the cross-attention
    models on the CLI's stub frontend embeddings)."""
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "36", "--new-tokens",
                 "3", "--max-seq", "48"])
    out = capsys.readouterr().out
    assert "6 tokens in" in out and out.count("req") == 2
