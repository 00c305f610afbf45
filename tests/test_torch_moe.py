"""The port's MoE path against the JAX reference, on the CPU.

K7's plain version (``repro_torch.kernels.grouped_matmul`` on CPU
tensors) against the reference's Pallas kernel in interpret mode and its
``grouped_matmul_ref`` oracle on the sweep of
``tests/test_kernels_attn.py``, and against the oracle alone on ragged
group sizes; its counts layout against the contiguous one and the
oracle; ``sort_tokens_by_key`` against the reference's ``xla`` tier;
``moe_block`` (through the counts layout, and through the contiguous
layout over the padded buffer) against the reference's
``moe_block(dispatch="einsum")`` with the weights carried across by
``params_from_jax``, for Arctic's smoke config (dense residual MLP) and
DeepSeek-V2's smoke MoE settings (a shared expert, a leading dense
layer), with and without dropped tokens; and the serving CLI on
Arctic's smoke config.  K7's launch rules, which are pure Python, run
here too: the row tile and the grid, and which weight storage the
wrapper hands the kernel (a stub launch records it).  Inputs
come from a seeded numpy generator and go to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (binds the reference's kernels package)
from repro.configs import base as jcb
from repro.kernels import ops as jops
from repro.kernels.grouped_matmul import grouped_matmul_pallas
from repro.kernels.ref import grouped_matmul_ref as jax_grouped_matmul_ref
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch.configs import base as tcb
from repro_torch.kernels import grouped_matmul as k7
from repro_torch.kernels import ops as tops
from repro_torch.kernels.grouped_matmul import (grid_rows, grouped_matmul,
                                                row_tile)
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BF16_ULP = 2.0 ** -7   # one bf16 rounding, relative

# tests/test_kernels_attn.py's sweep: T = 64, sizes multiples of 8
SWEEP = [(4, 16, 32, [8, 16, 0, 24]), (3, 8, 8, [8, 8, 8]),
         (5, 32, 16, [0, 0, 40, 8, 0]), (2, 64, 128, [32, 0])]
# sizes that are no multiples of 8, empty groups, rows past the last group
RAGGED = [(37, 5, 24, 40, [3, 0, 17, 1, 9]), (80, 3, 64, 136, [70, 5, 0]),
          (10, 1, 8, 16, [0]), (21, 4, 16, 8, [5, 6, 7, 3])]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _assert_one_rounding(got, want):
    """|got - want| within one bf16 rounding of want (2**-7 of it) plus
    1e-4 of the largest |want|: the float32 sums run in other orders."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    bound = BF16_ULP * np.abs(want) + 1e-4 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def _assert_close32(got, want, rel=1e-4):
    """|got - want| within ``rel`` of the largest |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _gmm_inputs(T, E, D, F, sizes, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = rng.standard_normal((E, D, F)).astype(np.float32)
    return x, w, np.array(sizes, np.int32)


@pytest.mark.parametrize("E,D,F,sizes", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_plain_matches_pallas_and_ref(E, D, F, sizes, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, gs = _gmm_inputs(64, E, D, F, sizes)
    got = grouped_matmul(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt), torch.from_numpy(gs))
    assert got.dtype == tdt and got.shape == (64, F)
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    pallas = grouped_matmul_pallas(xj, wj, jnp.asarray(gs), bt=8)
    oracle = jax_grouped_matmul_ref(xj.astype(jnp.float32),
                                    wj.astype(jnp.float32), jnp.asarray(gs))
    for want in (pallas, oracle):
        if dtype == "float32":
            _assert_close32(got, want)
        else:
            _assert_one_rounding(got, want)
    assert not _np(got)[gs.sum():].any()


@pytest.mark.parametrize("T,E,D,F,sizes", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_plain_ragged_sizes(T, E, D, F, sizes, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w, gs = _gmm_inputs(T, E, D, F, sizes, seed=2)
    got = grouped_matmul(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt), torch.from_numpy(gs))
    want = jax_grouped_matmul_ref(
        jnp.asarray(x).astype(jdt).astype(jnp.float32),
        jnp.asarray(w).astype(jdt).astype(jnp.float32), jnp.asarray(gs))
    if dtype == "float32":
        _assert_close32(got, want)
    else:
        _assert_one_rounding(got, want)
    assert not _np(got)[gs.sum():].any()


# (T, E, dtype, row tile): bf16 tiles of 64-256 rows, one per group of up
# to 256 (Arctic's decode cap 8 and prefill cap 40, DeepSeek-V2's cap 96,
# caps 160 and 256, cap 300 over two tiles); float32 keeps 16-64
ROW_TILES = [(1024, 128, "bfloat16", 64), (5120, 128, "bfloat16", 64),
             (160 * 96, 160, "bfloat16", 128), (4 * 160, 4, "bfloat16", 192),
             (2 * 256, 2, "bfloat16", 256), (3 * 300, 3, "bfloat16", 256),
             (10, 0, "bfloat16", 64), (1024, 128, "float32", 16),
             (5120, 128, "float32", 64), (64, 4, "float32", 16),
             (96, 3, "float32", 32), (10, 0, "float32", 16),
             (700, 2, "float32", 64), (160 * 96, 160, "float32", 64)]


@pytest.mark.parametrize("T,E,dtype,bm", ROW_TILES)
def test_grouped_matmul_row_tile(T, E, dtype, bm):
    assert row_tile(T, E, DTYPES[dtype][0]) == bm


# (T, E, bm, cap, row tiles of the launch)
GRID_ROWS = [
    # contiguous: ceil(T / bm) + E + 1, an upper bound of the groups' tiles
    (1024, 128, 64, None, 16 + 128 + 1), (37, 5, 64, None, 1 + 5 + 1),
    (1024, 128, 16, None, 64 + 128 + 1), (37, 5, 16, None, 3 + 5 + 1),
    # counts: ceil(cap / bm) tiles per group, then the rows past E cap
    (1024, 128, 64, 8, 128),              # Arctic decode
    (5120, 128, 64, 40, 128),             # Arctic prefill
    (160 * 96, 160, 128, 96, 160),        # DeepSeek-V2's prefill, cap 96
    (4 * 160, 4, 192, 160, 4), (2 * 256, 2, 256, 256, 2),
    (3 * 300, 3, 256, 300, 3 * 2),        # cap 300: two tiles a group
    (100, 2, 64, 40, 2 + 1),              # 20 rows past E cap
    (100, 2, 16, 40, 2 * 3 + 2),          # float32's tile
    (60, 2, 64, 40, 2),                   # T < E cap
    (9, 0, 64, 8, 1)]


@pytest.mark.parametrize("T,E,bm,cap,rows", GRID_ROWS)
def test_grouped_matmul_grid_rows(T, E, bm, cap, rows):
    assert grid_rows(T, E, bm, cap) == rows


def _recorded_launch(monkeypatch):
    """Stub K7's launch (pure Python from here on, so it runs on the
    CPU): record the storage and layout flag each launch is given.  The
    launch counters are restored afterwards."""
    seen = []

    def launch(x, w, sizes, out, *, cap=None, k_major=False):
        seen.append((x, w, k_major))

    monkeypatch.setattr(k7, "launch", launch)
    gm = k7.grouped_matmul
    monkeypatch.setattr(gm, "launches", gm.launches)
    monkeypatch.setattr(gm, "routes", dict(gm.routes))
    return seen


def _weights(E, K, N, how, dtype):
    """(w (E, K, N), the tensor whose storage w is a view of) for a stride
    pattern ``how``."""
    if how == "contiguous":
        w = torch.randn(E, K, N).to(dtype)
        return w, w
    if how == "transposed":        # the backward's w.transpose(1, 2)
        base = torch.randn(E, N, K).to(dtype)
        return base.transpose(1, 2), base
    if how == "permuted":          # (K, E, N) storage
        base = torch.randn(K, E, N).to(dtype)
        return base.transpose(0, 1), base
    if how == "column slice":      # the first N of 2 N columns
        base = torch.randn(E, K, 2 * N).to(dtype)
        return base[:, :, :N], base
    # a transposed view of a tensor that is not contiguous itself
    base = torch.randn(E, N, 2 * K).to(dtype)
    return base[:, :, :K].transpose(1, 2), base


@pytest.mark.parametrize("how", ["contiguous", "transposed", "permuted",
                                 "column slice", "transposed slice"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_weight_layout(monkeypatch, how, dtype):
    """The wrapper hands the kernel W as it lies when it is contiguous or
    the transposed view of a contiguous (E, N, K) tensor (the backward's
    dx = dy W^T: same storage, K-major flag set, no copy); any other
    strides are made contiguous (E, K, N)."""
    seen = _recorded_launch(monkeypatch)
    E, K, N, T, cap = 3, 16, 24, 12, 4
    w, base = _weights(E, K, N, how, DTYPES[dtype][0])
    x = torch.randn(T, K).to(w.dtype)
    out = k7.kernel_launch(x, w, torch.tensor([4, 2, 0]), cap)
    assert out.shape == (T, N) and len(seen) == 1
    _, ws, k_major = seen[0]
    assert ws.is_contiguous()
    if how in ("contiguous", "transposed"):
        assert ws.data_ptr() == base.data_ptr()
        assert k_major == (how == "transposed")
        assert ws.shape == ((E, N, K) if k_major else (E, K, N))
    else:
        assert not k_major and ws.shape == (E, K, N)
        assert ws.data_ptr() != base.data_ptr()
        assert torch.equal(ws, w)


def test_grouped_matmul_unaligned_inputs_are_copied(monkeypatch):
    """A base TMA cannot read (not 16-byte aligned) is copied; an aligned
    row slice is read in place."""
    seen = _recorded_launch(monkeypatch)
    flat = torch.randn(12 * 16 + 2).to(torch.bfloat16)
    x = flat[2:].view(12, 16)      # 4 bytes past an aligned base
    assert x.data_ptr() % 16
    rows = torch.randn(20, 16).to(torch.bfloat16)[8:]
    w = torch.randn(2, 16, 8).to(torch.bfloat16)
    for xi, in_place in ((x, False), (rows, True)):
        k7.kernel_launch(xi, w, torch.tensor([6, 6]), None)
        got = seen[-1][0]
        assert got.data_ptr() % 16 == 0 and torch.equal(got, xi)
        assert (got.data_ptr() == xi.data_ptr()) == in_place


# (T, E, cap, D, F, counts): kept rows per group at stride cap; empty
# groups, a count past cap (clamped), rows past E cap, T short of E cap
COUNTS = [(32, 4, 8, 16, 32, [3, 0, 8, 5]), (30, 3, 10, 8, 24, [10, 1, 0]),
          (30, 5, 6, 32, 16, [0, 0, 0, 0, 0]), (13, 2, 4, 16, 8, [7, 2]),
          (20, 2, 12, 16, 8, [12, 6])]


@pytest.mark.parametrize("T,E,cap,D,F,counts", COUNTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_plain_counts_layout(T, E, cap, D, F, counts, dtype):
    """The counts layout equals the contiguous layout over the same
    buffer with the unkept rows zeroed (value for value), ignores what
    the unkept rows hold, and matches the reference's oracle on the kept
    rows packed contiguously."""
    tdt, jdt = DTYPES[dtype]
    x, w, gs = _gmm_inputs(T, E, D, F, counts, seed=3)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    kept = np.zeros(T, bool)
    for g, n in enumerate(counts):
        kept[g * cap:min(g * cap + min(n, cap), T)] = True
    got = grouped_matmul(xt, wt, torch.from_numpy(gs), cap=cap)
    assert got.dtype == tdt and got.shape == (T, F)
    assert not _np(got)[~kept].any()
    padded = torch.where(torch.from_numpy(kept)[:, None], xt, 0)
    n_full = min(E, -(-T // cap))
    full = torch.tensor([min(cap, T - g * cap) for g in range(n_full)]
                        + [0] * (E - n_full), dtype=torch.int32)
    assert torch.equal(got, grouped_matmul(padded, wt, full))
    if not kept.any():
        return
    sizes = [int(kept[g * cap:(g + 1) * cap].sum()) for g in range(E)]
    want = jax_grouped_matmul_ref(
        jnp.asarray(x[kept]).astype(jdt).astype(jnp.float32),
        jnp.asarray(w).astype(jdt).astype(jnp.float32),
        jnp.asarray(sizes, jnp.int32))
    if dtype == "float32":
        _assert_close32(got[torch.from_numpy(kept)], want)
    else:
        _assert_one_rounding(got[torch.from_numpy(kept)], want)


def test_expert_ffn_counts_rows_only():
    """_expert_ffn reads each expert's first counts[e] rows only: what the
    other rows hold does not reach the output, which is zero there."""
    jcfg, tcfg = _moe_config("arctic", dtype="float32")
    _, ffn = _moe_blocks(jcfg, tcfg)
    E, C, D = tcfg.num_experts, 5, tcfg.d_model
    rng = np.random.default_rng(8)
    xe = torch.from_numpy(rng.standard_normal((E, C, D)).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, C + 1, E).astype(np.int32))
    kept = torch.arange(C)[None, :] < counts[:, None]
    got = tmoe._expert_ffn(ffn.experts, xe, counts)
    clean = tmoe._expert_ffn(ffn.experts, torch.where(kept[..., None], xe, 0),
                             counts)
    assert torch.equal(got, clean)
    assert not got[~kept].any() and got[kept].abs().min() > 0


@pytest.mark.parametrize("n", [8, 64, 256, 100, 1000])
def test_sort_tokens_by_key_matches_reference(n):
    keys = np.random.default_rng(n).integers(0, 8, n).astype(np.int32)
    want_k, want_p = jops.sort_tokens_by_key(jnp.asarray(keys), backend="xla")
    got_k, got_p = tops.sort_tokens_by_key(torch.from_numpy(keys),
                                           backend="torch")
    assert got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    # "auto" on CPU tensors is the torch route; "cuda" refuses them
    np.testing.assert_array_equal(
        tops.sort_tokens_by_key(torch.from_numpy(keys))[1].numpy(),
        got_p.numpy())
    with pytest.raises(ValueError, match="cuda"):
        tops.sort_tokens_by_key(torch.from_numpy(keys), backend="cuda")


def _moe_config(name, **overrides):
    """(reference config, port config): Arctic's smoke config, or
    DeepSeek-V2's smoke MoE settings (one shared expert, a leading dense
    layer) on GQA attention, since the port has no MLA yet."""
    if name == "arctic":
        jcfg = jcb.get_smoke_config("arctic_480b")
    else:
        jcfg = dataclasses.replace(jcb.get_smoke_config("deepseek_v2_236b"),
                                   mla=False)
    jcfg = dataclasses.replace(jcfg, **overrides)
    return jcfg, tcb.ModelConfig(**dataclasses.asdict(jcfg))


def _moe_blocks(jcfg, tcfg, seed=0):
    """The reference's and the port's MoE blocks of the last layer, with
    the same weights (carried across by params_from_jax)."""
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    jffn = jax.tree_util.tree_map(lambda a: a[-1], jp["g0"]["s0"]["ffn"])
    return jffn, model.layers[-1].ffn


def _contiguous_gmm(x, w, counts, *, cap):
    """The contiguous layout over the padded buffer: every group all
    ``cap`` rows, kept or not."""
    return grouped_matmul(x, w, torch.full_like(counts, cap))


@pytest.mark.parametrize("name", ["arctic", "deepseek"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["counts", "contiguous"])
def test_moe_block_matches_reference(name, dtype, layout):
    tdt, jdt = DTYPES[dtype]
    jcfg, tcfg = _moe_config(name, dtype=dtype)
    jffn, ffn = _moe_blocks(jcfg, tcfg)
    x = np.random.default_rng(4).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    want, want_aux = jmoe.moe_block(jffn, jnp.asarray(x).astype(jdt), jcfg,
                                    dispatch="einsum")
    gmm = grouped_matmul if layout == "counts" else _contiguous_gmm
    got, got_aux = tmoe.moe_block(ffn, torch.from_numpy(x).to(tdt), tcfg,
                                  gmm=gmm)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(got_aux), float(want_aux),
                                   rtol=1e-6)
    else:  # bf16 matmuls and sums rounded at other places
        np.testing.assert_allclose(_np(got), _np(want), rtol=0.05, atol=0.05)
        np.testing.assert_allclose(float(got_aux), float(want_aux),
                                   rtol=1e-3)


@pytest.mark.parametrize("name", ["arctic", "deepseek"])
def test_moe_block_drops_tokens_like_reference(name):
    """T·k > 256 takes the capacity; at capacity factor 0.5 the experts
    overflow, and the same assignments are dropped."""
    jcfg, tcfg = _moe_config(name, dtype="float32", capacity_factor=0.5)
    jffn, ffn = _moe_blocks(jcfg, tcfg, seed=1)
    x = np.random.default_rng(5).standard_normal(
        (2, 80, jcfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).reshape(-1, jcfg.d_model)
    _, _, _, cap, pos, keep = tmoe._assign(ffn, xt, tcfg)
    T = xt.shape[0]
    assert T * tcfg.top_k > 256 and cap == 24
    assert 0 < int((~keep).sum()) < T * tcfg.top_k
    assert int(pos.max()) >= cap
    want, want_aux = jmoe.moe_block(jffn, jnp.asarray(x), jcfg,
                                    dispatch="einsum")
    got, got_aux = tmoe.moe_block(ffn, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_moe_block_plain_gmm_is_the_same_block():
    """The gmm argument (the card's checks pass the plain version) changes
    which grouped matmul runs, not the block: on the CPU both are the
    plain version."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain

    jcfg, tcfg = _moe_config("arctic", dtype="float32")
    _, ffn = _moe_blocks(jcfg, tcfg)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 5, jcfg.d_model)).astype(np.float32))
    a, _ = tmoe.moe_block(ffn, x, tcfg)
    b, _ = tmoe.moe_block(ffn, x, tcfg, gmm=grouped_matmul_plain)
    assert torch.equal(a, b)


def test_deepseek_moe_settings_forward_matches_reference():
    """A leading dense layer then an MoE layer with a shared expert
    (first_k_dense = 1): the whole forward, and its aux loss."""
    jcfg, tcfg = _moe_config("deepseek", dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(2))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    assert [type(b.ffn).__name__ for b in model.layers] == ["MLP", "MoE"]
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 10))
    want, want_aux, _ = JM.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    from repro_torch.models import model as TM
    got, got_aux, _ = TM.forward(model, tcfg, torch.from_numpy(toks))
    assert np.abs(_np(got) - _np(want)).max() < 1e-4
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


def test_serve_cli_arctic_smoke_on_cpu(capsys):
    tserve.main(["--arch", "arctic-480b", "--smoke", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "6", "--new-tokens",
                 "3", "--max-seq", "16"])
    out = capsys.readouterr().out
    assert "6 tokens in" in out and out.count("req") == 2
