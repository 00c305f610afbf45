"""repro_torch's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports torch, numpy and the port
only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel (K1 chunk sort, K2 partition merge on short rows and on
long rows spread over many CTAs, K3 fused bucket on both of its routes
and on its expand entry, accumulators included,
K4 stream sort, K5 stream merge in its chunk and pointer forms; K1 and
K4 on both routes, counted in their ``routes``, and in every launch
shape of the warp route) must equal its plain version bit for bit — keys, values (-0.0 included),
lengths and the mszip counters — and count its launch.  K6 flash
attention must agree with its plain version within the reference
sweep's tolerances (2e-4 in float32, one bf16 rounding plus 1e-6 in
bf16: it sums each row tile by tile) at head dims up to 256 and
B * H = 65,536, take the wgmma route for bf16 and the fma route for
float32, and launch once per layer in a prefill and never in decode.  K7 grouped
matmul must agree with its plain version within 1e-4 of the output's
largest magnitude in float32 and one bf16 rounding (plus that 1e-4) in
bf16, in both of its layouts, write exact zeros in every row no group
keeps, and launch three times per MoE layer per forward pass, in the
counts layout, and under autograd run its backward pass (the dx launch
over W transposed on the route ``backward``, dW by ``torch.bmm``) with
plain autograd's gradients; K6 raises under autograd.  The sharded
batched path on one card equals
``execute_batched`` (CSR and the six counters); the SpGEMM service's
flush threads launch on the caller's stream, a kernel launch error raises
out of ``drain``, and its ladder degrades and isolates on the card only.
"""
import numpy as np
import pytest
import torch

import dataclasses

from repro_torch.configs import base as cb
from repro_torch.core import spgemm
from repro_torch.core.formats import EMPTY, csr_to_numpy, random_sparse
from repro_torch.kernels import backend as kb
from repro_torch.kernels.chunk_sort import (chunk_sort, chunk_sort_plain,
                                            sort_config)
from repro_torch.kernels.chunk_sort import launch as chunk_sort_launch
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.fused_bucket import (accumulators, fused_bucket,
                                              fused_bucket_plain,
                                              fused_expand_bucket,
                                              fused_expand_bucket_plain)
from repro_torch.kernels import grouped_matmul as k7
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.kernels.merge_partitions import (merge_partitions,
                                                  merge_partitions_plain)
from repro_torch.kernels.ops import sort_tokens_by_key
from repro_torch.kernels.stream_merge import (stream_merge, stream_merge_plain,
                                              stream_merge_ptr,
                                              stream_merge_ptr_plain)
from repro_torch.kernels.stream_sort import stream_sort, stream_sort_plain
from repro_torch.kernels.stream_sort import launch as stream_sort_launch
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, Request

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _eq(want, got):
    want, got = want.cpu(), got.cpu()
    assert want.dtype == got.dtype and want.shape == got.shape
    if want.is_floating_point():
        want, got = want.view(torch.int32), got.view(torch.int32)
    assert torch.equal(want, got)


def _chunks(rng, N, R, key_hi):
    """Random chunks with an empty chunk first and, where N > 3, a full
    all-duplicate chunk and a lone -0.0; -0.0 among the values."""
    lens = rng.integers(0, R + 1, N).astype(np.int32)
    lens[0] = 0
    keys = rng.integers(0, key_hi, (N, R)).astype(np.int32)
    vals = rng.standard_normal((N, R)).astype(np.float32)
    vals[rng.random((N, R)) < 0.1] = -0.0
    if N > 3:
        keys[1], lens[1] = 7, R
        keys[2, 0], vals[2, 0], lens[2] = 5, -0.0, 1
    return keys, vals, lens


# (N, R, key_hi) of the chunk sorts: the earlier sweep over R = 8-128, the
# warp route's widest chunk (R = 256), the block route (R = 512), many
# chunks (N = 65,536), and the main paths' shapes
_SORT_CASES = [(N, R, hi) for R in (8, 16, 32, 128, 256, 512)
               for N, hi in ((301, 3), (301, 1000), (3, 5))] + [
    (65536, 8, 3), (8192, 16, 39082), (512, 16, 7)]


def _route(R):
    return "block" if sort_config(R, R) is None else "warp"


def _every_warp_shape(launch, args, want):
    """The warp route in every launch shape its kernel takes for these
    chunks (each ITEMS with ITEMS <= R <= 32 ITEMS, 1 and 4 warps a
    block; R = 8 with ITEMS = 8 among them), against the plain version."""
    R = args[0].shape[1]
    outs = [torch.empty_like(w) for w in want]
    for items in (1, 2, 4, 8):
        if items <= R <= 32 * items:
            for warps in (1, 4):
                launch(*args, *outs, config=(items, warps))
                for w, g in zip(want, outs):
                    _eq(w, g)


def _partition(rng, N, L, key_hi, max_len=None):
    lens = rng.integers(0, min(L, max_len or L) + 1, N).astype(np.int32)
    keys = np.full((N, L), EMPTY, np.int32)
    vals = np.zeros((N, L), np.float32)
    for s in range(N):
        keys[s, :lens[s]] = np.sort(rng.choice(key_hi, lens[s], replace=False))
        vals[s, :lens[s]] = rng.standard_normal(lens[s])
    return keys, vals, lens


def _bucket(rng, S, L, key_hi):
    plens = rng.integers(0, L + 1, S).astype(np.int32)
    plens[0] = 0
    mask = np.arange(L)[None, :] < plens[:, None]
    keys = np.where(mask, rng.integers(0, key_hi, (S, L)), EMPTY)
    vals = np.where(mask, rng.standard_normal((S, L)), 0.0)
    return keys.astype(np.int32), vals.astype(np.float32), plens


@pytest.mark.parametrize("N,R,key_hi", _SORT_CASES)
def test_chunk_sort_kernel(card, N, R, key_hi):
    args = _on(card, *_chunks(np.random.default_rng(R + key_hi), N, R,
                              key_hi))
    before, routes = chunk_sort.launches, dict(chunk_sort.routes)
    got = chunk_sort(*args)
    assert chunk_sort.launches == before + 1
    assert chunk_sort.routes[_route(R)] == routes[_route(R)] + 1
    want = chunk_sort_plain(*args)
    for w, g in zip(want, got):
        _eq(w, g)
    _every_warp_shape(chunk_sort_launch, args, want)


@pytest.mark.parametrize("N,La,Lb,R,S", [(64, 256, 256, 16, 8),
                                         (6, 5, 3, 4, 3),
                                         (7, 16, 0, 8, None),
                                         (96, 16, 48, 8, 32),
                                         (2, 4096, 4096, 16, None),
                                         (1, 16384, 16384, 16, None),
                                         (1, 2**19, 2**19, 16, None),
                                         (3, 2**19, 2**19, 16, None)])
def test_merge_partitions_kernel(card, N, La, Lb, R, S):
    """The last two cases merge La + Lb = 2^20 slots a row: more ballot
    bits than a block's shared memory holds, so K2 keeps them in device
    memory (lengths stay modest so the plain advance loop stays short)."""
    rng = np.random.default_rng(La + Lb)
    hi = 3 * max(La, Lb, 1)
    max_len = min(max(La, Lb), 40_000)
    args = _on(card, *_partition(rng, N, La, hi, max_len),
               *_partition(rng, N, Lb, hi, max_len))
    got = merge_partitions(*args, R=R, pair_streams=S)
    want = merge_partitions_plain(*args, R=R, pair_streams=S)
    for w, g in zip(want[:3], got[:3]):
        _eq(w, g)
    assert [int(x) for x in want[3]] == [int(x) for x in got[3]]


def _long_rows(rng, N, La, Lb, max_len):
    """Long rows of max_len / 2 to max_len keys a side below 2 max_len
    (so duplicates fall on many of the 2,048-element tile boundaries):
    row 1 all duplicates (B holds A's keys), row 2 with an empty B side."""
    out = []
    for L in (La, Lb):
        hi = min(L, max_len)
        lens = rng.integers(hi // 2, hi + 1, N).astype(np.int32)
        keys = np.full((N, L), EMPTY, np.int32)
        vals = np.zeros((N, L), np.float32)
        for s in range(N):
            keys[s, :lens[s]] = np.sort(rng.choice(2 * max_len, lens[s],
                                                   replace=False))
            vals[s, :lens[s]] = rng.standard_normal(lens[s])
        out += [keys, vals, lens]
    ka, va, la, kb, vb, lb = out
    if N > 1:
        n = min(la[1], Lb)
        kb[1], vb[1] = EMPTY, 0.0
        kb[1, :n], lb[1] = ka[1, :n], n
    if N > 2:
        kb[2], vb[2], lb[2] = EMPTY, 0.0, 0
    return ka, va, la, kb, vb, lb


@pytest.mark.parametrize("N,La,Lb,R", [(1, 2**15, 2**15, 16),
                                       (3, 2**14, 2**12, 16),
                                       (3, 2**13, 2**13, 8),
                                       (1, 2**19, 2**19, 16)])
def test_merge_partitions_long_rows(card, N, La, Lb, R):
    """K2's long-row route: a row's merged elements are cut into tiles of
    2,048 across CTAs, and its counters come from pointer jumping; keys,
    values, lengths and the counters per row equal the plain version."""
    rng = np.random.default_rng(La + 3 * Lb + N)
    args = _on(card, *_long_rows(rng, N, La, Lb, 40_000))
    assert int(args[2][0] + args[5][0]) > 2048  # more than one tile
    before = merge_partitions.launches
    got = merge_partitions(*args, R=R, pair_streams=1)
    assert merge_partitions.launches == before + 1
    want = merge_partitions_plain(*args, R=R, pair_streams=1)
    for w, g in zip(want[:3], got[:3]):
        _eq(w, g)
    assert [int(x) for x in want[3]] == [int(x) for x in got[3]]
    # per-row counters: each row its own pair
    for s in range(N):
        row = [a[s:s + 1] for a in args]
        assert [int(x) for x in merge_partitions(*row, R=R)[3]] == \
            [int(x) for x in merge_partitions_plain(*row, R=R)[3]]
    got = merge_partitions(*args, R=R, with_counters=False)
    for w, g in zip(want[:3], got[:3]):
        _eq(w, g)


def test_merge_partitions_long_rows_unusual_inputs(card):
    """Inputs the plain advance loop admits beyond sorted, non-negative
    keys: an EMPTY inside A's length where B runs out first (pointer
    jumping), and negative keys (the plain loop in one warp)."""
    L = 4096
    ka = np.full((2, L), EMPTY, np.int32)
    kb = np.full((2, L), EMPTY, np.int32)
    va = np.ones((2, L), np.float32)
    vb = np.full((2, L), 2.0, np.float32)
    ka[0, :3000] = np.arange(0, 6000, 2)
    kb[0, :1000] = np.arange(1, 2000, 2)
    la = np.array([3001, 3000], np.int32)  # A[0, 3000] is EMPTY
    lb = np.array([1000, 2500], np.int32)
    ka[1, :3000] = np.arange(-3000, 3000, 2)
    kb[1, :2500] = np.arange(-2000, 3000, 2)
    args = _on(card, ka, va, la, kb, vb, lb)
    for s in range(2):
        row = [a[s:s + 1] for a in args]
        got = merge_partitions(*row, R=16)
        want = merge_partitions_plain(*row, R=16)
        for w, g in zip(want[:3], got[:3]):
            _eq(w, g)
        assert [int(x) for x in want[3]] == [int(x) for x in got[3]]


@pytest.mark.parametrize("S,L,R,route", [(64, 512, 16, "fused"),
                                         (5, 64, 8, "fused"),
                                         (2, 32, 16, "fused"),
                                         (1, 16, 16, "fused"),
                                         (512, 16, 16, "fused"),
                                         (300, 32, 16, "fused"),
                                         (3, 1024, 128, "fused"),
                                         (2, 8192, 16, "fused"),
                                         (4, 256, 4, "fused"),
                                         (2, 4096, 512, "fused"),
                                         (2, 32768, 16, "large"),
                                         (3, 16384, 8, "large")])
def test_fused_bucket_kernel(card, S, L, R, route):
    rng = np.random.default_rng(S * L)
    args = _on(card, *_bucket(rng, S, L, 3 * L))
    before = dict(fused_bucket.routes)
    got = fused_bucket(*args, R=R, detailed=True)
    assert fused_bucket.routes[route] == before[route] + 1
    want = fused_bucket_plain(*args, R=R, detailed=True)
    for w, g in zip(want[:3], got[:3]):
        _eq(w, g)
    assert len(want[3]) == len(got[3])
    for (ws, wz, wt), (gs, gz, gt) in zip(want[3], got[3]):
        _eq(ws, gs)
        assert int(wz) == int(gz)
        _eq(wt, gt)
    counters = fused_bucket(*args, R=R)[3]
    _eq(fused_bucket_plain(*args, R=R)[3], counters)


def _fma_values(rng, n):
    """Values 1 + k / 4096 (both signs): a product of two needs more than
    24 bits, so fmaf(a, b, acc) and acc + a * b differ."""
    k = rng.integers(1, 4096, n)
    return (np.where(rng.random(n) < 0.3, -1.0, 1.0) * (1 + k / 4096.0)) \
        .astype(np.float32)


def _expand_case(rng, L, Bn=2, n_rows=12):
    """Bn stacked CSR lanes (A: n_rows rows, B: 128 rows, some empty) whose
    A rows make between L / 2 and L products each, with columns in a
    narrow range (duplicate runs in every chunk)."""
    n_b, n_cols = 128, max(32, L // 4)
    lanes = []
    for _ in range(Bn):
        blen = rng.integers(1, max(2, L // 16) + 1, n_b)
        blen[rng.random(n_b) < 0.1] = 0
        b_rows = [np.sort(rng.choice(n_cols, min(n, n_cols), replace=False))
                  for n in blen]
        blen = np.array([len(r) for r in b_rows])
        a_rows = []
        for _ in range(n_rows):
            target, work, row = rng.integers(L // 2 + 1, L + 1), 0, []
            for j in rng.permutation(n_b):
                if work + blen[j] <= target:
                    row.append(j)
                    work += blen[j]
            a_rows.append(np.sort(np.array(row, np.int64)))
        lanes.append((a_rows, b_rows))
    cap_a = max(sum(len(r) for r in a) for a, _ in lanes) + 3
    cap_b = max(sum(len(r) for r in b) for _, b in lanes) + 3

    def csr(rows, cap):
        indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
        idx = np.full(cap, EMPTY, np.int32)
        val = np.zeros(cap, np.float32)
        flat = np.concatenate(rows).astype(np.int32)
        idx[:len(flat)] = flat
        val[:len(flat)] = _fma_values(rng, len(flat))
        return indptr.astype(np.int32), idx, val

    a = [csr(ar, cap_a) for ar, _ in lanes]
    b = [csr(br, cap_b) for _, br in lanes]
    return [np.stack([m[i] for m in mats]) for mats in (a, b)
            for i in range(3)]


@pytest.mark.parametrize("L,R", [(2 ** e, 16) for e in range(4, 14)]
                         + [(64, 8), (1024, 8), (32, 4), (512, 128),
                            (256, 4), (2048, 2), (4096, 512)])
def test_fused_expand_bucket_kernel(card, L, R):
    """The expand entry equals its plain composition (expansion, sort,
    merge tree, reduction) bit for bit: keys, values, lengths and the
    group accumulators, which already hold an earlier bucket's counters
    and belong to a group twice as wide (its columns sit elsewhere).
    Padding streams (row_ids = -1), two lanes, and values whose products
    an FMA would change."""
    rng = np.random.default_rng(L * R)
    mats = _on(card, *_expand_case(rng, L))
    S = 9
    rows = rng.integers(0, 12, S)
    rows[[2, 7]] = -1
    lanes = rng.integers(0, 2, S)
    ids = _on(card, rows.astype(np.int64), lanes.astype(np.int64))
    Cg = 2 * (L // R)
    prior = torch.from_numpy(rng.integers(0, 4, 4 * max(Cg - 1, 1))).to(card)
    accs = []
    for fn in (fused_expand_bucket, fused_expand_bucket_plain):
        buf, steps, zips, tails = accumulators(Cg, card)
        buf.copy_(prior)
        accs.append(buf)
        kb.reset_launch_counts()
        out = fn(*ids, *mats, R=R, L=L, steps_acc=steps, zip_acc=zips,
                 tails_acc=tails)
        if fn is fused_expand_bucket:
            got = out
            counts = kb.launch_counts()
            assert counts["fused_bucket"] == counts["fused_bucket.expand"] == 1
        else:
            want = out
    for w, g in zip(want, got):
        _eq(w, g)
    _eq(accs[1], accs[0])
    assert int(got[2][2]) == int(got[2][7]) == 0
    assert (accs[0] != prior).any() or L == R


def test_fused_expand_bucket_rejects_what_it_cannot_take(card):
    rng = np.random.default_rng(1)
    mats = _on(card, *_expand_case(rng, 64))
    ids = _on(card, np.arange(3, dtype=np.int64), np.zeros(3, np.int64))
    _, steps, zips, tails = accumulators(4, card)
    with pytest.raises(ValueError, match="large route"):
        fused_expand_bucket(*ids, *mats, R=16, L=16384, steps_acc=steps,
                            zip_acc=zips, tails_acc=tails)
    with pytest.raises(ValueError, match="accumulators"):
        fused_expand_bucket(*ids, *mats, R=16, L=64, steps_acc=steps[:2],
                            zip_acc=zips, tails_acc=tails)
    with pytest.raises(TypeError):
        fused_expand_bucket(ids[0].int(), ids[1], *mats, R=16, L=64,
                            steps_acc=steps, zip_acc=zips, tails_acc=tails)


@pytest.mark.parametrize("L,R", [(64, 16), (1024, 16), (8192, 16),
                                 (256, 4)])
def test_fused_expand_bucket_many_lanes(card, L, R):
    """The expand entry on four stacked lanes, their streams interleaved
    in one bucket (lane ids 0..3 in turn), lane 3 a padding lane (empty
    CSR) and two padding streams, equals its plain composition bit for
    bit: keys, values, lengths and the group accumulators."""
    rng = np.random.default_rng(L + R)
    arrays = _expand_case(rng, L, Bn=4)
    # lane 3 of A: no entries, EMPTY/0 padding
    arrays[0][3], arrays[1][3], arrays[2][3] = 0, EMPTY, 0.0
    mats = _on(card, *arrays)
    S = 16
    rows = rng.integers(0, 12, S)
    rows[[5, 11]] = -1
    lanes = np.arange(S) % 4
    ids = _on(card, rows.astype(np.int64), lanes.astype(np.int64))
    Cg = L // R
    accs, outs = [], []
    for fn in (fused_expand_bucket, fused_expand_bucket_plain):
        buf, steps, zips, tails = accumulators(Cg, card)
        accs.append(buf)
        outs.append(fn(*ids, *mats, R=R, L=L, steps_acc=steps, zip_acc=zips,
                       tails_acc=tails))
    for w, g in zip(outs[1], outs[0]):
        _eq(w, g)
    _eq(accs[1], accs[0])
    lens = outs[0][2].cpu().numpy()
    assert (lens[lanes == 3] == 0).all() and lens[5] == lens[11] == 0
    assert (lens[(lanes < 3) & (rows >= 0)] > 0).all()


def _hub_lanes():
    """A 512 x 512 lane with a 512-nnz hub row (A·A row 0: ~10K
    products, a bucket of L = 16,384 on the large route) and a uniform
    lane."""
    from repro_torch.core.formats import csr_from_coo
    base = random_sparse(512, 512, 0.04, seed=31)
    indptr, cols, vals = csr_to_numpy(base)
    rows = np.repeat(np.arange(512), np.diff(indptr))
    keep = rows != 0
    rng = np.random.default_rng(32)
    hub = csr_from_coo(
        np.concatenate([np.zeros(512, np.int64), rows[keep]]),
        np.concatenate([np.arange(512), cols[keep]]),
        np.concatenate([rng.standard_normal(512).astype(np.float32),
                        vals[keep]]), (512, 512))
    return [hub, random_sparse(512, 512, 0.03, seed=33)]


@pytest.mark.parametrize("engine", ["spz", "spz-rsort", "spz-host"])
def test_spgemm_batched_cuda_matches_torch(card, engine, tmp_path):
    """A batch with a lane on the large route and a padding lane: the
    cuda backend equals the torch backend on the card and each lane's
    single-matrix call, bit for bit; the fused drivers launch K3's
    expand entry for the lanes' buckets and K1 + K2 for the hub row's."""
    from repro_torch.core import dispatch as dp
    from repro_torch.core.formats import batch_csr
    mats = _hub_lanes()
    b = batch_csr(mats, batch_cap=3).to(card)
    cache = dp.AutotuneCache(str(tmp_path / "a.json"))
    kb.reset_launch_counts()
    out = dp.spgemm_batched(b, b, engine, cache=cache)
    counts = kb.launch_counts()
    ref = dp.spgemm_batched(b, b, engine, backend="torch", cache=cache)
    assert out.valid.tolist() == ref.valid.tolist() == [True, True, False]
    for f in ("indptr", "indices", "data"):
        _eq(getattr(ref, f), getattr(out, f))
    for i, m in enumerate(mats):
        single = spgemm(m, m, engine=engine)
        for w, g in zip(csr_to_numpy(single), csr_to_numpy(out[i])):
            np.testing.assert_array_equal(w, g)
    if engine == "spz-host":
        assert counts["stream_sort"] > 0 and counts["stream_merge"] > 0
    else:
        assert counts["fused_bucket.expand"] > 0
        assert counts["fused_bucket.large"] == 1
        assert counts["chunk_sort"] == 1 and counts["merge_partitions"] > 0


_FIELDS = ("n_mssort", "sort_elems", "n_mszip", "zip_elems", "chunk_loads",
           "chunk_stores")


@pytest.mark.parametrize("engine", ["spz", "spz-host", "esc"])
def test_sharded_on_the_card_matches_batched(card, engine, tmp_path):
    """One card, the default devices: execute_sharded equals
    execute_batched on the same base plan, CSR and the six counters, and
    a warmed bucket's plan is the flush's."""
    from repro_torch.core import dispatch as dp
    from repro_torch.core.formats import batch_csr
    from repro_torch.distributed import spgemm_shard as shard
    b = batch_csr(_hub_lanes(), batch_cap=3).to(card)
    cache = dp.AutotuneCache(str(tmp_path / "a.json"))
    sp = shard.plan_sharded(b, b, engine, cache=cache)
    assert sp.devices == tuple(torch.device("cuda", i)
                               for i in range(torch.cuda.device_count()))
    assert shard.lane_devices("cuda") == (
        torch.device("cuda", torch.cuda.current_device()),)
    kb.reset_launch_counts()
    out, st = shard.execute_sharded(sp, b, b, return_stats=True)
    counts = kb.launch_counts()
    ref, rst = dp.execute_batched(sp.base, b, b, return_stats=True)
    assert out.valid.tolist() == ref.valid.tolist() == [True, True, False]
    for f in ("indptr", "indices", "data"):
        _eq(getattr(ref, f), getattr(out, f))
    if engine == "esc":
        assert st is None and rst is None
    else:
        assert [getattr(st, f) for f in _FIELDS] == \
            [getattr(rst, f) for f in _FIELDS]
        assert counts["stream_sort" if engine == "spz-host"
                      else "fused_bucket.expand"] > 0
    dp.reset_warm_stats()
    bucket = ((512, 512), (512, 512), 1 << 14, 1 << 14)
    w = dp.warm_bucket(bucket, engine=engine, max_batch=3, cache=cache)
    assert w["engine"] == engine and dp.warm_stats()["warmed"] == 1


def test_service_on_the_card_keeps_one_stream(card, tmp_path, monkeypatch):
    """Flushes on two executor threads launch on the caller's stream;
    every result lives on the card and equals its single call."""
    import threading
    from repro_torch.core import dispatch as dp
    from repro_torch.distributed import spgemm_shard as shard
    from repro_torch.launch.serve_spgemm import make_traffic
    from repro_torch.serving import spgemm_service as svc
    caller = torch.cuda.current_stream()
    seen = []
    execute_sharded = shard.execute_sharded

    def capture(*a, **kw):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream()))
        return execute_sharded(*a, **kw)
    monkeypatch.setattr(shard, "execute_sharded", capture)
    service = svc.SpGemmService(max_batch=4, flush_timeout=1e9,
                                async_flushes=2,
                                cache=dp.AutotuneCache(str(tmp_path / "a")))
    try:
        reqs = [service.submit(A, B) for A, B in make_traffic(16, seed=1)]
        service.drain()
    finally:
        service.close()
    assert seen and all(s == caller for _, s in seen)
    assert any(n.startswith("spgemm-flush") for n, _ in seen)
    for r in reqs:
        assert r.tier == "planned" and r.result.device.type == "cuda"
        for w, g in zip(csr_to_numpy(spgemm(r.A, r.B, engine=r.engine)),
                        csr_to_numpy(r.result)):
            np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("async_flushes", [0, 2])
def test_service_kernel_errors_raise_on_the_card(card, async_flushes,
                                                 tmp_path):
    """A kernel launch error raises out of drain: not retried, degraded
    or dead-lettered."""
    from repro_torch.core import dispatch as dp
    from repro_torch.kernels import _build
    from repro_torch.runtime import faultinject as fi
    from repro_torch.serving import spgemm_service as svc
    fault = fi.FaultSpec(site="kernel.batched",
                         exc_factory=lambda site, ctx:
                         _build.KernelLaunchError("injected"))
    service = svc.SpGemmService(max_batch=8, flush_timeout=1e9,
                                async_flushes=async_flushes,
                                cache=dp.AutotuneCache(str(tmp_path / "a")))
    A = random_sparse(300, 300, 0.02, seed=3)
    try:
        with fi.injected(fault), pytest.raises(_build.KernelLaunchError):
            service.submit(A, A)
            service.drain()
    finally:
        service.close()
    assert fault.fires == 1
    assert not service.dead_letters and not service.flush_log


def test_service_ladder_stays_on_the_card(card, tmp_path):
    """Every esc launch failing degrades to spz-fused on the kernels;
    every batched launch failing isolates each request on esc, on the
    card: no plain tier, no host."""
    from repro_torch.core import dispatch as dp
    from repro_torch.runtime import faultinject as fi
    from repro_torch.serving import spgemm_service as svc
    A = random_sparse(300, 300, 0.02, seed=4)
    for match, tier, engine in (({"engine": "esc"},
                                 "degraded:spz-fused/cuda", "spz-fused"),
                                ({}, "isolated", "esc")):
        service = svc.SpGemmService(
            max_batch=2, flush_timeout=1e9, engine="esc",
            policy=dp.RetryPolicy(sleep=lambda s: None),
            cache=dp.AutotuneCache(str(tmp_path / tier)))
        with fi.injected(fi.FaultSpec(site="kernel.batched", match=match)):
            reqs = [service.submit(A, A) for _ in range(2)]
        f = service.flush_log[-1]
        assert (f.tier, f.engine) == (tier, engine)
        want = spgemm(A, A, engine="esc" if engine == "esc" else "spz")
        for r in reqs:
            assert r.result.device.type == "cuda"
            for w, g in zip(csr_to_numpy(want), csr_to_numpy(r.result)):
                np.testing.assert_array_equal(w, g)


def test_auto_on_the_card(card, tmp_path):
    """``spgemm(A, A)`` with no engine equals the engine it selects; an
    autotune sweep on the card measures only the cuda backend and a
    second plan replays it from the cache."""
    from repro_torch.core import dispatch as dp
    A = random_sparse(700, 700, 0.01, seed=5, pattern="powerlaw")
    cache = dp.AutotuneCache(str(tmp_path / "a.json"))
    p = dp.plan(A, A, cache=cache)
    assert p.kwargs_dict["device"].type == "cuda"
    for w, g in zip(csr_to_numpy(spgemm(A, A, engine=p.engine)),
                    csr_to_numpy(spgemm(A, A, cache=cache))):
        np.testing.assert_array_equal(w, g)
    tuned = dp.plan(A, A, autotune=True, cache=cache)
    timings = cache.get(tuned.cache_key)["timings"]
    assert tuned.source == "autotune" and tuned.backend in (None, "cuda")
    assert not [c for c in timings if c.endswith("|torch")]
    assert "spz|cuda" in timings and "spz-rsort|cuda" in timings
    again = dp.plan(A, A, cache=cache)
    assert again.source == "cache" and again.engine == tuned.engine


@pytest.mark.parametrize("n,density,pattern", [(700, 0.02, "powerlaw"),
                                               (1536, 1.5e-3, "uniform"),
                                               (600, 0.01, "banded")])
def test_spgemm_cuda_matches_torch_backend(card, n, density, pattern):
    A = random_sparse(n, n, density, seed=3, pattern=pattern)
    kb.reset_launch_counts()
    out, st = spgemm(A, A, engine="spz", return_stats=True)
    assert out.device.type == "cuda"
    counts = kb.launch_counts()
    assert counts["fused_bucket"] == counts["fused_bucket.expand"] > 0
    ref, st_ref = spgemm(A, A, engine="spz", backend="torch",
                         return_stats=True)
    for w, g in zip(csr_to_numpy(ref), csr_to_numpy(out)):
        np.testing.assert_array_equal(w, g)
    assert (st.n_mssort, st.sort_elems, st.n_mszip, st.zip_elems,
            st.chunk_loads, st.chunk_stores) == \
        (st_ref.n_mssort, st_ref.sort_elems, st_ref.n_mszip,
         st_ref.zip_elems, st_ref.chunk_loads, st_ref.chunk_stores)


def _sorted_front(rng, S, R, key_hi):
    lens = rng.integers(0, R + 1, S).astype(np.int32)
    lens[0] = 0  # always an empty side
    keys = np.full((S, R), EMPTY, np.int32)
    vals = np.zeros((S, R), np.float32)
    for s in range(S):
        keys[s, :lens[s]] = np.sort(rng.choice(key_hi, lens[s], replace=False))
        vals[s, :lens[s]] = rng.standard_normal(lens[s])
    vals[rng.random((S, R)) < 0.1] = -0.0
    return keys, vals, lens


@pytest.mark.parametrize("S,R,key_hi", [
    (S, R, hi) for R in (8, 16, 32, 128, 256, 512)
    for S, hi in ((1, 3), (2, 5), (512, 7), (300, 1000))] + [(65536, 8, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_sort_kernel(card, S, R, key_hi, dtype):
    keys, vals, lens = _on(card, *_chunks(np.random.default_rng(S + R), S, R,
                                          key_hi))
    vals = vals.to(dtype)
    before, routes = stream_sort.launches, dict(stream_sort.routes)
    got = stream_sort(keys, vals, lens)
    assert stream_sort.launches == before + 1
    assert stream_sort.routes[_route(R)] == routes[_route(R)] + 1
    assert got[1].dtype == dtype
    want = stream_sort_plain(keys, vals, lens)
    for w, g in zip(want, got):
        _eq(w.float() if w.dtype == torch.bfloat16 else w,
            g.float() if g.dtype == torch.bfloat16 else g)
    _every_warp_shape(stream_sort_launch, (keys, vals, lens), want)


@pytest.mark.parametrize("R", [8, 16, 64])
@pytest.mark.parametrize("S,key_hi", [(1, 20), (2, 40), (512, 48),
                                      (300, 1000)])
def test_stream_merge_kernel(card, S, R, key_hi):
    rng = np.random.default_rng(S * R)
    hi = max(key_hi, 2 * R)
    args = _on(card, *_sorted_front(rng, S, R, hi), *_sorted_front(rng, S, R, hi))
    before = stream_merge.launches
    got = stream_merge(*args)
    assert stream_merge.launches == before + 1
    want = stream_merge_plain(*args)
    assert len(got) == len(want) == 7
    for w, g in zip(want, got):
        _eq(w, g)


def test_stream_merge_one_side_empty(card):
    """Nothing is mergeable against an empty side: nothing advances and
    nothing is emitted."""
    ka, va, la = _sorted_front(np.random.default_rng(1), 3, 16, 64)
    la[:] = np.maximum(la, 1)
    args = _on(card, ka, va, la, np.full((3, 16), EMPTY, np.int32),
               np.zeros((3, 16), np.float32), np.zeros(3, np.int32))
    got = stream_merge(*args)
    for w, g in zip(stream_merge_plain(*args), got):
        _eq(w, g)
    assert int(got[4].sum()) == int(got[5].sum()) == int(got[6].sum()) == 0


def _ptr_pair(rng, S, La, Lb):
    hi = La + Lb
    out = []
    for L in (La, Lb):
        lens = rng.integers(0, L + 1, S)
        lens[S // 2] = 0  # one side empty
        K = np.full((S, L), EMPTY, np.int32)
        V = np.zeros((S, L), np.float32)
        for s in range(S):
            K[s, :lens[s]] = np.sort(rng.choice(hi, lens[s], replace=False))
            V[s, :lens[s]] = rng.standard_normal(lens[s])
        V[rng.random((S, L)) < 0.1] = -0.0
        out += [K, V, lens.astype(np.int64)]
    return out


@pytest.mark.parametrize("S,La,Lb,R", [(512, 64, 48, 16), (37, 200, 40, 8),
                                       (3, 16, 16, 4)])
def test_stream_merge_pointer_form(card, S, La, Lb, R):
    """Issue by issue through a merge round and 3 idle issues past its
    end, on partitions whose rows lie Lo + 1 apart (as the host driver's
    merged partitions do): the kernel's pointers, zip elements, appended
    rows, flag and count of issues that did work equal the plain
    composition's; an idle issue writes nothing; every launch counts as
    a pointer-form launch."""
    rng = np.random.default_rng(S + La)
    Ka, Va, la, Kb, Vb, lb = _ptr_pair(rng, S, La, Lb)
    Kw, Vw = _on(card, np.pad(Ka, ((0, 0), (0, 5)), constant_values=EMPTY),
                 np.pad(Va, ((0, 0), (0, 5))))
    Ka, Va = Kw[:, :La], Vw[:, :La]  # rows La + 5 apart
    Kb, Vb, la, lb = _on(card, Kb, Vb, la, lb)
    Lo = La + Lb
    state = {}
    for form in ("kernel", "plain"):
        z = torch.zeros(S, dtype=torch.int64, device=card)
        state[form] = [z.clone() for _ in range(4)] + [
            torch.full((S, Lo + 1), EMPTY, dtype=torch.int32, device=card),
            torch.zeros((S, Lo + 1), dtype=torch.float32, device=card)]
    worked = torch.zeros(2, dtype=torch.int64, device=card)
    idle = issues = 0
    while idle < 3:
        flags = torch.zeros(2, dtype=torch.int32, device=card)
        before = (stream_merge.launches, stream_merge.routes["pointer"])
        pa, pb, optr, zips, Ko, Vo = state["kernel"]
        stream_merge_ptr(Ka, Va, la, Kb, Vb, lb, pa, pb, optr, Ko, Vo, zips,
                         flags[0:1], worked[0:1], R=R)
        assert (stream_merge.launches, stream_merge.routes["pointer"]) == (
            before[0] + 1, before[1] + 1)
        pa, pb, optr, zips, Ko, Vo = state["plain"]
        stream_merge_ptr_plain(Ka, Va, la, Kb, Vb, lb, pa, pb, optr, Ko, Vo,
                               zips, flags[1:2], worked[1:2], R=R)
        for w, g in zip(state["plain"][:4], state["kernel"][:4]):
            _eq(w, g)
        for w, g in zip(state["plain"][4:], state["kernel"][4:]):
            _eq(w[:, :Lo], g[:, :Lo])
        assert not bool((state["kernel"][4][:, Lo] != EMPTY).any())
        f = flags.tolist()
        assert f[0] == f[1]
        w = worked.tolist()
        assert w[0] == w[1]
        issues += 1
        idle += not f[0] & 1
    assert issues > 4


@pytest.mark.parametrize("engine", ["spz-host", "esc"])
def test_engine_cuda_matches_cpu(card, engine):
    A = random_sparse(700, 700, 0.02, seed=3, pattern="powerlaw")
    kb.reset_launch_counts()
    out = spgemm(A, A, engine=engine, return_stats=True)[0]
    assert out.device.type == "cuda"
    want = spgemm(A, A, engine=engine, device="cpu", return_stats=True)[0]
    for w, g in zip(csr_to_numpy(want), csr_to_numpy(out)):
        np.testing.assert_array_equal(w, g)
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(w.view(np.int32), g.view(np.int32))
    if engine == "spz-host":
        counts = kb.launch_counts()
        assert counts["stream_sort"] > 0 and counts["stream_merge"] > 0


# tests/test_kernels_attn.py's sweep, a ragged hd = 128 case, a windowed
# bidirectional hd = 96 case, TinyLlama's prefill shape, and Whisper's
# bidirectional encoder (1,500 frames: 11 tiles of 128 rows and one of 92)
ATTN = [(2, 64, 64, 4, 2, 16, True, 0), (1, 96, 96, 8, 1, 32, True, 32),
        (2, 48, 64, 4, 4, 16, True, 0), (1, 64, 64, 2, 2, 8, False, 0),
        (1, 128, 128, 4, 1, 64, True, 0), (2, 100, 300, 24, 8, 128, True, 0),
        (1, 200, 200, 6, 2, 96, False, 50), (4, 512, 512, 32, 4, 64, True, 0),
        (1, 300, 300, 4, 1, 256, True, 100), (2, 130, 200, 4, 2, 256, True, 0),
        (2, 70, 70, 3, 1, 200, False, 0), (1, 100, 120, 4, 2, 20, True, 0),
        (2, 33, 33, 2, 2, 5, True, 7), (1, 1500, 1500, 12, 12, 64, False, 0)]


@pytest.mark.parametrize("B,Sq,Skv,H,KVH,hd,causal,window", ATTN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(card, B, Sq, Skv, H, KVH, hd, causal, window,
                                dtype):
    rng = np.random.default_rng(0)
    q, k, v = _on(card, *(rng.standard_normal(s).astype(np.float32) for s in
                          ((B, Sq, H, hd), (B, Skv, KVH, hd),
                           (B, Skv, KVH, hd))))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    before = flash_attention.launches, flash_attention.routes[route]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.launches,
            flash_attention.routes[route]) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:  # one bf16 rounding of the float32 result both compute
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_strided_inputs(card, dtype):
    """q, k and v read in place through their strides (slices of one
    packed projection); in bf16 also a copy of inputs whose base TMA
    cannot take (8 bytes past a 16-byte boundary)."""
    rng = np.random.default_rng(1)
    (qkv,) = _on(card, rng.standard_normal((2, 70, 12, 40)).astype(np.float32))
    qkv = qkv.to(dtype)
    cases = [(qkv[:, :, :8, :32], qkv[:, :, 8:10, :32], qkv[:, :, 10:, :32])]
    if dtype == torch.bfloat16:
        cases.append((qkv[:, :, :8, 4:36], qkv[:, :, 8:10, 4:36],
                      qkv[:, :, 10:, 4:36]))
    for q, k, v in cases:
        got = flash_attention(q, k, v)
        want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_many_heads(card, dtype):
    """B * H = 65,536 (heads run on grid.x): held against the plain
    version."""
    rng = np.random.default_rng(4)
    B, S, H, KVH, hd = 4096, 12, 16, 4, 16
    q, k, v = (t.to(dtype) for t in _on(card, *(
        rng.standard_normal(s).astype(np.float32)
        for s in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))))
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-6)


def test_flash_attention_rejects_unsupported(card):
    q = torch.zeros((1, 8, 2, 264), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 3, 16), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)


def test_engine_launches_flash_attention_once_per_layer(card):
    """A 2-layer model at TinyLlama's full width: one K6 launch per layer
    in the prefill, none in decode, greedy tokens equal to attn_impl="xla"
    in float32."""
    cfg = dataclasses.replace(cb.get_config("tinyllama_1_1b"), num_layers=2,
                              attn_impl="pallas", dtype="float32")
    model = M.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (64, 40)]
    outs = {}
    for impl in ("pallas", "xla"):
        eng = Engine(dataclasses.replace(cfg, attn_impl=impl), model,
                     max_batch=2, max_seq=128)
        before = flash_attention.launches
        reqs = eng.generate([Request(prompt=p, max_new_tokens=5)
                             for p in prompts])
        launched = flash_attention.launches - before
        assert launched == (cfg.num_layers if impl == "pallas" else 0)
        outs[impl] = [r.out.tolist() for r in reqs]
    assert outs["pallas"] == outs["xla"]


# tests/test_kernels_attn.py's sweep (T = 64), then ragged sizes (no
# multiples of 8, empty groups, rows past the last group, a group of more
# than 64 rows, F not a multiple of the 128-column tile), a single empty
# group, no groups at all, and groups longer than 64 rows at D and F no
# multiples of 64 (a group of 260 rows over two 256-row tiles)
GMM = [(64, 4, 16, 32, [8, 16, 0, 24]), (64, 3, 8, 8, [8, 8, 8]),
       (64, 5, 32, 16, [0, 0, 40, 8, 0]), (64, 2, 64, 128, [32, 0]),
       (37, 5, 24, 40, [3, 0, 17, 1, 9]), (300, 3, 64, 136, [170, 5, 0]),
       (21, 4, 16, 8, [5, 6, 7, 3]), (10, 1, 8, 16, [0]),
       (9, 0, 8, 24, []), (1024, 40, 256, 264, [8] * 40),
       (600, 3, 72, 200, [260, 90, 250])]


@pytest.mark.parametrize("T,E,D,F,sizes", GMM)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_kernel(card, T, E, D, F, sizes, dtype):
    rng = np.random.default_rng(0)
    x, w = _on(card, rng.standard_normal((T, D)).astype(np.float32),
               rng.standard_normal((E, D, F)).astype(np.float32))
    x, w = x.to(dtype), w.to(dtype)
    (gs,) = _on(card, np.array(sizes, np.int32))
    before = grouped_matmul.launches
    got = grouped_matmul(x, w, gs)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (T, F)
    want = grouped_matmul_plain(x, w, gs).float()
    diff = (got.float() - want).abs()
    top = float(want.abs().max()) if want.numel() else 0.0
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4 * top
    else:  # one bf16 rounding; the float32 sums run in other orders
        assert bool((diff <= 2 ** -7 * want.abs() + 1e-4 * top).all())
    assert bool((got[sum(sizes):] == 0).all())


# (T, E, cap, D, F, counts): Arctic's decode stride with 8 kept experts,
# empty groups, counts past cap, rows past E cap, T short of E cap, a
# stride of more than one 64-row tile; the bf16 route's 128-, 192- and
# 256-row tiles (caps 96, 160, 256) at D and F no multiples of 64 (TMA's
# zero fill past them), and cap 300 over two tiles a group
GMM_COUNTS = [(1024, 128, 8, 64, 72, None), (40, 4, 8, 16, 32, [3, 0, 8, 5]),
              (30, 3, 10, 8, 24, [10, 1, 0]), (13, 2, 4, 16, 8, [7, 2]),
              (20, 2, 12, 16, 8, [12, 6]), (300, 3, 90, 64, 136, [90, 70, 1]),
              (300, 3, 96, 72, 200, [96, 70, 0]),
              (480, 3, 160, 136, 88, [160, 1, 100]),
              (520, 2, 256, 40, 264, [256, 200]),
              (600, 2, 300, 64, 136, [300, 257])]


@pytest.mark.parametrize("T,E,cap,D,F,counts", GMM_COUNTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_counts_layout(card, T, E, cap, D, F, counts, dtype):
    """The counts layout against its plain version and against the
    contiguous layout on the kept rows; unkept rows hold noise that must
    not reach the output, which is exactly zero there."""
    rng = np.random.default_rng(4)
    if counts is None:  # 8 kept experts of 1 to cap rows
        counts = np.zeros(E, np.int32)
        counts[rng.choice(E, 8, replace=False)] = rng.integers(1, cap + 1, 8)
        counts = counts.tolist()
    x, w = _on(card, rng.standard_normal((T, D)).astype(np.float32),
               rng.standard_normal((E, D, F)).astype(np.float32))
    x, w = x.to(dtype), w.to(dtype)
    (gs,) = _on(card, np.array(counts, np.int32))
    kept = torch.zeros(T, dtype=torch.bool)
    for g, n in enumerate(counts):
        kept[g * cap:min(g * cap + min(n, cap), T)] = True
    kept = kept.to(card)
    before = grouped_matmul.launches, grouped_matmul.routes["counts"]
    got = grouped_matmul(x, w, gs, cap=cap)
    torch.cuda.synchronize()
    assert (grouped_matmul.launches,
            grouped_matmul.routes["counts"]) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == (T, F)
    assert bool((got[~kept] == 0).all())
    want = grouped_matmul_plain(x, w, gs, cap=cap).float()
    sizes = torch.tensor([int(kept[g * cap:(g + 1) * cap].sum())
                          for g in range(E)], dtype=torch.int32, device=card)
    packed = grouped_matmul(x[kept], w, sizes).float()
    top = float(want.abs().max()) if want.numel() else 0.0
    for ref, g in ((want, got.float()), (packed, got[kept].float())):
        diff = (g - ref).abs()
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-4 * top
        else:
            assert bool((diff <= 2 ** -7 * ref.abs() + 1e-4 * top).all())


@pytest.mark.parametrize("T,E,cap,D,F,counts", GMM_COUNTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_backward(card, T, E, cap, D, F, counts, dtype):
    """K7 under autograd in the counts layout: the forward and the dx
    launch (route ``backward``, over W transposed) each once, dx and dW
    against plain autograd through the plain version on the same card
    inputs (noise in the unkept rows of x and dy), dx exactly zero on the
    unkept rows.  The dx launch reads W in place: alone, it allocates dx
    and nothing else (a transposed copy of W would add W's bytes)."""
    rng = np.random.default_rng(5)
    if counts is None:
        counts = np.zeros(E, np.int32)
        counts[rng.choice(E, 8, replace=False)] = rng.integers(1, cap + 1, 8)
        counts = counts.tolist()
    x, w, dy = _on(card, rng.standard_normal((T, D)).astype(np.float32),
                   rng.standard_normal((E, D, F)).astype(np.float32),
                   rng.standard_normal((T, F)).astype(np.float32))
    x, w, dy = x.to(dtype), w.to(dtype), dy.to(dtype)
    (gs,) = _on(card, np.array(counts, np.int32))
    kept = torch.zeros(T, dtype=torch.bool)
    for g, n in enumerate(counts):
        kept[g * cap:min(g * cap + min(n, cap), T)] = True
    kept = kept.to(card)
    grads = []
    for fn in (grouped_matmul, grouped_matmul_plain):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = dict(grouped_matmul.routes)
        fn(xa, wa, gs, cap=cap).backward(dy)
        torch.cuda.synchronize()
        routes = {r: n - before[r] for r, n in grouped_matmul.routes.items()}
        assert routes == ({"contiguous": 0, "counts": 1, "backward": 1}
                          if fn is grouped_matmul else
                          {"contiguous": 0, "counts": 0, "backward": 0})
        grads.append((xa.grad, wa.grad))
    (dx, dw), (dx_p, dw_p) = grads
    assert bool((dx[~kept] == 0).all())
    for got, want in ((dx, dx_p), (dw, dw_p)):
        assert got.dtype == dtype and got.shape == want.shape
        diff = (got.float() - want.float()).abs()
        top = float(want.float().abs().max())
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-4 * top
        else:  # one bf16 rounding; the float32 sums run in other orders
            assert bool((diff <= 2 ** -7 * want.float().abs()
                         + 1e-4 * top).all())
    torch.cuda.synchronize(card)
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    dx_alone = k7.kernel_launch(dy, w.transpose(1, 2), gs, cap, "backward")
    torch.cuda.synchronize(card)
    grew = torch.cuda.max_memory_allocated(card) - base
    assert grew <= -(-dx_alone.numel() * dx_alone.element_size() // 512) * 512
    assert torch.equal(dx_alone, dx)


def test_grouped_matmul_contiguous_backward_raises(card):
    x = torch.randn((16, 8), device=card, requires_grad=True)
    w = torch.randn((2, 8, 8), device=card, requires_grad=True)
    y = grouped_matmul(x, w, torch.tensor([8, 8], dtype=torch.int32,
                                          device=card))
    with pytest.raises(NotImplementedError, match="counts layout"):
        y.sum().backward()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_raises_under_autograd(card, dtype):
    """K6 has no backward pass: under autograd it raises and launches
    nothing; under no_grad the same call launches."""
    q, k, v = (torch.randn(s, device=card, dtype=dtype, requires_grad=True)
               for s in ((2, 64, 8, 64), (2, 64, 2, 64), (2, 64, 2, 64)))
    before = flash_attention.launches
    with pytest.raises(NotImplementedError, match='attn_impl="xla"'):
        flash_attention(q, k, v)
    assert flash_attention.launches == before
    with torch.no_grad():
        flash_attention(q, k, v)
    assert flash_attention.launches == before + 1


def test_grouped_matmul_rejects_unsupported(card):
    x = torch.zeros((16, 12), device=card)
    sizes = torch.full((2,), 8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="multiples of 8"):
        grouped_matmul(x, torch.zeros((2, 12, 8), device=card), sizes)
    x = torch.zeros((16, 8), device=card)
    with pytest.raises(TypeError):
        grouped_matmul(x, torch.zeros((2, 8, 8), device=card,
                                      dtype=torch.bfloat16), sizes)
    with pytest.raises(ValueError, match="group_sizes"):
        grouped_matmul(x, torch.zeros((3, 8, 8), device=card), sizes)
    with pytest.raises(ValueError, match="cap"):
        grouped_matmul(x, torch.zeros((2, 8, 8), device=card), sizes, cap=0)


@pytest.mark.parametrize("n", [8, 64, 1024, 8192, 100, 16384])
def test_sort_tokens_by_key_cuda_branch(card, n):
    """Powers of two from 8 to 8,192 go through K4 as one front; the rest
    take the argsort.  Both give the torch route's permutation."""
    (keys,) = _on(card, np.random.default_rng(n).integers(0, 128, n)
                  .astype(np.int32))
    before, block = stream_sort.launches, stream_sort.routes["block"]
    got_k, got_p = sort_tokens_by_key(keys, backend="cuda")
    want_k, want_p = sort_tokens_by_key(keys, backend="torch")
    assert stream_sort.launches - before == int(n & (n - 1) == 0
                                                and n <= 8192)
    # a front wider than one warp's 256 slots takes K4's block route
    assert stream_sort.routes["block"] - block == int(n in (1024, 8192))
    _eq(want_p, got_p)
    _eq(want_k, got_k)


def test_engine_launches_flash_attention_in_encoder_and_decoder(card):
    """Whisper's smoke model on the card: one K6 launch per encoder layer
    (bidirectional) and per decoder layer (causal) in the prefill, none
    for cross attention or decode, nothing else launched; the greedy
    tokens of the CPU (plain versions) in float32."""
    cfg = dataclasses.replace(cb.get_smoke_config("whisper_small"),
                              attn_impl="pallas", dtype="float32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (30, 17)]
    enc = rng.standard_normal((2, cfg.num_frontend_tokens, cfg.d_model)
                              ).astype(np.float32)
    outs = {}
    for dev in ("cpu", card):
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        eng = Engine(cfg, model, max_batch=2, max_seq=48, device=dev)
        kb.reset_launch_counts()
        reqs = eng.generate([Request(prompt=p, max_new_tokens=5)
                             for p in prompts], enc_inp=enc)
        counts = kb.launch_counts()
        outs[str(dev)] = [r.out.tolist() for r in reqs]
    n = cfg.encoder_layers + cfg.num_layers
    assert counts["flash_attention"] == n == counts["flash_attention.fma"]
    assert not {k: c for k, c in counts.items()
                if c and not k.startswith("flash_attention")}
    assert outs["cpu"] == outs[str(card)]


def test_engine_launches_grouped_matmul_per_moe_layer(card):
    """Arctic's smoke config on the card: K7 three times per MoE layer per
    forward pass (1 prefill + the decode steps), K6 once per layer, and
    the greedy tokens of the CPU (plain versions) in float32."""
    cfg = dataclasses.replace(cb.get_smoke_config("arctic_480b"),
                              attn_impl="pallas", dtype="float32")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 25)]
    outs = {}
    for dev in ("cpu", card):
        model = M.init_params(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        eng = Engine(cfg, model, max_batch=2, max_seq=64, device=dev)
        kb.reset_launch_counts()
        reqs = eng.generate([Request(prompt=p, max_new_tokens=6)
                             for p in prompts])
        counts = kb.launch_counts()
        outs[str(dev)] = [r.out.tolist() for r in reqs]
    passes = 1 + len(eng.stats["decode_s"])
    assert counts["grouped_matmul"] == 3 * cfg.num_layers * passes
    assert counts["grouped_matmul.counts"] == counts["grouped_matmul"]
    assert counts["flash_attention"] == cfg.num_layers
    assert outs["cpu"] == outs[str(card)]
