"""repro_torch's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports torch, numpy and the port
only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel (K1 chunk sort, K2 partition merge, K3 fused bucket on both
of its routes, K4 stream sort, K5 stream merge) must equal its plain
version bit for bit — keys, values (-0.0 included), lengths and the
mszip counters — and count its launch.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import spgemm
from repro_torch.core.formats import EMPTY, csr_to_numpy, random_sparse
from repro_torch.kernels import backend as kb
from repro_torch.kernels.chunk_sort import chunk_sort, chunk_sort_plain
from repro_torch.kernels.fused_bucket import fused_bucket, fused_bucket_plain
from repro_torch.kernels.merge_partitions import (merge_partitions,
                                                  merge_partitions_plain)
from repro_torch.kernels.stream_merge import stream_merge, stream_merge_plain
from repro_torch.kernels.stream_sort import stream_sort, stream_sort_plain

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
    lens = rng.integers(0, R + 1, N).astype(np.int32)
    lens[0] = 0
    keys = rng.integers(0, key_hi, (N, R)).astype(np.int32)
    vals = rng.standard_normal((N, R)).astype(np.float32)
    vals[rng.random((N, R)) < 0.1] = -0.0
    return keys, vals, lens


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


@pytest.mark.parametrize("R", [8, 16, 32, 128])
@pytest.mark.parametrize("N,key_hi", [(301, 3), (301, 1000), (3, 5)])
def test_chunk_sort_kernel(card, N, R, key_hi):
    args = _on(card, *_chunks(np.random.default_rng(R + key_hi), N, R,
                              key_hi))
    before = chunk_sort.launches
    got = chunk_sort(*args)
    assert chunk_sort.launches == before + 1
    for w, g in zip(chunk_sort_plain(*args), got):
        _eq(w, g)


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


@pytest.mark.parametrize("S,L,R,route", [(64, 512, 16, "fused"),
                                         (5, 64, 8, "fused"),
                                         (2, 32, 16, "fused"),
                                         (1, 16, 16, "fused"),
                                         (512, 16, 16, "fused"),
                                         (300, 32, 16, "fused"),
                                         (3, 1024, 128, "fused"),
                                         (2, 8192, 16, "fused"),
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


@pytest.mark.parametrize("n,density,pattern", [(700, 0.02, "powerlaw"),
                                               (1536, 1.5e-3, "uniform"),
                                               (600, 0.01, "banded")])
def test_spgemm_cuda_matches_torch_backend(card, n, density, pattern):
    A = random_sparse(n, n, density, seed=3, pattern=pattern)
    kb.reset_launch_counts()
    out, st = spgemm(A, A, engine="spz", return_stats=True)
    assert out.device.type == "cuda"
    assert kb.launch_counts()["fused_bucket"] > 0
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


@pytest.mark.parametrize("R", [8, 16, 32, 128])
@pytest.mark.parametrize("S,key_hi", [(1, 3), (2, 5), (512, 7), (300, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_sort_kernel(card, S, R, key_hi, dtype):
    keys, vals, lens = _on(card, *_chunks(np.random.default_rng(S + R), S, R,
                                          key_hi))
    vals = vals.to(dtype)
    before = stream_sort.launches
    got = stream_sort(keys, vals, lens)
    assert stream_sort.launches == before + 1
    assert got[1].dtype == dtype
    for w, g in zip(stream_sort_plain(keys, vals, lens), got):
        _eq(w.float() if w.dtype == torch.bfloat16 else w,
            g.float() if g.dtype == torch.bfloat16 else g)


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
