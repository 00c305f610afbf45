"""The port's kernel modules against the JAX reference, on the CPU.

K1 (chunk sort), K2 (partition merge) and K3 (fused bucket) each hold a
CUDA kernel and its plain torch version.  Here the plain versions (which
the wrappers take for CPU tensors) are held bit-exact against the
reference's XLA oracles in ``repro.kernels.merge_tree`` — keys, values,
lengths and the mszip counters — and K3 also against the Pallas kernel
in interpret mode on one tiny bucket.  ``test_torch_cuda.py`` holds each
kernel against its plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as ref_stream
from repro.kernels import merge_tree as ref_mt
from repro.kernels.fused_bucket import fused_bucket_pallas
from repro_torch.core import stream as kvstream
from repro_torch.core.formats import EMPTY
from repro_torch.kernels import _build, backend as kb, ops
from repro_torch.kernels.chunk_sort import chunk_sort, chunk_sort_plain
from repro_torch.kernels.fused_bucket import fused_bucket, fused_bucket_plain
from repro_torch.kernels.merge_partitions import (merge_partitions,
                                                  merge_partitions_plain)

torch.set_num_threads(2)


def _eq(ref, port, msg=""):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_array_equal(ref, port, err_msg=msg)
    if ref.dtype.kind == "f":  # bit for bit, -0.0 included
        np.testing.assert_array_equal(ref.view(np.int32), port.view(np.int32),
                                      err_msg=msg)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# K1: chunk sort
# ---------------------------------------------------------------------------

def _chunks(rng, N, R, key_hi):
    lens = rng.integers(0, R + 1, N).astype(np.int32)
    lens[0] = 0  # always an empty chunk
    keys = rng.integers(0, key_hi, (N, R)).astype(np.int32)
    vals = rng.standard_normal((N, R)).astype(np.float32)
    vals[rng.random((N, R)) < 0.1] = -0.0  # signed zeros must survive
    return keys, vals, lens


@pytest.mark.parametrize("R", [8, 16, 128])
@pytest.mark.parametrize("N,key_hi", [(1, 2), (7, 3), (33, 9), (20, 1000)])
def test_chunk_sort_plain_bit_exact(N, R, key_hi):
    keys, vals, lens = _chunks(np.random.default_rng(N * R + key_hi), N, R,
                               key_hi)
    want = ref_mt.sort_chunks_linear(*_j(keys, vals, lens))
    for w, p in zip(want, chunk_sort_plain(*_t(keys, vals, lens))):
        _eq(w, p)
    for a, b in zip(chunk_sort(*_t(keys, vals, lens)),
                    chunk_sort_plain(*_t(keys, vals, lens))):
        _eq(a, b)  # the wrapper takes the plain version for CPU tensors


def test_chunk_sort_zero_chunks():
    keys, vals, lens = np.zeros((0, 8), np.int32), np.zeros((0, 8),
                                                            np.float32), \
        np.zeros(0, np.int32)
    ok, ov, ol = chunk_sort(*_t(keys, vals, lens))
    assert ok.shape == (0, 8) and ov.shape == (0, 8) and ol.shape == (0,)


def test_duplicate_run_sums_left_to_right():
    """A run of equal keys sums in product order from its first value:
    ((a + b) + c), not a tree, not from 0.0."""
    vals = np.array([[1e8, 1.0, -1e8, 1.0, -0.0, 0, 0, 0]], np.float32)
    keys = np.array([[5, 5, 5, 5, 7, 9, 9, 9]], np.int32)
    lens = np.array([5], np.int32)
    ok, ov, ol = chunk_sort_plain(*_t(keys, vals, lens))
    acc = np.float32(1e8)
    for v in (1.0, -1e8, 1.0):
        acc = np.float32(acc + np.float32(v))
    assert int(ol[0]) == 2
    assert ok[0, :2].tolist() == [5, 7]
    assert ov[0, 0].item() == acc
    assert np.signbit(ov[0, 1].item())  # -0.0 kept
    _eq(ref_mt.sort_chunks_linear(*_j(keys, vals, lens))[1], ov)


# ---------------------------------------------------------------------------
# K2: partition merge
# ---------------------------------------------------------------------------

def _partition(rng, N, L, key_hi, full=False):
    lens = (np.full(N, L) if full else rng.integers(0, L + 1, N)) \
        .astype(np.int32)
    keys = np.full((N, L), EMPTY, np.int32)
    vals = np.zeros((N, L), np.float32)
    for s in range(N):
        u = np.sort(rng.choice(key_hi, size=lens[s], replace=False))
        keys[s, :lens[s]] = u
        vals[s, :lens[s]] = rng.standard_normal(lens[s])
    return keys, vals, lens


def _merge_case(N, La, Lb, R, S, seed):
    rng = np.random.default_rng(seed)
    hi = 3 * max(La, Lb, 1)
    a = _partition(rng, N, La, hi)
    b = _partition(rng, N, Lb, hi)
    return a + b


@pytest.mark.parametrize("N,La,Lb,R,S", [
    (4, 32, 32, 8, None),
    (8, 64, 64, 16, 2),
    (6, 16, 48, 8, 3),     # ragged widths
    (6, 5, 3, 4, 3),       # non-pow2 widths
    (3, 16, 0, 8, None),   # zero-width side
    (5, 0, 0, 8, None),    # both sides zero-width
    (4, 256, 256, 16, 4),
    (2, 128, 128, 128, None),
])
def test_merge_partitions_plain_bit_exact(N, La, Lb, R, S):
    args = _merge_case(N, La, Lb, R, S, seed=N + La + Lb + R)
    want = ref_mt.merge_partitions(*_j(*args), R=R, pair_streams=S)
    got = merge_partitions_plain(*_t(*args), R=R, pair_streams=S)
    for w, p in zip(want[:3], got[:3]):
        _eq(w, p)
    for w, p in zip(want[3], got[3]):
        assert int(w) == int(p)
    for a, b in zip(merge_partitions(*_t(*args), R=R, pair_streams=S),
                    got):
        if isinstance(a, torch.Tensor):
            _eq(b, a)
    # the ops layer resolves the torch backend for CPU tensors
    for a, b in zip(ops.merge_partitions(*_t(*args), R=R, pair_streams=S)[:3],
                    got[:3]):
        _eq(b, a)


def test_merge_partitions_empty_sides_and_full_overlap():
    rng = np.random.default_rng(3)
    N, L, R = 4, 16, 8
    ka, va, la = _partition(rng, N, L, 2 * L)
    empty = (np.full((N, L), EMPTY, np.int32), np.zeros((N, L), np.float32),
             np.zeros(N, np.int32))
    for args in ((ka, va, la) + empty, empty + (ka, va, la),
                 (ka, va, la, ka, va * 2, la)):
        want = ref_mt.merge_partitions(*_j(*args), R=R)
        got = merge_partitions_plain(*_t(*args), R=R)
        for w, p in zip(want[:3], got[:3]):
            _eq(w, p)
        assert [int(x) for x in want[3]] == [int(x) for x in got[3]]


def test_merge_partitions_without_counters():
    args = _merge_case(4, 32, 32, 8, None, seed=1)
    ko, vo, lo, cnt = merge_partitions_plain(*_t(*args), R=8,
                                             with_counters=False)
    assert all(int(c) == 0 for c in cnt)
    _eq(ref_mt.merge_partitions(*_j(*args), R=8)[0], ko)


# ---------------------------------------------------------------------------
# K3: fused bucket (sort + zip-merge tree)
# ---------------------------------------------------------------------------

def _bucket(S, L, R, seed, key_hi=None):
    rng = np.random.default_rng(seed)
    plens = rng.integers(0, L + 1, S).astype(np.int32)
    if S > 1:
        plens[rng.integers(0, S)] = 0
    mask = np.arange(L)[None, :] < plens[:, None]
    keys = np.where(mask, rng.integers(0, key_hi or 3 * L, (S, L)), EMPTY)
    vals = np.where(mask, rng.standard_normal((S, L)), 0.0)
    return keys.astype(np.int32), vals.astype(np.float32), plens


def _ref_rounds(keys, vals, plens, R):
    sk, sv, sl, _, _ = ref_stream.chunk_sort_partitions(
        *_j(keys, vals, plens), R=R, backend="xla")
    return ref_mt.zip_merge_tree(sk, sv, sl, R=R, detailed=True)


def _assert_rounds_equal(want, got):
    assert len(want) == len(got)
    for (ws, wz, wt), (gs, gz, gt) in zip(want, got):
        _eq(np.asarray(ws).astype(np.int64), gs)
        assert int(wz) == int(gz)
        _eq(np.asarray(wt).astype(np.int64), gt)


@pytest.mark.parametrize("S,L,R", [(4, 32, 8), (1, 16, 16), (6, 64, 16),
                                   (8, 256, 16), (3, 512, 128),
                                   (5, 128, 8)])
def test_fused_bucket_plain_matches_zip_merge_tree(S, L, R):
    keys, vals, plens = _bucket(S, L, R, seed=S + L + R)
    want = _ref_rounds(keys, vals, plens, R)
    got = fused_bucket_plain(*_t(keys, vals, plens), R=R, detailed=True)
    for w, p in zip(want[:3], got[:3]):
        _eq(w, p)
    _assert_rounds_equal(want[3], got[3])
    # the 6-vector form against the reference seam
    mk, mv, ml, counters = ref_stream.fused_sort_merge(
        *_j(keys, vals, plens), R=R, backend="xla")
    got6 = kvstream.fused_sort_merge(*_t(keys, vals, plens), R=R)
    for w, p in zip((mk, mv, ml), got6[:3]):
        _eq(w, p)
    _eq(np.asarray(counters).astype(np.int64), got6[3])
    for a, b in zip(fused_bucket(*_t(keys, vals, plens), R=R), got6):
        _eq(b, a)


def test_fused_bucket_plain_matches_pallas_interpret():
    keys, vals, plens = _bucket(8, 64, 8, seed=8, key_hi=40)
    want = fused_bucket_pallas(*_j(keys, vals, plens), R=8, detailed=True,
                               interpret=True)
    got = fused_bucket_plain(*_t(keys, vals, plens), R=8, detailed=True)
    for w, p in zip(want[:3], got[:3]):
        _eq(w, p)
    _assert_rounds_equal(want[3], got[3])


def test_fused_bucket_all_empty_and_no_counters():
    S, L, R = 4, 32, 8
    keys = np.full((S, L), EMPTY, np.int32)
    vals = np.zeros((S, L), np.float32)
    plens = np.zeros(S, np.int32)
    mk, mv, ml, cnt = fused_bucket_plain(*_t(keys, vals, plens), R=R)
    assert int(ml.sum()) == 0 and int(cnt[2]) == 0
    keys, vals, plens = _bucket(S, L, R, seed=2)
    want = ref_stream.fused_sort_merge(*_j(keys, vals, plens), R=R,
                                       backend="xla", with_counters=False)
    got = fused_bucket_plain(*_t(keys, vals, plens), R=R, with_counters=False)
    for w, p in zip(want[:3], got[:3]):
        _eq(w, p)
    _eq(np.asarray(want[3]).astype(np.int64), got[3])


def test_chunk_sort_partitions_matches_reference():
    keys, vals, plens = _bucket(6, 64, 16, seed=5)
    want = ref_stream.chunk_sort_partitions(*_j(keys, vals, plens), R=16,
                                            backend="xla")
    got = kvstream.chunk_sort_partitions(*_t(keys, vals, plens), R=16)
    for w, p in zip(want, got):
        _eq(w, p)


# ---------------------------------------------------------------------------
# backend registry, ops, build
# ---------------------------------------------------------------------------

def test_backend_registry():
    assert set(kb.available_backends()) == {"torch", "cuda"}
    assert kb.resolve_backend("auto", "cpu").name == "torch"
    assert kb.resolve_backend("auto", "cuda").name == "cuda"
    assert kb.resolve_backend("torch", "cuda").name == "torch"
    bk = kb.get_backend("torch")
    assert kb.resolve_backend(bk, "cpu") is bk
    with pytest.raises(ValueError, match="runs on cuda"):
        kb.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        kb.resolve_backend("xla", "cpu")
    for b in kb.available_backends().values():
        for slot in ("chunk_sort", "merge_partitions", "fused_bucket",
                     "stream_sort", "stream_merge"):
            assert callable(getattr(b, slot))


def test_launch_counts_reset():
    kb.reset_launch_counts()
    counts = kb.launch_counts()
    assert set(counts) == {"chunk_sort", "merge_partitions", "fused_bucket",
                           "fused_bucket.fused", "fused_bucket.large",
                           "stream_sort", "stream_merge"}
    assert not any(counts.values())


def test_pad_streams():
    keys, vals, lens = _t(*_chunks(np.random.default_rng(0), 3, 8, 5))
    k, v, n, S = ops._pad_streams(5, keys, vals, lens)
    assert S == 3 and k.shape == (5, 8) and n.tolist()[3:] == [0, 0]
    assert (k[3:] == EMPTY).all() and k.dtype == torch.int32
    assert ops._pad_streams(2, keys, vals, lens)[0] is keys


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build_all()
    assert len(_build.source_hash()) == 16
