"""The port's kernel modules against the JAX reference, on the CPU.

K1 (chunk sort), K2 (partition merge) and K3 (fused bucket) each hold a
CUDA kernel and its plain torch version.  Here the plain versions (which
the wrappers take for CPU tensors) are held bit-exact against the
reference's XLA oracles in ``repro.kernels.merge_tree`` — keys, values,
lengths and the mszip counters — and K3 also against the Pallas kernel
in interpret mode on one tiny bucket.  The arithmetic of the CUDA
kernels that the CPU cannot run (the warp chunk sort of K1, K4 and K3,
K2's long rows, K3's merge-path rounds, counter chain and group
reduction) is emulated in numpy and held against the same oracles (and
``repro.kernels.ref.stream_sort_ref`` for K4).  ``test_torch_cuda.py`` holds each kernel against its
plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as ref_stream  # before repro.kernels.ref
from repro.kernels import merge_tree as ref_mt
from repro.kernels import ref as ref_k
from repro.kernels.fused_bucket import fused_bucket_pallas
from repro_torch.core import stream as kvstream
from repro_torch.core.formats import EMPTY
from repro_torch.kernels import _build, backend as kb, ops
from repro_torch.kernels.chunk_sort import (MAX_ITEMS, chunk_sort,
                                            chunk_sort_plain, sort_config)
from repro_torch.kernels.fused_bucket import fused_bucket, fused_bucket_plain
from repro_torch.kernels.merge_partitions import (merge_partitions,
                                                  merge_partitions_plain)
from repro_torch.kernels.merge_tree import (_advance_counters,
                                            sort_chunks_linear)
from repro_torch.kernels.stream_sort import stream_sort_plain

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
# K2's long-row route (csrc/merge_partitions.cu), its arithmetic emulated in
# numpy at tiles small enough to cut every row many times
# ---------------------------------------------------------------------------

def _merge_path(a, b, d):
    """A elements among the first d of the merged order, A first on ties."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _long_payload(A, VA, na, B, VB, nb, tile):
    """merge_partitions_long_payload on one row: diagonal tiles of ``tile`` merged
    elements, each element placed at its merged position less the B
    duplicates before it (earlier tiles' from the look-back sum, its own
    tile's from a prefix), EMPTY / 0 past the merged length."""
    M, L = na + nb, len(A) + len(B)
    ok, ov = np.full(L, EMPTY, np.int32), np.zeros(L, np.float32)
    excl = 0
    for d0 in range(0, M, tile):
        d1 = min(d0 + tile, M)
        i0, i1 = _merge_path(A[:na], B[:nb], d0), _merge_path(A[:na], B[:nb], d1)
        j0, j1 = d0 - i0, d1 - i1
        As, Bs, n = A[i0:i1], B[j0:j1], d1 - d0
        keys, vals = np.zeros(n, np.int32), np.zeros(n, np.float32)
        dup = np.zeros(n, bool)
        for a, k in enumerate(As):
            r = int(np.searchsorted(Bs, k, "left"))
            v = VA[i0 + a]
            if Bs[r] == k if r < len(Bs) else j1 < nb and B[j1] == k:
                v = v + (VB[j0 + r] if r < len(Bs) else VB[j1])
            keys[a + r], vals[a + r] = k, v
        for b, k in enumerate(Bs):
            r = int(np.searchsorted(As, k, "right"))
            keys[b + r], vals[b + r] = k, VB[j0 + b]
            dup[b + r] = As[r - 1] == k if r > 0 else i0 > 0 and A[i0 - 1] == k
        before = np.cumsum(dup) - dup
        keep = ~dup
        ok[d0 - excl + np.arange(n)[keep] - before[keep]] = keys[keep]
        ov[d0 - excl + np.arange(n)[keep] - before[keep]] = vals[keep]
        excl += int(dup.sum())
    return ok, ov, M - excl


def _well_formed(k):
    """Sorted, duplicate-free, non-negative, EMPTY only at the end."""
    return bool((k >= 0).all() and ((k[:-1] < k[1:]) | (k[1:] == EMPTY)).all())


def _jump_counters(A, na, B, nb, R):
    """merge_partitions_long_jump_{init,round,final} on one row: (steps, zips,
    tail_a, tail_b) of the chain of cutoffs by pointer jumping, or None
    for a row the kernel hands to the plain advance loop."""
    if not (_well_formed(A[:na]) and _well_formed(B[:nb])):
        return None
    ea = int(np.searchsorted(A[:na], EMPTY))
    eb = int(np.searchsorted(B[:nb], EMPTY))

    def state(x):  # (pa, pb) at candidate x, None for an EMPTY key
        if x == 0:
            return 0, 0
        if x <= na:
            i = x - 1
            return None if i >= ea else (
                i + 1, int(np.searchsorted(B[:eb], A[i], "right")))
        j = x - 1 - na
        return None if j >= eb else (
            int(np.searchsorted(A[:ea], B[j], "right")), j + 1)

    n = na + nb + 1
    nxt, steps, zips = list(range(n)), [0] * n, [0] * n
    for x in range(n):
        st = state(x)
        if st is None or not (st[0] < na and st[1] < nb):
            continue
        pa, pb = st
        fa, fb = min(na - pa, R), min(nb - pb, R)
        xa, xb = min(pa + fa, ea), min(pb + fb, eb)
        mxa = A[xa - 1] if xa > pa else -1
        mxb = B[xb - 1] if xb > pb else -1
        if mxa >= 0 and mxb >= 0:
            nxt[x] = xa if mxa <= mxb else na + xb
            steps[x], zips[x] = 1, fa + fb
    more = nxt[0] != 0
    rounds = 0  # 2^rounds >= (La + Lb) / R + 2 steps, the kernel's bound
    while 2 ** rounds < (len(A) + len(B)) // R + 2:
        rounds += 1
    for _ in range(rounds):
        if not more:
            break
        nxt2 = [nxt[nxt[x]] for x in range(n)]
        steps = [steps[x] + (steps[nxt[x]] if nxt[x] != x else 0)
                 for x in range(n)]
        zips = [zips[x] + (zips[nxt[x]] if nxt[x] != x else 0)
                for x in range(n)]
        more = nxt[nxt2[0]] != nxt2[0]
        nxt = nxt2
    assert nxt[nxt[0]] == nxt[0]  # the chain ended within the bound
    pa, pb = state(nxt[0])
    return (steps[0], zips[0], -(-max(na - pa, 0) // R),
            -(-max(nb - pb, 0) // R))


def _long_rows(seed, N, La, Lb, key_hi):
    rng = np.random.default_rng(seed)
    rows = _partition(rng, N, La, key_hi) + _partition(rng, N, Lb, key_hi)
    ka, va, la, kb, vb, lb = rows
    if N > 1:  # one side empty
        ka[0], va[0], la[0] = EMPTY, 0.0, 0
    lb[-1] = min(lb[-1], 1)  # one key against many
    kb[-1, lb[-1]:], vb[-1, lb[-1]:] = EMPTY, 0.0
    if N > 2:  # the same keys on both sides: every B element a duplicate
        n = min(la[1], lb[1])
        kb[1, :n], la[1], lb[1] = ka[1, :n], n, n
        kb[1, n:] = EMPTY
    return rows


@pytest.mark.parametrize("tile", [1, 3, 8, 64])
@pytest.mark.parametrize("N,La,Lb,key_hi", [(4, 40, 40, 90), (3, 64, 24, 70),
                                           (5, 33, 70, 400), (3, 16, 16, 20)])
def test_long_row_payload_emulation(N, La, Lb, key_hi, tile):
    """Tiles of the merged diagonal (tile = 1 cuts every duplicate pair
    across two tiles) give the plain union merge bit for bit."""
    ka, va, la, kb, vb, lb = _long_rows(La * Lb + tile, N, La, Lb, key_hi)
    want = ref_mt.merge_partitions(*_j(ka, va, la, kb, vb, lb), R=8,
                                   with_counters=False)
    for s in range(N):
        ok, ov, n = _long_payload(ka[s], va[s], int(la[s]), kb[s], vb[s],
                                  int(lb[s]), tile)
        _eq(np.asarray(want[0])[s], ok)
        _eq(np.asarray(want[1])[s], ov)
        assert n == int(want[2][s])


@pytest.mark.parametrize("R", [2, 4, 16])
@pytest.mark.parametrize("N,La,Lb,key_hi", [(4, 40, 40, 90), (3, 64, 24, 70),
                                           (5, 33, 70, 400), (6, 200, 150,
                                                              1000)])
def test_long_row_counters_emulation(N, La, Lb, key_hi, R):
    """The chain of cutoffs by pointer jumping gives the plain advance
    loop's four counters bit for bit, per row; a row with an EMPTY inside
    its length whose other side runs out first too."""
    ka, va, la, kb, vb, lb = _long_rows(La + Lb + R, N, La, Lb, key_hi)
    ka[-1], kb[-1] = EMPTY, EMPTY
    ka[-1, :2], la[-1] = (7, 11), 3  # an EMPTY inside A's length ...
    kb[-1, 0], lb[-1] = 6, 1  # ... where B runs out first
    for s in range(N):
        got = _jump_counters(ka[s], int(la[s]), kb[s], int(lb[s]), R)
        k_a, l_a, k_b, l_b = _t(ka[s:s + 1], la[s:s + 1], kb[s:s + 1],
                                lb[s:s + 1])
        steps, zips, tails = _advance_counters(k_a, l_a, k_b, l_b, R=R,
                                               pair_streams=1)
        assert got == (int(steps[0]), int(zips), int(tails[0, 0]),
                       int(tails[0, 1])), s


def test_long_row_counters_emulation_hands_malformed_rows_on():
    """Rows out of order, with a duplicate or a negative key go to the
    plain loop (None); well-formed ones with EMPTY only at the end do
    not."""
    A = np.array([1, 4, 9, EMPTY, EMPTY], np.int32)
    B = np.array([2, 3, EMPTY], np.int32)
    assert _jump_counters(A, 5, B, 3, 4) is not None
    for bad in ([4, 1, 9], [1, 4, 4], [-3, 1, 9], [1, EMPTY, 9]):
        assert _jump_counters(np.array(bad, np.int32), 3, B, 3, 4) is None


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
# The warp chunk sort of K1 and K4 (csrc/zipper.cuh: sort_warp_kernel and
# sort_chunks_warp, also K3's chunk sort) emulated in numpy, lane by lane
# ---------------------------------------------------------------------------

def _warp_sort(keys, vals, lens, items, zero_start):
    """The warp route as its lanes run it.  A warp holds 32 * items
    slots, lane l the items slots from l * items, masked by its chunk's
    length; a chunk spans lpc = R / items lanes.  Each element ranks
    itself against the keys the chunk's lanes shuffle to it, is placed by
    rank in the warp's scratch and read back; each run is summed in
    float32 lane to lane (lane j carries lane j - 1's trailing run on,
    from zero when zero_start); run ends form a bit mask per lane whose
    popcounts, prefixed over the chunk's lanes by shuffle-ups, give the
    output slots.  Returns (keys (N, R), float32 vals (N, R), lens (N,))."""
    N, R = keys.shape
    E, W, lpc = N * R, 32 * items, R // items
    assert items <= R <= W
    kf, vf = keys.reshape(-1), vals.reshape(-1).astype(np.float32)
    ok = np.full(E, -7, np.int32)  # every slot must be stored once
    ov = np.full(E, np.nan, np.float32)
    ol = np.full(N, -7, np.int32)
    lane = np.arange(32)
    first = lane & ~(lpc - 1)
    j0 = lane - first
    off = j0 * items
    c0 = lane * items - off
    zero = np.float32(0.0)
    for w0 in range(0, E, W):
        x = w0 + lane * items
        live = x < E
        ln = np.where(live, lens[np.minimum(x, E - 1) // R], 0)
        k = np.full((32, items), EMPTY, np.int32)
        v = np.zeros((32, items), np.float32)
        for i in range(items):
            valid = off + i < ln
            k[valid, i] = kf[x[valid] + i]
            v[valid, i] = vf[x[valid] + i]
        # rank: lane first + src shuffles its element e to the chunk
        rk = np.zeros((32, items), np.int64)
        for src in range(lpc):
            for e in range(items):
                kj = k[first + src, e][:, None]
                j = src * items + e
                rk += (kj < k) | ((kj == k)
                                  & (j < off[:, None] + np.arange(items)))
        wk = np.full(W, -9, np.int32)
        wv = np.zeros(W, np.float32)
        slot = c0[:, None] + rk
        assert len(np.unique(slot)) == W  # a permutation of the warp's slots
        wk[slot], wv[slot] = k, v
        k, v = wk.reshape(32, items).copy(), wv.reshape(32, items).copy()
        # run ends
        nk = np.where(j0 == lpc - 1, EMPTY, np.roll(k[:, 0], -1))
        nxt = np.concatenate([k[:, 1:], nk[:, None]], axis=1)
        last = (k != nxt) & (k != EMPTY)
        # running sums, lane by lane, carried through a shuffle-up
        carry = np.zeros(32, np.float32)
        ckey = np.full(32, EMPTY, np.int32)
        for j in range(lpc):
            for ln_ in np.flatnonzero(j0 == j):
                if j > 0 and k[ln_, 0] == ckey[ln_]:
                    acc = np.float32(carry[ln_] + v[ln_, 0])
                else:
                    acc = np.float32(zero + v[ln_, 0]) if zero_start \
                        else v[ln_, 0]
                v[ln_, 0] = acc
                for i in range(1, items):
                    if k[ln_, i] == k[ln_, i - 1]:
                        acc = np.float32(acc + v[ln_, i])
                    else:
                        acc = np.float32(zero + v[ln_, i]) if zero_start \
                            else v[ln_, i]
                    v[ln_, i] = acc
            up_v = np.concatenate([v[:1, -1], v[:-1, -1]])
            up_k = np.concatenate([k[:1, -1], k[:-1, -1]])
            take = j0 == j + 1
            carry[take], ckey[take] = up_v[take], up_k[take]
        # output slots: popcount prefix over the chunk's lanes
        cnt = last.sum(1)
        incl = cnt.copy()
        o = 1
        while o < lpc:
            y = np.concatenate([incl[:o], incl[:-o]])
            incl = np.where(j0 >= o, incl + y, incl)
            o <<= 1
        before = incl - cnt
        n = incl[first + lpc - 1]
        for l in np.flatnonzero(live):
            for i in range(items):
                if last[l, i]:
                    pos = w0 + c0[l] + before[l] + last[l, :i].sum()
                    ok[pos], ov[pos] = k[l, i], v[l, i]
                if off[l] + i >= n[l]:
                    ok[x[l] + i], ov[x[l] + i] = EMPTY, 0.0
            if j0[l] == 0:
                ol[(w0 + c0[l]) // R] = n[l]
    assert (ok != -7).all() and (ol != -7).all()
    return ok.reshape(N, R), ov.reshape(N, R), ol


def _sort_inputs(R, seed):
    """Chunks of R from a numpy seed: random keys over narrow and wide
    ranges (many duplicate runs, some across lanes), an empty chunk, an
    all-duplicate full chunk, a lone -0.0, a run of -0.0 and a lens past
    R; -0.0 among the values.  Enough chunks for a partial last warp."""
    rng = np.random.default_rng(seed)
    N = max(9, 1152 // R)
    keys = rng.integers(0, 3, (N, R))
    keys[N // 2:] = rng.integers(0, 4 * R, (N - N // 2, R))
    lens = rng.integers(0, R + 1, N)
    vals = rng.standard_normal((N, R)).astype(np.float32)
    vals[rng.random((N, R)) < 0.1] = -0.0
    lens[0] = 0
    keys[1], lens[1] = 7, R
    keys[2, 0], vals[2, 0], lens[2] = 5, -0.0, 1
    keys[3], vals[3], lens[3] = 9, -0.0, R
    lens[4] = R + 3
    return keys.astype(np.int32), vals, lens.astype(np.int32)


def _warp_items(R):
    """Every ITEMS the warp route takes for chunks of R."""
    return [i for i in (1, 2, 4, 8) if i <= R <= 32 * i]


_WARP_CASES = [(R, i) for R in (8, 16, 32, 128) for i in _warp_items(R)]


@pytest.mark.parametrize("R,items", _WARP_CASES)
def test_warp_chunk_sort_emulation_k1(R, items):
    """K1's warp route: the reference's sort_chunks_linear bit for bit
    (runs summed from their first value, -0.0 kept)."""
    keys, vals, lens = _sort_inputs(R, seed=R * 10 + items)
    got = _warp_sort(keys, vals, lens, items, zero_start=False)
    want = ref_mt.sort_chunks_linear(*_j(keys, vals, lens))
    for w, g in zip(want, got):
        _eq(w, g)
    assert np.signbit(got[1][2, 0]) and np.signbit(got[1][3, 0])


@pytest.mark.parametrize("vdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,items", _WARP_CASES)
def test_warp_chunk_sort_emulation_k4(R, items, vdtype):
    """K4's warp route: the reference's stream_sort_ref bit for bit (runs
    summed from zero: a lone -0.0 becomes +0.0).  bfloat16 values are
    loaded as float32 and each total rounded once on store: the
    reference on the float32 values, rounded once, and the port's plain
    version on the bfloat16 values."""
    keys, vals, lens = _sort_inputs(R, seed=R * 10 + items + 1)
    if vdtype == "bfloat16":
        vals = torch.from_numpy(vals).bfloat16().float().numpy()
    k, v, n = _warp_sort(keys, vals, lens, items, zero_start=True)
    want = ref_k.stream_sort_ref(*_j(keys, vals, lens))
    _eq(want[0], k)
    _eq(want[2], n)
    _eq(want[1], v)
    assert not np.signbit(v[2, 0]) and not np.signbit(v[3, 0])
    if vdtype == "bfloat16":
        tv = torch.from_numpy(vals).bfloat16()
        pk, pv, pn = stream_sort_plain(*_t(keys), tv, *_t(lens))
        _eq(pk, k)
        _eq(pn, n)
        assert torch.equal(pv.view(torch.int16),
                           torch.from_numpy(v).bfloat16().view(torch.int16))


def test_sort_config_shapes():
    """The launch shapes of the warp route: a legal ITEMS for every R
    (a chunk inside one warp), the block route past R = 256, and grids
    that spread K4's host-driver front and K1's large-route bucket."""
    for R in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        for E in (R, 8192, 131072, 1 << 22):
            items, warps = sort_config(E, R)
            assert items in _warp_items(R) and 1 <= warps <= 4
    assert sort_config(1 << 20, 512) is None and 32 * MAX_ITEMS == 256

    def blocks(E, R):
        items, warps = sort_config(E, R)
        return -(-E // (32 * items * warps))
    assert sort_config(512 * 16, 16) == (1, 1) and blocks(512 * 16, 16) >= 64
    assert sort_config(8192 * 16, 16) == (2, 4)
    assert blocks(8192 * 16, 16) >= 256
    assert sort_config(65536 * 16, 16) == (4, 4)
    assert sort_config(1 << 24, 16) == (4, 4) and sort_config(256, 256)[0] == 8


# ---------------------------------------------------------------------------
# K3's kernel body (csrc/fused_bucket.cu) emulated in numpy: the merge
# rounds by merge path, the counters along the stored successor chain,
# and the per-block reduction into a group's accumulator columns
# ---------------------------------------------------------------------------

_END = 0xFFFF


def _walk_fronts(A, la, B, lb, R):
    """walk_fronts: the plain front loop, (steps, zips, pa, pb)."""
    pa = pb = steps = zips = 0
    while pa < la and pb < lb:
        na, nb = min(la - pa, R), min(lb - pb, R)
        fa, fb = A[pa:pa + na], B[pb:pb + nb]
        mxa = max([-1] + [int(k) for k in fa if k != EMPTY])
        mxb = max([-1] + [int(k) for k in fb if k != EMPTY])
        cut = min(mxa, mxb)
        pa += int(((fa != EMPTY) & (fa <= cut)).sum())
        pb += int(((fb != EMPTY) & (fb <= cut)).sum())
        steps, zips = steps + 1, zips + na + nb
    return steps, zips, pa, pb


def _k3_pair(A, VA, la, B, VB, lb, W, R, items):
    """One merge pair of one round as K3's threads run it.  Thread t takes
    diagonals [t * items, (t + 1) * items) of the pair's 2W output slots:
    one merge-path search, a sequential merge (a key on both sides is
    va + vb in A's element; its B partner drops out by looking at A's
    previous key), each element's candidate word (successor | rank << 16),
    a scan of the drops, then its stores.  The pair's first thread walks
    the successor chain.  Returns (keys, vals, n_out, (steps, zips, ta,
    tb))."""
    tot, W2 = la + lb, 2 * W
    cand = np.zeros(W2, np.int64)
    threads = []
    for d0 in range(0, W2, items):
        ds = min(d0, tot)
        ia = _merge_path(A[:la], B[:lb], ds)
        ib = ds - ia
        out, drop = [], 0
        for i in range(items):
            if d0 + i >= tot:
                break
            if ib >= lb or (ia < la and A[ia] <= B[ib]):
                k, v = A[ia], VA[ia]
                m = ib < lb and B[ib] == k
                if m:
                    v = np.float32(v + VB[ib])
                rank, slot = ib + m, ia
                ia += 1
                pa, pb = ia, rank
            else:
                k, v = B[ib], VB[ib]
                if ia > 0 and A[ia - 1] == k:
                    drop |= 1 << i
                rank, slot = ia, W + ib
                ib += 1
                pa, pb = rank, ib
            nxt = _END
            if pa < la and pb < lb:
                na, nb = min(la - pa, R), min(lb - pb, R)
                nxt = pa + na - 1 if A[pa + na - 1] <= B[pb + nb - 1] \
                    else W + pb + nb - 1
            cand[slot] = nxt | rank << 16
            out.append((d0 + i, k, v))
        threads.append((out, drop))
    before = np.cumsum([0] + [bin(dr).count("1") for _, dr in threads])
    n_out = tot - int(before[-1])
    keys, vals = np.full(W2, EMPTY, np.int32), np.zeros(W2, np.float32)
    for t, (out, drop) in enumerate(threads):
        for i, (d, k, v) in enumerate(out):
            if not drop >> i & 1:
                pos = d - before[t] - bin(drop & ((1 << i) - 1)).count("1")
                keys[pos], vals[pos] = k, v
    # counters
    steps = zips = pa = pb = 0
    if la and lb:
        if A[0] < 0 or B[0] < 0:
            steps, zips, pa, pb = _walk_fronts(A, la, B, lb, R)
        else:
            na, nb = min(la, R), min(lb, R)
            x = na - 1 if A[na - 1] <= B[nb - 1] else W + nb - 1
            steps, zips = 1, na + nb
            while True:
                c = int(cand[x])
                pa, pb = (x + 1, c >> 16) if x < W else (c >> 16, x - W + 1)
                if c & _END == _END:
                    break
                zips += min(la - pa, R) + min(lb - pb, R)
                steps, x = steps + 1, c & _END
    tails = (-(-max(la - pa, 0) // R), -(-max(lb - pb, 0) // R))
    return keys, vals, n_out, (steps, zips) + tails


def _k3_tree(sk, sv, sl, R, items):
    """merge_rounds over (S, C, R) sorted chunks: merged (keys, vals,
    lens) and the per-stream (S, C - 1, 4) counter columns (round r, pair
    q at column C - (C >> r) + q)."""
    S, C, _ = sk.shape
    k, v = sk.reshape(S, -1).copy(), sv.reshape(S, -1).copy()
    n = sl.astype(np.int64).copy()
    cols = np.zeros((S, max(C - 1, 1), 4), np.int64)
    W, cc, r = R, C, 0
    while cc > 1:
        nn = np.zeros((S, cc // 2), np.int64)
        for s in range(S):
            for q in range(cc // 2):
                b = q * 2 * W
                ko, vo, no, cnt = _k3_pair(
                    k[s, b:b + W], v[s, b:b + W], int(n[s, 2 * q]),
                    k[s, b + W:b + 2 * W], v[s, b + W:b + 2 * W],
                    int(n[s, 2 * q + 1]), W, R, items)
                k[s, b:b + 2 * W], v[s, b:b + 2 * W], nn[s, q] = ko, vo, no
                cols[s, C - (C >> r) + q] = cnt
        n, W, cc, r = nn, 2 * W, cc // 2, r + 1
    return k, v, n[:, 0], cols


def _k3_bucket(L, R, seed):
    """Four streams of width L: random keys over a narrow range, chunks
    with disjoint key ranges, every chunk holding the same keys (full
    overlap), and a short stream (empty sides); -0.0 among the values."""
    rng = np.random.default_rng(seed)
    S, C = 4, L // R
    keys = rng.integers(0, max(2 * R, L // 3), (S, L))
    chunk = np.arange(L) // R
    keys[1] = chunk * 1000 + rng.integers(0, R, L)
    keys[2] = np.tile(rng.permutation(R), C)
    plens = np.array([L, L - R // 2, L, min(L, 3 * R // 2)], np.int32)
    vals = rng.standard_normal((S, L)).astype(np.float32)
    vals[rng.random((S, L)) < 0.1] = -0.0
    mask = np.arange(L)[None, :] < plens[:, None]
    return (np.where(mask, keys, EMPTY).astype(np.int32),
            np.where(mask, vals, 0.0).astype(np.float32), plens)


@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("L", [2 ** e for e in range(4, 14)])
def test_k3_merge_path_rounds_emulation(L, R):
    """The kernel's merge rounds (merge path, straddling duplicates, the
    successor chain) give the plain zip_merge_tree bit for bit — keys,
    values (-0.0 too), lengths and every round's counters — the oracle
    test_fused_bucket_plain_matches_zip_merge_tree holds against the
    reference (which takes ~30 s a case at L = 8,192 on the CPU)."""
    from repro_torch.kernels.fused_bucket import fused_config
    from repro_torch.kernels.merge_tree import zip_merge_tree
    items = fused_config(L, R)[0]
    keys, vals, plens = _k3_bucket(L, R, seed=L + R)
    S, C = keys.shape[0], L // R
    sk, sv, sl = sort_chunks_linear(*_t(keys.reshape(S * C, R),
                                        vals.reshape(S * C, R)),
                                    kvstream.chunk_lens(_t(plens)[0], C, R))
    sk, sv, sl = sk.view(S, C, R), sv.view(S, C, R), sl.view(S, C)
    want = zip_merge_tree(sk, sv, sl, R=R, detailed=True)
    k, v, n, cols = _k3_tree(*(t.numpy() for t in (sk, sv, sl)), R, items)
    _eq(k, want[0])
    _eq(v, want[1])
    _eq(n.astype(np.int32), want[2])
    for r, (steps, ze, tails) in enumerate(want[3]):
        c = cols[:, C - (C >> r):C - (C >> (r + 1))]
        _eq(c[..., 0].max(0), steps)
        assert int(ze) == int(c[..., 1].sum())
        _eq(c[..., 2:].max(0), tails)


def test_k3_pair_negative_keys_take_the_front_loop():
    """A pair holding a negative key walks the plain front loop (its -1
    floor is not the chain's state); the payload is the union merge."""
    A = np.array([-9, -5, -2, 4, 7, EMPTY, EMPTY, EMPTY], np.int32)
    B = np.array([-7, -5, 3, 4, EMPTY, EMPTY, EMPTY, EMPTY], np.int32)
    VA, VB = np.arange(8, dtype=np.float32), -np.arange(8, dtype=np.float32)
    for R in (2, 4):
        keys, vals, n, cnt = _k3_pair(A, VA, 5, B, VB, 4, 8, R, 2)
        want = ref_mt.merge_partitions(*_j(A[None], VA[None], [5], B[None],
                                           VB[None], [4]), R=R)
        _eq(np.asarray(want[0])[0], keys)
        _eq(np.asarray(want[1])[0], vals)
        steps, zips, tails = _advance_counters(*_t(A[None], np.int32([5]),
                                                   B[None], np.int32([4])),
                                               R=R, pair_streams=1)
        assert n == int(want[2][0])
        assert cnt == (int(steps[0]), int(zips), int(tails[0, 0]),
                       int(tails[0, 1]))


def _flush(block_cols, C, Cg, steps, zips, tails):
    """The kernel's epilogue: block column b (round r, pair q) lands at
    group column Cg - (Cg >> r) + q, steps and tails by atomicMax, zip
    elements by atomicAdd per round."""
    for b in range(C - 1):
        r = 0
        while b >= C - (C >> (r + 1)):
            r += 1
        gc = Cg - (Cg >> r) + b - (C - (C >> r))
        steps[gc] = max(steps[gc], block_cols[b, 0])
        zips[r] += block_cols[b, 1]
        tails[gc] = np.maximum(tails[gc], block_cols[b, 2:])


@pytest.mark.parametrize("spb", [1, 2, 8])
def test_k3_group_reduction_emulation(spb):
    """Per-block max / sum of the streams' counter columns, then one
    atomic per block and column into the group's accumulators, equals the
    old driver's path: per-bucket amax / sum over streams, then
    scatter_reduce_ at the group columns (buckets of mixed C)."""
    from repro_torch.kernels.fused_bucket import accumulators, reduce_rounds
    rng = np.random.default_rng(spb)
    Cs = [1, 2, 8, 4, 32]
    Cg = max(Cs)
    buckets = [rng.integers(0, 50, (rng.integers(1, 20), max(C - 1, 1), 4))
               for C in Cs]
    for b, C in zip(buckets, Cs):
        if C == 1:
            b[:] = 0  # no rounds, no counters
    # the kernel: blocks of spb streams, reduced in shared memory, flushed
    W = max(Cg - 1, 1)
    steps, zips = np.zeros(W, np.int64), np.zeros(W, np.int64)
    tails = np.zeros((W, 2), np.int64)
    for b, C in zip(buckets, Cs):
        for s0 in range(0, len(b), spb):
            blk = b[s0:s0 + spb]
            red = np.concatenate([blk[..., :1].max(0), blk[..., 1:2].sum(0),
                                  blk[..., 2:].max(0)], axis=1)
            _flush(red, C, Cg, steps, zips, tails)
    # the old driver: per-bucket rounds, scatter_reduce_ at group columns
    old_steps = torch.zeros(W, dtype=torch.int64)
    old_tails = torch.zeros((W, 2), dtype=torch.int64)
    old_zips = 0
    cols = np.concatenate([Cg - (Cg >> k) + np.arange(C >> (k + 1))
                           for C in Cs for k in range(C.bit_length() - 1)])
    at = 0
    acc, s_acc, z_acc, t_acc = accumulators(Cg, "cpu")
    for b, C in zip(buckets, Cs):
        rounds = []
        for k in range(C.bit_length() - 1):
            c = torch.from_numpy(b[:, C - (C >> k):C - (C >> (k + 1))])
            rounds.append((c[..., 0].amax(0), c[..., 1].sum(), c[..., 2:]
                           .amax(0)))
        if rounds:
            idx = torch.from_numpy(cols[at:at + C - 1])
            at += C - 1
            old_steps.scatter_reduce_(0, idx, torch.cat([r[0] for r in rounds]),
                                      "amax")
            old_tails.scatter_reduce_(0, idx[:, None].expand(-1, 2),
                                      torch.cat([r[2] for r in rounds]), "amax")
            old_zips += sum(int(r[1]) for r in rounds)
        reduce_rounds(rounds, s_acc, z_acc, t_acc)
    _eq(old_steps.numpy(), steps)
    _eq(old_tails.numpy(), tails)
    assert old_zips == int(zips.sum())
    # the torch slot's reduction: the same accumulators
    _eq(steps, s_acc)
    _eq(zips, z_acc)
    _eq(tails, t_acc)
    n_zip, ze, ta, tb = acc.view(4, -1).sum(1).tolist()
    assert (n_zip, ze, ta + tb) == (int(steps.sum()), int(zips.sum()),
                                    int(tails.sum()))


# ---------------------------------------------------------------------------
# backend registry, ops, build
# ---------------------------------------------------------------------------

def test_backend_registry():
    assert set(kb.available_backends()) == {"torch", "cuda", "ref"}
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
                     "fused_expand_bucket", "stream_sort", "stream_merge"):
            assert callable(getattr(b, slot))


def test_launch_counts_reset():
    kb.reset_launch_counts()
    counts = kb.launch_counts()
    assert set(counts) == {"chunk_sort", "chunk_sort.warp", "chunk_sort.block",
                           "merge_partitions", "fused_bucket",
                           "fused_bucket.expand", "fused_bucket.fused",
                           "fused_bucket.large",
                           "stream_sort", "stream_sort.warp",
                           "stream_sort.block", "stream_merge",
                           "stream_merge.chunk",
                           "stream_merge.pointer", "flash_attention",
                           "flash_attention.wgmma", "flash_attention.fma",
                           "grouped_matmul", "grouped_matmul.contiguous",
                           "grouped_matmul.counts", "grouped_matmul.backward"}
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
