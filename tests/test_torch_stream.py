"""The host tier of the port against the JAX reference, on the CPU.

K4 (stream sort) and K5 (stream merge) each hold a CUDA kernel and its
plain torch version (``repro_torch.kernels.ref``), which the wrappers
take for CPU tensors.  Here the plain versions are held bit for bit
against the reference's oracles ``repro.kernels.ref.stream_sort_ref`` /
``stream_merge_ref`` (-0.0 included) and, at the reference's own
tolerances (``tests/test_kernels.py``), against the Pallas kernels in
interpret mode; the host-tier stream API (``sort_chunks``/
``merge_chunks`` with ``cap_s``, ``gather_chunk_fronts``/
``scatter_chunk_outputs``) against ``repro.core.stream``.
``test_torch_cuda.py`` holds each kernel against its plain version on
the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro.kernels in its own order)
from repro.core import stream as ref_stream
from repro.kernels import ref as ref_k
from repro.kernels.stream_merge import stream_merge_pallas
from repro.kernels.stream_sort import stream_sort_pallas
from repro_torch.core import stream as kvstream
from repro_torch.core.formats import EMPTY
from repro_torch.kernels import backend as kb, ops
from repro_torch.kernels.stream_merge import stream_merge, stream_merge_plain
from repro_torch.kernels.stream_sort import stream_sort, stream_sort_plain

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


def _fronts(rng, S, R, key_hi):
    lens = rng.integers(0, R + 1, S).astype(np.int32)
    lens[0] = 0  # always an empty stream
    keys = rng.integers(0, key_hi, (S, R)).astype(np.int32)
    vals = rng.standard_normal((S, R)).astype(np.float32)
    vals[rng.random((S, R)) < 0.15] = -0.0  # signed zeros
    return keys, vals, lens


def _sorted_fronts(rng, S, R, key_hi):
    lens = rng.integers(0, R + 1, S).astype(np.int32)
    keys = np.full((S, R), EMPTY, np.int32)
    vals = np.zeros((S, R), np.float32)
    for s in range(S):
        keys[s, :lens[s]] = np.sort(rng.choice(key_hi, lens[s], replace=False))
        vals[s, :lens[s]] = rng.standard_normal(lens[s])
    vals[rng.random((S, R)) < 0.15] = -0.0
    return keys, vals, lens


# ---------------------------------------------------------------------------
# K4: stream sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [8, 16, 32, 64])
@pytest.mark.parametrize("S", [1, 3, 16])
def test_stream_sort_plain_matches_reference(S, R):
    for key_hi in (2, max(2, R // 2), 1000):
        a = _fronts(np.random.default_rng(S * R + key_hi), S, R, key_hi)
        want = ref_k.stream_sort_ref(*_j(*a))
        got = stream_sort(*_t(*a))  # CPU tensors: the plain version
        for w, g in zip(want, got):
            _eq(w, g, f"S={S} R={R} key_hi={key_hi}")


@pytest.mark.parametrize("vdtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("S,R", [(3, 16), (16, 8)])
def test_stream_sort_plain_matches_pallas(S, R, vdtype):
    keys, vals, lens = _fronts(np.random.default_rng(R), S, R, max(2, R // 2))
    jv = jnp.asarray(vals).astype(jnp.dtype(vdtype))
    pk, pv, pl = stream_sort_pallas(*_j(keys), jv, *_j(lens), interpret=True)
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32)))
    if vdtype != np.float32:
        tv = tv.to(torch.bfloat16)
    gk, gv, gl = stream_sort_plain(*_t(keys), tv, *_t(lens))
    assert gv.dtype == tv.dtype
    tol = 2e-2 if vdtype != np.float32 else 1e-5
    _eq(pk, gk)
    _eq(pl, gl)
    np.testing.assert_allclose(gv.float().numpy(),
                               np.asarray(pv, np.float32), rtol=tol, atol=tol)


def test_stream_sort_empty_streams():
    keys = np.full((4, 16), EMPTY, np.int32)
    k, v, n = stream_sort(*_t(keys, np.zeros((4, 16), np.float32),
                              np.zeros(4, np.int32)))
    assert int(n.sum()) == 0 and bool((k == EMPTY).all())
    assert not bool(v.any())


# ---------------------------------------------------------------------------
# K5: stream merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [8, 16, 64])
@pytest.mark.parametrize("S", [1, 5, 16])
def test_stream_merge_plain_matches_reference(S, R):
    rng = np.random.default_rng(S + R)
    a = _sorted_fronts(rng, S, R, 4 * R) + _sorted_fronts(rng, S, R, 4 * R)
    want = ref_k.stream_merge_ref(*_j(*a))
    got = stream_merge(*_t(*a))
    assert len(got) == 7
    for i, (w, g) in enumerate(zip(want, got)):
        _eq(w, g, f"output {i}")


@pytest.mark.parametrize("S,R", [(5, 16), (16, 8)])
def test_stream_merge_plain_matches_pallas(S, R):
    rng = np.random.default_rng(7 * S)
    a = _sorted_fronts(rng, S, R, 4 * R) + _sorted_fronts(rng, S, R, 4 * R)
    want = stream_merge_pallas(*_j(*a), interpret=True)
    got = stream_merge_plain(*_t(*a))
    for i, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=f"output {i}")
        else:
            _eq(w, g, f"output {i}")


def test_stream_merge_one_side_empty():
    ka, va, la = _sorted_fronts(np.random.default_rng(3), 3, 16, 64)
    la[:] = np.maximum(la, 1)
    res = stream_merge(*_t(ka, va, la, np.full((3, 16), EMPTY, np.int32),
                           np.zeros((3, 16), np.float32),
                           np.zeros(3, np.int32)))
    # unmergeable: nothing advances, nothing is emitted
    assert int(res[4].sum()) == int(res[5].sum()) == int(res[6].sum()) == 0


# ---------------------------------------------------------------------------
# the host-tier stream API: registry slots, cap_s padding, numpy helpers
# ---------------------------------------------------------------------------

def test_backends_carry_the_stream_slots():
    assert kb.get_backend("torch").stream_sort is stream_sort_plain
    assert kb.get_backend("torch").stream_merge is stream_merge_plain
    assert kb.get_backend("cuda").stream_sort is stream_sort
    assert kb.get_backend("cuda").stream_merge is stream_merge
    assert {"stream_sort", "stream_merge"} <= set(kb.launch_counts())
    with pytest.raises(ValueError, match="runs on cuda"):
        ops.stream_sort(*_t(*_fronts(np.random.default_rng(0), 2, 8, 4)),
                        backend="cuda")


@pytest.mark.parametrize("cap_s", [None, 5, 8])
def test_sort_and_merge_chunks_with_cap_s(cap_s):
    rng = np.random.default_rng(11)
    a = _fronts(rng, 5, 16, 9)
    want = ref_stream.sort_chunks(*a, backend="xla", cap_s=cap_s)
    got = kvstream.sort_chunks(*_t(*a), backend="torch", cap_s=cap_s)
    for w, g in zip(want, got):
        assert g.shape[0] == 5
        _eq(w, g)
    m = _sorted_fronts(rng, 5, 16, 64) + _sorted_fronts(rng, 5, 16, 64)
    want = ref_stream.merge_chunks(*m, backend="xla", cap_s=cap_s)
    got = kvstream.merge_chunks(*_t(*m), backend="torch", cap_s=cap_s)
    for w, g in zip(want, got):
        assert g.shape[0] == 5
        _eq(w, g)


def test_gather_and_scatter_chunk_fronts():
    rng = np.random.default_rng(5)
    parts_k = [np.sort(rng.choice(100, n, replace=False)).astype(np.int32)
               for n in (0, 3, 20, 16)]
    parts_v = [rng.standard_normal(len(k)).astype(np.float32)
               for k in parts_k]
    ptrs = np.array([0, 1, 4, 16])
    for w, g in zip(ref_stream.gather_chunk_fronts(parts_k, parts_v, ptrs, 8),
                    kvstream.gather_chunk_fronts(parts_k, parts_v, ptrs, 8)):
        _eq(w, g)
    out_k = rng.integers(0, 50, (4, 6)).astype(np.int32)
    out_v = rng.standard_normal((4, 6)).astype(np.float32)
    lens = np.array([0, 6, 2, 3])
    bufs = []
    for mod in (ref_stream, kvstream):
        dk = [np.zeros(12, np.int32) for _ in range(4)]
        dv = [np.zeros(12, np.float32) for _ in range(4)]
        ptr = np.array([0, 2, 5, 9])
        mod.scatter_chunk_outputs(out_k, out_v, dk, dv, ptr, lens)
        bufs.append((dk, dv, ptr))
    (wk, wv, wp), (gk, gv, gp) = bufs
    _eq(wp, gp)
    for a, b in zip(wk + wv, gk + gv):
        _eq(a, b)
