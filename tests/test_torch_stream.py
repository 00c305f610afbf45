"""The host tier of the port against the JAX reference, on the CPU.

K4 (stream sort) and K5 (stream merge) each hold a CUDA kernel and its
plain torch version (``repro_torch.kernels.ref``), which the wrappers
take for CPU tensors.  Here the plain versions are held bit for bit
against the reference's oracles ``repro.kernels.ref.stream_sort_ref`` /
``stream_merge_ref`` (-0.0 included) and, at the reference's own
tolerances (``tests/test_kernels.py``), against the Pallas kernels in
interpret mode; the host-tier stream API (``sort_chunks``/
``merge_chunks`` with ``cap_s``, ``gather_chunk_fronts``/
``scatter_chunk_outputs``) against ``repro.core.stream``.  K5's pointer
form (one whole issue of the host driver's merge round on pointers into
the padded partitions) is held step by step against the reference's
``stream_merge_ref`` with its own front gathers and appends, and the
port's ``merge_round`` against the reference's, counters included.
``test_torch_cuda.py`` holds each kernel against its plain version on
the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro.kernels in its own order)
from repro.core import spgemm_engines as ref_sg
from repro.core import stream as ref_stream
from repro.kernels import ref as ref_k
from repro.kernels.stream_merge import stream_merge_pallas
from repro.kernels.stream_sort import stream_sort_pallas
from repro_torch.core import spgemm_engines as sg
from repro_torch.core import stream as kvstream
from repro_torch.core.formats import EMPTY
from repro_torch.kernels import backend as kb, ops, ref as port_ref
from repro_torch.kernels.stream_merge import (stream_merge, stream_merge_plain,
                                              stream_merge_ptr,
                                              stream_merge_ptr_plain)
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
# K5's pointer form: one issue of a merge round, in place
# ---------------------------------------------------------------------------

def _pair(rng, S, La, Lb, case):
    """Two padded sorted-unique partitions of S streams (int64 lengths):
    "random"; "exhausted" (half the streams have an empty side, and B is
    short, so it runs out while A goes on); "overlap" (B holds A's first
    keys: every early front is all duplicates)."""
    hi = La + Lb  # keys of both sides interleave: many issues a round
    la = rng.integers(0, La + 1, S)
    lb = rng.integers(0, Lb + 1, S)
    if case == "exhausted":
        la[::2], lb[1::2] = 0, rng.integers(1, 20, len(lb[1::2]))
    out = []
    for L, lens in ((La, la), (Lb, lb)):
        K = np.full((S, L), EMPTY, np.int32)
        V = np.zeros((S, L), np.float32)
        for s in range(S):
            K[s, :lens[s]] = np.sort(rng.choice(hi, lens[s], replace=False))
            V[s, :lens[s]] = rng.standard_normal(lens[s])
        V[rng.random((S, L)) < 0.1] = -0.0
        out.append([K, V, lens.astype(np.int64)])
    if case == "overlap":
        (Ka, _, la), (Kb, Vb, lb) = out
        n = np.minimum(la, lb)
        for s in range(S):
            Kb[s, :n[s]] = Ka[s, :n[s]]
            Kb[s, n[s]:] = EMPTY
            Vb[s, n[s]:] = 0.0
        lb[:] = n
    return out[0] + out[1]


@pytest.mark.parametrize("case", ["random", "exhausted", "overlap"])
@pytest.mark.parametrize("R", [8, 16])
def test_stream_merge_ptr_plain_matches_reference_step_by_step(R, case):
    """Issue by issue through a whole merge round and 3 idle issues past
    its end: the plain pointer form's pointers, zip elements, appended
    rows and flag equal the reference's stream_merge_ref with its own
    gathers and appends (``_take_chunk``/``_put_rows``), and the chunk-form
    composition (take_chunk -> merge_chunks -> put_rows) on the port; its
    count of issues that did work is the count of issues with a live
    stream."""
    rng = np.random.default_rng(R + len(case))
    S, La, Lb = 7, 96, 64
    Ka, Va, la, Kb, Vb, lb = _pair(rng, S, La, Lb, case)
    Lo = La + Lb
    ref = dict(pa=np.zeros(S, np.int64), pb=np.zeros(S, np.int64),
               optr=np.zeros(S, np.int64), zips=np.zeros(S, np.int64),
               Ko=np.full((S, Lo), EMPTY, np.int32),
               Vo=np.zeros((S, Lo), np.float32))
    tKa, tVa, tla, tKb, tVb, tlb = _t(Ka, Va, la, Kb, Vb, lb)

    def fresh():
        z = torch.zeros(S, dtype=torch.int64)
        return dict(pa=z.clone(), pb=z.clone(), optr=z.clone(),
                    zips=z.clone(),
                    Ko=torch.full((S, Lo + 1), EMPTY, dtype=torch.int32),
                    Vo=torch.zeros((S, Lo + 1), dtype=torch.float32))

    ptr, comp = fresh(), fresh()
    worked = torch.zeros(1, dtype=torch.int64)
    live_issues = idle = 0
    while idle < 3:
        both = (ref["pa"] < la) & (ref["pb"] < lb)
        ka, va, na = ref_sg._take_chunk(Ka, Va, np.where(both, la, 0),
                                        ref["pa"], R)
        kb_, vb, nb = ref_sg._take_chunk(Kb, Vb, np.where(both, lb, 0),
                                         ref["pb"], R)
        klo, vlo, khi, vhi, ca, cb, ol = map(np.asarray, ref_k.stream_merge_ref(
            *_j(ka, va, na, kb_, vb, nb)))
        ref_sg._put_rows(ref["Ko"], ref["Vo"], ref["optr"],
                         np.concatenate([klo, khi], 1),
                         np.concatenate([vlo, vhi], 1), ol.astype(np.int64))
        for key, d in (("optr", ol), ("pa", ca), ("pb", cb), ("zips", na),
                       ("zips", nb)):
            ref[key] += d
        more = (ref["pa"] < la) & (ref["pb"] < lb)
        want_flag = int(both.any()) + 2 * int(more.any())

        flag = torch.zeros(1, dtype=torch.int32)
        stream_merge_ptr(tKa, tVa, tla, tKb, tVb, tlb, ptr["pa"], ptr["pb"],
                         ptr["optr"], ptr["Ko"], ptr["Vo"], ptr["zips"],
                         flag, worked, R=R)  # CPU tensors: the plain version
        assert int(flag) == want_flag
        # the chunk-form composition on the port
        tboth = (comp["pa"] < tla) & (comp["pb"] < tlb)
        fa = port_ref.take_chunk(tKa, tVa, torch.where(tboth, tla, 0),
                                 comp["pa"], R)
        fb = port_ref.take_chunk(tKb, tVb, torch.where(tboth, tlb, 0),
                                 comp["pb"], R)
        cklo, cvlo, ckhi, cvhi, cca, ccb, col = kvstream.merge_chunks(
            *fa, *fb, backend="torch")
        port_ref.put_rows(comp["Ko"], comp["Vo"], comp["optr"],
                          torch.cat([cklo, ckhi], 1),
                          torch.cat([cvlo, cvhi], 1), col)
        for key, d in (("optr", col), ("pa", cca), ("pb", ccb),
                       ("zips", fa[2]), ("zips", fb[2])):
            comp[key] += d
        for got in (ptr, comp):
            for key in ("pa", "pb", "optr", "zips"):
                _eq(ref[key], got[key], key)
            _eq(ref["Ko"], got["Ko"][:, :Lo])
            _eq(ref["Vo"], got["Vo"][:, :Lo])
        live_issues += bool(both.any())
        idle += not both.any()
        assert int(worked) == live_issues
    assert live_issues > 1


@pytest.mark.parametrize("case", ["random", "exhausted", "overlap"])
@pytest.mark.parametrize("R", [8, 16])
def test_merge_round_matches_reference(R, case):
    """The port's merge_round (pointer-form issues, flags read every
    MERGE_FLAG_EVERY issues) gives the reference's merged partition and
    its counters: n_mszip, zip elements, chunk loads and stores (the
    issues that did work, zip elements and tail stores gathered in
    ``acc`` on the device, as the host driver turns them into
    SpzStats)."""
    rng = np.random.default_rng(3 * R + len(case))
    S = 9
    Ka, Va, la, Kb, Vb, lb = _pair(rng, S, 160, 128, case)
    want_st = ref_sg.SpzStats()
    wk, wv, wl = ref_sg.merge_round((Ka, Va, la), (Kb, Vb, lb), R, "xla",
                                    want_st)
    st = sg.SpzStats()
    acc = torch.zeros((3, S), dtype=torch.int64)
    tKa, tVa, tla, tKb, tVb, tlb = _t(Ka, Va, la, Kb, Vb, lb)
    gk, gv, gl, live = sg.merge_round((tKa, tVa, tla, la > 0),
                                      (tKb, tVb, tlb, lb > 0), R, "torch",
                                      st, acc)
    _eq(wk, gk)
    _eq(wv, gv)
    _eq(wl, gl)
    assert list(live) == list((la > 0) | (lb > 0))
    worked, tails = int(acc[2, 0]), int(acc[1, 0])
    assert (worked, int(acc[0].sum()), 2 * worked, worked + tails) == (
        want_st.n_mszip, want_st.zip_elems, want_st.chunk_loads,
        want_st.chunk_stores)
    assert st.merge_rounds == 1
    if case == "random":
        assert want_st.n_mszip > sg.MERGE_FLAG_EVERY  # more than one batch


@pytest.mark.parametrize("La,Lb,R", [(8, 8, 8), (16, 16, 16), (160, 128, 8),
                                     (96, 64, 16), (40, 8, 8)])
def test_merge_round_issue_bound(monkeypatch, La, Lb, R):
    """merge_round launches at most ceil(La/R) + ceil(Lb/R) - 1 issues
    and at most MERGE_FLAG_EVERY - 1 idle ones past the last that did
    work; a first-level round (La = Lb = R) launches exactly one, and
    reads no flag (the bound is reached), nor do rounds whose issues all
    fit in one batch."""
    rng = np.random.default_rng(La + Lb + R)
    S = 11
    Ka, Va, la, Kb, Vb, lb = _pair(rng, S, La, Lb, "random")
    la[0], lb[0] = La, Lb  # at least one stream is live
    plain = kb.get_backend("torch")
    issues = []  # the flag word of each issue

    def counted(*args, **kw):
        issues.append(args[12].data_ptr())
        return plain.stream_merge_ptr(*args, **kw)

    monkeypatch.setitem(kb._BACKENDS, "torch", dataclasses.replace(
        plain, stream_merge_ptr=counted))
    reads = []
    real_int = torch.Tensor.__int__
    monkeypatch.setattr(torch.Tensor, "__int__", lambda t: (
        t.numel() == 1 and t.data_ptr() in issues and reads.append(1))
        or real_int(t))
    st = sg.SpzStats()
    acc = torch.zeros((3, S), dtype=torch.int64)
    tKa, tVa, tla, tKb, tVb, tlb = _t(Ka, Va, la, Kb, Vb, lb)
    sg.merge_round((tKa, tVa, tla, la > 0), (tKb, tVb, tlb, lb > 0), R,
                   "torch", st, acc)
    monkeypatch.undo()
    bound = -(-La // R) + -(-Lb // R) - 1
    worked = int(acc[2, 0])
    assert 1 <= worked <= len(issues) <= bound
    assert len(issues) - worked <= sg.MERGE_FLAG_EVERY - 1
    if La == Lb == R:
        assert len(issues) == 1
    if bound <= sg.MERGE_FLAG_EVERY:
        assert len(issues) == bound and not reads
    else:
        assert 1 <= len(reads) <= -(-len(issues) // sg.MERGE_FLAG_EVERY)


# ---------------------------------------------------------------------------
# the host-tier stream API: registry slots, cap_s padding, numpy helpers
# ---------------------------------------------------------------------------

def test_backends_carry_the_stream_slots():
    assert kb.get_backend("torch").stream_sort is stream_sort_plain
    assert kb.get_backend("torch").stream_merge is stream_merge_plain
    assert kb.get_backend("torch").stream_merge_ptr is stream_merge_ptr_plain
    assert kb.get_backend("cuda").stream_sort is stream_sort
    assert kb.get_backend("cuda").stream_merge is stream_merge
    assert kb.get_backend("cuda").stream_merge_ptr is stream_merge_ptr
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
