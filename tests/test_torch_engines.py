"""The port's spz host driver, scl-hash and esc against the JAX reference,
on the CPU.

``spgemm(A, B, engine="spz-host", device="cpu")`` must give the CSR of
the reference ``spgemm_spz(A, B, driver="host", backend="xla")`` bit for
bit with all six ``SpzStats`` counters equal, and the port's own fused
``spz`` result with n_mssort / sort_elems / n_mszip / zip_elems equal
(chunk_stores differs by design: the fused tree copies an odd partition
through an empty merge).  ``scl-hash`` and ``esc`` must equal the
reference's ``spgemm_scl_hash`` / ``spgemm_esc`` bit for bit.

The table3 cases run the reference in a fresh process each, as
``test_torch_spz.py`` does (XLA's CPU compiler keeps every compiled
shape mapped for the life of a process).
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as ref_formats
from repro.core import spgemm_engines as ref_sg
from repro_torch.core import dispatch as dp
from repro_torch.core import spgemm, spgemm_engines as sg
from repro_torch.core.formats import csr_from_coo, csr_to_numpy, random_sparse
from repro_torch.data import table3

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ("n_mssort", "sort_elems", "n_mszip", "zip_elems", "chunk_loads",
            "chunk_stores")
SHARED = COUNTERS[:4]


def _ref_csr(m):
    indptr, idx, data = (t.numpy() for t in (m.indptr, m.indices, m.data))
    return ref_formats.CSR(jnp.asarray(indptr), jnp.asarray(idx),
                           jnp.asarray(data), m.shape)


def _assert_csr_identical(want_arrays, out):
    for w, p in zip(want_arrays, csr_to_numpy(out)):
        np.testing.assert_array_equal(w, p)
        if p.dtype.kind == "f":
            np.testing.assert_array_equal(w.view(np.int32), p.view(np.int32))


def _host_vs_fused(A, B, out, stats, **kw):
    fused, st_f = spgemm(A, B, engine="spz-rsort" if kw.pop("rsort", False)
                         else "spz", device="cpu", return_stats=True, **kw)
    _assert_csr_identical(csr_to_numpy(fused), out)
    assert [getattr(stats, c) for c in SHARED] == \
        [getattr(st_f, c) for c in SHARED]


def _assert_host_matches_reference(A, B, **kw):
    """Port spz-host (cpu) vs reference host driver (xla): bit-identical
    CSR + six counters; vs the port's fused spz: CSR + four counters."""
    out_r, st_r = ref_sg.spgemm_spz(_ref_csr(A), _ref_csr(B), backend="xla",
                                    driver="host", **kw)
    out, stats = sg.spgemm_spz(A, B, driver="host", device="cpu", **kw)
    assert out.shape == out_r.shape and out.device.type == "cpu"
    _assert_csr_identical(ref_formats.csr_to_numpy(out_r), out)
    assert [getattr(st_r, c) for c in COUNTERS] == \
        [getattr(stats, c) for c in COUNTERS]
    assert stats.t_expand > 0 and stats.t_sort > 0 and stats.t_output > 0
    _host_vs_fused(A, B, out, stats, **kw)
    return out, stats


# ---------------------------------------------------------------------------
# spz-host: the small cases of the reference's tests/test_spz_fused.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["uniform", "powerlaw", "banded"])
def test_spz_host_patterns(pattern):
    A = random_sparse(96, 96, 0.03, seed=11, pattern=pattern)
    _assert_host_matches_reference(A, A, R=16)


@pytest.mark.parametrize("R", [8, 16, 128])
def test_spz_host_chunk_widths(R):
    A = random_sparse(64, 64, 0.05, seed=5, pattern="powerlaw")
    _, stats = _assert_host_matches_reference(A, A, R=R)
    assert stats.n_mssort > 0


def test_spz_host_rectangular():
    A = random_sparse(40, 70, 0.06, seed=1)
    B = random_sparse(70, 50, 0.06, seed=2)
    _assert_host_matches_reference(A, B, R=16)


def test_spz_host_rsort_small_groups():
    A = random_sparse(128, 128, 0.04, seed=9, pattern="powerlaw")
    _assert_host_matches_reference(A, A, R=16, S=16, rsort=True)


def test_spz_host_zero_nnz_and_empty_rows():
    Z = csr_from_coo([], [], [], (8, 8))
    out, stats = spgemm(Z, Z, engine="spz-host", device="cpu",
                        return_stats=True)
    assert int(out.indptr[-1]) == 0 and stats.n_mssort == 0
    A = csr_from_coo([1, 1, 5], [0, 3, 2], [1.0, 2.0, 3.0], (8, 8))
    _assert_host_matches_reference(A, A, R=8)
    E = csr_from_coo([], [], [], (0, 7))
    out, stats = sg.spgemm_spz(E, random_sparse(7, 5, 0.2, seed=0),
                               driver="host", device="cpu")
    assert out.shape == (0, 5) and stats.n_mszip == 0


def test_host_driver_pieces_match_reference():
    """expand_group is the reference's, array for array."""
    A = random_sparse(30, 30, 0.15, seed=3, pattern="powerlaw")
    a, b = csr_to_numpy(A), csr_to_numpy(A)
    rows = np.array([0, 5, 29, 7, 12])
    for (wk, wv), (gk, gv) in zip(ref_sg.expand_group(rows, *a, *b),
                                  sg.expand_group(rows, *a, *b)):
        np.testing.assert_array_equal(wk, gk)
        np.testing.assert_array_equal(wv, gv)


# ---------------------------------------------------------------------------
# spz-host == fused spz on all 13 stand-ins; against the reference on the
# three cheapest, each reference in its own process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", table3.names())
def test_spz_host_matches_fused_table3(name):
    A = table3.build(name)
    out, stats = spgemm(A, A, engine="spz-host", device="cpu",
                        return_stats=True)
    _host_vs_fused(A, A, out, stats)


_REFERENCE_CHILD = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.core.formats import CSR, csr_to_numpy
from repro.core.spgemm import spgemm_spz
z = np.load(sys.argv[1])
A = CSR(jnp.asarray(z["indptr"]), jnp.asarray(z["indices"]),
        jnp.asarray(z["data"]), tuple(int(x) for x in z["shape"]))
out, st = spgemm_spz(A, A, backend="xla", driver="host")
indptr, indices, data = csr_to_numpy(out)
np.savez(sys.argv[2], indptr=indptr, indices=indices, data=data,
         stats=np.array([st.n_mssort, st.sort_elems, st.n_mszip,
                         st.zip_elems, st.chunk_loads, st.chunk_stores]))
"""


@pytest.mark.parametrize("name", ["m133-b3", "usroads", "scircuit"])
def test_spz_host_table3_matches_reference(name, tmp_path):
    A = table3.build(name)
    indptr, indices, data = csr_to_numpy(A)
    np.savez(tmp_path / "a.npz", indptr=indptr, indices=indices, data=data,
             shape=np.array(A.shape))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REFERENCE_CHILD,
                    str(tmp_path / "a.npz"), str(tmp_path / "ref.npz")],
                   env=env, check=True, timeout=600)
    want = np.load(tmp_path / "ref.npz")
    out, stats = spgemm(A, A, engine="spz-host", device="cpu",
                        return_stats=True)
    _assert_csr_identical([want["indptr"], want["indices"], want["data"]],
                          out)
    assert [int(x) for x in want["stats"]] == \
        [getattr(stats, c) for c in COUNTERS]


# ---------------------------------------------------------------------------
# scl-hash and esc
# ---------------------------------------------------------------------------

_SMALL = [("uniform", 96, 0.03), ("powerlaw", 96, 0.03), ("banded", 96, 0.03),
          ("blocked", 80, 0.05)]


@pytest.mark.parametrize("pattern,n,density", _SMALL)
def test_scl_hash_and_esc_match_reference(pattern, n, density):
    A = random_sparse(n, n, density, seed=4, pattern=pattern)
    B = random_sparse(n, n // 2, density * 2, seed=6)
    for A_, B_ in ((A, A), (A, B)):
        Ar, Br = _ref_csr(A_), _ref_csr(B_)
        _assert_csr_identical(
            ref_formats.csr_to_numpy(ref_sg.spgemm_scl_hash(Ar, Br)),
            sg.spgemm_scl_hash(A_, B_, device="cpu"))
        _assert_csr_identical(
            ref_formats.csr_to_numpy(ref_sg.spgemm_esc(Ar, Br)),
            sg.spgemm_esc(A_, B_, device="cpu"))


def test_esc_core_matches_reference():
    """The core's padded outputs, array for array, with spare capacity."""
    A = random_sparse(50, 50, 0.08, seed=2, pattern="powerlaw")
    cap = int(sg.row_work(A, A).sum()) + 40
    want = ref_sg.esc_core_impl(*(jnp.asarray(t.numpy()) for t in (
        A.indptr, A.indices, A.data, A.indptr, A.indices, A.data)),
        cap, A.n_rows, A.n_cols)
    got = sg.esc_core_impl(A.indptr, A.indices, A.data, A.indptr, A.indices,
                           A.data, cap, A.n_rows, A.n_cols)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_esc_and_scl_hash_edge_cases():
    Z = csr_from_coo([], [], [], (6, 6))
    for engine in ("esc", "scl-hash"):
        out = spgemm(Z, Z, engine=engine, device="cpu")
        assert out.shape == (6, 6) and int(out.indptr[-1]) == 0
    # exact cancellation drops the entry, as in scl-array
    A = csr_from_coo([0, 0, 1, 2], [1, 2, 0, 0], [1.0, 1.0, 2.0, -2.0],
                     (3, 3))
    oracle = csr_to_numpy(sg.spgemm_scl_array(A, A))
    for engine in ("esc", "scl-hash", "spz-host"):
        _assert_csr_identical(oracle, spgemm(A, A, engine=engine,
                                             device="cpu"))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_dispatch_registers_the_engines():
    A = random_sparse(48, 48, 0.05, seed=2)
    engines = dp.available_engines()
    assert {"scl-hash", "esc", "spz-host"} <= set(engines)
    assert engines["spz-host"].returns_stats
    assert engines["spz-host"].backend_aware
    assert not engines["esc"].backend_aware
    p = dp.plan(A, A, engine="spz-host", device="cpu", R=8)
    assert p.backend == "torch"
    out, stats = dp.execute(p, A, A, return_stats=True)
    assert stats.n_mssort > 0
    oracle = sg.spgemm_scl_array(A, A).to_dense().numpy()
    for engine in ("scl-hash", "esc", "spz-host"):
        got = dp.spgemm(A, A, engine=engine, device="cpu")
        np.testing.assert_allclose(got.to_dense().numpy(), oracle,
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="does not take a kernel backend"):
        dp.plan(A, A, engine="esc", backend="torch", device="cpu")


def test_new_engines_default_to_the_card():
    A = random_sparse(16, 16, 0.1, seed=0)
    if torch.cuda.is_available():
        for engine in ("scl-hash", "esc", "spz-host"):
            assert dp.plan(A, A, engine=engine).kwargs_dict["device"].type \
                == "cuda"
        return
    for engine in ("scl-hash", "esc", "spz-host"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spgemm(A, A, engine=engine)
    for fn in (sg.spgemm_scl_hash, sg.spgemm_esc):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(A, A)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sg.spgemm_spz(A, A, driver="host")
