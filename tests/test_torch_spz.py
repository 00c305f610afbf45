"""The port's spz main path against the JAX reference, on the CPU.

``repro_torch.core.spgemm(A, B, engine="spz", device="cpu")`` must give
the CSR of the reference ``spgemm_spz(A, B, backend="xla",
driver="fused")`` bit for bit, with equal n_mssort / sort_elems /
n_mszip / zip_elems / chunk_loads / chunk_stores, and agree with the
port's own scl-array oracle at the reference's tolerance (1e-4).

The 13 Table III stand-ins each run the reference in a fresh process:
XLA's CPU compiler keeps every compiled bucket mapped for the life of a
process, and a few of these matrices in one process exhaust the
kernel's memory-map limit.  One case per matrix lets xdist spread them.
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
from repro_torch.core.formats import (InvalidOperand, csr_from_coo,
                                      csr_from_numpy, csr_to_numpy,
                                      random_sparse)
from repro_torch.data import table3
from repro_torch.kernels import backend as kb

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ("n_mssort", "sort_elems", "n_mszip", "zip_elems", "chunk_loads",
            "chunk_stores")


def _ref_csr(m):
    indptr, idx, data = (t.numpy() for t in (m.indptr, m.indices, m.data))
    return ref_formats.CSR(jnp.asarray(indptr), jnp.asarray(idx),
                           jnp.asarray(data), m.shape)


def _assert_identical(want_arrays, want_stats, out, stats):
    for w, p in zip(want_arrays, csr_to_numpy(out)):
        np.testing.assert_array_equal(w, p)
        if p.dtype.kind == "f":
            np.testing.assert_array_equal(w.view(np.int32), p.view(np.int32))
    assert [int(x) for x in want_stats] == \
        [getattr(stats, c) for c in COUNTERS]


def _assert_matches_reference(A, B, **kw):
    """Port (cpu) vs reference (xla, fused): bit-identical CSR + counters;
    vs the port's scl-array oracle at rtol=atol=1e-4."""
    out_r, st_r = ref_sg.spgemm_spz(_ref_csr(A), _ref_csr(B), backend="xla",
                                    driver="fused", **kw)
    engine = "spz-rsort" if kw.pop("rsort", False) else "spz"
    out, stats = spgemm(A, B, engine=engine, device="cpu", return_stats=True,
                        **kw)
    assert out.shape == out_r.shape and out.device.type == "cpu"
    _assert_identical(ref_formats.csr_to_numpy(out_r),
                      [getattr(st_r, c) for c in COUNTERS], out, stats)
    oracle = sg.spgemm_scl_array(A, B)
    np.testing.assert_allclose(out.to_dense().numpy(),
                               oracle.to_dense().numpy(), rtol=1e-4,
                               atol=1e-4)
    return out, stats


# ---------------------------------------------------------------------------
# the small cases of the reference's tests/test_spz_fused.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", ["uniform", "powerlaw", "banded"])
def test_spz_patterns(pattern):
    A = random_sparse(96, 96, 0.03, seed=11, pattern=pattern)
    _assert_matches_reference(A, A, R=16)


@pytest.mark.parametrize("R", [8, 16, 128])
def test_spz_chunk_widths(R):
    A = random_sparse(64, 64, 0.05, seed=5, pattern="powerlaw")
    _, stats = _assert_matches_reference(A, A, R=R)
    assert stats.n_mssort > 0


def test_spz_rectangular():
    A = random_sparse(40, 70, 0.06, seed=1)
    B = random_sparse(70, 50, 0.06, seed=2)
    _assert_matches_reference(A, B, R=16)


def test_spz_rsort_small_groups():
    A = random_sparse(128, 128, 0.04, seed=9, pattern="powerlaw")
    _assert_matches_reference(A, A, R=16, S=16, rsort=True)


def test_spz_zero_nnz_and_empty_rows():
    Z = csr_from_coo([], [], [], (8, 8))
    out, stats = spgemm(Z, Z, engine="spz", device="cpu", return_stats=True)
    assert int(out.indptr[-1]) == 0 and stats.n_mssort == 0
    A = csr_from_coo([1, 1, 5], [0, 3, 2], [1.0, 2.0, 3.0], (8, 8))
    _assert_matches_reference(A, A, R=8)


def test_spz_empty_inputs():
    E = csr_from_coo([], [], [], (0, 7))
    B = random_sparse(7, 5, 0.2, seed=0)
    out, stats = sg.spgemm_spz(E, B, device="cpu")
    assert out.shape == (0, 5) and int(out.indptr[-1]) == 0
    assert stats.n_mssort == 0 and stats.n_mszip == 0


def test_fused_expand_matches_reference():
    A = random_sparse(30, 30, 0.15, seed=3, pattern="powerlaw")
    mats = [t[None] for t in (A.indptr, A.indices, A.data)] * 2
    rows = np.array([0, 5, -1, 29, 7, 7, 12, -1], np.int32)
    lanes = np.zeros(8, np.int32)
    L = 64
    want = ref_sg._fused_expand(jnp.asarray(rows), jnp.asarray(lanes),
                                *[jnp.asarray(m.numpy()) for m in mats], L)
    got = sg._fused_expand(torch.from_numpy(rows), torch.from_numpy(lanes),
                           *mats, L)
    for w, p in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), p.numpy())


def test_work_stats_and_bucket_helpers():
    A = random_sparse(60, 60, 0.05, seed=8, pattern="powerlaw")
    Ar = _ref_csr(A)
    np.testing.assert_array_equal(ref_sg.row_work(Ar, Ar), sg.row_work(A, A))
    assert ref_sg.work_stats(Ar, Ar) == sg.work_stats(A, A)
    for n in (1, 15, 16, 17, 300):
        assert sg._pow2_chunks(n, 16) == ref_sg._pow2_chunks(n, 16)
        assert sg._group_cap(n, 64) == ref_sg._group_cap(n, 64)


# ---------------------------------------------------------------------------
# dispatch: explicit engines, devices, backends
# ---------------------------------------------------------------------------

def test_dispatch_engines_and_plans():
    A = random_sparse(48, 48, 0.04, seed=2)
    assert {"scl-array", "spz", "spz-fused", "spz-rsort"} <= \
        set(dp.available_engines())
    p = dp.plan(A, A, engine="spz", device="cpu", R=8)
    assert p.backend == "torch" and p.kwargs_dict["R"] == 8
    assert hash(p.jit_key) == hash(dp.plan(A, A, engine="spz", device="cpu",
                                           R=8).jit_key)
    out, stats = dp.execute(p, A, A, return_stats=True)
    fused = dp.spgemm(A, A, engine="spz-fused", device="cpu", R=8)
    oracle = dp.spgemm(A, A, engine="scl-array", device="cpu")
    for a, b in zip(csr_to_numpy(out), csr_to_numpy(fused)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out.to_dense().numpy(),
                               oracle.to_dense().numpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="plan/operand mismatch"):
        dp.execute(p, A, random_sparse(48, 40, 0.1, seed=0))
    with pytest.raises(ValueError, match="does not take a kernel backend"):
        dp.plan(A, A, engine="scl-array", backend="torch", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        dp.plan(A, A, engine="nope", device="cpu")


def test_unported_paths_raise():
    A = random_sparse(16, 16, 0.1, seed=0)
    with pytest.raises(NotImplementedError, match="dispatch slice"):
        spgemm(A, A)
    with pytest.raises(NotImplementedError, match="dispatch slice"):
        spgemm(A, A, engine="spz", device="cpu", autotune=True)
    # the host driver is ported: it runs, with the fused driver's output
    out, _ = sg.spgemm_spz(A, A, driver="host", device="cpu")
    fused, _ = sg.spgemm_spz(A, A, device="cpu")
    for h, f in zip(csr_to_numpy(out), csr_to_numpy(fused)):
        np.testing.assert_array_equal(h, f)
    with pytest.raises(ValueError, match="unknown spz driver"):
        sg.spgemm_spz(A, A, driver="nope", device="cpu")


def test_entry_points_default_to_the_card():
    A = random_sparse(16, 16, 0.1, seed=0)
    if torch.cuda.is_available():
        assert dp.plan(A, A, engine="spz").kwargs_dict["device"].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spgemm(A, A, engine="spz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sg.spgemm_spz(A, A)
    with pytest.raises(ValueError, match="runs on cuda"):
        spgemm(A, A, engine="spz", device="cpu", backend="cuda")


def test_plan_validates_operands():
    A = random_sparse(16, 16, 0.1, seed=0)
    bad = csr_from_numpy(A.indptr.numpy(), A.indices.numpy() + 100,
                         A.data.numpy(), A.shape)
    with pytest.raises(InvalidOperand, match="A.indices"):
        dp.plan(bad, A, engine="spz", device="cpu")
    with pytest.raises(ValueError, match="inner dims"):
        dp.plan(A, random_sparse(10, 4, 0.2, seed=0), engine="spz",
                device="cpu")


def test_stats_counters_come_back_once_per_call(monkeypatch):
    """The fused driver reads its merge counters from the device once per
    call, not once per bucket."""
    A = random_sparse(200, 200, 0.03, seed=4, pattern="powerlaw")
    reads = []
    real = torch.Tensor.tolist

    def counting(self):
        reads.append(tuple(self.shape))
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    _, stats = sg.spgemm_spz(A, A, R=8, S=64, device="cpu")
    assert reads == [(3,)] and stats.n_mszip > 0


# ---------------------------------------------------------------------------
# the 13 Table III stand-ins, each against the reference in its own process
# ---------------------------------------------------------------------------

# The child compiles the reference with XLA's optimization passes off:
# compiling its buckets is most of its time (about 30% less this way), and
# the comparison below is bit for bit, so a reference that computed other
# values this way would fail the test, not pass it.
_REFERENCE_CHILD = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro.core.formats import CSR, csr_to_numpy
from repro.core.spgemm import spgemm_spz
z = np.load(sys.argv[1])
A = CSR(jnp.asarray(z["indptr"]), jnp.asarray(z["indices"]),
        jnp.asarray(z["data"]), tuple(int(x) for x in z["shape"]))
out, st = spgemm_spz(A, A, backend="xla", driver="fused")
indptr, indices, data = csr_to_numpy(out)
np.savez(sys.argv[2], indptr=indptr, indices=indices, data=data,
         stats=np.array([st.n_mssort, st.sort_elems, st.n_mszip,
                         st.zip_elems, st.chunk_loads, st.chunk_stores]))
"""

# heaviest reference compiles first, so xdist starts them early
_BY_COST = ["soc", "wiki", "ca-cm", "bcsstk17", "ndwww", "p3d", "email",
            "p2p", "scircuit", "cage11", "usroads", "patents", "m133-b3"]


def test_table3_cases_cover_every_stand_in():
    assert sorted(_BY_COST) == sorted(table3.names())


@pytest.mark.parametrize("name", _BY_COST)
def test_spz_table3_matches_reference(name, tmp_path):
    A = table3.build(name)
    indptr, indices, data = csr_to_numpy(A)
    np.savez(tmp_path / "a.npz", indptr=indptr, indices=indices, data=data,
             shape=np.array(A.shape))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _REFERENCE_CHILD,
                    str(tmp_path / "a.npz"), str(tmp_path / "ref.npz")],
                   env=env, check=True, timeout=900)
    want = np.load(tmp_path / "ref.npz")
    out, stats = spgemm(A, A, engine="spz", device="cpu", return_stats=True)
    _assert_identical([want["indptr"], want["indices"], want["data"]],
                      want["stats"], out, stats)
    np.testing.assert_allclose(out.to_dense().numpy(),
                               sg.spgemm_scl_array(A, A).to_dense().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert kb.resolve_backend("auto", out.device).name == "torch"
