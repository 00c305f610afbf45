"""The port's batched SpGEMM against the JAX reference, on the CPU.

``BatchedCSR``/``batch_csr``/``unbatch_csr`` keep the reference's layout,
caps and errors.  ``spgemm_batched(..., device="cpu")`` with ``esc``,
``spz``, ``spz-rsort`` and ``spz-host`` must give, lane by lane, the CSR
of the reference's ``spgemm_batched(..., backend="xla")`` bit for bit
(-0.0 included), on a batch of 1,024 x 1,024 stand-ins plus a padding
lane, and on a batch one of whose lanes takes the fused driver's large
route (a bucket wider than L = 8,192).  The reference runs in a fresh
process, as in ``tests/test_torch_spz.py``: XLA's CPU compiler keeps
every compiled shape mapped for the life of a process.  One process
computes the stand-in batch for all four engines, once per test session
(shared by the xdist workers through a lock), and one more the
large-route batch.
"""
import fcntl
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as ref_dp
from repro.core import formats as ref_formats
from repro_torch.core import dispatch as dp
from repro_torch.core.formats import (BatchedCSR, batch_csr, csr_from_coo,
                                      csr_to_numpy, random_sparse,
                                      unbatch_csr)
from repro_torch.data import table3

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAND_INS = ["p2p", "scircuit", "cage11"]


def _ref_csr(m):
    indptr, idx, data = (t.numpy() for t in (m.indptr, m.indices, m.data))
    return ref_formats.CSR(jnp.asarray(indptr), jnp.asarray(idx),
                           jnp.asarray(data), m.shape)


def _assert_bits(want, got):
    for w, g in zip(want, got):
        assert w.shape == g.shape and np.array_equal(w, g)
        if g.dtype.kind == "f":
            assert np.array_equal(w.view(np.int32), g.view(np.int32))


def _ragged_batch(seed=0, n=48):
    """Same shape, very different nnz per lane — the serving request mix."""
    densities = (0.004, 0.05, 0.015, 0.03)
    return [random_sparse(n, n, d, seed=seed + i)
            for i, d in enumerate(densities)]


def _large_route_lanes():
    """(A lanes, B lanes) of a 512 x 512 batch with one bucket on the large
    route: lane 0's A has a hub row of 512 nnz over ~2 nnz a row, its B
    ~20 nnz a row, so row 0 of A·B holds ~10K products (a bucket of L =
    16,384, the large route, at any R) and every other row a few dozen;
    lane 1 is plain.  A times B, not A·A, keeps the other buckets narrow:
    the reference's compile of the wide one is most of the case's time."""
    n = 512
    base = random_sparse(n, n, 2.0 / n, seed=31)
    indptr, cols, vals = csr_to_numpy(base)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    keep = rows != 0
    rng = np.random.default_rng(32)
    hub = csr_from_coo(
        np.concatenate([np.zeros(n, np.int64), rows[keep]]),
        np.concatenate([np.arange(n), cols[keep]]),
        np.concatenate([rng.standard_normal(n).astype(np.float32),
                        vals[keep]]), (n, n))
    return ([hub, random_sparse(n, n, 2.0 / n, seed=34)],
            [random_sparse(n, n, 0.04, seed=s) for s in (33, 35)])


# ---------------------------------------------------------------------------
# BatchedCSR
# ---------------------------------------------------------------------------

def test_batch_csr_matches_reference_layout():
    mats = _ragged_batch(n=20)
    for kw in ({}, {"nnz_cap": 4096, "batch_cap": 8}):
        b = batch_csr(mats, **kw)
        r = ref_formats.batch_csr([_ref_csr(m) for m in mats], **kw)
        for f in ("indptr", "indices", "data", "valid"):
            got, want = getattr(b, f).numpy(), np.asarray(getattr(r, f))
            assert got.dtype == want.dtype and np.array_equal(got, want), f
        assert (b.shape, b.batch, b.nnz_cap, b.n_valid, len(b)) == \
            (r.shape, r.batch, r.nnz_cap, r.n_valid, len(r))


def test_batch_csr_roundtrip_and_caps():
    mats = _ragged_batch(n=20)
    b = batch_csr(mats, nnz_cap=4096, batch_cap=8)
    assert b.nnz_cap == 4096 and b.batch == 8 and b.n_valid == len(mats)
    assert b.valid.tolist() == [True] * 4 + [False] * 4
    for i, m in enumerate(mats):
        _assert_bits(csr_to_numpy(m), csr_to_numpy(b[i]))
    assert [i for i, _ in b.lanes()] == [0, 1, 2, 3]
    for m, u in zip(mats, unbatch_csr(b)):
        _assert_bits(csr_to_numpy(m), csr_to_numpy(u))
    assert int(b[5].indptr[-1]) == 0
    with pytest.raises(ValueError, match="nnz_cap"):
        batch_csr(mats, nnz_cap=1)
    with pytest.raises(ValueError, match="batch_cap"):
        batch_csr(mats, batch_cap=1)
    with pytest.raises(ValueError, match="shape mismatch"):
        batch_csr([mats[0], random_sparse(20, 21, 0.1, seed=0)])
    with pytest.raises(ValueError, match="at least one"):
        batch_csr([])
    assert b.to("cpu") is b and isinstance(b, BatchedCSR)


# ---------------------------------------------------------------------------
# batched plans and drivers, in process
# ---------------------------------------------------------------------------

@pytest.fixture
def cache(tmp_path):
    return dp.AutotuneCache(str(tmp_path / "autotune.json"))


@pytest.mark.parametrize("engine", ["esc", "spz", "spz-fused", "spz-rsort",
                                    "spz-host"])
def test_batched_equals_single_calls(engine, cache):
    """Every valid lane is the single-matrix call with the same engine,
    bit for bit; padding lanes come back invalid and empty."""
    mats = _ragged_batch()
    A = batch_csr(mats, batch_cap=len(mats) + 2)
    kw = {"R": 8, "S": 32} if engine.startswith("spz") else {}
    out = dp.spgemm_batched(A, A, engine=engine, device="cpu", cache=cache,
                            **kw)
    assert isinstance(out, BatchedCSR)
    assert out.valid.tolist() == [True] * len(mats) + [False] * 2
    for i, m in enumerate(mats):
        single = dp.spgemm(m, m, engine=engine, device="cpu", **kw)
        _assert_bits(csr_to_numpy(single), csr_to_numpy(out[i]))
    assert int(out[4].indptr[-1]) == int(out[5].indptr[-1]) == 0


def test_batched_auto_maps_scalar_engines_to_esc(cache, tmp_path):
    """A batch whose heaviest lane is tiny work picks scl-hash, and the
    batched plan maps it onto esc, as the reference's does."""
    mats = [random_sparse(24, 24, 0.002, seed=s) for s in (3, 4)]
    b = batch_csr(mats, batch_cap=3)
    p = dp.plan_batched(b, b, device="cpu", cache=cache)
    rb = ref_formats.batch_csr([_ref_csr(m) for m in mats], batch_cap=3)
    r = ref_dp.plan_batched(rb, rb, cache=ref_dp.AutotuneCache(
        str(tmp_path / "ref.json")))
    assert (p.engine, p.rule, p.source, p.cache_key) == \
        (r.engine, r.rule, r.source, r.cache_key) == \
        ("esc", "tiny-work", "heuristic", p.cache_key)
    assert p.kwargs_dict["cap_products"] == r.kwargs_dict["cap_products"]
    assert cache.get(p.cache_key) == {"engine": "scl-hash",
                                      "source": "heuristic"}
    out = dp.execute_batched(p, b, b)
    for i, m in enumerate(mats):
        _assert_bits(csr_to_numpy(dp.spgemm(m, m, engine="esc",
                                            device="cpu")),
                     csr_to_numpy(out[i]))
    # an explicit scalar engine maps the same way
    assert dp.plan_batched(b, b, "scl-hash", device="cpu").engine == "esc"


def test_batched_plan_resolves_static_capacity(cache):
    mats = _ragged_batch()
    A = batch_csr(mats)
    p = dp.plan_batched(A, A, "esc", device="cpu", cache=cache)
    cap = p.kwargs_dict["cap_products"]
    assert cap & (cap - 1) == 0
    rb = ref_formats.batch_csr([_ref_csr(m) for m in mats])
    assert cap == ref_dp.plan_batched(rb, rb, "esc").kwargs_dict[
        "cap_products"]
    assert p.jit_key == dp.plan_batched(A, A, "esc", device="cpu",
                                        cache=cache).jit_key
    assert p.jit_key[2:4] == (True, 4)
    hinted = dp.plan_batched(A, A, "esc", device="cpu",
                             lane_work_hint=[1, 2, 3, 40])
    assert hinted.kwargs_dict["cap_products"] == 64


def test_batched_plan_resolves_backend(cache):
    mats = _ragged_batch()
    A = batch_csr(mats)
    p = dp.plan_batched(A, A, "spz-fused", backend="torch", device="cpu",
                        R=8, S=32, cache=cache)
    assert p.backend == "torch" and p.kwargs_dict["backend"] == "torch"
    assert p.kwargs_dict["device"] == torch.device("cpu")
    with pytest.raises(ValueError, match="does not take a kernel backend"):
        dp.plan_batched(A, A, "esc", backend="torch", device="cpu")
    with pytest.raises(ValueError, match="runs on cuda"):
        dp.plan_batched(A, A, "spz", backend="cuda", device="cpu")


def test_batched_validates_shapes_and_plan_kinds(cache):
    A = batch_csr(_ragged_batch(n=16))
    B = batch_csr(_ragged_batch(n=32))
    with pytest.raises(ValueError, match="batch mismatch"):
        dp.spgemm_batched(A, B, device="cpu")
    empty = BatchedCSR(A.indptr, A.indices, A.data,
                       torch.zeros_like(A.valid), A.shape)
    with pytest.raises(ValueError, match="no valid lanes"):
        dp.plan_batched(empty, empty, device="cpu")
    m = random_sparse(16, 16, 0.05, seed=0)
    single = dp.plan(m, m, "esc", device="cpu")
    batched = dp.plan_batched(A, A, "esc", device="cpu", cache=cache)
    with pytest.raises(ValueError, match="batched"):
        dp.execute_batched(single, A, A)
    with pytest.raises(ValueError, match="batched"):
        dp.execute(batched, m, m)
    with pytest.raises(ValueError, match="no batched driver"):
        dp.get_batch_driver("scl-array")
    with pytest.raises(ValueError, match="plan/operand mismatch"):
        dp.execute_batched(batched, batch_csr(_ragged_batch(n=16)[:2]),
                           batch_csr(_ragged_batch(n=16)[:2]))


def test_batched_entry_points_default_to_the_card():
    A = batch_csr(_ragged_batch(n=16))
    if torch.cuda.is_available():
        assert dp.plan_batched(A, A, "esc").kwargs_dict["device"].type \
            == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.spgemm_batched(A, A, engine="spz")


# ---------------------------------------------------------------------------
# against the reference, in a fresh process per batch
# ---------------------------------------------------------------------------

# argv: inputs, outputs, cache path, R, then (engine, ...): every engine's
# lanes go into the one output file under "<engine>:" keys
_REFERENCE_CHILD = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro.core import dispatch as dp
from repro.core.formats import CSR, batch_csr, csr_to_numpy
z = np.load(sys.argv[1])
n, shape = int(z["n"]), tuple(int(x) for x in z["shape"])
a, b = ([CSR(jnp.asarray(z[f"{s}indptr{i}"]), jnp.asarray(z[f"{s}indices{i}"]),
             jnp.asarray(z[f"{s}data{i}"]), shape) for i in range(n)]
        for s in "ab")
a, b = batch_csr(a, batch_cap=n + 1), batch_csr(b, batch_cap=n + 1)
cache, R = dp.AutotuneCache(sys.argv[3]), int(sys.argv[4])
res = {}
for engine in sys.argv[5:]:
    kw = {} if engine == "esc" else {"backend": "xla", "R": R}
    out = dp.spgemm_batched(a, b, engine=engine, cache=cache, **kw)
    res[f"{engine}:valid"] = np.asarray(out.valid)
    for i in range(n + 1):
        for f, x in zip(("indptr", "indices", "data"), csr_to_numpy(out[i])):
            res[f"{engine}:{f}{i}"] = x
np.savez(sys.argv[2], **res)
"""

STAND_IN_ENGINES = ("spz-host", "esc", "spz-rsort", "spz")
# the large-route batch runs at R = 64: the reference compiles its
# L = 16,384 bucket (8 merge rounds) in well under half the time it takes
# at R = 16 (10 rounds); the port's route is the same (fused_config
# gives None)
_CASES = [("spz", "stand-ins", 16), ("spz-rsort", "stand-ins", 16),
          ("spz-host", "stand-ins", 16), ("esc", "stand-ins", None),
          ("spz", "large-route", 64)]


def _run_reference(lhs, rhs, R, engines, out_dir):
    """The reference's ``spgemm_batched`` of ``lhs`` x ``rhs`` (+ one
    padding lane) for each of ``engines``, in one fresh process; returns
    the path of its output file."""
    arrays = {"n": len(lhs), "shape": np.array(lhs[0].shape)}
    for side, mats in (("a", lhs), ("b", rhs)):
        for i, m in enumerate(mats):
            for f, x in zip(("indptr", "indices", "data"), csr_to_numpy(m)):
                arrays[f"{side}{f}{i}"] = x
    np.savez(out_dir / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = out_dir / "ref.npz"
    subprocess.run([sys.executable, "-c", _REFERENCE_CHILD,
                    str(out_dir / "in.npz"), str(out),
                    str(out_dir / "ref_cache.json"), str(R), *engines],
                   env=env, check=True, timeout=600)
    return out


@pytest.fixture(scope="session")
def stand_in_reference(tmp_path_factory):
    """The reference's stand-in batch for every engine of
    ``STAND_IN_ENGINES``, computed once for the session: the xdist
    workers share the session's temporary root, and the first to take
    the lock runs the one process."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out_dir = root / "batched-stand-in-reference"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = out_dir / "done.npz"
        if not done.exists():
            mats = [table3.build(n) for n in STAND_INS]
            os.replace(_run_reference(mats, mats, 16, STAND_IN_ENGINES,
                                      out_dir), done)
    return np.load(done)


@pytest.mark.parametrize("engine,batch,R", _CASES)
def test_batched_matches_reference(engine, batch, R, tmp_path, request):
    if batch == "stand-ins":
        lhs = rhs = [table3.build(n) for n in STAND_INS]
        want = request.getfixturevalue("stand_in_reference")
    else:
        lhs, rhs = _large_route_lanes()
        want = np.load(_run_reference(lhs, rhs, R, [engine], tmp_path))
    want = {k.split(":", 1)[1]: v for k, v in want.items()
            if k.startswith(f"{engine}:")}
    a = batch_csr(lhs, batch_cap=len(lhs) + 1)
    b = batch_csr(rhs, batch_cap=len(rhs) + 1)
    assert int(a[len(lhs)].indptr[-1]) == 0  # the padding lane
    kw = {"R": R} if R else {}
    out = dp.spgemm_batched(a, b, engine=engine, device="cpu",
                            cache=dp.AutotuneCache(str(tmp_path / "c.json")),
                            **kw)
    assert out.valid.tolist() == want["valid"].tolist() == \
        [True] * len(lhs) + [False]
    for i in range(len(lhs) + 1):
        _assert_bits([want[f"{f}{i}"] for f in ("indptr", "indices",
                                                  "data")],
                     csr_to_numpy(out[i]))
    if batch == "large-route":
        from repro_torch.core import spgemm_engines as sg
        from repro_torch.kernels.fused_bucket import fused_config
        L = sg._pow2_chunks(int(sg.row_work(lhs[0], rhs[0]).max()), R) * R
        assert L == 16384 and fused_config(L, R) is None
