#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main path on one card:

  device   the card's name and power limit, the torch version, the build
  kernel   each kernel (K1 chunk sort, K2 partition merge — also on one
           row of 2^20 slots, past a block's shared memory — K3 fused
           bucket on both routes, K4 stream sort, K5 stream merge) at the
           main paths' shapes, held bit for bit against its plain torch
           version on the same card inputs, with its time, the plain
           version's time and its bound
  spgemm   the fused path: ``spgemm(A, A, engine="spz")`` on the 13 Table
           III stand-ins, the three SuiteSparse-scale ones and
           dense-row-full, with every launch counter set to 0 before and
           read after; then each result held bit-identical (CSR and
           SpzStats) against the same call with ``backend="torch"`` on the
           card and structure-identical against the scl-array oracle
  host     the host-driver path: ``engine="spz-host"`` on the same 16
           matrices, counters set to 0 before and read after; every call
           launches K4 exactly n_mssort and K5 exactly n_mszip times; held
           against ``backend="torch"`` on the card (stand-ins: CSR and six
           counters) and against the fused result (CSR and four counters)
  engines  ``esc`` on the 16 matrices (bit for bit against the port's CPU
           esc on the stand-ins, against scl-array everywhere) and
           ``scl-hash`` on the stand-ins against scl-array
  kernels  every ported kernel and its launches on its path's run
  profile  host wall clock vs device kernel time of one spz call on the
           two SuiteSparse-scale fused-route matrices and of one spz-host
           call on cage11-full, with its waits for the card per issue
           (torch.profiler)

It imports nothing of JAX.  The line before the last is the JSON kernel
table; the last line is ``{"ok": true, "device": {...}}``, printed only
when every phase passed.  Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.

Run: ``python3 chip_smoke.py`` (one card).
"""
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SEED = 0


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=10, warmup=2):
    """Median of ``reps`` runs after ``warmup``, each between two CUDA
    events, with the device synchronised around the whole."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    return statistics.median(times)


def bound_ms(nbytes: int, fp32_ops: int):
    """Least time for the work: bytes over the memory rate vs float32
    operations over the float32 rate; returns (ms, which bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(torch, got, want) -> float:
    """Largest |kernel - plain| over matching outputs; raises unless every
    output is equal bit for bit."""
    err = 0.0
    for g, w in zip(got, want):
        if isinstance(g, (tuple, list)):
            err = max(err, max_abs_err(torch, g, w))
            continue
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if g.is_floating_point():
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError("kernel output differs from its plain "
                                 f"version (max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch, build):
    t0 = time.perf_counter()
    build.LIBS.get("fused_bucket")  # builds all kernels, in parallel
    secs = time.perf_counter() - t0
    name = smi()
    log(f"device: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()} | kernels built in {secs:.1f} s "
        f"({build.LIBS.build_dir})")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    return name


def _sorted_partitions(np, rng, N, L, key_hi, max_len=None):
    hi = min(L, max_len or L)
    lens = rng.integers(hi // 2, hi + 1, N).astype(np.int32)
    keys = np.full((N, L), 2**31 - 1, np.int32)
    vals = np.zeros((N, L), np.float32)
    for s in range(N):
        keys[s, :lens[s]] = np.sort(rng.choice(key_hi, lens[s], replace=False))
        vals[s, :lens[s]] = rng.standard_normal(lens[s])
    return keys, vals, lens


def _bucket(np, rng, S, L, key_hi):
    plens = rng.integers(L // 2, L + 1, S).astype(np.int32)
    mask = np.arange(L)[None, :] < plens[:, None]
    keys = np.where(mask, rng.integers(0, key_hi, (S, L)), 2**31 - 1)
    vals = np.where(mask, rng.standard_normal((S, L)), 0.0)
    return keys.astype(np.int32), vals.astype(np.float32), plens


def phase_kernel(torch, np):
    """Each kernel vs its plain version on card inputs of the main path's
    shapes (cage11-full: 512-stream groups, R = 16, keys < 39,082)."""
    from repro_torch.kernels import chunk_sort as k1
    from repro_torch.kernels import fused_bucket as k3
    from repro_torch.kernels import merge_partitions as k2
    from repro_torch.kernels import stream_merge as k5
    from repro_torch.kernels import stream_sort as k4

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    R, cols = 16, 39082
    rows = {}

    def cuda(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    # K1: one group's bucket of L = 256 (C = 16): N = 512 * 16 chunks
    keys, vals, plens = cuda(*_bucket(np, rng, 512, 256, cols))
    ck, cv = keys.view(-1, R), vals.view(-1, R)
    cl = k1.chunk_lens(plens, 16, R)
    got = k1.chunk_sort(ck, cv, cl)
    want = k1.chunk_sort_plain(ck, cv, cl)
    err = max_abs_err(torch, got, want)
    adds = int(cl.sum()) - int(got[2].sum())
    b, by = bound_ms(nbytes(ck, cv, cl, *got), adds)
    outs = [torch.empty_like(t) for t in got]
    rows["chunk_sort"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k1.launch(ck, cv, cl, *outs)),
        wrapper_ms=time_ms(torch, lambda: k1.chunk_sort(ck, cv, cl)),
        plain_ms=time_ms(torch, lambda: k1.chunk_sort_plain(ck, cv, cl),
                         reps=10, warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.sort(ck, dim=-1, stable=True)),
        shape=f"N={ck.shape[0]} R={R}")

    # K2: N = 512 streams, La = Lb = 256
    args = cuda(*_sorted_partitions(np, rng, 512, 256, cols),
                *_sorted_partitions(np, rng, 512, 256, cols))
    got = k2.merge_partitions(*args, R=R, pair_streams=512)
    want = k2.merge_partitions_plain(*args, R=R, pair_streams=512)
    err = max_abs_err(torch, got[:3], want[:3])
    if [int(x) for x in got[3]] != [int(x) for x in want[3]]:
        raise AssertionError(f"K2 counters {got[3]} != {want[3]}")
    adds = int(args[2].sum() + args[5].sum() - got[2].sum())
    b, by = bound_ms(nbytes(*args, *got[:3]) + 16 * 512, adds)
    outs = [torch.empty_like(t) for t in got[:3]]
    cnt = torch.zeros((4, 512), dtype=torch.int32, device=dev)
    rows["merge_partitions"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k2.launch(*args, R, True, *outs, cnt)),
        wrapper_ms=time_ms(torch, lambda: k2.merge_partitions(
            *args, R=R, pair_streams=512)),
        plain_ms=time_ms(torch, lambda: k2.merge_partitions_plain(
            *args, R=R, pair_streams=512), reps=10, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None,
        shape="N=512 La=Lb=256")

    # K3: S = 512, L = 1024 (fused route) and S = 4, L = 32768 (large route)
    for S, L, route in ((512, 1024, "fused"), (4, 32768, "large")):
        keys, vals, plens = cuda(*_bucket(np, rng, S, L, cols))
        before = dict(k3.fused_bucket.routes)
        got = k3.fused_bucket(keys, vals, plens, R=R, detailed=True)
        if k3.fused_bucket.routes[route] != before[route] + 1:
            raise AssertionError(f"bucket ({S}, {L}) did not take the "
                                 f"{route} route")
        want = k3.fused_bucket_plain(keys, vals, plens, R=R, detailed=True)
        err = max_abs_err(torch, got[:3], want[:3])
        for (gs, gz, gt), (ws, wz, wt) in zip(got[3], want[3]):
            if not (torch.equal(gs, ws) and int(gz) == int(wz)
                    and torch.equal(gt, wt)):
                raise AssertionError(f"K3 {route} round counters differ")
        C = L // R
        adds = int(plens.sum()) - int(got[2].sum())
        b, by = bound_ms(nbytes(keys, vals, plens, *got[:3])
                         + 16 * S * max(C - 1, 1), adds)
        wrapper = time_ms(torch, lambda: k3.fused_bucket(
            keys, vals, plens, R=R, detailed=True))
        if route == "fused":  # the kernel alone; the large route is K1 + K2s
            outs = [torch.empty_like(t) for t in got[:3]]
            planes = torch.zeros((4, S, max(C - 1, 1)), dtype=torch.int32,
                                 device=dev)
            ms = time_ms(torch, lambda: k3.launch(keys, vals, plens, R, *outs,
                                                  planes))
        else:
            ms = wrapper
        rows[f"fused_bucket.{route}"] = dict(
            max_abs_err=err, ms=ms, wrapper_ms=wrapper,
            plain_ms=time_ms(torch, lambda: k3.fused_bucket_plain(
                keys, vals, plens, R=R, detailed=True), reps=10, warmup=1),
            bound_ms=b, bound_by=by, library_ms=None,
            shape=f"S={S} L={L} R={R}")
    # K2 on one row of La + Lb = 2^20 slots: its bits and prefixes live
    # in device memory.  Lengths as dense-row-full's row 0 has (<= 39,082
    # uniques a side), so the plain advance loop stays short.
    L = 2**19
    args = cuda(*_sorted_partitions(np, rng, 1, L, 3 * L, max_len=39082),
                *_sorted_partitions(np, rng, 1, L, 3 * L, max_len=39082))
    got = k2.merge_partitions(*args, R=R)
    want = k2.merge_partitions_plain(*args, R=R)
    err = max_abs_err(torch, got[:3], want[:3])
    if [int(x) for x in got[3]] != [int(x) for x in want[3]]:
        raise AssertionError(f"K2 long-row counters {got[3]} != {want[3]}")
    adds = int(args[2].sum() + args[5].sum() - got[2].sum())
    b, by = bound_ms(nbytes(*args, *got[:3]) + 16, adds)
    outs = [torch.empty_like(t) for t in got[:3]]
    cnt = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    rows["merge_partitions.long"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k2.launch(*args, R, True, *outs, cnt),
                   reps=5, warmup=1),
        wrapper_ms=time_ms(torch, lambda: k2.merge_partitions(*args, R=R),
                           reps=5, warmup=1),
        plain_ms=time_ms(torch, lambda: k2.merge_partitions_plain(
            *args, R=R), reps=2, warmup=0),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"N=1 La=Lb={L}")

    # K4: one host-driver front, S = 512 streams of R = 16 products
    keys, vals, plens = cuda(*_bucket(np, rng, 512, R, cols))
    got = k4.stream_sort(keys, vals, plens)
    want = k4.stream_sort_plain(keys, vals, plens)
    err = max_abs_err(torch, got, want)
    b, by = bound_ms(nbytes(keys, vals, plens, *got), int(plens.sum()))
    outs = [torch.empty_like(t) for t in got]
    rows["stream_sort"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k4.launch(keys, vals, plens, *outs),
                   reps=50, warmup=5),
        wrapper_ms=time_ms(torch, lambda: k4.stream_sort(keys, vals, plens),
                           reps=50, warmup=5),
        plain_ms=time_ms(torch, lambda: k4.stream_sort_plain(
            keys, vals, plens), reps=10, warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.sort(keys, dim=-1,
                                                     stable=True),
                           reps=50, warmup=5),
        shape=f"S=512 R={R}")

    # K5: two sorted, duplicate-free fronts of S = 512, R = 16
    args = cuda(*_sorted_partitions(np, rng, 512, R, 4 * R),
                *_sorted_partitions(np, rng, 512, R, 4 * R))
    got = k5.stream_merge(*args)
    want = k5.stream_merge_plain(*args)
    err = max_abs_err(torch, got, want)
    b, by = bound_ms(nbytes(*args, *got), int(got[4].sum() + got[5].sum()))
    outs = [torch.empty_like(t) for t in got]
    rows["stream_merge"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k5.launch(*args, *outs), reps=50, warmup=5),
        wrapper_ms=time_ms(torch, lambda: k5.stream_merge(*args), reps=50,
                           warmup=5),
        plain_ms=time_ms(torch, lambda: k5.stream_merge_plain(*args),
                         reps=10, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"S=512 R={R}")
    for name, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel: {name} {r['shape']} bit-exact (max_abs_err "
            f"{r['max_abs_err']}) kernel_ms {r['ms']:.4f} wrapper_ms "
            f"{r['wrapper_ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.5f} ({r['bound_by']}) library_ms {lib}")
    return rows


FIELDS = ("n_mssort", "sort_elems", "n_mszip", "zip_elems", "chunk_loads",
          "chunk_stores")


def _csr_equal(np, a, b) -> bool:
    """Two (indptr, indices, data) triples equal bit for bit."""
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and np.array_equal(a[2].view(np.int32), b[2].view(np.int32)))


def _check_oracle(np, name, got, oracle):
    """Structure identical to scl-array, values within 1e-4."""
    if not (np.array_equal(got[0], oracle[0])
            and np.array_equal(got[1], oracle[1])):
        raise AssertionError(f"{name}: structure differs from scl-array")
    if not np.allclose(got[2], oracle[2], rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: values differ from scl-array")


def _launched(counts, kernels, path):
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"never launched on the {path} path: {missing}")


def phase_spgemm(torch, np, mats, oracles):
    """The fused path on the card, counters zeroed before and read after;
    then every result held against the torch backend and scl-array.
    Returns the path's launch counts and each matrix's (CSR, stats)."""
    from repro_torch.core import spgemm
    from repro_torch.core.formats import csr_to_numpy
    from repro_torch.data import table3
    from repro_torch.kernels import backend as kb

    results = {}
    kb.reset_launch_counts()
    for n, A in mats.items():
        before = kb.launch_counts()
        out, st = spgemm(A, A, engine="spz", return_stats=True)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            spgemm(A, A, engine="spz")
            times.append((time.perf_counter() - t0) * 1e3)
        after = kb.launch_counts()
        delta = {k: (after[k] - before[k]) // 4 for k in after
                 if after[k] != before[k]}
        results[n] = (csr_to_numpy(out), [getattr(st, f) for f in FIELDS])
        log(f"spgemm: {n} {A.shape[0]}x{A.shape[1]} nnz "
            f"{int(A.indptr[-1])} -> {results[n][0][1].size} | ms/call "
            f"{statistics.median(times):.2f} | per call: {delta} | "
            + " ".join(f"{f}={v}" for f, v in zip(FIELDS, results[n][1])))
    counts = kb.launch_counts()
    _launched(counts, ("chunk_sort", "merge_partitions", "fused_bucket"),
              "spz")
    for n, A in mats.items():
        csr, stats = results[n]
        _check_oracle(np, n, csr, oracles[n])
        if n == table3.LONG_ROW:  # held against scl-array only
            log(f"spgemm: {n} structure-identical to scl-array, values "
                f"within 1e-4 (row 0: {int(csr[0][1])} columns)")
            continue
        ref, st = spgemm(A, A, engine="spz", backend="torch",
                         return_stats=True)
        if not _csr_equal(np, csr, csr_to_numpy(ref)):
            raise AssertionError(f"{n}: cuda and torch backends differ")
        if stats != [getattr(st, f) for f in FIELDS]:
            raise AssertionError(f"{n}: SpzStats differ: {stats} vs "
                                 f"{[getattr(st, f) for f in FIELDS]}")
        log(f"spgemm: {n} bit-identical to backend='torch' (CSR + SpzStats),"
            f" structure-identical to scl-array, values within 1e-4")
    return counts, results


def phase_host(torch, np, mats, fused):
    """The host-driver path on the card: every spz-host call launches K4
    n_mssort and K5 n_mszip times; results held against the torch
    backend on the card (stand-ins) and the fused path (all)."""
    from repro_torch.core import spgemm
    from repro_torch.core.formats import csr_to_numpy
    from repro_torch.data import table3
    from repro_torch.kernels import backend as kb

    def call(n, A):
        """One spz-host call: K4 launched n_mssort and K5 n_mszip times,
        and nothing else."""
        before = kb.launch_counts()
        t0 = time.perf_counter()
        out, st = spgemm(A, A, engine="spz-host", return_stats=True)
        ms = (time.perf_counter() - t0) * 1e3
        after = kb.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        k4, k5 = delta.pop("stream_sort"), delta.pop("stream_merge")
        if (k4, k5) != (st.n_mssort, st.n_mszip):
            raise AssertionError(f"{n}: K4/K5 launches {k4}/{k5} != n_mssort"
                                 f"/n_mszip {st.n_mssort}/{st.n_mszip}")
        if any(delta.values()):
            raise AssertionError(f"{n}: spz-host launched {delta}")
        return out, st, ms, k4, k5

    stand_ins = table3.names()
    results = {}
    kb.reset_launch_counts()
    for n, A in mats.items():
        if n == table3.LONG_ROW:
            continue
        out, st, ms, k4, k5 = call(n, A)
        timed = ""
        if n == "cage11-full":
            times = [call(n, A)[2] for _ in range(3)]
            timed = (f" | median of 3 warm calls {statistics.median(times):.1f}"
                     f" ms ({', '.join(f'{t:.1f}' for t in times)})")
        results[n] = (csr_to_numpy(out), [getattr(st, f) for f in FIELDS])
        log(f"host: {n} first call {ms:.1f} ms{timed} | K4 {k4} K5 {k5} | "
            f"t_expand {st.t_expand * 1e3:.1f} t_sort {st.t_sort * 1e3:.1f} "
            f"t_output {st.t_output * 1e3:.1f} ms | "
            + " ".join(f"{f}={v}" for f, v in zip(FIELDS, results[n][1])))
    counts = kb.launch_counts()
    _launched(counts, ("stream_sort", "stream_merge"), "spz-host")
    for n, (csr, stats) in results.items():
        fcsr, fstats = fused[n]
        if not _csr_equal(np, csr, fcsr) or stats[:4] != fstats[:4]:
            raise AssertionError(f"{n}: spz-host differs from spz (fused): "
                                 f"{stats[:4]} vs {fstats[:4]}")
        if n in stand_ins:
            ref, st = spgemm(mats[n], mats[n], engine="spz-host",
                             backend="torch", return_stats=True)
            if not _csr_equal(np, csr, csr_to_numpy(ref)) \
                    or stats != [getattr(st, f) for f in FIELDS]:
                raise AssertionError(f"{n}: spz-host cuda and torch backends "
                                     f"differ")
        log(f"host: {n} equal to spz (CSR + 4 counters)"
            + (", bit-identical to backend='torch' (CSR + 6 counters)"
               if n in stand_ins else ""))
    return counts


def phase_engines(torch, np, mats, oracles):
    """esc on every matrix (bit for bit against the port's CPU esc on the
    stand-ins) and scl-hash on the stand-ins, against scl-array."""
    from repro_torch.core import spgemm
    from repro_torch.core.formats import csr_to_numpy
    from repro_torch.data import table3

    stand_ins = table3.names()
    for n, A in mats.items():
        t0 = time.perf_counter()
        got = csr_to_numpy(spgemm(A, A, engine="esc"))
        ms = (time.perf_counter() - t0) * 1e3
        _check_oracle(np, f"esc {n}", got, oracles[n])
        line = f"engines: esc {n} {ms:.1f} ms, matches scl-array"
        if n in stand_ins:
            cpu = csr_to_numpy(spgemm(A, A, engine="esc", device="cpu"))
            if not _csr_equal(np, got, cpu):
                raise AssertionError(f"esc {n}: card and CPU differ")
            hashed = csr_to_numpy(spgemm(A, A, engine="scl-hash"))
            _check_oracle(np, f"scl-hash {n}", hashed, oracles[n])
            line += "; bit-identical to the CPU esc; scl-hash matches"
        log(line)


def _count_waits(torch, fn):
    """``fn()`` and the host's waits for the card inside it, counted by
    PyTorch's sync debug mode (one warning per synchronizing operation).
    Returns (waits, what fn returned)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught), out


def _rows(A, n_rows):
    """The first ``n_rows`` rows of a CPU CSR."""
    from repro_torch.core.formats import csr_from_numpy, csr_to_numpy

    indptr, indices, data = csr_to_numpy(A)
    nnz = int(indptr[n_rows])
    return csr_from_numpy(indptr[:n_rows + 1], indices[:nnz], data[:nnz],
                          (n_rows, A.n_cols))


def phase_profile(torch):
    """Where one call's time goes: host wall clock vs device kernel time
    (torch.profiler), for one spz call on the two SuiteSparse-scale
    fused-route matrices, and for spz-host on a steady window of
    cage11-full (its first 8 groups of 512 rows: a whole call records
    ~800K events, whose processing alone takes minutes), plus the waits
    for the card per kernel issue over one whole spz-host call on
    cage11-full.  A diagnostic: a profiler that records no device time
    prints "not measured" instead of failing the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spgemm
    from repro_torch.data import table3

    A = table3.build("cage11-full")
    waits, (_, st) = _count_waits(torch, lambda: spgemm(
        A, A, engine="spz-host", return_stats=True))
    issues = st.n_mssort + st.n_mszip
    log(f"profile: cage11-full spz-host: {waits} waits for the card over "
        f"{issues} kernel issues ({st.n_mssort} K4 + {st.n_mszip} K5): "
        f"{waits / issues:.3f} per issue" if waits else
        "profile: cage11-full spz-host: waits per issue not measured (sync "
        "debug mode reported none)")
    for n, engine, rows in (("cage11-full", "spz", None),
                            ("email-Enron-full", "spz", None),
                            ("cage11-full", "spz-host", 8 * 512)):
        B = table3.build(n)
        A = B if rows is None else _rows(B, rows)
        spgemm(A, B, engine=engine)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            spgemm(A, B, engine=engine)
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in kernels) / 1e3
        if rows is not None:
            n = f"{n} rows 0-{rows - 1}"
        if not kernels:
            log(f"profile: {n} {engine} wall {wall:.1f} ms under the "
                f"profiler; device time not measured (no CUDA events "
                f"recorded)")
            continue
        log(f"profile: {n} {engine} wall {wall:.1f} ms under the profiler, "
            f"device kernels {busy:.1f} ms over "
            f"{sum(e.count for e in kernels)} launches, device idle share "
            f"{1 - busy / wall:.3f}")
        for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
            log(f"profile:   device {dev_us(e) / 1e3:9.2f} ms x{e.count:6d} "
                f"{e.key[:90]}")
        host = [e for e in events if e.device_type == DeviceType.CPU]
        for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:6]:
            log(f"profile:   host   {e.self_cpu_time_total / 1e3:9.2f} ms "
                f"x{e.count:6d} {e.key[:90]}")


def phase_inputs(np):
    """The 16 matrices of the main paths plus dense-row-full, and the
    scl-array oracle of each (host numpy)."""
    from repro_torch.core import spgemm_engines as sg
    from repro_torch.core.formats import csr_to_numpy
    from repro_torch.data import table3

    names = table3.names() + table3.names(full=True) + [table3.LONG_ROW]
    mats = {n: table3.build(n) for n in names}
    oracles = {n: csr_to_numpy(sg.spgemm_scl_array(A, A))
               for n, A in mats.items()}
    return mats, oracles


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.manual_seed(SEED)
    failed = []
    res = {}
    phases = (("device", lambda: phase_device(torch, _build)),
              ("kernel", lambda: phase_kernel(torch, np)),
              ("inputs", lambda: phase_inputs(np)),
              ("spgemm", lambda: phase_spgemm(torch, np, *res["inputs"])),
              ("host", lambda: phase_host(torch, np, res["inputs"][0],
                                          res["spgemm"][1])),
              ("engines", lambda: phase_engines(torch, np, *res["inputs"])))
    for label, fn in phases:
        t0 = time.perf_counter()
        try:
            res[label] = fn()
        except Exception:
            traceback.print_exc()
            log(f"{label}: FAILED")
            failed.append(label)
            if label in ("device", "inputs", "spgemm"):
                break  # the later phases need what these make
            continue
        log(f"{label}: passed in {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    t0 = time.perf_counter()
    try:
        phase_profile(torch)
    except Exception as e:  # a diagnostic only: report, do not fail
        log(f"profile: not measured ({type(e).__name__}: {e})")
    log(f"profile: done in {time.perf_counter() - t0:.1f} s")
    name, rows = res["device"], res["kernel"]
    # each kernel's launches on its own path's run
    counts = {k: v for k, v in res["spgemm"][0].items()
              if not k.startswith("stream_")}
    counts.update((k, res["host"][k]) for k in ("stream_sort", "stream_merge"))
    log("kernels: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    sources = {
        "chunk_sort": ("src/repro_torch/kernels/csrc/chunk_sort.cu",
                       "src/repro/kernels/chunk_sort.py:91"),
        "merge_partitions": ("src/repro_torch/kernels/csrc/merge_partitions.cu",
                             "src/repro/kernels/merge_partitions.py:163"),
        "fused_bucket": ("src/repro_torch/kernels/csrc/fused_bucket.cu",
                         "src/repro/kernels/fused_bucket.py:93"),
        "stream_sort": ("src/repro_torch/kernels/csrc/stream_sort.cu",
                        "src/repro/kernels/stream_sort.py:48"),
        "stream_merge": ("src/repro_torch/kernels/csrc/stream_merge.cu",
                         "src/repro/kernels/stream_merge.py:69"),
    }
    table = []
    for key, r in rows.items():
        kernel = key.split(".")[0]
        src, replaces = sources[kernel]
        launches = counts[key] if key in counts else counts[kernel]
        table.append({"name": key, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches,
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "wrapper_ms": r["wrapper_ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
