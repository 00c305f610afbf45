"""One run of one cell: inputs from the seed, warm-up, the measured window,
the traced segment, and the comparison with the reference.

Everything that belongs to one configuration, traffic mix, caller or
per-layer metric is a file of its own, found by name: the configuration
``configs/<name>.json`` names its pattern generator
(``patterns/<pattern>.py``, see ``generate``); the traffic mix
``traffic/<name>.json`` names its caller (``entries/<entry>.py``); each
per-layer metric is read by ``metrics/<name>.py``.  A traffic mix holds:

  ``entry``            the caller: ``entries/<entry>.py``, which defines
                       ``make_call(traffic, lanes, shape, device)`` and
                       ``outputs(out, n_lanes)``
  ``engine``           the engine the caller asks for ("auto": the program
                       selects)
  ``lanes``            independent draws of the configuration a call
                       multiplies (default one)
  ``warmup_calls``     calls made before the window, counted as set-up
  ``sample``           calls of the window kept and compared, drawn from
                       the seed
  ``profile_seconds``  length of the traced segment (``--trace 1``)

Every call multiplies ``C = A A`` for each lane and ends in
``torch.cuda.synchronize()``, so a product is complete when its CSR has
landed.  The caller is one closed loop: the next call starts when the last
one has returned.
"""
from __future__ import annotations

import gc
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

from perfbench import compare, generate, load_module, roofline, trace
from perfbench.reference import spgemm as ref

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of ``workload`` in the manifest,
    each file found by its name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the manifest has "
                       f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def cell_metrics(manifest: dict, workload: str, trace_on: bool) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    without the trace, the per-layer ones with it."""
    group = manifest["per_layer" if trace_on else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, JAX's libraries' or
    the JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


class Reservoir:
    """A uniform sample of ``k`` of the window's calls, drawn from the
    seed, whatever the number of calls turns out to be."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(generate.seed_sequence(seed, 2))
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def make_inputs(cfg: dict, traffic: dict, seed: int):
    """The lanes' CSR triples (numpy), drawn from the configuration and
    the seed."""
    base = generate.pattern(cfg)
    return [generate.draw(cfg, seed, lane=i, base=base)
            for i in range(int(traffic.get("lanes", 1)))]


def csr_arrays(csr) -> tuple:
    """A CSR on any device as numpy ``(indptr, indices, data)``, cut to
    its nnz."""
    indptr = csr.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    return (indptr, csr.indices[:nnz].cpu().numpy(),
            csr.data[:nnz].cpu().numpy())


def run_cell(cfg: dict, traffic: dict, metrics: list, *,
             seed: int, seconds: float, trace_on: bool, device="cuda",
             t_start: float | None = None) -> dict:
    """One run of a cell; returns the result line's object.  ``metrics``:
    the manifest entries to report; ``t_start``: the process's start on
    ``time.perf_counter``'s clock (set-up is counted from it)."""
    import torch

    from repro_torch.kernels import backend as kb

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    shape = (int(cfg["rows"]), int(cfg["cols"]))
    t_in = time.perf_counter()
    lanes = make_inputs(cfg, traffic, seed)
    n_lanes = len(lanes)
    entry = load_module("entries", traffic["entry"])
    call = entry.make_call(traffic, lanes, shape, device)
    t_warm = time.perf_counter()
    for _ in range(int(traffic["warmup_calls"])):
        call()
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    log(f"set-up: start {t_in - t_start:.3f} s, inputs and operands "
        f"{t_warm - t_in:.3f} s, warm-up {time.perf_counter() - t_warm:.3f} s")

    # the measured window
    kb.reset_launch_counts()
    sample = Reservoir(int(traffic["sample"]), seed)
    records, failed, errors = [], 0, []
    t_first = time.perf_counter()
    while True:
        try:
            plan_s, call_s, out, stats = call()
        except Exception as e:  # a product that never comes is counted
            failed += n_lanes
            errors.append(f"{type(e).__name__}: {e}")
            out = None
        else:
            records.append({"plan_s": plan_s, "call_s": call_s,
                            "t_sort": getattr(stats, "t_sort", None)})
        sample.offer(out)
        del out
        if time.perf_counter() - t_first >= seconds:
            break
    t_last = time.perf_counter()
    launches = kb.launch_counts()
    attempted = (len(records) * n_lanes) + failed
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                         if on_card else 0)}
    for err in errors[:3]:
        log(f"call failed: {err}")

    # the traced segment, after the window
    prof_summary = None
    if trace_on:
        prof_summary = traced_segment(call, float(traffic["profile_seconds"]),
                                      n_lanes, on_card)

    # the program's state is freed before the reference runs
    judged = [None if out is None else entry.outputs(out, n_lanes)
              for out in sample.items]
    del call, sample
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    refs = [ref.spgemm(lane, lane, shape[1], device=device)
            for lane in lanes]
    per = []
    for got in judged:
        for i in range(n_lanes):
            per.append(compare.compare(None if got is None else got[i],
                                       refs[i], shape[1]))
    checks = compare.merge(per)
    log(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s")
    correct = bool(judged) and failed == 0 and compare.passes(checks)

    products = len(records) * n_lanes
    c_nnz = [len(r[1]) for r in refs]
    a_nnz = [len(lane[1]) for lane in lanes]
    work = [int(generate.row_work(lane[0], lane[1], lane[0]).sum())
            for lane in lanes]
    least = [roofline.least_time(
        roofline.spgemm_bytes((shape[0], a), (shape[0], a), (shape[0], c)),
        roofline.spgemm_flops(w)) for a, c, w in zip(a_nnz, c_nnz, work)]
    least_s = sum(t for t, _ in least) / n_lanes
    ops_s = sum(roofline.spgemm_flops(w) for w in work) / n_lanes \
        / roofline.H100_SXM["fp32_flops_per_s"]
    log(f"product: {n_lanes} lane(s) of {shape[0]} x {shape[1]}, nnz(A) "
        f"{a_nnz}, products {work}, entries with a product {c_nnz} "
        f"(sums exactly 0 in float64: {[int((r[2] == 0).sum()) for r in refs]}); least time "
        f"{least_s * 1e6:.3f} us a product, bound by {least[0][1]} "
        f"(ops bound {ops_s * 1e6:.4f} us)")
    log(f"window: {len(records)} calls, {products} products, {failed} "
        f"failed, {t_last - t_first:.4f} s; {len(judged)} calls compared")
    if len(records) >= 2:
        ms = sorted(r["call_s"] * 1e3 for r in records)
        q = statistics.quantiles(ms, n=4)
        log(f"call ms: min {ms[0]:.3f} quartiles {q[0]:.3f} {q[1]:.3f} "
            f"{q[2]:.3f} max {ms[-1]:.3f}")

    ctx = {"calls": records, "products": products, "window_s": t_last - t_first,
           "launches": sum(launches[k] for k in kb.KERNELS),
           "least_time_s": least_s, "profile": prof_summary}
    values = {}
    if trace_on:
        for m in metrics:
            v = load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rates = {"products_per_s": products / (t_last - t_first),
                 "setup_s": t_first - t_start}
        for m in metrics:
            values[m["name"]] = {"value": rates[m["name"]], "unit": m["unit"]}

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": device_info}
    if prof_summary is not None:
        result["device"]["busy_s"] = prof_summary["busy_s"]
        result["device"]["window_s"] = prof_summary["window_s"]
        result["breakdown"] = {"device_ops": prof_summary["device_ops"],
                               "idle_gaps": prof_summary["idle_gaps"]}
    result["checks"] = {k: {"value": _finite(checks[k]), "limit": lim}
                        for k, lim in compare.LIMITS.items()}
    return result


def _finite(x: float) -> float:
    return x if np.isfinite(x) else sys.float_info.max


def traced_segment(call, seconds: float, n_lanes: int, on_card: bool):
    """Calls made for ``seconds`` under ``torch.profiler``, reduced to the
    device's busy time, the segment's length and the breakdown; the number
    of products is added as ``products``.  None where the trace shows no
    device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    n = 0
    with profile(activities=acts) as prof:
        with record_function(trace.SEGMENT):
            t0 = time.perf_counter()
            while n == 0 or time.perf_counter() - t0 < seconds:
                call()
                n += 1
            if on_card:
                torch.cuda.synchronize()
    summary = trace.reduce_profile(prof)
    if summary is None:
        log("trace: no device operation in the traced segment")
        return None
    summary["products"] = n * n_lanes
    log(f"trace: {n} calls, busy {summary['busy_s']:.6f} s of "
        f"{summary['window_s']:.6f} s")
    return summary
