#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main path on one card:

  device   the card's name and power limit, the torch version, the build
  kernel   each kernel (K1 chunk sort, K2 partition merge — also on one
           row of 2^20 slots, its long-row route over many CTAs, timed
           with and without the counters — K3 fused bucket on both
           routes of its streams entry and on its expand entry (the
           buckets of cage11-full's first group and S = 512, L = 1,024;
           accumulators compared too), K4 stream sort, K5 stream merge in its chunk form and
           in the pointer form the host driver launches, issue by issue
           through a merge round) at the main paths' shapes, held bit for
           bit against its plain torch version on the same card inputs,
           with its time, the plain version's time and its bound; K1 and
           K4 also with their device time (``device_ms``: 100 launches
           replayed from one CUDA graph), beside the same time of an
           empty kernel (``launch_floor_ms``)
  spgemm   the fused path: ``spgemm(A, A, engine="spz")`` on the 13 Table
           III stand-ins, the three SuiteSparse-scale ones and
           dense-row-full, with every launch counter set to 0 before and
           read after (K3's expand entry launched once per bucket on the
           kernel's route, as the bucketing counts them; K1 once per
           large-route bucket, on its warp route); then each result held bit-identical (CSR and
           SpzStats) against the same call with ``backend="torch"`` on the
           card and structure-identical against the scl-array oracle
  host     the host-driver path: ``engine="spz-host"`` on the same 16
           matrices, counters set to 0 before and read after; every call
           launches K4 exactly n_mssort times, all on its warp route, and K5's pointer form
           between n_mszip times and 7 more per merge round (idle issues
           past the last live one; a flag is read at most once per 8
           issues, and not once a round's bound on issues is reached); held
           against ``backend="torch"`` on the card (stand-ins: CSR and six
           counters) and against the fused result (CSR and four counters)
  engines  ``esc`` on the 16 matrices (bit for bit against the port's CPU
           esc on the stand-ins, against scl-array everywhere) and
           ``scl-hash`` on the stand-ins against scl-array
  dispatch the dispatch layer, on an autotune cache in a temporary
           directory: ``spgemm(A, A)`` with no engine on the 17 matrices
           (the heuristic table's engine and rule, the CSR bit for bit
           the named engine's, the second plan a memo hit, K3's expand
           entry on email-Enron-full), ``autotune=True`` on
           email-Enron-full and cage11 (only cuda-backend candidates;
           the second plan from the cache), ``spgemm_batched`` on
           [cage11-full, hub-full, dense-row-full] plus a padding lane
           (spz, spz-rsort, esc; spz also on the torch backend) and on
           six 1,024-row stand-ins (spz-host), every lane bit for bit
           its single call, and ``execute_resilient`` on
           email-Enron-full (planned; under an injected fault at
           dispatch.execute, degraded to spz-fused/cuda, the card's
           ladder, with K3 launched, the CSR unchanged, the combo
           quarantined; an injected kernel launch error raised, not
           degraded)
  service  the in-process SpGEMM service (``serving/spgemm_service.py``
           through ``distributed/spgemm_shard.py``), counters zeroed
           before and read after each path: the CLI's own 200 requests
           (``launch/serve_spgemm.py --warm --async-flushes 2 --verify``:
           availability 1.0, every result bit for bit its flush engine's
           single call, steady plan hit rate >= 0.9, warm hits, every
           flush on the caller's stream); a full-size bucket of 8
           requests alternating cage11-full and hub-full at max_batch 4
           under ``spz`` (K3's expand launches exactly the batch's
           bucketing, hub-full's large buckets on K1 + K2, the flush's
           SpzStats ``execute_batched``'s; one flush profiled) and
           ``auto``, every lane its single call; spz-host on six
           stand-ins (K4, K5); chaos (availability, card tiers only) and
           an injected ``KernelLaunchError`` raised out of ``drain``
  pool     multi-process serving (``runtime/coordinator.py``): a pool of
           two spawned workers sharing the card (startup timed); the
           full-size bucket through it (every lane the in-process flush's
           CSR, each flush record holding the worker's launches: 1,136 K3
           expand, 2 large on K1 + K2), spz-host on six stand-ins (K4,
           K5); worker 0 SIGKILLed mid-flush (every request resolved,
           ``worker_lost``/``restart``/``remesh``); an injected
           ``KernelLaunchError`` in a worker raised out of the parent's
           ``drain``, never re-run; the CLI's 200 requests ``--warm``
           inline, on 2 flush threads and on ``--workers 2`` (req/s,
           p50, p99; every pool result bit for bit the in-process
           service's on the same flush); 32 MiB through a worker-like
           pipe with default and widened socket buffers
  learned  the dispatch model (``models/dispatch_model.py``): three
           autotune sweeps on the card over the CLI traffic's keys and
           the stand-ins, each on a cache of its own, every sample's
           timing the median of the three (sigma logged), the model
           trained on the card and on the CPU
           (within the CPU test's tolerances, the same picks; the
           weights held where the samples determine them), then
           beside a fresh cache ``plan`` takes ``source="model"`` where
           it is confident, never on a host engine, and ``execute``
           equals that engine's direct call bit for bit, the card's and
           the CPU's model agreeing on those operands too; a plan's µs
           through the model rung, cold and memo hit, beside the
           heuristic table's
  attention  K6 flash attention on the sweep of tests/test_kernels_attn.py
           (float32 on the fma route, bf16 on the wgmma route, each
           route's counter checked) and at TinyLlama's prefill shapes
           (B = 4, S = 512 and B = 1, S = 4,096; H = 32, KVH = 4, hd = 64,
           bf16, causal) and RecurrentGemma-9B's local attention (B = 1,
           S = 4,096, H = 16, KVH = 1, hd = 256, window 2,048) on both
           routes, held against its plain version on the same card
           inputs within 2e-4 (float32) / 3e-2 and one bf16 rounding
           (bf16), with its time, TFLOP/s, the plain version's time,
           SDPA's and its bound; also hd = 20 and B * H = 65,536, and no
           ptxas spill or wgmma advisory at hd = 256
  serve    the LLM path: TinyLlama-1.1B at full width (22 layers, random
           fp32 weights from SEED, bf16 compute, attn_impl="pallas")
           behind ``Engine(max_batch=4, max_seq=1024).generate`` on 4
           ragged prompts (512, 480, 400, 300 tokens) x 32 greedy tokens,
           counters set to 0 before and read after: K6 launched exactly
           once per layer, all on the wgmma route, nothing else; the
           prefill's last-token logits
           held against attn_impl="xla" (plain blocked attention) within
           0.15 and finite; a 2-layer float32 model at full width held
           against the CPU (plain version) within 1e-3
  profile  host wall clock vs device kernel time of one spz call on the
           two SuiteSparse-scale fused-route matrices (K3's device total,
           device launches per bucket, idle share) and on
           dense-row-full (K2's device total), of spz-host on the first
           8 groups of cage11-full (launches per issue), the waits for
           the card per issue over one whole spz-host call on
           cage11-full, and one TinyLlama generate (torch.profiler)
  moe      Arctic-480B at full width, 2 of its 35 layers (TinyLlama's
           engine and model dropped first): K7 grouped matmul on the
           sweep of tests/test_kernels_attn.py, on ragged group sizes and
           at Arctic's four serve shapes (float32 within 1e-4 of the
           output's largest magnitude, bf16 within one rounding plus
           that), with its time (float32 too), the plain version's,
           torch.bmm's and its bound, in the contiguous layout and in the
           counts layout (prefill: every expert keeps 1 to cap rows;
           decode: 8 experts from SEED do; rows no expert keeps hold
           noise and must come out exactly zero; held against the plain
           version and the contiguous launch on the kept rows); K6 at
           Arctic's prefill shape; one MoE block (bf16 weights from SEED)
           at 4 x 512 and 4 x 1 tokens through K7 vs the plain grouped
           matmul (same keep mask, within 0.05); serving behind
           ``Engine(max_batch=4, max_seq=1024).generate`` on TinyLlama's
           prompts x 32 greedy tokens, counters set to 0 before and read
           after: K6 once per layer on the wgmma route, K7 three times
           per layer per forward pass in the counts layout, nothing else;
           one profiled generate
  families the three architectures of MLA, local attention and the
           recurrent blocks at full width, random weights from SEED,
           behind ``Engine(max_batch=4).generate`` x 32 greedy tokens,
           counters set to 0 before one measured generate and read
           after, each model dropped before the next is made:
           RecurrentGemma-9B (38 layers, RG-LRU + local attention,
           attn_impl="pallas"; prompts of 2,560, 2,300, 2,100 and 1,800
           tokens, max_seq 4,096, so the prefill's window of 2,048 and
           the decode ring both wrap): K6 at its served prefill shape
           (B = 4, S = 2,560, 16 / 1 heads, hd 256, window 2,048, bf16)
           against its plain version, with times, bound and SDPA's
           (boolean window mask); K6 once per local-attention layer (12)
           on the wgmma route and nothing else; prefill logits with K6
           against attn_impl="xla" in float32 within 1e-3, and in bf16
           no further from the float32 ones than the plain bf16 logits
           are, by BF16_SPREAD (two plain bf16 attentions that only block
           differently lie 0.17 apart here).  DeepSeek-V2-236B (2 of 60
           layers: the dense lead layer and one MoE layer of 160 experts
           top-6, MLA; TinyLlama's prompts): one MoE block at 4 x 512
           and 4 x 1 tokens through K7 vs the plain grouped matmul
           (within 0.05), K7 at the prefill's w1 product in the counts
           layout of that routing, with times, bound and torch.bmm's; K7
           3 x 32 passes, nothing else.  Mamba2-780M (48 SSD layers, no
           kernel; prompts of 500, 480, 400 and 300 tokens, no multiple
           of the chunk of 256): nothing launched; prefill then 4
           decode steps against the full forward over the same tokens,
           in float32 within 1e-3, in bf16 no further from the float32
           forward than the bf16 forward is, by BF16_SPREAD; 2 layers
           at full width in float32, card vs CPU within 1e-3.  For each:
           prefill ms, decode ms per step, tokens/s, peak memory, and
           one decode step profiled (launches, device idle share)
  encdec   cross attention and the whisper encoder, each model whole at
           full width behind ``Engine(max_batch=4).generate`` x 32
           greedy tokens on stub frontend embeddings (float32 normal
           from SEED), counters set to 0 before one measured generate and
           read after, the families' models dropped first:
           Whisper-small (12 encoder + 12 decoder layers, 1,500 frames,
           prompts 400 / 360 / 300 / 200, max_seq 448): K6 at the
           encoder's shape (B = 4, Sq = Skv = 1,500, 12 / 12 heads, hd
           64, bidirectional, bf16) on the first encoder layer's
           projections against its plain version, with times, bound and
           SDPA's; K6 once per encoder and decoder layer (24) on the
           wgmma route and nothing else; the prefill logits with K6
           against attn_impl="xla" with a key block of 1,500 (at the
           config's 1,024 the plain attention counts zero-padded keys in
           its bidirectional softmax, as the reference's does: logged,
           not gated) in float32 within 1e-3 and in bf16 by BF16_SPREAD;
           2 + 2 layers at full width in float32, card vs CPU within
           1e-3.  Llama-3.2-Vision-11B's backbone (40 layers, every 5th
           cross-attending 1,601 patch embeddings; TinyLlama's prompts):
           K6 at its prefill shape (B = 4, S = 512, 32 / 8 heads, hd
           128, causal) with times, bound and SDPA's; K6 once per layer
           (40), nothing else; the same logit gates.  For each: prefill
           ms, decode ms per step, tokens/s, peak memory, one decode step
           profiled
  train    the trainer (``launch/train.py``, ``launch/steps.py``,
           ``runtime/fault.py``, ``checkpoint/ckpt.py``), autograd on: K6
           on q, k, v that require gradients raises NotImplementedError
           and launches nothing; TinyLlama-1.1B whole (22 layers,
           remat="block", float32 weights and moments, bf16 compute), 6
           steps of 8 x 2,048 tokens through ``train`` with no
           checkpoint (step ms, tokens/s, model-FLOP share, peak GiB; no
           kernel launched), one more step profiled (launches, idle
           share); at 2 of its layers a run checkpointed every 3 steps
           and preempted before step 5, resumed by ``run_resilient``:
           each step's loss within 1e-4 of an uninterrupted run's (the
           largest difference and whether it is 0 logged; save and
           restore s), and the float32 loss and gradients on the card
           within 1e-4 of the CPU's; DeepSeek-V2 at 2 of 60 layers, one
           forward and backward at 4 x 512 tokens with the expert
           products through K7 and through the plain grouped matmul (no
           optimizer step: 43 GB of float32 weights and gradients): K7
           launched 9 times (3 forward, 3 recomputed, 3 dx on the route
           ``backward``) and nothing else, the expert weights'
           gradients nonzero, float32 loss and gradients within 1e-4 of
           the plain run's, bf16 within BF16_SPREAD of the plain bf16
           run's distance from float32; K7's dx launch at that routing
           against its plain version on W1 as stored (read in place as
           W1^T: no transposed copy), with its time, bound, the plain
           version's, torch.bmm's and torch.bmm's dW; the float32 K7
           run's peak memory
  dryrun   the dry run (``launch/dryrun.py``): its CLI on four cells at
           the 16 x 16 production mesh (a fake process group of 256
           ranks, meta tensors; TinyLlama-1.1B's train_4k, DeepSeek-V2's
           decode_32k through K7's shape-only path and _shardmap_moe's
           all_to_alls, two more decodes), each exiting 0 with a complete
           record; the dry run on a (1, 1) mesh of TinyLlama-1.1B's train
           step (8 x 2,048, remat "block"), prefill (4 x 512, K6) and one
           decode step held against the same steps on the card: FLOPs
           equal (FlopCounterMode plus K6's and K7's card FLOPs),
           argument bytes equal to what the arguments allocate, the
           predicted peak within 0.8-1.25x of max_memory_allocated; and
           ``serving.sampler.zipper_topk`` on 16 shards of TinyLlama's
           vocab, k = 40: torch.topk's ids, bit for bit its CPU run, each
           merge a K5 launch (``stream_merge.zipper_topk``)
  kernels  every ported kernel and its launches on its path's run, on
           the service path's (``service_launches``) and in the pool's
           workers (``pool_launches``)

It imports nothing of JAX.  The launch floor, the JSON kernel table and
the card's name and power limit are on the lines before the last; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase
passed.  Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.

Run: ``python3 chip_smoke.py`` (one card).
"""
import json
import math
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
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
SEED = 0
SERVE_PROMPTS = (512, 480, 400, 300)
SERVE_NEW_TOKENS = 32
SERVE_LOGIT_TOL = 0.15      # bf16 bound of tests/test_archs.py
CPU_LOGIT_TOL = 1e-3        # float32, card vs CPU, 2 layers at full width
# at full depth in bf16, a run under test (K6, or prefill + decode) lies no
# further from the float32 logits than its plain bf16 counterpart, by this
# factor: bf16 rounding puts either 0.3-0.4 away at RecurrentGemma-9B's
# 38 layers, a wrong kernel or state carry several units
BF16_SPREAD = 1.5


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=10, warmup=2, setup=None):
    """Median of ``reps`` runs after ``warmup``, each between two CUDA
    events, with the device synchronised around the whole; ``setup()``
    (untimed) before each run restores state a run changes in place."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_ms(torch, fn, n=100, reps=5):
    """Device time of one ``fn()`` launch: ``n`` launches captured in one
    CUDA graph, the graph replayed between two events, over ``n`` (median
    of ``reps`` replays).  The host's issue of each launch is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def launch_floor_ms(torch, build):
    """:func:`graph_ms` of a kernel that does nothing: the least any
    one-launch kernel takes on this card."""
    empty = build.entry("chunk_sort", "zipper_empty_launch")

    def launch():
        err = empty(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel: CUDA error {err}")
    return graph_ms(torch, launch)


def bound_ms(nbytes: int, ops: int, ops_per_s: float = FP32_OPS_PER_S):
    """Least time for the work: bytes over the memory rate vs operations
    over their type's peak rate (float32 unless given); returns (ms,
    which bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def k2_long_row(torch, np, rng, k2, R):
    """K2 on one row of La + Lb = 2^20 slots, the long-row route: the
    row's valid elements cut into tiles of 2,048 over as many CTAs, the
    counters by pointer jumping.  Lengths as dense-row-full's row 0 has
    (<= 39,082 uniques a side), so the plain advance loop stays short.
    Held bit for bit (counters too) against the plain version, and timed
    with the counters (ms) and without (payload_ms)."""
    dev = torch.device("cuda")
    L = 2**19
    args = [torch.from_numpy(a).to(dev) for a in
            (*_sorted_partitions(np, rng, 1, L, 3 * L, max_len=39082),
             *_sorted_partitions(np, rng, 1, L, 3 * L, max_len=39082))]
    got = k2.merge_partitions(*args, R=R)
    want = k2.merge_partitions_plain(*args, R=R)
    err = max_abs_err(torch, got[:3], want[:3])
    if [int(x) for x in got[3]] != [int(x) for x in want[3]]:
        raise AssertionError(f"K2 long-row counters {got[3]} != {want[3]}")
    payload = k2.merge_partitions(*args, R=R, with_counters=False)
    max_abs_err(torch, payload[:3], want[:3])
    valid = int(args[2].sum() + args[5].sum())
    adds = valid - int(got[2].sum())
    # each valid input element read once, every output slot written once
    b, by = bound_ms(8 * valid + 8 + nbytes(*got[:3]) + 16, adds)
    outs = [torch.empty_like(t) for t in got[:3]]
    cnt = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    return dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k2.launch(*args, R, True, *outs, cnt),
                   reps=10, warmup=2),
        payload_ms=time_ms(torch, lambda: k2.launch(*args, R, False, *outs,
                                                    cnt), reps=10, warmup=2),
        wrapper_ms=time_ms(torch, lambda: k2.merge_partitions(*args, R=R),
                           reps=10, warmup=2),
        plain_ms=time_ms(torch, lambda: k2.merge_partitions_plain(
            *args, R=R), reps=2, warmup=0),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"N=1 La=Lb={L}, {valid} valid, counters "
              f"{[int(x) for x in got[3]]}")


def k3_expand_row(torch, np, k3, A, rows, L, R=16):
    """K3's expand entry on the streams ``rows`` of A * A at width L: held
    bit for bit against its plain composition (expansion, sort, merge
    tree, reduction) on the same card inputs, keys, values, lengths and
    the group accumulators; timed alone, through the wrapper and as the
    plain composition.  Bound: bytes (per stream its ids and A's row
    pointers, per A entry its column, value and B row pointers, per
    product the gathered B column and value; out every slot, the lengths
    and the accumulators)."""
    from repro_torch.core.formats import csr_to_numpy
    from repro_torch.core import spgemm_engines as sg

    dev = torch.device("cuda")
    Ad = A.to(dev)
    mats = [t[None] for t in (Ad.indptr, Ad.indices, Ad.data)] * 2
    row_ids = torch.tensor(rows, dtype=torch.int64, device=dev)
    lane_ids = torch.zeros_like(row_ids)
    S, C = len(rows), L // R

    def run(fn):
        buf, steps, zips, tails = k3.accumulators(C, dev)
        return fn(row_ids, lane_ids, *mats, R=R, L=L, steps_acc=steps,
                  zip_acc=zips, tails_acc=tails), buf

    before = k3.fused_bucket.routes["expand"]
    got, got_acc = run(k3.fused_expand_bucket)
    if k3.fused_bucket.routes["expand"] != before + 1:
        raise AssertionError(f"bucket ({S}, {L}) did not take the expand "
                             f"entry")
    want, want_acc = run(k3.fused_expand_bucket_plain)
    err = max_abs_err(torch, (*got, got_acc), (*want, want_acc))
    indptr = csr_to_numpy(A)[0]
    real = np.asarray(rows)[np.asarray(rows) >= 0]
    entries = int((indptr[real + 1] - indptr[real]).sum())
    products = int(sg.row_work(A, A)[real].sum())
    adds = products - int(got[2].sum())
    b, by = bound_ms(24 * S + 16 * entries + 8 * products
                     + nbytes(*got, got_acc), products + adds)
    buf, steps, zips, tails = k3.accumulators(C, dev)
    outs = [torch.empty_like(t) for t in got]
    return dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k3.launch_expand(
            row_ids, lane_ids, mats, R, L, *outs, steps, zips, tails),
            reps=20, warmup=3),
        wrapper_ms=time_ms(torch, lambda: run(k3.fused_expand_bucket),
                           reps=20, warmup=3),
        plain_ms=time_ms(torch, lambda: run(k3.fused_expand_bucket_plain),
                         reps=5, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"expand entry, S={S} L={L} R={R}: {entries} A entries, "
              f"{products} products, accumulators equal")


def k3_expand_rows(torch, np, k3):
    """The expand entry at the buckets of cage11-full's first lock-step
    group (rows 0-511: S, L = 4, 64; 64, 128; 512, 256; 128, 512, padding
    streams included) and at S = 512, L = 1,024 (rows of a uniform
    8,192-row matrix, density 0.003, seed SEED, with 513-1,024 products
    each)."""
    from repro_torch.core import spgemm_engines as sg
    from repro_torch.core.formats import random_sparse
    from repro_torch.data import table3

    out = {}
    A = table3.build("cage11-full")
    work = sg.row_work(A, A)[:512]
    chunks = np.array([sg._pow2_chunks(int(w), 16) if w else 0 for w in work])
    for C in sorted(set(chunks[chunks > 0].tolist())):
        rows = np.flatnonzero(chunks == C)
        n = 1 << max(0, len(rows) - 1).bit_length()
        rows = np.concatenate([rows, np.full(n - len(rows), -1)])
        out[f"fused_bucket.expand.cage11-full-g0-L{16 * C}"] = k3_expand_row(
            torch, np, k3, A, rows, 16 * C)
    B = random_sparse(8192, 8192, 0.003, seed=SEED)
    work = sg.row_work(B, B)
    rows = np.flatnonzero((work > 512) & (work <= 1024))[:512]
    out["fused_bucket.expand"] = k3_expand_row(torch, np, k3, B, rows, 1024)
    return out


def phase_kernel(torch, np):
    """Each kernel vs its plain version on card inputs of the main path's
    shapes (cage11-full: 512-stream groups, R = 16, keys < 39,082); K1's
    and K4's rows also with their device time (:func:`graph_ms`), and the
    launch floor beside them."""
    from repro_torch.kernels import _build
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
        device_ms=graph_ms(torch, lambda: k1.launch(ck, cv, cl, *outs)),
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
                         + 32 * max(C - 1, 1), adds)
        wrapper = time_ms(torch, lambda: k3.fused_bucket(
            keys, vals, plens, R=R, detailed=True))
        if route == "fused":  # the kernel alone; the large route is K1 + K2s
            outs = [torch.empty_like(t) for t in got[:3]]
            acc = k3.accumulators(C, dev)[0]
            ms = time_ms(torch, lambda: k3.launch(keys, vals, plens, R, *outs,
                                                  acc))
        else:
            ms = wrapper
        rows[f"fused_bucket.{route}"] = dict(
            max_abs_err=err, ms=ms, wrapper_ms=wrapper,
            plain_ms=time_ms(torch, lambda: k3.fused_bucket_plain(
                keys, vals, plens, R=R, detailed=True), reps=10, warmup=1),
            bound_ms=b, bound_by=by, library_ms=None,
            shape=f"S={S} L={L} R={R}")
    rows.update(k3_expand_rows(torch, np, k3))
    rows["merge_partitions.long"] = k2_long_row(torch, np, rng, k2, R)

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
        device_ms=graph_ms(torch, lambda: k4.launch(keys, vals, plens,
                                                    *outs)),
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
    rows["stream_merge.chunk"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k5.launch(*args, *outs), reps=50, warmup=5),
        wrapper_ms=time_ms(torch, lambda: k5.stream_merge(*args), reps=50,
                           warmup=5),
        plain_ms=time_ms(torch, lambda: k5.stream_merge_plain(*args),
                         reps=10, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"S=512 R={R}")
    rows["stream_merge"] = _k5_pointer_row(torch, np, rng, k5, R)
    floor = launch_floor_ms(torch, _build)
    log(f"kernel: launch_floor_ms {floor:.5f} (an empty kernel, 100 "
        f"launches in one CUDA graph)")
    for name, r in rows.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        extra = "".join(f" {x} {r[x]:.4f}" for x in ("payload_ms", "device_ms")
                        if x in r)
        log(f"kernel: {name} {r['shape']} bit-exact (max_abs_err "
            f"{r['max_abs_err']}) kernel_ms {r['ms']:.4f}{extra} wrapper_ms "
            f"{r['wrapper_ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.5f} ({r['bound_by']}) library_ms {lib}")
    return rows, floor


def _k5_pointer_row(torch, np, rng, k5, R, S=512, L=64):
    """K5's pointer form against its plain composition (take_chunk ->
    stream_merge_ref -> put_rows -> pointer updates) on one host-driver
    merge round of S = 512 streams (partitions of up to 64 keys a side,
    the second round's width): every issue's pointers, zip elements,
    appended rows, flag and count of issues that did work equal, through
    2 idle issues past the end.
    Times one issue from the round's start, state restored before each."""
    dev = torch.device("cuda")
    parts = []
    for _ in range(2):
        k, v, n = _sorted_partitions(np, rng, S, L, 2 * L)
        parts += [torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev),
                  torch.from_numpy(n.astype(np.int64)).to(dev)]
    Ka, Va, la, Kb, Vb, lb = parts
    Lo = 2 * L

    def fresh():
        z = torch.zeros(S, dtype=torch.int64, device=dev)
        return [z.clone() for _ in range(4)] + [
            torch.full((S, Lo + 1), 2**31 - 1, dtype=torch.int32, device=dev),
            torch.zeros((S, Lo + 1), dtype=torch.float32, device=dev)]

    def issue(fn, st, flag, worked):
        pa, pb, optr, zips, Ko, Vo = st
        fn(Ka, Va, la, Kb, Vb, lb, pa, pb, optr, Ko, Vo, zips, flag, worked,
           R=R)

    kern, plain = fresh(), fresh()
    worked = torch.zeros(2, dtype=torch.int64, device=dev)
    idle = issues = 0
    err = 0.0
    while idle < 2:
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        issue(k5.stream_merge_ptr, kern, flags[0:1], worked[0:1])
        issue(k5.stream_merge_ptr_plain, plain, flags[1:2], worked[1:2])
        err = max(err, max_abs_err(
            torch, plain[:4] + [plain[4][:, :Lo], plain[5][:, :Lo]],
            kern[:4] + [kern[4][:, :Lo], kern[5][:, :Lo]]))
        f, w = flags.tolist(), worked.tolist()
        if f[0] != f[1] or w[0] != w[1]:
            raise AssertionError(f"K5 pointer flag {f[0]} != plain {f[1]} "
                                 f"or issues with work {w[0]} != {w[1]}")
        if issues == 0:  # the timed issue: fronts read, rows written, and
            # per stream 2 lengths read, 4 pointers read and written
            live = (la > 0) & (lb > 0)
            front = (la.clamp(max=R) + lb.clamp(max=R))[live].sum()
            nbytes_issue = 8 * int(front) + 8 * int(kern[2].sum()) \
                + 8 * 10 * S + 4
        issues += 1
        idle += not f[0] & 1
    start = fresh()
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    done = torch.zeros(1, dtype=torch.int64, device=dev)

    def reset():
        for t, s0 in zip(kern, start):
            t.copy_(s0)
        flag.zero_()

    def raw():
        pa, pb, optr, zips, Ko, Vo = kern
        k5.launch_ptr(Ka, Va, la, Kb, Vb, lb, pa, pb, optr, Ko, Vo, zips,
                      flag, done, R)

    b, by = bound_ms(nbytes_issue, 0)
    return dict(
        max_abs_err=err,
        ms=time_ms(torch, raw, reps=50, warmup=5, setup=reset),
        wrapper_ms=time_ms(torch, lambda: issue(k5.stream_merge_ptr, kern,
                                                flag, done),
                           reps=50, warmup=5, setup=reset),
        plain_ms=time_ms(torch, lambda: issue(k5.stream_merge_ptr_plain, kern,
                                              flag, done),
                         reps=10, warmup=1, setup=reset),
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"pointer form, one issue of S={S} R={R} (partitions of "
              f"<= {L} a side; {issues - 2} live issues in the round, each "
              f"held against the plain composition, 2 idle past it)")


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


def _bucket_counts(np, A, R=16, S=512):
    """Buckets of one spz call on A * A at its defaults (groups of S rows
    in order, a bucket per distinct pow2 chunk count), by route: (on K3's
    expand entry, large)."""
    from repro_torch.core import spgemm_engines as sg

    return _work_buckets(sg.row_work(A, A), R, S)


def _work_buckets(work, R=16, S=512):
    """(on K3's expand entry, large) buckets of the spz fused driver over
    the rows whose product counts are ``work``, in order: a single call's
    rows, or a batch's valid lanes' rows one lane after another."""
    from repro_torch.kernels.fused_bucket import fused_config

    fused = large = 0
    for g0 in range(0, len(work), S):
        for C in {1 << max(0, -(-int(w) // R) - 1).bit_length()
                  for w in work[g0:g0 + S] if w}:
            if fused_config(C * R, R) is None:
                large += 1
            else:
                fused += 1
    return fused, large


def phase_spgemm(torch, np, mats, oracles):
    """The fused path on the card, counters zeroed before and read after:
    every call launches K3 (its expand entry) once per bucket on the
    kernel's route and nothing else of K3; then every result held
    against the torch backend and scl-array.
    Returns the path's launch counts and each matrix's (CSR, stats)."""
    from repro_torch.core import spgemm
    from repro_torch.core.formats import csr_to_numpy
    from repro_torch.data import table3
    from repro_torch.kernels import backend as kb

    results = {}
    kb.reset_launch_counts()
    for n, A in mats.items():
        n_fused, n_large = _bucket_counts(np, A)
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
        got = (delta.get("fused_bucket.expand", 0),
               delta.get("fused_bucket.large", 0), delta.get("fused_bucket", 0))
        if got != (n_fused, n_large, n_fused):
            raise AssertionError(
                f"{n}: K3 expand launches / large buckets / K3 launches per "
                f"call {got}, the bucketing gives {n_fused} fused-route and "
                f"{n_large} large-route buckets")
        k1 = (delta.get("chunk_sort", 0), delta.get("chunk_sort.warp", 0))
        if k1 != (n_large, n_large):
            raise AssertionError(f"{n}: K1 launches / on the warp route per "
                                 f"call {k1}, {n_large} large buckets")
        results[n] = (csr_to_numpy(out), [getattr(st, f) for f in FIELDS])
        log(f"spgemm: {n} {A.shape[0]}x{A.shape[1]} nnz "
            f"{int(A.indptr[-1])} -> {results[n][0][1].size} | buckets "
            f"{n_fused} on K3's expand entry, {n_large} large | ms/call "
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
    n_mssort times and K5 in its pointer form between n_mszip times and
    MERGE_FLAG_EVERY - 1 more per merge round (the issues past the last
    live one; n_mszip itself is held against the torch backend);
    results held against the torch backend on the card (stand-ins) and
    the fused path (all)."""
    from repro_torch.core import spgemm
    from repro_torch.core import spgemm_engines as sg
    from repro_torch.core.formats import csr_to_numpy
    from repro_torch.data import table3
    from repro_torch.kernels import backend as kb

    k = sg.MERGE_FLAG_EVERY

    def call(n, A):
        """One spz-host call: K4 launched n_mssort times, K5's pointer
        form n_mszip times plus at most k - 1 per merge round, nothing
        else."""
        before = kb.launch_counts()
        t0 = time.perf_counter()
        out, st = spgemm(A, A, engine="spz-host", return_stats=True)
        ms = (time.perf_counter() - t0) * 1e3
        after = kb.launch_counts()
        delta = {key: after[key] - before[key] for key in after}
        k4, k5 = delta.pop("stream_sort"), delta.pop("stream_merge")
        ptr = delta.pop("stream_merge.pointer")
        warp = delta.pop("stream_sort.warp")
        if warp != k4 or delta.pop("stream_sort.block"):
            raise AssertionError(f"{n}: {warp} of {k4} K4 launches on the "
                                 f"warp route")
        rounds = st.merge_rounds
        if k4 != st.n_mssort or k5 != ptr or not \
                st.n_mszip <= ptr <= st.n_mszip + (k - 1) * rounds:
            raise AssertionError(
                f"{n}: K4 {k4} (n_mssort {st.n_mssort}), K5 {k5} of which "
                f"pointer form {ptr} over {rounds} merge rounds (n_mszip "
                f"{st.n_mszip}, at most {k - 1} more a round)")
        if any(delta.values()):
            raise AssertionError(f"{n}: spz-host launched {delta}")
        return out, st, ms, k4, ptr

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
        log(f"host: {n} first call {ms:.1f} ms{timed} | K4 {k4} K5 {k5} "
            f"(pointer form: n_mszip {st.n_mszip} with work, "
            f"{k5 - st.n_mszip} idle over {st.merge_rounds} merge rounds) | "
            f"t_expand {st.t_expand * 1e3:.1f} t_sort {st.t_sort * 1e3:.1f} "
            f"t_output {st.t_output * 1e3:.1f} ms | "
            + " ".join(f"{f}={v}" for f, v in zip(FIELDS, results[n][1])))
    counts = kb.launch_counts()
    _launched(counts, ("stream_sort", "stream_merge.pointer"), "spz-host")
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


# engine="auto" on the 17 matrices: what the reference's heuristic table
# picks from the same features (tests/test_torch_dispatch.py holds the
# port to it on the CPU); every other matrix takes the default rule, spz
AUTO_CHOICE = {"wiki": ("spz-rsort", "skewed"),
               "ndwww": ("spz-rsort", "skewed"),
               "bcsstk17": ("esc", "dense"), "p3d": ("esc", "dense"),
               "cage11-full": ("esc", "dense"), "hub-full": ("esc", "dense"),
               "dense-row-full": ("esc", "dense")}
FULL_BATCH = ("cage11-full", "hub-full", "dense-row-full")
HOST_BATCH = ("p2p", "soc", "ca-cm", "email", "scircuit", "cage11")


def _warm_ms(torch, fn, reps=3):
    """Median host ms of ``reps`` calls, each ending in a synchronize
    (the call's time as PERF.md section 2 defines it)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_dispatch(torch, np, mats, fused):
    """The dispatch layer on the card, on an AutotuneCache in a temporary
    directory (never ~/.cache):

    1. ``spgemm(A, A)`` with no engine and no device on the 17 matrices,
       counters zeroed before and read after: engine, rule and source of
       each (the heuristic table's choice, AUTO_CHOICE), the CSR bit for
       bit the named engine's, the second plan a memo hit (µs per plan
       cold and on a hit), K3's expand entry launched on
       email-Enron-full's call; ms per warm call on the full-size ones;
    2. ``autotune=True`` on email-Enron-full and cage11: the timing
       vector (every backend-aware candidate on cuda), the second plan
       from the cache;
    3. batched: [cage11-full, hub-full, dense-row-full] plus a padding
       lane through spz, spz-rsort and esc, and the six 1,024-row
       stand-ins through spz-host; every valid lane bit for bit the
       single-matrix call, the padding lane invalid and empty; spz also
       with backend="torch" (K3's expand entry on lanes > 0, K1 and K2
       on hub-full's and dense-row-full's large buckets, against their
       plain versions); launches by route and ms per call;
    4. execute_resilient on email-Enron-full: tier "planned" without a
       fault; with dispatch.execute raising for the planned engine,
       "degraded:spz-fused/cuda" (the card's ladder: K3 launched, no
       plain tier), the same CSR, the combo quarantined; with it raising
       a kernel launch error, that error raised and nothing degraded."""
    import shutil
    import tempfile

    from repro_torch.core import dispatch as dp
    from repro_torch.core import spgemm
    from repro_torch.core.formats import batch_csr, csr_to_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels import backend as kb
    from repro_torch.runtime import faultinject as fi

    out = {"auto": {}, "batched": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    saved = dp._default_cache
    try:
        # 1. engine="auto", one matrix at a time, each on a default cache
        # of its own (wiki, bcsstk17 and p3d share a shape/nnz bucket: one
        # cache would replay the first one's selection for the others)
        dp.clear_feature_cache()
        kb.reset_launch_counts()
        for n, A in mats.items():
            dp._default_cache = dp.AutotuneCache(
                os.path.join(tmp, f"auto-{n}.json"))
            t0 = time.perf_counter()
            p = dp.plan(A, A)
            cold_us = (time.perf_counter() - t0) * 1e6
            hits = dp._plan_memo.hits
            t0 = time.perf_counter()
            p2 = dp.plan(A, A)
            hit_us = (time.perf_counter() - t0) * 1e6
            if p2 is not p or dp._plan_memo.hits != hits + 1:
                raise AssertionError(f"auto {n}: second plan not a memo hit")
            want = AUTO_CHOICE.get(n, ("spz", "default"))
            if (p.engine, p.rule, p.source, p.backend) != (
                    *want, "heuristic",
                    "cuda" if want[0].startswith("spz") else None):
                raise AssertionError(
                    f"auto {n}: planned {p.engine} {p.rule} {p.source} "
                    f"{p.backend}, the table gives {want}")
            before = kb.launch_counts()
            got = csr_to_numpy(spgemm(A, A))
            after = kb.launch_counts()
            delta = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            explicit = fused[n][0] if p.engine == "spz" else csr_to_numpy(
                spgemm(A, A, engine=p.engine))
            if not _csr_equal(np, got, explicit):
                raise AssertionError(f"auto {n}: CSR differs from "
                                     f"engine={p.engine!r}")
            row = dict(engine=p.engine, rule=p.rule, source=p.source,
                       plan_cold_us=cold_us, plan_hit_us=hit_us,
                       launches=delta)
            if A.shape[0] > 10_000:
                row["ms"] = _warm_ms(torch, lambda: spgemm(A, A))
            out["auto"][n] = row
            log(f"dispatch: auto {n} -> {p.engine} (rule {p.rule}, source "
                f"{p.source}, backend {p.backend}) | plan {cold_us:.0f} us "
                f"cold, {hit_us:.1f} us memo hit | bit-identical to "
                f"engine={p.engine!r}"
                + (f" | {row['ms']:.2f} ms per warm call" if "ms" in row
                   else "") + f" | launches {delta}")
        counts = kb.launch_counts()
        if out["auto"]["email-Enron-full"]["launches"].get(
                "fused_bucket.expand", 0) == 0:
            raise AssertionError("auto email-Enron-full: no K3 expand launch")
        out["auto_counts"] = {k: v for k, v in counts.items() if v}
        log(f"dispatch: auto path launches {out['auto_counts']}")

        # 2. autotune=True
        tune = dp.AutotuneCache(os.path.join(tmp, "tune.json"))
        out["autotune"] = {}
        for n in ("email-Enron-full", "cage11"):
            A = mats[n]
            t0 = time.perf_counter()
            p = dp.plan(A, A, autotune=True, cache=tune)
            sweep_s = time.perf_counter() - t0
            timings = tune.get(p.cache_key)["timings"]
            bad = [c for c in timings if dp.split_combo(c)[0] in
                   ("spz", "spz-rsort") and not c.endswith("|cuda")]
            if p.source != "autotune" or bad:
                raise AssertionError(f"autotune {n}: source {p.source}, "
                                     f"candidates off the card {bad}")
            again = dp.plan(A, A, autotune=True, cache=tune)
            if (again.source, again.engine, again.backend) != (
                    "cache", p.engine, p.backend):
                raise AssertionError(f"autotune {n}: second plan "
                                     f"{again.source} {again.engine}")
            out["autotune"][n] = dict(winner=f"{p.engine}|{p.backend or ''}",
                                      sweep_s=sweep_s,
                                      timings_ms={c: t * 1e3 for c, t in
                                                  timings.items()})
            log(f"dispatch: autotune {n} -> {p.engine}/{p.backend} in "
                f"{sweep_s:.1f} s | ms per candidate " + ", ".join(
                    f"{c}={t * 1e3:.2f}" for c, t in timings.items())
                + " | second plan from the cache")

        # 3. batched
        cache = dp.AutotuneCache(os.path.join(tmp, "batched.json"))
        full = batch_csr([mats[n] for n in FULL_BATCH], batch_cap=4).to("cuda")
        singles = {}
        for engine in ("spz", "spz-rsort", "esc"):
            kb.reset_launch_counts()
            t0 = time.perf_counter()
            res = dp.spgemm_batched(full, full, engine, cache=cache)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in kb.launch_counts().items() if v}
            ms = _warm_ms(torch, lambda: dp.spgemm_batched(
                full, full, engine, cache=cache), reps=2)
            if res.valid.tolist() != [True] * 3 + [False] or \
                    int(res[3].indptr[-1]) != 0:
                raise AssertionError(f"batched {engine}: padding lane "
                                     f"{res.valid.tolist()}")
            for i, n in enumerate(FULL_BATCH):
                single = fused[n][0] if engine == "spz" else csr_to_numpy(
                    spgemm(mats[n], mats[n], engine=engine))
                if not _csr_equal(np, csr_to_numpy(res[i]), single):
                    raise AssertionError(f"batched {engine}: lane {i} ({n}) "
                                         f"differs from the single call")
                singles[engine, n] = single
            if engine.startswith("spz") and not (
                    counts.get("fused_bucket.expand", 0)
                    and counts.get("fused_bucket.large", 0)):
                raise AssertionError(f"batched {engine}: routes {counts}")
            out["batched"][f"full {engine}"] = dict(ms=ms, first_ms=first_ms,
                                                    launches=counts)
            log(f"dispatch: batched full-size {engine}: {ms:.1f} ms per warm "
                f"call (first {first_ms:.1f}) | every lane bit-identical to "
                f"its single call, padding lane invalid | launches {counts}")
        t0 = time.perf_counter()
        plain = dp.spgemm_batched(full, full, "spz", backend="torch",
                                  cache=cache)
        plain_ms = (time.perf_counter() - t0) * 1e3
        for i, n in enumerate(FULL_BATCH):
            if not _csr_equal(np, csr_to_numpy(plain[i]), singles["spz", n]):
                raise AssertionError(f"batched spz: backend='torch' lane {i}"
                                     f" ({n}) differs from cuda")
        out["batched"]["full spz torch"] = dict(ms=plain_ms)
        log(f"dispatch: batched full-size spz backend='torch' "
            f"{plain_ms:.0f} ms: bit-identical to cuda on every lane")
        host = batch_csr([mats[n] for n in HOST_BATCH]).to("cuda")
        kb.reset_launch_counts()
        t0 = time.perf_counter()
        res = dp.spgemm_batched(host, host, "spz-host", cache=cache)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in kb.launch_counts().items() if v}
        for i, n in enumerate(HOST_BATCH):
            if not _csr_equal(np, csr_to_numpy(res[i]), fused[n][0]):
                raise AssertionError(f"batched spz-host: lane {i} ({n}) "
                                     f"differs from spz")
        if not counts.get("stream_sort") or not counts.get(
                "stream_merge.pointer"):
            raise AssertionError(f"batched spz-host: launches {counts}")
        out["batched"]["stand-ins spz-host"] = dict(ms=ms, launches=counts)
        log(f"dispatch: batched stand-ins spz-host ({len(HOST_BATCH)} lanes) "
            f"{ms:.1f} ms | every lane bit-identical to spz | launches "
            f"{counts}")

        # 4. execute_resilient
        res_cache = dp.AutotuneCache(os.path.join(tmp, "resilient.json"))
        A = mats["email-Enron-full"]
        p = dp.plan(A, A, cache=res_cache)
        got, report = dp.execute_resilient(p, A, A, cache=res_cache)
        if report.tier_label != "planned":
            raise AssertionError(f"resilient: {report.tier_label}")
        want = csr_to_numpy(got)
        kb.reset_launch_counts()
        t0 = time.perf_counter()
        with fi.injected(fi.FaultSpec(site="dispatch.execute",
                                      match={"engine": p.engine})):
            got, report = dp.execute_resilient(
                p, A, A, cache=res_cache,
                policy=dp.RetryPolicy(sleep=lambda s: None))
        torch.cuda.synchronize()
        degraded_ms = (time.perf_counter() - t0) * 1e3
        expand = kb.launch_counts()["fused_bucket.expand"]
        if report.tier_label != "degraded:spz-fused/cuda" or not \
                res_cache.is_quarantined(p.cache_key, p.engine, p.backend) \
                or not _csr_equal(np, csr_to_numpy(got), want) \
                or not expand:
            raise AssertionError(
                f"resilient: {report.tier_label}, {expand} K3 expand "
                f"launches, quarantined {res_cache.quarantined(p.cache_key)}")
        out["resilient_ms"] = degraded_ms
        log(f"dispatch: resilient email-Enron-full planned {p.engine}/"
            f"{p.backend}; under a fault at dispatch.execute: "
            f"{report.tier_label} after {report.attempts} attempts in "
            f"{degraded_ms:.0f} ms ({expand} K3 expand launches), same "
            f"CSR, {p.engine}/{p.backend} quarantined")
        p = dp.fallback_plan(p, "spz-fused", "cuda")
        launch_fault = fi.FaultSpec(
            site="dispatch.execute", match={"engine": "spz-fused"},
            exc_factory=lambda site, ctx: _build.KernelLaunchError(
                f"{site}: injected launch error"))
        try:
            with fi.injected(launch_fault):
                dp.execute_resilient(p, A, A, cache=res_cache)
        except _build.KernelLaunchError:
            pass
        else:
            raise AssertionError("resilient: a kernel launch error was "
                                 "served by a lower tier")
        if launch_fault.fires != 1:
            raise AssertionError(f"resilient: the launch error fired "
                                 f"{launch_fault.fires} times")
        log("dispatch: resilient, a kernel launch error in the planned "
            "tier raised at once (1 attempt, no tier below)")
    finally:
        dp._default_cache = saved
        shutil.rmtree(tmp, ignore_errors=True)
    return out


SERVICE_FULL = ("cage11-full", "hub-full")   # one pad bucket of 2^20 nnz
CARD_TIERS = ("planned", "degraded:spz-fused/cuda", "degraded:esc",
              "isolated")


def _service_counts(kb):
    return {k: v for k, v in kb.launch_counts().items() if v}


def _add_counts(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def phase_service(torch, np, mats, fused):
    """The in-process SpGEMM service on the card (one card: every flush
    on cuda:0, the caller's stream), each path's launch counters zeroed
    before and read after it, the checks run after the read:

    1. the CLI's own traffic, ``serve_spgemm.run(["--requests", "200",
       "--warm", "--async-flushes", "2", "--verify", ...])``: every
       request resolves (availability 1.0), every result bit for bit
       ``spgemm(A, B, engine=<its flush's engine>)`` alone on the card,
       the steady plan hit rate >= 0.9, warm hits, no flush isolated or
       degraded; every flush and warm ran on the caller's stream
       (``torch.cuda.current_stream()`` read on the flush threads);
    2. a full-size bucket: 8 requests alternating cage11-full and
       hub-full (one pad bucket of 2^20 nnz) through
       ``SpGemmService(max_batch=4)``, with ``engine="spz"`` and then
       ``"auto"``: every lane its single call's CSR; under spz K3's
       expand entry launched exactly as the batch's bucketing gives
       (beside the singles' sum: groups straddle lane boundaries),
       hub-full's large buckets on K1 + K2, the flush's SpzStats those
       of ``execute_batched`` on the same plan, sort_elems and
       zip_elems the singles' sums; one flush profiled (idle share);
    3. spz-host on the six 1,024-row stand-ins: K4 and K5 launched;
    4. chaos: ``--inject-rate 0.1 --kill-worker 0 --chaos-seed 0`` on 100
       requests: every id resolves, every tier a card tier; every esc
       launch failing degrades to ``spz-fused/cuda``, every batched launch
       failing isolates each request on ``esc`` on the card; and an
       injected ``KernelLaunchError`` at the batched kernel launch raises
       out of ``drain`` (inline and async), nothing degraded or
       dead-lettered.
    Returns the service path's launch counts and its numbers."""
    import shutil
    import tempfile
    import threading

    from repro_torch.core import dispatch as dp
    from repro_torch.core import spgemm
    from repro_torch.core import spgemm_engines as sg
    from repro_torch.core.formats import batch_csr, csr_to_numpy
    from repro_torch.distributed import spgemm_shard as shard
    from repro_torch.kernels import _build
    from repro_torch.kernels import backend as kb
    from repro_torch.launch import serve_spgemm as cli
    from repro_torch.runtime import faultinject as fi
    from repro_torch.serving import spgemm_service as svc

    out = {"counts": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_service_")
    caller = torch.cuda.current_stream()
    streams = []
    execute_sharded = shard.execute_sharded

    def on_stream(*a, **kw):
        streams.append((threading.current_thread().name,
                        torch.cuda.current_stream()))
        return execute_sharded(*a, **kw)

    try:
        # 1. the CLI's traffic, warm and async
        dp.reset_warm_stats()
        shard.execute_sharded = on_stream
        kb.reset_launch_counts()
        try:
            res = cli.run(["--requests", "200", "--warm", "--async-flushes",
                           "2", "--verify", "--cache",
                           os.path.join(tmp, "cli.json")])
        finally:
            shard.execute_sharded = execute_sharded
        part = _service_counts(kb)
        _add_counts(out["counts"], part)
        service, steady = res["service"], res["steady"]
        if res["all"]["n_requests"] != 200 or \
                res["all"].get("availability") != 1.0 or \
                service.dead_letters:
            raise AssertionError(f"service cli: {res['all']}")
        tiers = {f.tier for f in service.flush_log}
        if tiers != {"planned"}:
            raise AssertionError(f"service cli: tiers {tiers}")
        if steady["plan_hit_rate"] < 0.9 or not steady["warm_hit_rate"] \
                or not dp.warm_stats()["hits"]:
            raise AssertionError(f"service cli: plan hit rate "
                                 f"{steady['plan_hit_rate']}, warm hit rate "
                                 f"{steady['warm_hit_rate']}, warm stats "
                                 f"{dp.warm_stats()}")
        flush_threads = {n for n, _ in streams if n.startswith("spgemm-flush")}
        off = [n for n, st in streams if st != caller]
        if off or not flush_threads:
            raise AssertionError(f"service cli: flushes on another stream "
                                 f"{off}, flush threads {flush_threads}")
        engines = {}
        for r in service.completed:
            if r.result.device != service.device:
                raise AssertionError(f"service cli: request {r.id} result "
                                     f"on {r.result.device}")
            single = spgemm(r.A, r.B, engine=r.engine)
            if not _csr_equal(np, csr_to_numpy(r.result),
                              csr_to_numpy(single)):
                raise AssertionError(f"service cli: request {r.id} differs "
                                     f"from spgemm(engine={r.engine!r})")
            engines[r.engine] = engines.get(r.engine, 0) + 1
        out["cli"] = dict(
            req_per_s=steady["req_per_s"], wall_s=res["wall_s"],
            warm_s=res["warm_s"], p50_ms=steady["p50_latency_s"] * 1e3,
            p99_ms=steady["p99_latency_s"] * 1e3,
            plan_hit_rate=steady["plan_hit_rate"],
            warm_hit_rate=steady["warm_hit_rate"],
            flushes=len(service.flush_log),
            mean_flush_ms=res["all"]["mean_flush_wall_s"] * 1e3,
            launches=part)
        log(f"service: cli 200 requests (--warm, 2 flush threads) in "
            f"{res['wall_s']:.2f} s after a {res['warm_s']:.2f} s prewarm | "
            f"steady {steady['req_per_s']:.1f} req/s, p50 "
            f"{out['cli']['p50_ms']:.2f} ms, p99 {out['cli']['p99_ms']:.2f} "
            f"ms, plan hit rate {steady['plan_hit_rate']:.3f}, warm hit rate "
            f"{steady['warm_hit_rate']:.3f} | {len(service.flush_log)} "
            f"flushes, mean {out['cli']['mean_flush_ms']:.2f} ms, all "
            f"planned, engines {engines} | every result bit-identical to its "
            f"single call | {len(streams)} flushes and warms, "
            f"{len(flush_threads)} flush threads, all on the caller's stream "
            f"| launches {part}")

        # 2. a full-size bucket
        reqs = [mats[SERVICE_FULL[i % 2]] for i in range(8)]
        lanes = [reqs[i] for i in range(4)]
        want_expand, want_large = _work_buckets(np.concatenate(
            [sg.row_work(A, A) for A in lanes]))
        singles_expand = 2 * sum(_bucket_counts(np, mats[n])[0]
                                 for n in SERVICE_FULL)
        out["full"] = {}
        for engine in ("spz", "auto"):
            service = svc.SpGemmService(
                max_batch=4, flush_timeout=1e9, engine=engine,
                cache=dp.AutotuneCache(os.path.join(tmp, f"full-{engine}")))
            kb.reset_launch_counts()
            got = [service.submit(A, A) for A in reqs]
            torch.cuda.synchronize()
            part = _service_counts(kb)
            _add_counts(out["counts"], part)
            flushes = service.flush_log
            if len(flushes) != 2 or any(
                    (f.n_requests, f.reason, f.tier) != (4, "full", "planned")
                    for f in flushes) or not all(r.done for r in got):
                raise AssertionError(f"service full {engine}: {flushes}")
            for r, n in zip(got, [SERVICE_FULL[i % 2] for i in range(8)]):
                single = fused[n][0] if r.engine == "spz" else csr_to_numpy(
                    spgemm(r.A, r.B, engine=r.engine))
                if not _csr_equal(np, csr_to_numpy(r.result), single):
                    raise AssertionError(f"service full {engine}: request "
                                         f"{r.id} ({n}) differs from its "
                                         f"single call")
            row = dict(engine=flushes[0].engine,
                       flush_ms=[f.wall_s * 1e3 for f in flushes],
                       launches=part)
            if engine == "spz":
                per = {k: v // 2 for k, v in part.items()}
                if (per.get("fused_bucket.expand"), per.get(
                        "fused_bucket.large")) != (want_expand, want_large) \
                        or not per.get("chunk_sort") \
                        or not per.get("merge_partitions"):
                    raise AssertionError(
                        f"service full spz: per flush {per}, the batch's "
                        f"bucketing gives {want_expand} expand and "
                        f"{want_large} large (singles' sum {singles_expand})")
                Ab = batch_csr(lanes, nnz_cap=flushes[0].bucket[2],
                               batch_cap=4).to(service.device)
                sp = shard.plan_sharded(Ab, Ab, "spz", cache=service.cache)
                _, st = shard.execute_sharded(sp, Ab, Ab, return_stats=True)
                _, bst = dp.execute_batched(sp.base, Ab, Ab,
                                            return_stats=True)
                stats = [getattr(st, f) for f in FIELDS]
                if stats != [getattr(bst, f) for f in FIELDS]:
                    raise AssertionError(f"service full spz: SpzStats "
                                         f"{stats} vs execute_batched "
                                         f"{[getattr(bst, f) for f in FIELDS]}")
                sums = [2 * sum(fused[n][1][j] for n in SERVICE_FULL)
                        for j in (1, 3)]
                if [st.sort_elems, st.zip_elems] != sums:
                    raise AssertionError(f"service full spz: sort/zip elems "
                                         f"{st.sort_elems}/{st.zip_elems}, "
                                         f"the singles' sums {sums}")
                prof = _profiled(torch, "service full-size spz flush",
                                 lambda: shard.execute_sharded(sp, Ab, Ab))
                row.update(per_flush=per, singles_expand=singles_expand,
                           stats=dict(zip(FIELDS, stats)),
                           idle=(1 - prof["busy"] / prof["wall"]
                                 if prof else None))
            out["full"][engine] = row
            log(f"service: full-size bucket {engine} -> {row['engine']}: 2 "
                f"flushes of 4 lanes ({' / '.join(SERVICE_FULL)}) in "
                + ", ".join(f"{t:.1f}" for t in row["flush_ms"])
                + " ms | every lane bit-identical to its single call | "
                f"launches {part}"
                + (f" | per flush {want_expand} K3 expand (the batch's "
                   f"bucketing; singles' sum {singles_expand}), "
                   f"{want_large} large on K1 + K2 | SpzStats = "
                   f"execute_batched's: {row['stats']}" if engine == "spz"
                   else ""))

        # 3. spz-host on the stand-ins
        service = svc.SpGemmService(
            max_batch=len(HOST_BATCH), flush_timeout=1e9, engine="spz-host",
            cache=dp.AutotuneCache(os.path.join(tmp, "host.json")))
        kb.reset_launch_counts()
        got = [service.submit(mats[n], mats[n]) for n in HOST_BATCH]
        service.drain()
        torch.cuda.synchronize()
        part = _service_counts(kb)
        _add_counts(out["counts"], part)
        for r, n in zip(got, HOST_BATCH):
            if r.tier != "planned" or not _csr_equal(
                    np, csr_to_numpy(r.result), fused[n][0]):
                raise AssertionError(f"service spz-host: {n} {r.tier}")
        if not part.get("stream_sort") or not part.get("stream_merge.pointer"):
            raise AssertionError(f"service spz-host: launches {part}")
        out["host"] = dict(flushes=len(service.flush_log), launches=part,
                           flush_ms=[f.wall_s * 1e3
                                     for f in service.flush_log])
        log(f"service: spz-host on {len(HOST_BATCH)} stand-ins, "
            f"{len(service.flush_log)} flushes, every result bit-identical "
            f"to spz | launches {part}")

        # 4. chaos
        res = cli.run(["--requests", "100", "--inject-rate", "0.1",
                       "--kill-worker", "0", "--chaos-seed", "0", "--cache",
                       os.path.join(tmp, "chaos.json")])
        service = res["service"]
        unresolved = [i for i in range(100) if not service.lookup(i).done]
        tiers = {f.tier for f in service.flush_log}
        engines = {f.engine for f in service.flush_log}
        if unresolved or not tiers <= set(CARD_TIERS) or \
                engines & {"scl-array", "scl-hash", "?"}:
            raise AssertionError(f"service chaos: unresolved {unresolved}, "
                                 f"tiers {tiers}, engines {engines}")
        out["chaos"] = dict(availability=res["all"]["availability"],
                            tiers=sorted(tiers), engines=sorted(engines),
                            dead=len(service.dead_letters))
        log(f"service: chaos 100 requests, availability "
            f"{res['all']['availability']:.4f}, every id resolved, tiers "
            f"{sorted(tiers)}, engines {sorted(engines)}")
        A = mats["p2p"]
        want_esc = csr_to_numpy(spgemm(A, A, engine="esc"))
        for match, tier in (({"engine": "esc"}, "degraded:spz-fused/cuda"),
                            ({}, "isolated")):
            service = svc.SpGemmService(
                max_batch=2, flush_timeout=1e9, engine="esc",
                policy=dp.RetryPolicy(sleep=lambda s: None),
                cache=dp.AutotuneCache(os.path.join(tmp, f"{tier}.json")))
            with fi.injected(fi.FaultSpec(site="kernel.batched",
                                          match=match)):
                reqs = [service.submit(A, A) for _ in range(2)]
            f = service.flush_log[-1]
            want = fused["p2p"][0] if tier.startswith("degraded") \
                else want_esc
            if f.tier != tier or f.engine != ("spz-fused" if match
                                              else "esc") or not all(
                    _csr_equal(np, csr_to_numpy(r.result), want)
                    and r.result.device == service.device for r in reqs):
                raise AssertionError(f"service ladder: {f}")
            log(f"service: every batched launch of {match or 'any engine'} "
                f"failing -> {f.tier} on {f.engine} after {f.attempts} "
                f"attempts, results bit-identical and on the card")
        for async_flushes in (0, 2):
            fault = fi.FaultSpec(
                site="kernel.batched", exc_factory=lambda site, ctx:
                _build.KernelLaunchError(f"{site}: injected launch error"))
            service = svc.SpGemmService(
                max_batch=8, flush_timeout=1e9, async_flushes=async_flushes,
                cache=dp.AutotuneCache(os.path.join(
                    tmp, f"launch-{async_flushes}.json")))
            try:
                with fi.injected(fault):
                    reqs = [service.submit(A, A) for _ in range(3)]
                    service.drain()
            except _build.KernelLaunchError:
                pass
            else:
                raise AssertionError("service: a kernel launch error was "
                                     "served")
            finally:
                service.close()
            if fault.fires != 1 or service.dead_letters or \
                    service.flush_log or any(r.done for r in reqs):
                raise AssertionError(
                    f"service: launch error fired {fault.fires} times, "
                    f"{len(service.dead_letters)} dead letters, "
                    f"{len(service.flush_log)} flushes")
        log("service: an injected KernelLaunchError raised out of drain, "
            "inline and from a flush thread, after 1 attempt: nothing "
            "retried, degraded or dead-lettered")
    finally:
        shard.execute_sharded = execute_sharded
        shutil.rmtree(tmp, ignore_errors=True)
    _launched(out["counts"], ("chunk_sort", "merge_partitions",
                              "fused_bucket", "stream_sort", "stream_merge"),
              "service")
    log(f"service: the service path's launches {out['counts']}")
    return out


POOL_WORKERS = 2
POOL_PIPE_BYTES = 32 << 20   # the pipe probe's message (int32s)
# SuiteSparse-scale matrices no sweep saw (hub-full shares cage11-full's
# cache key)
LEARNED_NEW = ("cage11-full", "email-Enron-full")
# independent autotune sweeps whose timings train the model: each
# (key, combo) sample is the median of this many timings, each from one
# call (``dispatch._measure``'s repeat of 1, which ``plan`` keeps), so one
# noisy call does not set a sample
LEARNED_SWEEPS = 3
# the CPU test's tolerances (tests/test_torch_learned_dispatch.py): a
# model trained on the same samples, card against CPU
W_ATOL, BIAS_ATOL, SIGMA_ATOL, CONF_ATOL = 2e-2, 1e-3, 1e-3, 1e-2
PRED_ATOL = 1e-2            # predicted log-runtime, every sample and combo
# a direction of weight space is flat to the samples where the
# standardised features' singular value along it is below this share of
# the largest: rounding moves Adam's normalised step along it freely
# (the fit runs in float64 to keep that small), since the loss barely
# changes there.  W_ATOL holds the weight difference's projection onto
# the other directions
FLAT_SHARE = 0.05


def _flush_groups(service):
    """The pool's flushes as request lists: the requests of one flush
    landed together (one bucket, one landing time, one engine)."""
    groups = {}
    for r in service.completed:
        groups.setdefault((r.bucket, r.t_done, r.engine), []).append(r)
    return list(groups.values())


def _affine_bucket(coord, svc, random_sparse, worker, n_workers):
    """A small request whose pad bucket's rendezvous owner among
    ``n_workers`` live workers is ``worker``."""
    for n in range(40, 200):
        A = random_sparse(n, n, 0.05, seed=n)
        key = svc.bucket_key(A, A)
        if max(range(n_workers),
               key=lambda w: coord._hrw(repr(key), w)) == worker:
            return A, key
    raise AssertionError(f"no bucket owned by worker {worker}")


def _pipe_send(conn, n_bytes):
    """Child of ``_pipe_rate``: send ``n_bytes`` of int32 over ``conn``."""
    import numpy as np
    x = np.arange(n_bytes // 4, dtype=np.int32)
    conn.send("ready")
    conn.send(x)
    conn.close()


def _pipe_rate(coord, widened):
    """Seconds and MiB/s of ``POOL_PIPE_BYTES`` sent from a spawned
    process to this one over a pipe like a worker's, with the kernel's
    default socket buffers or widened as ``coordinator._widen`` widens
    every worker pipe."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    mine, theirs = ctx.Pipe()
    if widened:
        for c in (mine, theirs):
            coord._widen(c)
    proc = ctx.Process(target=_pipe_send, args=(theirs, POOL_PIPE_BYTES))
    proc.start()
    theirs.close()
    try:
        if not mine.poll(60.0) or mine.recv() != "ready":
            raise AssertionError("pool pipe: the sender did not start")
        t0 = time.perf_counter()
        x = mine.recv()
        sec = time.perf_counter() - t0
        if x.nbytes != POOL_PIPE_BYTES or int(x[-1]) != x.size - 1:
            raise AssertionError(f"pool pipe: received {x.nbytes} bytes")
    finally:
        proc.join(30.0)
        if proc.is_alive():
            proc.kill()
            proc.join()
    return {"s": sec, "mib_per_s": POOL_PIPE_BYTES / 2**20 / sec}


def phase_pool(torch, np, mats, fused):
    """Multi-process SpGEMM serving on the one card: a
    ``ProcessCoordinator`` of two spawned workers, both on cuda:0
    (``remesh_lanes(1, 2)``), every flush run by a worker's local service
    and its result unpacked on the caller's card.  Each check runs after
    its path:

    1. one pool (startup timed; worker 0 armed to SIGKILL itself in the
       flush of one small bucket it owns, every worker armed with a
       ``KernelLaunchError`` at the batched launch of a 3-request esc
       flush):
       the full-size ``spz`` bucket, [cage11-full, hub-full] x 2 at
       max_batch 4 — two flushes, every lane bit-identical to its single
       call (the in-process flush of phase ``service`` equals the same
       singles), each flush record carrying the worker's launches: K3's
       expand entry as the batch's bucketing gives (1,136), 2 large
       buckets on K1 + K2; spz-host on the six stand-ins (K4, K5);
    2. the kill: every request resolves bit for bit its engine's single
       call, and ``worker_lost`` (with the orphaned task), ``restart``
       and ``remesh`` appear;
    3. the kernel error: it raises out of the parent's ``drain`` naming
       the worker, answered once — nothing re-dispatched, dead-lettered
       or served by this process's ladder — and the worker is reaped and
       respawned;
    4. the CLI's 200 requests (``--warm``) inline, on two flush threads
       and on ``--workers 2``: req/s, p50, p99; every pool result equal
       bit for bit to the in-process service's on the same flush (the
       same requests, landed together, through an inline service of the
       same engine);
    5. the pipe under the pool: 32 MiB from a spawned process to this
       one, over the default socket buffers and over widened ones, as
       every worker pipe is widened (the full-size flush's results are
       ~246 MiB).
    The pool's launches (``pool_launches``) are the workers' flush
    records' sums."""
    import shutil
    import tempfile

    from repro_torch.core import dispatch as dp
    from repro_torch.core import spgemm
    from repro_torch.core import spgemm_engines as sg
    from repro_torch.core.formats import csr_to_numpy, random_sparse
    from repro_torch.kernels import _build
    from repro_torch.launch import serve_spgemm as cli
    from repro_torch.runtime import coordinator as coord
    from repro_torch.runtime import faultinject as fi
    from repro_torch.serving import spgemm_service as svc

    out = {"counts": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pool_")
    torch.cuda.empty_cache()  # leave the card's memory to the workers
    kill_A, kill_bucket = _affine_bucket(coord, svc, random_sparse, 0,
                                         POOL_WORKERS)
    err_A = random_sparse(48, 48, 0.05, seed=7)
    # the pool's only esc flush of 3 lanes is step 3's
    err = fi.FaultSpec(site="kernel.batched",
                       match={"engine": "esc", "lanes": 3},
                       exc_factory=_build.KernelLaunchError)
    specs = {0: [fi.FaultSpec(site="service.flush", kind="kill_process",
                              match={"bucket": kill_bucket}, max_fires=1),
                 err],
             1: [err]}
    pool = None
    try:
        t0 = time.perf_counter()
        pool = coord.ProcessCoordinator(
            POOL_WORKERS, cache_path=os.path.join(tmp, "pool.json"),
            fault_specs=specs, max_worker_restarts=2)
        out["start_s"] = time.perf_counter() - t0
        spawns = [e for e in pool.events if e["event"] == "spawn"]
        if len(spawns) != POOL_WORKERS or pool.n_lanes != 1 or any(
                e["n_lanes"] != 1 for e in spawns):
            raise AssertionError(f"pool start: {pool.events}")
        log(f"pool: {POOL_WORKERS} workers on {pool.devices} started in "
            f"{out['start_s']:.2f} s (each: spawn, torch import, CUDA "
            f"context, kb.load) | lanes {pool._partition(POOL_WORKERS)}")

        def pool_service(**kw):
            return svc.SpGemmService(flush_timeout=1e9, coordinator=pool,
                                     cache=dp.AutotuneCache(pool.cache_path),
                                     policy=dp.RetryPolicy(
                                         backoff_base_s=0.0), **kw)

        # 1. the full-size bucket, then spz-host on the stand-ins
        reqs = [mats[SERVICE_FULL[i % 2]] for i in range(8)]
        want_expand, want_large = _work_buckets(np.concatenate(
            [sg.row_work(A, A) for A in reqs[:4]]))
        service = pool_service(max_batch=4, engine="spz")
        got = [service.submit(A, A) for A in reqs]
        service.drain(timeout=300.0)
        flushes = service.flush_log
        if len(flushes) != 2 or any(
                (f.n_requests, f.reason, f.tier, f.engine) !=
                (4, "full", "planned", "spz") for f in flushes) or \
                service.dead_letters or not all(r.done for r in got):
            raise AssertionError(f"pool full: {flushes}")
        for r, n in zip(got, [SERVICE_FULL[i % 2] for i in range(8)]):
            if r.result.device != service.device or not _csr_equal(
                    np, csr_to_numpy(r.result), fused[n][0]):
                raise AssertionError(f"pool full: request {r.id} ({n}) "
                                     f"differs from the in-process flush")
        for f in flushes:
            _add_counts(out["counts"], f.launches)
            got_l = (f.launches.get("fused_bucket.expand"),
                     f.launches.get("fused_bucket.large"))
            if got_l != (want_expand, want_large) or \
                    not f.launches.get("chunk_sort") or \
                    not f.launches.get("merge_partitions"):
                raise AssertionError(
                    f"pool full: a flush's launches {f.launches}, the "
                    f"batch's bucketing gives {want_expand} expand and "
                    f"{want_large} large")
        out["full"] = dict(flush_ms=[f.wall_s * 1e3 for f in flushes],
                           attempts=[f.attempts for f in flushes],
                           launches=flushes[0].launches)
        log(f"pool: full-size spz bucket ({' / '.join(SERVICE_FULL)} x 2) "
            f"in 2 flushes, " + ", ".join(f"{t:.1f}" for t in
                                          out["full"]["flush_ms"])
            + f" ms dispatch to landing, attempts "
            f"{out['full']['attempts']}, errors "
            f"{[f.errors for f in flushes]} | every lane bit-identical to "
            f"the in-process flush | a worker's launches per flush "
            f"{flushes[0].launches}")
        service = pool_service(max_batch=len(HOST_BATCH), engine="spz-host")
        got = [service.submit(mats[n], mats[n]) for n in HOST_BATCH]
        service.drain(timeout=300.0)
        for r, n in zip(got, HOST_BATCH):
            if r.tier != "planned" or not _csr_equal(
                    np, csr_to_numpy(r.result), fused[n][0]):
                raise AssertionError(f"pool spz-host: {n} {r.tier}")
        host = {}
        for f in service.flush_log:
            _add_counts(host, f.launches)
        _add_counts(out["counts"], host)
        if not host.get("stream_sort") or not host.get("stream_merge.pointer"):
            raise AssertionError(f"pool spz-host: launches {host}")
        log(f"pool: spz-host on {len(HOST_BATCH)} stand-ins, "
            f"{len(service.flush_log)} flushes, every result bit-identical "
            f"to spz | the workers' launches {host}")

        # 2. SIGKILL mid-flush in worker 0
        n_events = len(pool.events)
        service = pool_service(max_batch=2)
        got = [service.submit(kill_A, kill_A) for _ in range(2)]
        service.drain(timeout=300.0)
        events = pool.events[n_events:]
        names = [e["event"] for e in events]
        lost = [e for e in events if e["event"] == "worker_lost"]
        if not all(r.done and not r.failed for r in got) or \
                service.stats()["availability"] != 1.0 or \
                names[:4] != ["worker_lost", "spawn", "restart", "remesh"] \
                or lost[0]["worker"] != 0 or not lost[0]["orphans"]:
            raise AssertionError(f"pool kill: {events}, "
                                 f"{[r.tier for r in got]}")
        for r in got:
            if not _csr_equal(np, csr_to_numpy(r.result), csr_to_numpy(
                    spgemm(kill_A, kill_A, engine=r.engine))):
                raise AssertionError(f"pool kill: request {r.id} differs "
                                     f"from engine={r.engine!r}")
        for f in service.flush_log:
            _add_counts(out["counts"], f.launches)
        log(f"pool: worker 0 SIGKILLed in a flush of bucket {kill_bucket} "
            f"-> {names} ({lost[0]['why']}, orphans {lost[0]['orphans']}) | "
            f"availability 1.0, results bit-identical to engine="
            f"{got[0].engine!r} on {got[0].tier}")

        # 3. a kernel launch error in a worker
        n_events = len(pool.events)
        service = pool_service(max_batch=3, engine="esc")
        got = [service.submit(err_A, err_A) for _ in range(3)]
        try:
            service.drain(timeout=300.0)
        except _build.KernelLaunchError as e:
            message = str(e)
        else:
            raise AssertionError("pool: a worker's kernel launch error was "
                                 "served")
        events = pool.events[n_events:]
        names = [e["event"] for e in events]
        if not message.startswith("worker ") or names != [
                "task_error", "worker_lost", "spawn", "restart", "remesh"] \
                or events[1]["orphans"] or any(r.done for r in got) or \
                service.flush_log or service.dead_letters or \
                pool.in_flight or pool.alive_count != POOL_WORKERS:
            raise AssertionError(f"pool kernel error: {message!r}, {events}")
        log(f"pool: an injected KernelLaunchError in a worker raised out of "
            f"drain ({message[:60]}...), answered once: {names}, nothing "
            f"re-dispatched, dead-lettered or served here")
    finally:
        if pool is not None:
            pool.shutdown()

    # 4. the CLI's traffic: inline, two flush threads, two workers
    out["cli"] = {}
    try:
        for label, extra in (("inline", []),
                             ("async 2", ["--async-flushes", "2"]),
                             ("workers 2", ["--workers",
                                            str(POOL_WORKERS)])):
            res = cli.run(["--requests", "200", "--warm", "--cache",
                           os.path.join(tmp, f"cli-{label[0]}.json")]
                          + extra)
            service, steady = res["service"], res["steady"]
            if res["all"]["n_requests"] != 200 or \
                    res["all"].get("availability") != 1.0 or \
                    {f.tier for f in service.flush_log} != {"planned"}:
                raise AssertionError(f"pool cli {label}: {res['all']}")
            row = dict(req_per_s=steady["req_per_s"],
                       p50_ms=steady["p50_latency_s"] * 1e3,
                       p99_ms=steady["p99_latency_s"] * 1e3,
                       wall_s=res["wall_s"], warm_s=res["warm_s"],
                       flushes=len(service.flush_log),
                       plan_hit_rate=steady["plan_hit_rate"])
            if res["pool"] is not None:
                row["start_s"] = res["pool"]["start_s"]
                launches = {}
                for f in service.flush_log:
                    _add_counts(launches, f.launches)
                _add_counts(out["counts"], launches)
                row["launches"] = launches
                # the in-process service on the same flushes: the same
                # requests landed together, one inline service per engine
                inline = {}
                for grp in _flush_groups(service):
                    eng = grp[0].engine
                    if eng not in inline:
                        inline[eng] = svc.SpGemmService(
                            max_batch=8, flush_timeout=1e9, engine=eng,
                            cache=dp.AutotuneCache(os.path.join(
                                tmp, f"replay-{eng}.json")))
                    mine = [inline[eng].submit(r.A, r.B) for r in grp]
                    inline[eng].drain()
                    for r, m in zip(grp, mine):
                        if m.engine != eng or not _csr_equal(
                                np, csr_to_numpy(r.result),
                                csr_to_numpy(m.result)):
                            raise AssertionError(
                                f"pool cli: request {r.id} differs from the "
                                f"in-process flush on {eng}")
                row["replayed_flushes"] = len(_flush_groups(service))
            out["cli"][label] = row
            log(f"pool: cli 200 requests --warm, {label}: steady "
                f"{row['req_per_s']:.1f} req/s, p50 {row['p50_ms']:.2f} ms, "
                f"p99 {row['p99_ms']:.2f} ms, plan hit rate "
                f"{row['plan_hit_rate']:.3f} | {row['flushes']} flushes, "
                f"wall {row['wall_s']:.2f} s after a {row['warm_s']:.2f} s "
                f"prewarm"
                + (f" | pool started in {row['start_s']:.2f} s, every result "
                   f"bit-identical to the in-process service on the same "
                   f"{row['replayed_flushes']} flushes | the workers' "
                   f"launches {row['launches']}" if "start_s" in row
                   else ""))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 5. the pipe under the pool
    out["pipe"] = {k: _pipe_rate(coord, k == "widened")
                   for k in ("default", "widened")}
    log("pool: pipe, 32 MiB from a spawned process: " + ", ".join(
        f"{k} socket buffers {v['s']:.3f} s ({v['mib_per_s']:.1f} MiB/s)"
        for k, v in out["pipe"].items()))
    _launched({k: out["counts"].get(k, 0) for k in (
        "chunk_sort", "merge_partitions", "fused_bucket", "stream_sort",
        "stream_merge")}, ("chunk_sort", "merge_partitions", "fused_bucket",
                           "stream_sort", "stream_merge"), "pool")
    log(f"pool: the pool path's launches (in the workers) {out['counts']}")
    return out


def _weight_split(np, dm, card, cpu, samples):
    """The largest |card.w - cpu.w| on the directions the samples
    determine and on the flat ones, and the standardised features'
    singular values.  Each candidate's weights are fit on the samples
    that timed it: its difference is split along the right singular
    vectors of those samples' standardised features (``FLAT_SHARE``)."""
    samples = [s for s in samples if s.get("timings") and s.get("features")]
    X = np.stack([dm.featurize(s["features"]) for s in samples])
    Z = (X - card.mean) / card.std
    seen = flat = 0.0
    sv = None
    for j, c in enumerate(card.candidates):
        rows = [i for i, s in enumerate(samples) if c in s["timings"]]
        _, S, Vt = np.linalg.svd(Z[rows], full_matrices=False)
        if sv is None or len(rows) == len(samples):
            sv = [float(x) for x in S]
        keep = S >= FLAT_SHARE * S[0]
        d = card.w[j] - cpu.w[j]
        on = Vt[keep].T @ (Vt[keep] @ d)
        seen = max(seen, float(np.abs(on).max()))
        flat = max(flat, float(np.abs(d - on).max()))
    return seen, flat, sv


def _median_samples(sweeps):
    """The training samples of several sweeps over the same operands:
    each key's features and, for every combo timed in every sweep, the
    median of its timings.  Also the spread of the timings: the median
    and largest log(max / min) over the (key, combo) pairs."""
    by_key = [{s["key"]: s for s in sw} for sw in sweeps]
    samples, logs = [], []
    for key in sorted(set.intersection(*(set(b) for b in by_key))):
        runs = [b[key]["timings"] for b in by_key]
        timings = {}
        for c in sorted(set.intersection(*(set(r) for r in runs))):
            ts = [r[c] for r in runs]
            timings[c] = statistics.median(ts)
            logs.append(math.log(max(ts) / min(ts)))
        if timings:
            samples.append({"key": key, "features": by_key[0][key]["features"],
                            "timings": timings})
    return samples, {"median": statistics.median(logs) if logs else 0.0,
                     "max": max(logs, default=0.0)}


def phase_learned(torch, np, mats):
    """The learned dispatch rung on the card:

    1. LEARNED_SWEEPS independent autotune sweeps (``autotune=True``:
       every combo measurable on the card) over the CLI's traffic (200
       requests, seed 0) and the 13 stand-ins, one operand per cache key,
       each on a temporary cache of its own: each entry a timing vector
       of card combos; the samples are each key's median timing of each
       combo over the sweeps (:func:`_median_samples`);
    2. the dispatch model trained on the card from those samples, and on
       the CPU from the same samples: every predicted log-runtime,
       bias, sigma and confidence within the CPU test's tolerances, the
       same pick on every sample (a tie within twice ``PRED_ATOL`` is
       counted, as in 3), and the weights' difference within
       the CPU test's weight tolerance on the directions the samples
       determine (its part on the flat ones logged);
    3. the card's artifact beside a fresh cache: ``plan(A, A)`` on new
       operands (the CLI's traffic at seed 1 and two SuiteSparse-scale
       matrices, one operand per key) takes ``source="model"``
       exactly where ``explain`` calls the model confident, at least
       once, never on an engine that computes on the host, and
       ``execute`` equals that engine's direct call bit for bit; on
       each of them the card's and the CPU's model agree within
       ``PRED_ATOL`` on every log-cost and pick the same card engine
       (a tie within twice that is counted);
    4. the µs of a plan through the model rung, cold and on a memo hit,
       beside the heuristic table's (no artifact), on the same operands
       (the medians over the plans each source made)."""
    import shutil
    import tempfile

    from repro_torch.core import dispatch as dp
    from repro_torch.core.formats import csr_to_numpy
    from repro_torch.data import table3
    from repro_torch.launch import serve_spgemm as cli
    from repro_torch.models import dispatch_model as dm

    def per_key(ops):
        """The first operand of each cache key (A·A requests)."""
        seen = {}
        for A in ops:
            seen.setdefault(dp.cache_key(A, A), A)
        return list(seen.values())

    def traffic(seed):
        return [A for A, _ in cli.make_traffic(200, seed=seed)]

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_learned_")
    saved = dp._default_cache
    try:
        # 1. sweeps, each on a cache of its own
        swept = per_key(traffic(0) + [mats[n] for n in table3.names()])
        t0 = time.perf_counter()
        sweeps = []
        for i in range(LEARNED_SWEEPS):
            cache = dp.AutotuneCache(os.path.join(tmp, f"sweep{i}.json"))
            for A in swept:
                p = dp.plan(A, A, autotune=True, cache=cache, model=False)
                combos = set(cache.get(p.cache_key).get("timings", {}))
                if p.source != "autotune" or not combos or any(
                        c.endswith("|torch") for c in combos):
                    raise AssertionError(f"learned sweep: {p.source} "
                                         f"{combos}")
            sweeps.append(dm.samples_from_entries(cache.entries()))
        out["sweep_s"] = time.perf_counter() - t0
        samples, spread = _median_samples(sweeps)
        combos = sorted({c for s in samples for c in s["timings"]})
        winners = {}
        for s in samples:
            w = min(s["timings"], key=s["timings"].get)
            winners[w] = winners.get(w, 0) + 1
        out["timing_spread"] = spread
        log(f"learned: {LEARNED_SWEEPS} autotune sweeps of {len(swept)} "
            f"operands (the CLI traffic's keys and the stand-ins) in "
            f"{out['sweep_s']:.1f} s; {len(samples)} samples, each timing "
            f"the median of {LEARNED_SWEEPS} | median |log(max / min)| "
            f"of a (key, combo)'s timings over the sweeps "
            f"{spread['median']:.4f}, largest {spread['max']:.4f} | combos "
            f"{combos} | winners {winners}")

        # 2. train on the card and on the CPU
        t0 = time.perf_counter()
        card = dm.DispatchModel.train(samples)
        torch.cuda.synchronize()
        out["train_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = dm.DispatchModel.train(samples, device="cpu")
        out["train_cpu_s"] = time.perf_counter() - t0
        dw = float(np.abs(card.w - cpu.w).max())
        dw_seen, dw_flat, sv = _weight_split(np, dm, card, cpu, samples)
        db = float(np.abs(card.bias - cpu.bias).max())
        dp_ = max(abs(math.log(card.predict(s["features"])[c])
                      - math.log(cpu.predict(s["features"])[c]))
                  for s in samples for c in card.candidates)
        ds = abs(card.sigma - cpu.sigma)
        dc = 0.0
        n_ties_seen = 0
        for s in samples:
            a, b = card.select(s["features"]), cpu.select(s["features"])
            if a.combo != b.combo:
                # the same rule as on new operands below: the picks may
                # differ only where the card's two best log-costs lie
                # within the two models' tolerance of each other
                two = sorted(math.log(t) for t in a.costs.values())[:2]
                if len(two) < 2 or two[1] - two[0] > 2 * PRED_ATOL:
                    raise AssertionError(
                        f"learned: card picks {a.combo}, CPU {b.combo} on "
                        f"{s['key']} (log-cost gap "
                        f"{two[1] - two[0] if len(two) == 2 else None})")
                n_ties_seen += 1
            dc = max(dc, abs(a.confidence - b.confidence))
        if card.candidates != cpu.candidates or dp_ > PRED_ATOL or \
                db > BIAS_ATOL or ds > SIGMA_ATOL or dc > CONF_ATOL or \
                dw_seen > W_ATOL or not np.array_equal(card.mean, cpu.mean) \
                or not np.array_equal(card.std, cpu.std):
            raise AssertionError(f"learned: card vs CPU model |dpred| {dp_}"
                                 f", |db| {db}, |dsigma| {ds}, |dconf| {dc}"
                                 f", |dw| seen {dw_seen} flat {dw_flat}")
        out.update(dw=dw, dw_seen=dw_seen, dw_flat=dw_flat,
                   singular_values=sv, dpred=dp_, db=db, dsigma=ds,
                   dconf=dc, sigma=card.sigma, candidates=card.candidates,
                   ties_seen=n_ties_seen)
        log(f"learned: sigma {card.sigma:.4f} (model trained on the "
            f"median timings of {LEARNED_SWEEPS} sweeps)")
        log(f"learned: trained on the card in {out['train_card_s']:.2f} s "
            f"(CPU {out['train_cpu_s']:.2f} s), sigma {card.sigma:.4f}, "
            f"loss {card.train_loss:.5f} | card vs CPU: |dlog-cost| "
            f"{dp_:.2e} (limit {PRED_ATOL}), |dbias| {db:.2e}, |dsigma| "
            f"{ds:.2e}, |dconf| {dc:.2e}, the same pick on "
            f"{len(samples) - n_ties_seen} of {len(samples)} samples, "
            f"{n_ties_seen} ties within {2 * PRED_ATOL} in log-cost | "
            f"|dw| {dw:.2e}: {dw_seen:.2e} on "
            f"the directions the samples determine (limit {W_ATOL}), "
            f"{dw_flat:.2e} on the flat ones (singular value < "
            f"{FLAT_SHARE} x the largest; the standardised features' "
            f"singular values {[round(x, 4) for x in sv]})")

        # 3. plan on new operands beside a fresh cache: the CLI's traffic
        # at another seed, where the engines' times lie close, and the
        # SuiteSparse-scale matrices, which no sweep saw
        new_ops = per_key(traffic(1) + [mats[n] for n in LEARNED_NEW])
        fresh = dp.AutotuneCache(os.path.join(tmp, "fresh.json"))
        card.save(dp.model_path_for(fresh))
        n_model = n_other = n_ties = 0
        engines = {}
        dp_new = 0.0
        for A in new_ops:
            info = dp.explain(A, A, cache=fresh)["model"]
            p = dp.plan(A, A, cache=fresh)
            confident = bool(info and info["confident"])
            if confident != (p.source == "model"):
                raise AssertionError(f"learned: plan source {p.source}, "
                                     f"explain {info}")
            # the card's and the CPU's model on this operand: every
            # log-cost within PRED_ATOL, and the same pick among the
            # card's candidates unless the card's two best lie within
            # the two models' tolerance of each other
            feats = dp.extract_features(A, A)
            pc, pu = card.predict(feats), cpu.predict(feats)
            dp_new = max(dp_new, max(abs(math.log(pc[c]) - math.log(pu[c]))
                                     for c in card.candidates))
            allowed = dp._model_candidates(dp.cache_key(A, A), "auto",
                                           fresh, "cuda")
            a, b = card.select(feats, allowed), cpu.select(feats, allowed)
            if (a is None) != (b is None):
                raise AssertionError(f"learned: card {a}, CPU {b}")
            if a is not None and a.combo != b.combo:
                two = sorted(math.log(t) for t in a.costs.values())[:2]
                if len(two) < 2 or two[1] - two[0] > 2 * PRED_ATOL:
                    raise AssertionError(
                        f"learned: on a new operand the card picks "
                        f"{a.combo}, the CPU {b.combo}")
                n_ties += 1
            if not confident:
                n_other += 1
                continue
            n_model += 1
            engines[p.engine] = engines.get(p.engine, 0) + 1
            if dp.get_engine(p.engine).on_host:
                raise AssertionError(f"learned: the model planned the host "
                                     f"engine {p.engine} on the card")
            got = dp.execute(p, A, A)
            want = dp.spgemm(A, A, engine=p.engine,
                             **({"backend": p.backend} if p.backend else {}))
            if not _csr_equal(np, csr_to_numpy(got), csr_to_numpy(want)):
                raise AssertionError(f"learned: model plan {p.engine} "
                                     f"differs from its direct call")
        if not n_model:
            raise AssertionError("learned: the model was never confident")
        if dp_new > PRED_ATOL:
            raise AssertionError(f"learned: on the new operands the card's "
                                 f"and the CPU's model differ by {dp_new} "
                                 f"in a log-cost")
        out.update(n_model=n_model, n_other=n_other, engines=engines,
                   dpred_new=dp_new, ties_new=n_ties)
        log(f"learned: {len(new_ops)} new operands, {n_model} planned by "
            f"the model (engines {engines}, none on the host), {n_other} "
            f"below the confidence floor (heuristic) | every model plan's "
            f"result bit-identical to its engine's direct call | card vs "
            f"CPU model on them: |dlog-cost| {dp_new:.2e} (limit "
            f"{PRED_ATOL}), the same pick on {len(new_ops) - n_ties}, "
            f"{n_ties} ties within {2 * PRED_ATOL} in log-cost")

        # 4. plan µs: the model rung against the table, cold and memo hit,
        # on the operands the model planned
        def plan_us(path, with_model):
            """(source, cold µs, memo-hit µs) of each of ``new_ops``, on
            a default cache of its own (the plan memo keys on it)."""
            dp._default_cache = dp.AutotuneCache(path)
            if with_model:
                card.save(dp.model_path_for(dp._default_cache))
                dp.resolve_model("auto", dp._default_cache)  # load once
            rows = []
            for A in new_ops:
                t0 = time.perf_counter()
                p = dp.plan(A, A)
                cold = (time.perf_counter() - t0) * 1e6
                t0 = time.perf_counter()
                if dp.plan(A, A) is not p:
                    raise AssertionError("learned: second plan not a memo "
                                         "hit")
                rows.append((p.source, cold,
                             (time.perf_counter() - t0) * 1e6))
            return rows

        m_rows = plan_us(os.path.join(tmp, "m.json"), True)
        h_rows = plan_us(os.path.join(tmp, "h.json"), False)
        picked = [i for i, r in enumerate(m_rows) if r[0] == "model"]
        if len(picked) != n_model or any(h_rows[i][0] != "heuristic"
                                         for i in picked):
            raise AssertionError(f"learned: plan sources {m_rows} / "
                                 f"{h_rows}")
        for key, rows in (("model", m_rows), ("heuristic", h_rows)):
            out[f"{key}_cold_us"] = statistics.median(rows[i][1]
                                                      for i in picked)
            out[f"{key}_hit_us"] = statistics.median(rows[i][2]
                                                     for i in picked)
        log(f"learned: plan on the {len(picked)} operands the model "
            f"planned, median: through the model rung "
            f"{out['model_cold_us']:.0f} us cold, {out['model_hit_us']:.1f} "
            f"us memo hit | the heuristic table (no artifact) "
            f"{out['heuristic_cold_us']:.0f} us cold (it writes the cache "
            f"file), {out['heuristic_hit_us']:.1f} us memo hit")
    finally:
        dp._default_cache = saved
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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


def _kernel_name(key: str) -> str:
    """A profiler key's kernel name, without namespace and arguments."""
    return key.replace("(anonymous namespace)::", "").split("(")[0]


def _profiled(torch, label, fn):
    """Run ``fn`` under torch.profiler and log its host wall clock, the
    device's kernel time and idle share, and the top device kernels and
    host operations.  A profiler that records no device time prints "not
    measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    if not kernels:
        log(f"profile: {label} wall {wall:.1f} ms under the profiler; device "
            f"time not measured (no CUDA events recorded)")
        return None
    launches = sum(e.count for e in kernels)
    api = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    log(f"profile: {label} wall {wall:.1f} ms under the profiler, device "
        f"kernels {busy:.1f} ms over {launches} launches "
        f"({api} cudaLaunchKernel), device idle share {1 - busy / wall:.3f}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        log(f"profile:   device {dev_us(e) / 1e3:9.2f} ms x{e.count:6d} "
            f"{e.key[:90]}")
    host = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:6]:
        log(f"profile:   host   {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"x{e.count:6d} {e.key[:90]}")
    return dict(wall=wall, busy=busy, launches=launches, api=api,
                kernels={e.key: (e.count, dev_us(e) / 1e3) for e in kernels})


def _rows(A, n_rows):
    """The first ``n_rows`` rows of a CPU CSR."""
    from repro_torch.core.formats import csr_from_numpy, csr_to_numpy

    indptr, indices, data = csr_to_numpy(A)
    nnz = int(indptr[n_rows])
    return csr_from_numpy(indptr[:n_rows + 1], indices[:nnz], data[:nnz],
                          (n_rows, A.n_cols))


def k2_device_total(prof, label):
    """Log and return K2's device total in a :func:`_profiled` run: every
    kernel whose name holds ``merge_partitions``, as (ms, launches,
    {kernel: (launches, ms)})."""
    k2 = {_kernel_name(key): v for key, v in prof["kernels"].items()
          if "merge_partitions" in key}
    ms = sum(t for _, t in k2.values())
    launches = sum(c for c, _ in k2.values())
    log(f"profile: {label}: K2 device total {ms:.3f} ms over {launches} "
        f"kernel launches ("
        + "; ".join(f"{key} x{c} {t:.3f} ms" for key, (c, t) in k2.items())
        + ")")
    return ms, launches, k2


def k3_device_total(prof, label, buckets):
    """Log K3's device total in a :func:`_profiled` spz call, with the
    call's device launches per bucket and its idle share; ``buckets``:
    the call's (fused-route, large-route) bucket counts."""
    k3 = [(c, t) for key, (c, t) in prof["kernels"].items()
          if "fused_bucket" in key]
    n = sum(buckets)
    log(f"profile: {label}: K3 device total "
        f"{sum(t for _, t in k3):.3f} ms over {sum(c for c, _ in k3)} "
        f"launches; {prof['launches']} device launches over {n} buckets "
        f"({buckets[0]} on K3, {buckets[1]} large): "
        f"{prof['launches'] / n:.2f} per bucket; device idle share "
        f"{1 - prof['busy'] / prof['wall']:.3f}")


def phase_profile(torch, np, serve):
    """Where one call's time goes: host wall clock vs device kernel time
    (torch.profiler), for one spz call on the two SuiteSparse-scale
    fused-route matrices (K3's device total, device launches per bucket)
    and on dense-row-full (K2's device total on its long rows), for
    spz-host on a steady window of cage11-full (its
    first 8 groups of 512 rows, with launches per kernel issue from the
    window's own SpzStats: a whole call records ~130K device events,
    whose processing alone takes minutes), and for one TinyLlama
    generate, plus the waits for the card per kernel issue over one
    whole spz-host call on cage11-full."""
    from repro_torch.core import spgemm
    from repro_torch.data import table3

    A = table3.build("cage11-full")
    waits, (_, st) = _count_waits(torch, lambda: spgemm(
        A, A, engine="spz-host", return_stats=True))
    issues = st.n_mssort + st.n_mszip
    log(f"profile: cage11-full spz-host: {waits} waits for the card over "
        f"{issues} kernel issues ({st.n_mssort} K4 + {st.n_mszip} K5): "
        f"{waits / issues:.4f} per issue" if waits else
        "profile: cage11-full spz-host: waits per issue not measured (sync "
        "debug mode reported none)")
    for n, engine, rows in (("cage11-full", "spz", None),
                            ("email-Enron-full", "spz", None),
                            (table3.LONG_ROW, "spz", None),
                            ("cage11-full", "spz-host", 8 * 512)):
        B = table3.build(n)
        A = B if rows is None else _rows(B, rows)
        spgemm(A, B, engine=engine)  # warm
        label = n if rows is None else f"{n} rows 0-{rows - 1}"
        stats = []
        prof = _profiled(torch, f"{label} {engine}", lambda: stats.append(
            spgemm(A, B, engine=engine, return_stats=True)[1]))
        if prof is None:
            continue
        if n == table3.LONG_ROW:
            k2_device_total(prof, f"{n} spz")
        elif engine == "spz":
            k3_device_total(prof, f"{n} spz", _bucket_counts(np, A))
        if engine == "spz-host":
            st = stats[-1]
            n_issues = st.n_mssort + st.n_mszip
            log(f"profile: {label} spz-host: {n_issues} kernel issues "
                f"({st.n_mssort} K4 + {st.n_mszip} K5): "
                f"{prof['launches'] / n_issues:.3f} device launches and "
                f"{prof['api'] / n_issues:.3f} cudaLaunchKernel per issue, "
                f"device idle share {1 - prof['busy'] / prof['wall']:.3f}")
    _profiled(torch, f"tinyllama-1.1b generate ({len(SERVE_PROMPTS)} x "
              f"{SERVE_NEW_TOKENS} tokens)", serve["generate"])


ATTN_SWEEP = [(2, 64, 64, 4, 2, 16, True, 0), (1, 96, 96, 8, 1, 32, True, 32),
              (2, 48, 64, 4, 4, 16, True, 0), (1, 64, 64, 2, 2, 8, False, 0),
              (1, 128, 128, 4, 1, 64, True, 0)]


def _attn_inputs(torch, np, rng, B, Sq, Skv, H, KVH, hd, dtype):
    shapes = ((B, Sq, H, hd), (B, Skv, KVH, hd), (B, Skv, KVH, hd))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to("cuda", dtype) for s in shapes]


def _k6_check(torch, what, got, want, tol, floor=1e-6):
    """Max abs error of K6 against its plain version, which fails above
    ``tol`` and, in bf16, above one rounding of the float32 result both
    compute (2**-7 of the value, ``floor`` near zero)."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if got.dtype != want.dtype or not err <= tol:
        raise AssertionError(f"{what} {got.dtype}: max abs err {err} > {tol}")
    if got.dtype == torch.bfloat16:
        over = float((diff - 2 ** -7 * want.float().abs()).max())
        if not over <= floor:
            raise AssertionError(f"{what}: off by more than one bf16 "
                                 f"rounding (by {over} beyond 2**-7 |want|)")
    return err


def _k6_routed(torch, k6, q, k, v, **kw):
    """K6's wrapper on card inputs, failing unless the launch took the
    route of its dtype (bf16: wgmma, float32: fma)."""
    route = "wgmma" if q.dtype == torch.bfloat16 else "fma"
    before = dict(k6.flash_attention.routes)
    out = k6.flash_attention(q, k, v, **kw)
    after = k6.flash_attention.routes
    if {r: after[r] - before[r] for r in after} != {
            r: int(r == route) for r in after}:
        raise AssertionError(f"K6 {q.dtype} did not take the {route} route "
                             f"alone: {before} -> {after}")
    return out


def phase_attention(torch, np):
    """K6 against its plain version on the same card inputs: the sweep of
    tests/test_kernels_attn.py in float32 and bf16, then TinyLlama's
    prefill shapes in float32 and in bf16, the latter with times, bound
    and SDPA's time."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k6

    rng = np.random.default_rng(SEED)
    worst = {}
    for case in ATTN_SWEEP:
        B, Sq, Skv, H, KVH, hd, causal, window = case
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
            q, k, v = _attn_inputs(torch, np, rng, B, Sq, Skv, H, KVH, hd,
                                   dtype)
            got = _k6_routed(torch, k6, q, k, v, causal=causal,
                             window=window)
            want = k6.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            err = _k6_check(torch, f"K6 {case}", got, want, tol)
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    log(f"attention: K6 sweep, {len(ATTN_SWEEP)} cases x 2 dtypes (fma and "
        f"wgmma routes) within 2e-4 / 3e-2 and one bf16 rounding of the "
        f"plain version; max abs err float32 {worst[torch.float32]} bf16 "
        f"{worst[torch.bfloat16]}")
    rows = {}
    H, KVH, hd = 32, 4, 64
    for name, B, S in (("flash_attention", 4, 512),
                       ("flash_attention.4096", 1, 4096)):
        q, k, v = _attn_inputs(torch, np, rng, B, S, S, H, KVH, hd,
                               torch.float32)
        err32 = _k6_check(torch, f"K6 {name} float32", _k6_routed(
            torch, k6, q, k, v), k6.flash_attention_plain(q, k, v), 2e-4)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        got = _k6_routed(torch, k6, q, k, v)
        want = k6.flash_attention_plain(q, k, v)
        err = _k6_check(torch, f"K6 {name} bf16", got, want, 3e-2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        lib_err = float((sdpa().transpose(1, 2).float() - want.float())
                        .abs().max())
        if not lib_err <= 3e-2:
            raise AssertionError(f"SDPA at {name}: max abs err {lib_err} "
                                 f"> 3e-2")
        # causal: S (S + 1) / 2 (query, key) pairs per head, 2 hd
        # multiply-adds each for QK^T and for PV
        ops = 4 * hd * B * H * (S * (S + 1) // 2)
        b, by = bound_ms(nbytes(q, k, v, got), ops, BF16_OPS_PER_S)
        out = torch.empty_like(q)
        rows[name] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: k6.launch(q, k, v, out, causal=True,
                                                window=0, scale=hd ** -0.5)),
            wrapper_ms=time_ms(torch, lambda: k6.flash_attention(q, k, v)),
            plain_ms=time_ms(torch, lambda: k6.flash_attention_plain(q, k, v),
                             reps=5, warmup=1),
            bound_ms=b, bound_by=by, library_ms=time_ms(torch, sdpa),
            shape=f"B={B} S={S} H={H} KVH={KVH} hd={hd} bf16 causal")
        rows[name]["tflops"] = ops / rows[name]["ms"] / 1e9
        log(f"attention: {name} {rows[name]['shape']} max_abs_err {err} "
            f"(float32 {err32}; SDPA vs plain {lib_err}) kernel_ms "
            f"{rows[name]['ms']:.4f} ({rows[name]['tflops']:.1f} TFLOP/s) "
            f"wrapper_ms {rows[name]['wrapper_ms']:.4f} plain_ms "
            f"{rows[name]['plain_ms']:.4f} bound_ms {b:.5f} ({by}) "
            f"library_ms {rows[name]['library_ms']:.4f} (SDPA, enable_gqa)")
    rows.update(_k6_head_dims(torch, np, rng, k6))
    return rows


# RecurrentGemma-9B's local attention (configs/recurrentgemma_9b.py: 16
# heads over 1 KV head, head_dim 256, attention window 2,048) at S = 4,096
RG9B = dict(B=1, S=4096, H=16, KVH=1, hd=256, window=2048)


def _k6_head_dims(torch, np, rng, k6):
    """K6 past hd = 128: at RecurrentGemma-9B's attention shape on both
    routes (bf16 wgmma with 32-key tiles in a 4-stage ring, float32 fma
    with 214,016 bytes of shared memory), with times, bound and SDPA's
    (causal window as a boolean mask); hd = 20 (copied into 24 zero-padded
    columns) and B * H = 65,536 (heads on grid.x), each held against the
    plain version; ptxas's spills and wgmma advisories for the hd = 256
    instantiations, which must be none."""
    import re

    import torch.nn.functional as F

    from repro_torch.kernels import _build

    text = (_build.LIBS.build_dir / "flash_attention.log").read_text()
    for entry in text.split("Compiling entry function '")[1:]:
        fn = entry.split("'", 1)[0]
        if "ILi256E" not in fn:
            continue
        spill = re.search(r"(\d+) bytes spill stores", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        log(f"attention: ptxas {fn}: {regs.group(1) if regs else '?'} "
            f"registers, {spill.group(1) if spill else '?'} bytes spilled")
        if spill is None or int(spill.group(1)):
            raise AssertionError(f"ptxas: {fn} spills")
    advice = [line.strip() for line in text.splitlines() if "(C75" in line]
    if advice:
        raise AssertionError("ptxas serialised wgmma: " + "; ".join(advice))
    log("attention: ptxas flash_attention: 0 wgmma advisories")

    rows = {}
    B, S, H, KVH, hd, W = (RG9B[x] for x in ("B", "S", "H", "KVH", "hd",
                                              "window"))
    q32, k32, v32 = _attn_inputs(torch, np, rng, B, S, S, H, KVH, hd,
                                 torch.float32)
    pos = torch.arange(S, device="cuda")
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    # (query, key) pairs the causal window keeps: min(i + 1, W) for query i
    pairs = int(torch.clamp(pos + 1, max=W).sum())
    ops = 4 * hd * B * H * pairs
    for dtype, route, tol, rate in ((torch.bfloat16, "wgmma", 3e-2,
                                     BF16_OPS_PER_S),
                                    (torch.float32, "fma", 2e-4,
                                     FP32_OPS_PER_S)):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        got = _k6_routed(torch, k6, q, k, v, window=W)
        want = k6.flash_attention_plain(q, k, v, window=W)
        err = _k6_check(torch, f"K6 rg9b {dtype}", got, want, tol)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        lib_err = float((sdpa().transpose(1, 2).float() - want.float())
                        .abs().max())
        if not lib_err <= 3e-2:
            raise AssertionError(f"SDPA at RG9B {dtype}: max abs err "
                                 f"{lib_err} > 3e-2")
        b, by = bound_ms(nbytes(q, k, v, got), ops, rate)
        out = torch.empty_like(q)
        name = "flash_attention.rg9b_s4096" + ("" if route == "wgmma"
                                               else ".fma")
        r = rows[name] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: k6.launch(q, k, v, out, causal=True,
                                                window=W, scale=hd ** -0.5)),
            wrapper_ms=time_ms(torch, lambda: k6.flash_attention(q, k, v,
                                                                 window=W)),
            plain_ms=time_ms(torch, lambda: k6.flash_attention_plain(
                q, k, v, window=W), reps=3, warmup=1),
            bound_ms=b, bound_by=by, library_ms=time_ms(torch, sdpa),
            shape=f"B={B} S={S} H={H} KVH={KVH} hd={hd} window={W} "
                  f"{str(dtype)[6:]} ({route} route)")
        r["tflops"] = ops / r["ms"] / 1e9
        log(f"attention: {name} {r['shape']} max_abs_err {err} (SDPA vs "
            f"plain {lib_err}) kernel_ms {r['ms']:.4f} ({r['tflops']:.1f} "
            f"TFLOP/s) wrapper_ms {r['wrapper_ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {b:.5f} ({by}) library_ms "
            f"{r['library_ms']:.4f} (SDPA, boolean window mask, enable_gqa)")
        del q, k, v, got, want, out
    del q32, k32, v32, mask
    torch.cuda.empty_cache()
    for what, (B, Sq, H, KVH, hd, window) in (
            ("hd = 20", (2, 300, 8, 2, 20, 0)),
            ("B * H = 65,536", (4096, 16, 16, 4, 16, 0))):
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
            q, k, v = _attn_inputs(torch, np, rng, B, Sq, Sq, H, KVH, hd,
                                   dtype)
            got = _k6_routed(torch, k6, q, k, v, window=window)
            err = _k6_check(torch, f"K6 {what} {dtype}", got,
                            k6.flash_attention_plain(q, k, v, window=window),
                            tol)
            log(f"attention: K6 at {what} (B={B} Sq={Sq} H={H} KVH={KVH} "
                f"hd={hd}) {str(dtype)[6:]}: max abs err {err} against the "
                f"plain version (within {tol} and one bf16 rounding)")
    return rows


def _left_padded(torch, np, prompts, device):
    """The engine's batch: prompts left-padded with token 0."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
    return torch.from_numpy(toks).to(device)


def phase_serve(torch, np):
    """TinyLlama-1.1B at full width behind the serving engine, K6 on its
    prefill; returns the path's launch counts and the engine and requests
    for the profile phase."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.kernels import backend as kb
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full float32 (default)
    cfg = dataclasses.replace(cb.get_config("tinyllama-1.1b"),
                              attn_impl="pallas")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"serve: {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} KV heads, hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{sum(p.numel() for p in params.parameters()):,} {cfg.param_dtype} "
        f"parameters made on the card in {time.perf_counter() - t0:.1f} s; "
        f"compute {cfg.dtype}")
    eng = Engine(cfg, params, max_batch=4, max_seq=1024)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_PROMPTS]

    def generate(engine=eng):
        return engine.generate([Request(prompt=p,
                                        max_new_tokens=SERVE_NEW_TOKENS)
                                for p in prompts])

    generate()  # warm: the first call sets up cuBLAS and the allocator
    torch.cuda.synchronize()
    kb.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = generate()
    wall = time.perf_counter() - t0
    counts = kb.launch_counts()
    want = {"flash_attention": cfg.num_layers,
            "flash_attention.wgmma": cfg.num_layers}
    others = {k: n for k, n in counts.items() if n and k not in want}
    if any(counts[k] != n for k, n in want.items()) or others:
        raise AssertionError(f"one generate launched {counts} (want {want} "
                             f"and nothing else)")
    for r in reqs:
        if r.out.shape != (SERVE_NEW_TOKENS,) or r.out.min() < 0 \
                or r.out.max() >= cfg.vocab_size:
            raise AssertionError(f"bad tokens {r.out}")
    tokens = sum(len(r.out) for r in reqs)
    prefill_ms = eng.stats["prefill_s"] * 1e3
    decode_ms = statistics.median(eng.stats["decode_s"]) * 1e3
    log(f"serve: generate of {len(reqs)} requests x {SERVE_NEW_TOKENS} "
        f"tokens (prompts {SERVE_PROMPTS}) in {wall * 1e3:.1f} ms; K6 "
        f"launched {counts['flash_attention']} times, all on the wgmma "
        f"route, nothing else launched")
    log(f"serve: prefill_ms {prefill_ms:.3f}")
    log(f"serve: decode_ms_per_token {decode_ms:.3f} (median of "
        f"{len(eng.stats['decode_s'])} steps)")
    log(f"serve: tokens_per_s {tokens / wall:.1f}")
    log(f"serve: first tokens {[r.out[:6].tolist() for r in reqs]}")

    # (b) the same prefill through the plain blocked attention
    toks = _left_padded(torch, np, prompts, dev)
    xcfg = dataclasses.replace(cfg, attn_impl="xla")
    lg = {c.attn_impl: M.prefill(params, c, toks, M.init_cache(
        c, len(prompts), 1024, dev))[0].float() for c in (cfg, xcfg)}
    if not all(bool(torch.isfinite(x).all()) for x in lg.values()):
        raise AssertionError("non-finite prefill logits")
    err = float((lg["pallas"] - lg["xla"]).abs().max())
    if not err <= SERVE_LOGIT_TOL:
        raise AssertionError(f"prefill logits K6 vs blocked attention: max "
                             f"abs err {err} > {SERVE_LOGIT_TOL}")
    xreqs = generate(Engine(xcfg, params, max_batch=4, max_seq=1024))
    same = sum(int((a.out == b.out).sum()) for a, b in zip(reqs, xreqs))
    log(f"serve: prefill last-token logits, K6 vs attn_impl='xla' on the "
        f"card: max abs err {err} (tolerance {SERVE_LOGIT_TOL}), all finite; "
        f"greedy tokens equal at {same} of {tokens} positions")

    # (c) 2 layers at full width in float32: card (K6) vs CPU (plain)
    c2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    lg = {}
    for where in ("cpu", "cuda"):
        model = M.init_params(c2, torch.Generator().manual_seed(SEED),
                              device=where)
        lg[where] = M.prefill(model, c2, toks.to(where), M.init_cache(
            c2, len(prompts), 1024, where))[0].cpu()
    err = float((lg["cuda"] - lg["cpu"]).abs().max())
    if not (bool(torch.isfinite(lg["cuda"]).all()) and err <= CPU_LOGIT_TOL):
        raise AssertionError(f"2-layer float32 logits card vs CPU: max abs "
                             f"err {err} > {CPU_LOGIT_TOL}")
    log(f"serve: 2 layers at full width, float32: last-token logits on the "
        f"card (K6) vs the CPU (plain version) max abs err {err} "
        f"(tolerance {CPU_LOGIT_TOL})")
    return dict(counts=counts, generate=generate, prefill_ms=prefill_ms,
                decode_ms=decode_ms, tokens_per_s=tokens / wall)


# K7: tests/test_kernels_attn.py's sweep (T = 64), then ragged sizes (no
# multiples of 8, empty groups, rows past the last group, a group of more
# than 64 rows)
GMM_SWEEP = [(64, 4, 16, 32, [8, 16, 0, 24]), (64, 3, 8, 8, [8, 8, 8]),
             (64, 5, 32, 16, [0, 0, 40, 8, 0]), (64, 2, 64, 128, [32, 0])]
GMM_RAGGED = [(37, 5, 24, 40, [3, 0, 17, 1, 9]),
              (300, 3, 64, 136, [170, 5, 0]), (21, 4, 16, 8, [5, 6, 7, 3]),
              (10, 1, 8, 16, [0])]
ARCTIC_LAYERS = 2           # of 35: two layers at full width fill the card
ARCTIC_BATCH = 4
MOE_BLOCK_TOL = 0.05        # bf16 MoE block, K7 vs the plain version


def _k7_check(torch, what, got, want):
    """Max abs error of K7 against its plain version, which fails in
    float32 above 1e-4 of the output's largest magnitude and in bf16
    beyond one rounding (2**-7 of the value) plus that 1e-4: the two
    float32 sums over D run in different orders."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max()) if want.numel() else 0.0
    err = float(diff.max()) if diff.numel() else 0.0
    if got.dtype == torch.float32:
        ok = err <= 1e-4 * top
    else:
        ok = bool((diff <= 2 ** -7 * want.float().abs() + 1e-4 * top).all())
    if not ok:
        raise AssertionError(f"{what} {got.dtype}: max abs err {err} (largest "
                             f"|plain| {top}) beyond the tolerance")
    return err


def _arctic_gmm_shapes(cfg):
    """(name, T, D, F, cap) of K7's four launches in Arctic's serving: the
    prefill of 4 x 512 tokens (cap 40) and a decode step of 4 tokens
    (cap 8), w1/w3 (D -> F) and w2 (F -> D)."""
    from repro_torch.models.moe import _capacity

    E, k, D, F = cfg.num_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    out = []
    for step, T in (("prefill", ARCTIC_BATCH * SERVE_PROMPTS[0]),
                    ("decode", ARCTIC_BATCH)):
        cap = _capacity(T, k, E, cfg.capacity_factor)
        out += [(step, E * cap, D, F, cap), (f"{step}.w2", E * cap, F, D, cap)]
    return out


def moe_kernel_checks(torch, np, cfg):
    """K7 against its plain version on the sweep and the ragged sizes
    (float32 and bf16, numpy inputs from SEED) and at Arctic's four serve
    shapes (float32 and bf16, inputs drawn on the card from SEED), with
    K7's, the plain version's and torch.bmm's times and the bound in bf16;
    then K6 at Arctic's prefill shape.  Returns the kernel table's rows."""
    import torch.nn.functional as F_

    from repro_torch.kernels import flash_attention as k6
    from repro_torch.kernels import grouped_matmul as k7

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    worst = {}
    for T, E, D, F, sizes in GMM_SWEEP + GMM_RAGGED:
        x = rng.standard_normal((T, D)).astype(np.float32)
        w = rng.standard_normal((E, D, F)).astype(np.float32)
        gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xt = torch.from_numpy(x).to(dev, dtype)
            wt = torch.from_numpy(w).to(dev, dtype)
            got = k7.grouped_matmul(xt, wt, gs)
            err = _k7_check(torch, f"K7 {(T, E, D, F, sizes)}", got,
                            k7.grouped_matmul_plain(xt, wt, gs))
            if not bool((got[sum(sizes):] == 0).all()):
                raise AssertionError(f"K7 {sizes}: rows past the last group "
                                     f"are not zero")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    T, E, D, F, sizes = GMM_SWEEP[0]
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)) \
        .to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((E, D, F)).astype(np.float32)) \
        .to(dev, torch.bfloat16)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    sweep_ms = time_ms(torch, lambda: k7.grouped_matmul(x, w, gs), reps=50,
                       warmup=5)
    log(f"moe: K7 sweep and ragged sizes, {len(GMM_SWEEP + GMM_RAGGED)} cases "
        f"x 2 dtypes within 1e-4 / one bf16 rounding of the plain version, "
        f"rows past the last group zero; max abs err float32 "
        f"{worst[torch.float32]} bf16 {worst[torch.bfloat16]}; "
        f"{(T, E, D, F, sizes)} bf16 wrapper_ms {sweep_ms:.4f}")

    rows = {}
    gen = torch.Generator(device=dev)
    for name, T, D, F, cap in _arctic_gmm_shapes(cfg):
        E = cfg.num_experts
        gen.manual_seed(SEED)
        x32 = torch.randn((T, D), generator=gen, device=dev)
        w32 = torch.empty((E, D, F), device=dev)
        for e in range(E):
            w32[e] = torch.randn((D, F), generator=gen, device=dev) * D ** -0.5
        gs = torch.full((E,), cap, dtype=torch.int32, device=dev)
        got = k7.grouped_matmul(x32, w32, gs)
        err32 = _k7_check(torch, f"K7 {name} float32", got,
                          k7.grouped_matmul_plain(x32, w32, gs))
        fp32_ms = time_ms(torch, lambda: k7.launch(x32, w32, gs, got),
                          reps=3, warmup=1)
        x, w = x32.to(torch.bfloat16), w32.to(torch.bfloat16)
        del x32, w32, got
        got = k7.grouped_matmul(x, w, gs)
        want = k7.grouped_matmul_plain(x, w, gs)
        err = _k7_check(torch, f"K7 {name} bf16", got, want)

        def bmm():
            return torch.bmm(x.view(E, cap, D), w)

        top = float(want.float().abs().max())
        lib_err = float((bmm().reshape(T, F).float() - want.float())
                        .abs().max())
        b, by = bound_ms(nbytes(x, w, got), 2 * T * D * F, BF16_OPS_PER_S)
        out = torch.empty_like(got)
        rows[f"grouped_matmul.{name}"] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: k7.launch(x, w, gs, out), reps=10),
            wrapper_ms=time_ms(torch, lambda: k7.grouped_matmul(x, w, gs),
                               reps=10),
            plain_ms=time_ms(torch, lambda: k7.grouped_matmul_plain(x, w, gs),
                             reps=3, warmup=1),
            bound_ms=b, bound_by=by, library_ms=time_ms(torch, bmm, reps=10),
            fp32_ms=fp32_ms,
            shape=f"T={T} E={E} D={D} F={F} groups of {cap} bf16")
        r = rows[f"grouped_matmul.{name}"]
        log(f"moe: K7 {name} {r['shape']} max_abs_err {err} (float32 "
            f"{err32}; largest |plain| {top}; torch.bmm vs plain {lib_err}) "
            f"kernel_ms {r['ms']:.4f} (float32 {fp32_ms:.4f}) wrapper_ms "
            f"{r['wrapper_ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{b:.5f} ({by}) library_ms {r['library_ms']:.4f} (torch.bmm "
            f"over (E, cap, D))")
        # the counts layout, as the MoE block launches K7: at the prefill
        # every expert keeps 1 to cap rows, at decode 8 experts do
        if name.startswith("prefill"):
            counts = rng.integers(1, cap + 1, E)
        else:
            counts = np.zeros(E, np.int64)
            counts[rng.choice(E, 8, replace=False)] = rng.integers(1, cap + 1,
                                                                  8)
        rows[f"grouped_matmul.{name}.counts"] = r = _k7_counts_row(
            torch, np, k7, f"{name}.counts", x, w, cap, counts)
        r["library_ms"] = rows[f"grouped_matmul.{name}"]["library_ms"]
        log(f"moe: K7 {name}.counts {r['shape']} max_abs_err "
            f"{r['max_abs_err']} (vs the contiguous launch on the kept rows "
            f"{r['packed_err']}), unkept rows exactly zero; kernel_ms "
            f"{r['ms']:.4f} wrapper_ms {r['wrapper_ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
            f"({r['bound_by']}) library_ms {r['library_ms']:.4f} (torch.bmm "
            f"over (E, cap, D), the same call as above)")
        del x, w, got, want, out
        torch.cuda.empty_cache()

    # K6 at Arctic's prefill shape
    B, S = ARCTIC_BATCH, SERVE_PROMPTS[0]
    H, KVH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _attn_inputs(torch, np, rng, B, S, S, H, KVH, hd, torch.float32)
    err32 = _k6_check(torch, "K6 arctic float32", _k6_routed(torch, k6, q, k,
                                                             v),
                      k6.flash_attention_plain(q, k, v), 2e-4)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = _k6_routed(torch, k6, q, k, v)
    want = k6.flash_attention_plain(q, k, v)
    err = _k6_check(torch, "K6 arctic bf16", got, want, 3e-2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F_.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)

    ops = 4 * hd * B * H * (S * (S + 1) // 2)
    b, by = bound_ms(nbytes(q, k, v, got), ops, BF16_OPS_PER_S)
    out = torch.empty_like(q)
    rows["flash_attention.arctic"] = r = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k6.launch(q, k, v, out, causal=True,
                                            window=0, scale=hd ** -0.5)),
        wrapper_ms=time_ms(torch, lambda: k6.flash_attention(q, k, v)),
        plain_ms=time_ms(torch, lambda: k6.flash_attention_plain(q, k, v),
                         reps=5, warmup=1),
        bound_ms=b, bound_by=by, library_ms=time_ms(torch, sdpa),
        shape=f"B={B} S={S} H={H} KVH={KVH} hd={hd} bf16 causal")
    r["tflops"] = ops / r["ms"] / 1e9
    log(f"moe: K6 flash_attention.arctic {r['shape']} max_abs_err {err} "
        f"(float32 {err32}) kernel_ms {r['ms']:.4f} ({r['tflops']:.1f} "
        f"TFLOP/s) wrapper_ms "
        f"{r['wrapper_ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
        f"{b:.5f} ({by}) library_ms {r['library_ms']:.4f} (SDPA, enable_gqa)")
    return rows


def _k7_counts_row(torch, np, k7, name, x, w, cap, counts):
    """K7 in the counts layout on (T, D) rows of noise, group g keeping
    its first counts[g] of cap rows: the unkept rows come out exactly
    zero, the result agrees with the plain version and with the
    contiguous launch on the kept rows packed together.  ``w`` may be
    the transposed view of a contiguous tensor (the backward's W^T), read
    in place.  Returns the kernel table's row; its bound counts the kept
    rows of x, the weights of the experts that keep rows, and all of the
    output."""
    (T, D), (E, _, F) = x.shape, w.shape
    dev = x.device
    kept = torch.zeros(T, dtype=torch.bool)
    for g in np.nonzero(counts)[0]:
        kept[g * cap:g * cap + min(int(counts[g]), cap)] = True
    kept = kept.to(dev)
    gs = torch.from_numpy(counts.astype(np.int32)).to(dev)
    before = k7.grouped_matmul.routes["counts"]
    got = k7.grouped_matmul(x, w, gs, cap=cap)
    if k7.grouped_matmul.routes["counts"] != before + 1:
        raise AssertionError(f"K7 {name} did not take the counts layout")
    if not bool((got[~kept] == 0).all()):
        raise AssertionError(f"K7 {name}: unkept rows are not zero")
    want = k7.grouped_matmul_plain(x, w, gs, cap=cap)
    err = _k7_check(torch, f"K7 {name} bf16", got, want)
    sizes = torch.from_numpy(np.minimum(counts, cap).astype(np.int32)).to(dev)
    packed_err = _k7_check(torch, f"K7 {name} vs the contiguous launch",
                           got[kept], k7.grouped_matmul(x[kept], w, sizes))
    n_kept, n_experts = int(kept.sum()), int((counts > 0).sum())
    b, by = bound_ms(2 * (n_kept * D + n_experts * D * F + T * F) + 4 * E,
                     2 * n_kept * D * F, BF16_OPS_PER_S)
    out = torch.empty_like(got)
    storage, k_major = k7.b_storage(w)  # W^T's view: W as stored
    return dict(
        max_abs_err=err, packed_err=packed_err,
        ms=time_ms(torch, lambda: k7.launch(x, storage, gs, out, cap=cap,
                                            k_major=k_major), reps=10),
        wrapper_ms=time_ms(torch, lambda: k7.grouped_matmul(x, w, gs, cap=cap),
                           reps=10),
        plain_ms=time_ms(torch, lambda: k7.grouped_matmul_plain(
            x, w, gs, cap=cap), reps=3, warmup=1),
        bound_ms=b, bound_by=by,
        shape=f"T={T} E={E} D={D} F={F} cap {cap}, {n_experts} experts "
              f"keep {n_kept} rows, bf16")


def _ptxas_summary(build, name, strict=False):
    """One line per kernel of ``csrc/<name>.cu`` from the build's ``-Xptxas
    -v`` log: its (mangled) entry name, registers and spills; then any
    advisory of ptxas that it serialised wgmma (C75xx).  ``strict``: a
    spill or an advisory fails the run."""
    import re

    text = (build.LIBS.build_dir / f"{name}.log").read_text()
    for entry in text.split("Compiling entry function '")[1:]:
        fn = entry.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        log(f"moe: ptxas {name}: {fn} {regs.group(1) if regs else '?'} "
            f"registers, {spill.group(1) if spill else '?'} bytes spilled")
        if strict and (spill is None or int(spill.group(1))):
            raise AssertionError(f"ptxas: {fn} spills")
    advice = [line.strip() for line in text.splitlines() if "(C75" in line]
    log(f"moe: ptxas {name}: {len(advice)} wgmma advisories"
        + "".join(f"\n  {line}" for line in advice))
    if strict and advice:
        raise AssertionError(f"ptxas serialised wgmma in {name}: "
                             + "; ".join(advice))


def _moe_block_check(torch, cfg, ffn, x, label):
    """One MoE block through K7 and through the plain grouped matmul on
    the same input: the same keep mask (routing runs before the expert
    products), finite outputs within MOE_BLOCK_TOL, equal aux losses.
    Returns the number of dropped assignments."""
    from repro_torch.kernels import grouped_matmul as k7
    from repro_torch.models import moe

    xt = x.reshape(-1, cfg.d_model)
    keeps = [moe._assign(ffn, xt, cfg)[5] for _ in range(2)]
    if not torch.equal(*keeps):
        raise AssertionError(f"moe block {label}: keep masks differ")
    before = k7.grouped_matmul.launches
    got, aux = moe.moe_block(ffn, x, cfg)
    launched = k7.grouped_matmul.launches - before
    want, aux_p = moe.moe_block(ffn, x, cfg, gmm=k7.grouped_matmul_plain)
    err = float((got.float() - want.float()).abs().max())
    if launched != 3 or not bool(torch.isfinite(got).all()) \
            or not err <= MOE_BLOCK_TOL or not torch.equal(aux, aux_p):
        raise AssertionError(f"moe block {label}: K7 launched {launched} "
                             f"times, max abs err {err}, aux {aux} vs {aux_p}")
    dropped = int((~keeps[0]).sum())
    log(f"moe: block at {label}: K7 vs the plain grouped matmul max abs err "
        f"{err} (tolerance {MOE_BLOCK_TOL}), finite, same keep mask, aux "
        f"{float(aux)}; {dropped} of {keeps[0].numel()} assignments dropped")
    return dropped


def phase_moe(torch, np, serve):
    """Arctic-480B at full width, 2 of its 35 layers: K7 and K6 at its
    shapes, one MoE block through K7 against the plain grouped matmul,
    serving through the engine (counters set to 0 before one measured
    generate and read after: K6 once per layer, K7 three times per layer
    per forward pass, nothing else), and one profiled generate."""
    import dataclasses
    import gc

    from repro_torch.configs import base as cb
    from repro_torch.kernels import _build
    from repro_torch.kernels import backend as kb
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    _ptxas_summary(_build, "grouped_matmul", strict=True)
    _ptxas_summary(_build, "flash_attention")
    serve.pop("generate", None)  # TinyLlama's engine and model
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(cb.get_config("arctic-480b"),
                              num_layers=ARCTIC_LAYERS, attn_impl="pallas")
    rows = moe_kernel_checks(torch, np, cfg)
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"moe: {cfg.name}: {cfg.num_layers} of 35 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} KV "
        f"heads, hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.num_experts} experts top-{cfg.top_k} of moe_d_ff "
        f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}; {n_params:,} "
        f"{cfg.param_dtype} parameters made on the card in "
        f"{time.perf_counter() - t0:.1f} s; compute {cfg.dtype}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    ffn = params.layers[0].ffn
    for S in (SERVE_PROMPTS[0], 1):
        x = torch.randn((ARCTIC_BATCH, S, cfg.d_model), generator=gen,
                        device=dev).to(torch.bfloat16)
        dropped = _moe_block_check(torch, cfg, ffn, x,
                                   f"{ARCTIC_BATCH} x {S} tokens")
        if S == 1 and dropped:
            raise AssertionError("a decode step dropped assignments")

    eng = Engine(cfg, params, max_batch=ARCTIC_BATCH, max_seq=1024)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_PROMPTS]

    def generate():
        return eng.generate([Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS)
                             for p in prompts])

    generate()  # warm
    torch.cuda.synchronize()
    kb.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = generate()
    wall = time.perf_counter() - t0
    counts = kb.launch_counts()
    passes = 1 + len(eng.stats["decode_s"])
    want = {"flash_attention": cfg.num_layers,
            "flash_attention.wgmma": cfg.num_layers,
            "grouped_matmul": 3 * cfg.num_layers * passes,
            "grouped_matmul.counts": 3 * cfg.num_layers * passes}
    others = {k: n for k, n in counts.items() if n and k not in want}
    if any(counts[k] != n for k, n in want.items()) or others:
        raise AssertionError(f"one generate launched {counts} (want {want} "
                             f"and nothing else)")
    for r in reqs:
        if r.out.shape != (SERVE_NEW_TOKENS,) or r.out.min() < 0 \
                or r.out.max() >= cfg.vocab_size:
            raise AssertionError(f"bad tokens {r.out}")
    tokens = sum(len(r.out) for r in reqs)
    prefill_ms = eng.stats["prefill_s"] * 1e3
    decode_ms = statistics.median(eng.stats["decode_s"]) * 1e3
    log(f"moe: generate of {len(reqs)} requests x {SERVE_NEW_TOKENS} tokens "
        f"(prompts {SERVE_PROMPTS}) in {wall * 1e3:.1f} ms; {passes} forward "
        f"passes; K6 launched {counts['flash_attention']} times (wgmma "
        f"route), K7 {counts['grouped_matmul']} times (3 x {cfg.num_layers} "
        f"layers x {passes} passes, counts layout), nothing else launched")
    log(f"moe: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"moe: prefill_ms {prefill_ms:.3f}")
    log(f"moe: decode_ms_per_token {decode_ms:.3f} (median of "
        f"{len(eng.stats['decode_s'])} steps)")
    log(f"moe: tokens_per_s {tokens / wall:.1f}")
    log(f"moe: first tokens {[r.out[:6].tolist() for r in reqs]}")
    _profiled(torch, f"{cfg.name} ({cfg.num_layers} layers) generate "
              f"({len(SERVE_PROMPTS)} x {SERVE_NEW_TOKENS} tokens)", generate)
    return dict(rows=rows, counts=counts, prefill_ms=prefill_ms,
                decode_ms=decode_ms, tokens_per_s=tokens / wall)


# phase families: the three architectures of MLA, local attention and the
# recurrent blocks, each at full width behind the engine (DeepSeek-V2 at 2
# of its 60 layers: the dense lead layer and one MoE layer)
RG9B_PROMPTS = (2560, 2300, 2100, 1800)  # past the window of 2,048
RG9B_MAX_SEQ = 4096
DEEPSEEK_LAYERS = 2                      # of 60
# not a multiple of the SSD chunk (256): the prefill pads with dt = 0
MAMBA2_PROMPTS = (500, 480, 400, 300)
MAMBA2_DECODE_CHECK = 4                  # decode steps held to the forward


def _family_model(torch, cfg, label, phase="families"):
    """``cfg``'s model on the card with random weights from SEED, its
    size logged."""
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(SEED))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    size = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"{phase}: {label}: {cfg.num_layers} layers {cfg.groups}, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}; {n:,} parameters "
        f"({size / 1e9:.2f} GB, {cfg.param_dtype} but the float32 leaves) "
        f"made on the card in {time.perf_counter() - t0:.1f} s; compute "
        f"{cfg.dtype}")
    return params


def _family_serve(torch, np, cfg, params, prompts, max_seq, want, label,
                  enc=None, phase="families"):
    """Serve ``prompts`` x SERVE_NEW_TOKENS greedy tokens through
    ``Engine(max_batch=4)``, with the frontend's embeddings ``enc`` (a
    host array) for a model with cross attention: a warm generate, then
    one with every launch counter set to 0 before and read after, which
    must launch exactly ``want`` (kernel -> count) and nothing else; then
    one decode step profiled.  Returns the engine, the prompts' tokens
    and the metrics."""
    from repro_torch.kernels import backend as kb
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    eng = Engine(cfg, params, max_batch=len(prompts), max_seq=max_seq)
    rng = np.random.default_rng(SEED)
    toks = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in prompts]

    def generate():
        return eng.generate([Request(prompt=p, max_new_tokens=SERVE_NEW_TOKENS)
                             for p in toks], enc_inp=enc)

    generate()  # warm
    torch.cuda.synchronize()
    kb.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = generate()
    wall = time.perf_counter() - t0
    counts = kb.launch_counts()
    others = {k: n for k, n in counts.items() if n and k not in want}
    if any(counts[k] != n for k, n in want.items()) or others:
        raise AssertionError(f"{label}: one generate launched {counts} (want "
                             f"{want} and nothing else)")
    for r in reqs:
        if r.out.shape != (SERVE_NEW_TOKENS,) or r.out.min() < 0 \
                or r.out.max() >= cfg.vocab_size:
            raise AssertionError(f"{label}: bad tokens {r.out}")
    tokens = sum(len(r.out) for r in reqs)
    res = dict(counts=counts, wall_ms=wall * 1e3,
               prefill_ms=eng.stats["prefill_s"] * 1e3,
               decode_ms=statistics.median(eng.stats["decode_s"]) * 1e3,
               tokens_per_s=tokens / wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"{phase}: {label}: generate of {len(reqs)} requests x "
        f"{SERVE_NEW_TOKENS} tokens (prompts {prompts}) in {wall * 1e3:.1f} "
        f"ms; K6 launched {counts.get('flash_attention', 0)} times "
        f"({counts.get('flash_attention.wgmma', 0)} wgmma), K7 "
        f"{counts.get('grouped_matmul', 0)} times "
        f"({counts.get('grouped_matmul.counts', 0)} counts layout), nothing "
        f"else launched")
    log(f"{phase}: {label}: prefill_ms {res['prefill_ms']:.3f}")
    log(f"{phase}: {label}: decode_ms_per_token {res['decode_ms']:.3f} "
        f"(median of {len(eng.stats['decode_s'])} steps)")
    log(f"{phase}: {label}: tokens_per_s {res['tokens_per_s']:.1f}")
    log(f"{phase}: {label}: max_memory_allocated {res['peak_gib']:.2f} GiB")
    log(f"{phase}: {label}: first tokens "
        f"{[r.out[:6].tolist() for r in reqs]}")

    # one decode step under the profiler: launches per step, idle share
    batch = _left_padded(torch, np, toks, "cuda")
    cache = M.init_cache(cfg, len(toks), max_seq, "cuda",
                         enc_len=cfg.num_frontend_tokens)
    logits, cache = M.prefill(params, cfg, batch, cache, enc_inp=None if enc
                              is None else torch.from_numpy(enc).cuda())
    nxt = logits.argmax(-1)[:, None]
    # decode returns a new cache and leaves this one as it is
    M.decode_step(params, cfg, nxt, cache, batch.shape[1])  # warm
    prof = _profiled(torch, f"{label} decode step", lambda: M.decode_step(
        params, cfg, nxt, cache, batch.shape[1]))
    if prof is not None:
        res["step_launches"] = prof["launches"]
        res["step_idle"] = 1 - prof["busy"] / prof["wall"]
        log(f"{phase}: {label}: {prof['launches']} device launches per "
            f"decode step, device idle share {res['step_idle']:.3f}")
    else:
        log(f"{phase}: {label}: launches per decode step and idle share "
            f"not measured")
    del cache, logits
    return eng, toks, res


def _rg9b_k6_row(torch, np, k6, cfg):
    """K6 against its plain version at RecurrentGemma-9B's served
    local-attention prefill (B = 4, S = 2,560, 16 / 1 heads, hd 256,
    window 2,048, bf16, wgmma route), with its time, the plain version's,
    SDPA's (boolean window mask) and the bound."""
    import torch.nn.functional as F

    B, S = len(RG9B_PROMPTS), RG9B_PROMPTS[0]
    H, KVH, hd, W = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                     cfg.local_window)
    rng = np.random.default_rng(SEED)
    q, k, v = _attn_inputs(torch, np, rng, B, S, S, H, KVH, hd,
                           torch.bfloat16)
    got = _k6_routed(torch, k6, q, k, v, window=W)
    want = k6.flash_attention_plain(q, k, v, window=W)
    err = _k6_check(torch, "K6 rg9b served", got, want, 3e-2)
    pos = torch.arange(S, device="cuda")
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    ops = 4 * hd * B * H * int(torch.clamp(pos + 1, max=W).sum())
    b, by = bound_ms(nbytes(q, k, v, got), ops, BF16_OPS_PER_S)
    out = torch.empty_like(q)
    r = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k6.launch(q, k, v, out, causal=True,
                                            window=W, scale=hd ** -0.5)),
        wrapper_ms=time_ms(torch, lambda: k6.flash_attention(q, k, v,
                                                             window=W)),
        plain_ms=time_ms(torch, lambda: k6.flash_attention_plain(
            q, k, v, window=W), reps=3, warmup=1),
        bound_ms=b, bound_by=by, library_ms=time_ms(torch, sdpa),
        shape=f"B={B} S={S} H={H} KVH={KVH} hd={hd} window={W} bf16 "
              f"(wgmma route)")
    r["tflops"] = ops / r["ms"] / 1e9
    log(f"families: K6 flash_attention.rg9b {r['shape']} max_abs_err {err} "
        f"(within 3e-2 and one bf16 rounding of the plain version) "
        f"kernel_ms {r['ms']:.4f} ({r['tflops']:.1f} TFLOP/s) wrapper_ms "
        f"{r['wrapper_ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
        f"{b:.5f} ({by}) library_ms {r['library_ms']:.4f} (SDPA, boolean "
        f"window mask, enable_gqa)")
    return r


def _prefill_logit_gates(torch, np, cfg, params, toks, max_seq, label,
                         phase, enc=None, **plain):
    """The prefill's last-token logits four ways (on the frontend's
    embeddings ``enc`` for a cross-attention model): K6 and the plain
    blocked attention, each in bf16 (served) and in float32, with
    ``plain`` set in all four configs.  Gates: float32 K6 (fma route)
    within CPU_LOGIT_TOL of the plain attention, and bf16 K6 no further
    from the float32 plain logits than the plain bf16 logits are, by
    BF16_SPREAD.  Returns the four distances."""
    import dataclasses

    from repro_torch.models import model as M

    batch = _left_padded(torch, np, toks, "cuda")
    e = None if enc is None else torch.from_numpy(enc).cuda()
    lg = {}
    for impl in ("pallas", "xla"):
        for dt in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, attn_impl=impl, dtype=dt, **plain)
            lg[impl, dt] = M.prefill(params, c, batch, M.init_cache(
                c, len(toks), max_seq, "cuda",
                enc_len=c.num_frontend_tokens), enc_inp=e)[0].float()
            torch.cuda.empty_cache()
    if not all(bool(torch.isfinite(x).all()) for x in lg.values()):
        raise AssertionError(f"{label}: non-finite prefill logits")

    def dist(a, b):
        return float((lg[a] - lg[b]).abs().max())

    res = dict(logit_err32=dist(("pallas", "float32"), ("xla", "float32")),
               logit_err=dist(("pallas", "bfloat16"), ("xla", "bfloat16")),
               k6_off=dist(("pallas", "bfloat16"), ("xla", "float32")),
               plain_off=dist(("xla", "bfloat16"), ("xla", "float32")))
    with_plain = f" with {plain}" if plain else ""
    log(f"{phase}: {label}: prefill last-token logits{with_plain} (largest "
        f"|logit| "
        f"{float(lg['xla', 'float32'].abs().max()):.3f}): float32 K6 vs "
        f"attn_impl='xla' max abs err {res['logit_err32']} (tolerance "
        f"{CPU_LOGIT_TOL}); bf16 K6 vs 'xla' {res['logit_err']}; from the "
        f"float32 plain logits: bf16 K6 {res['k6_off']}, bf16 plain "
        f"{res['plain_off']} (K6 within {BF16_SPREAD} x the plain's); all "
        f"finite")
    if not (res["logit_err32"] <= CPU_LOGIT_TOL
            and res["k6_off"] <= BF16_SPREAD * res["plain_off"]):
        raise AssertionError(f"{label} prefill logits: float32 K6 vs plain "
                             f"{res['logit_err32']} (> {CPU_LOGIT_TOL}?) or "
                             f"bf16 K6 {res['k6_off']} from float32 against "
                             f"the plain's {res['plain_off']} (x "
                             f"{BF16_SPREAD})")
    if plain:  # the served config's plain attention, for the record
        c = dataclasses.replace(cfg, attn_impl="xla", dtype="float32")
        x = M.prefill(params, c, batch, M.init_cache(
            c, len(toks), max_seq, "cuda", enc_len=c.num_frontend_tokens),
            enc_inp=e)[0].float()
        res["served_plain_err32"] = float((lg["pallas", "float32"] - x)
                                          .abs().max())
        log(f"{phase}: {label}: float32 K6 vs attn_impl='xla' at the "
            f"config's own key block ({cfg.attn_kv_block}) "
            f"{res['served_plain_err32']}: not gated, that plain attention "
            f"counts the zero-padded keys of its last block in a "
            f"bidirectional softmax, as the reference's does")
    return res


def _family_rg9b(torch, np):
    """RecurrentGemma-9B, all 38 layers: K6 at its served prefill shape,
    serving (K6 once per local-attention layer, on the wgmma route, and
    nothing else), the prefill's last-token logits with K6 against the
    plain blocked attention (the gates below)."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cb.get_config("recurrentgemma-9b"),
                              attn_impl="pallas")
    row = _rg9b_k6_row(torch, np, k6, cfg)
    torch.cuda.empty_cache()
    params = _family_model(torch, cfg, cfg.name)
    n_local = sum(kind == "local_attn" for kind, _ in M.layer_kinds(cfg))
    _, toks, res = _family_serve(
        torch, np, cfg, params, RG9B_PROMPTS, RG9B_MAX_SEQ,
        {"flash_attention": n_local, "flash_attention.wgmma": n_local},
        cfg.name)
    # the prefill's last-token logits four ways (_prefill_logit_gates).  In
    # bf16 the logits of two plain attentions that only block the keys
    # differently lie 0.170 apart at this depth on an H100, past
    # SERVE_LOGIT_TOL, so the bf16 pair is logged and the gates are
    # float32 and the bf16 spread
    return dict(res, row=row, **_prefill_logit_gates(
        torch, np, cfg, params, toks, RG9B_MAX_SEQ, cfg.name, "families"))


def _family_deepseek(torch, np):
    """DeepSeek-V2-236B at full width, 2 of 60 layers (the dense lead
    layer and one MoE layer: 160 experts top-6, 2 shared, MLA): one MoE
    block through K7 against the plain grouped matmul, K7 at the
    prefill's expert-product shape in the counts layout the block
    launches (the kept counts of that routing), and serving (K7 three
    times per forward pass, nothing else)."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.kernels import grouped_matmul as k7
    from repro_torch.models import moe

    cfg = dataclasses.replace(cb.get_config("deepseek-v2-236b"),
                              num_layers=DEEPSEEK_LAYERS, attn_impl="pallas")
    params = _family_model(torch, cfg, f"{cfg.name} ({DEEPSEEK_LAYERS} of 60 "
                           f"layers)")
    ffn = params.layers[1].ffn
    B, S = len(SERVE_PROMPTS), SERVE_PROMPTS[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for s in (S, 1):
        x = torch.randn((B, s, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        dropped = _moe_block_check(torch, cfg, ffn, x, f"deepseek {B} x {s} "
                                   f"tokens")
        if s == 1 and dropped:
            raise AssertionError("deepseek: a decode step dropped "
                                 "assignments")
        if s == S:
            xt = x.reshape(-1, cfg.d_model)
    # K7 at the prefill's w1 product: the (E * cap, D) buffer of kept rows
    # the block builds for this routing, against the plain version
    ids, _, _, cap, pos, keep = moe._assign(ffn, xt, cfg)
    E = cfg.num_experts
    counts = torch.zeros(E, dtype=torch.int64, device="cuda")
    counts.scatter_add_(0, ids.reshape(-1).long(), keep.long())
    w = ffn.experts.w1.to(torch.bfloat16)
    xb = torch.randn((E * cap, cfg.d_model), generator=gen,
                     device="cuda").to(torch.bfloat16)
    r = _k7_counts_row(torch, np, k7, "deepseek", xb, w, cap,
                       counts.cpu().numpy())

    def bmm():
        return torch.bmm(xb.view(E, cap, cfg.d_model), w)

    r["library_ms"] = time_ms(torch, bmm, reps=10)
    log(f"families: K7 grouped_matmul.deepseek {r['shape']} max_abs_err "
        f"{r['max_abs_err']} (vs the contiguous launch on the kept rows "
        f"{r['packed_err']}), unkept rows exactly zero; kernel_ms "
        f"{r['ms']:.4f} wrapper_ms {r['wrapper_ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} ({r['bound_by']}) "
        f"library_ms {r['library_ms']:.4f} (torch.bmm over (E, cap, D))")
    del w, xb, x, xt
    torch.cuda.empty_cache()
    n_moe = DEEPSEEK_LAYERS - cfg.first_k_dense
    passes = SERVE_NEW_TOKENS  # the prefill and 31 decode steps
    want = {"grouped_matmul": 3 * n_moe * passes,
            "grouped_matmul.counts": 3 * n_moe * passes}
    _, _, res = _family_serve(torch, np, cfg, params, SERVE_PROMPTS, 1024,
                              want, f"{cfg.name} ({DEEPSEEK_LAYERS} layers)")
    return dict(res, row=r)


def _family_mamba2(torch, np):
    """Mamba2-780M, all 48 layers: serving (no kernel: SSD has no Pallas
    kernel in the reference), prefill-then-decode logits against the full
    forward over the same tokens (the gates below), and 2 layers at full
    width in float32 on the card against the CPU within CPU_LOGIT_TOL."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.models import model as M

    cfg = cb.get_config("mamba2-780m")
    params = _family_model(torch, cfg, cfg.name)
    _, toks, res = _family_serve(torch, np, cfg, params, MAMBA2_PROMPTS,
                                 1024, {}, cfg.name)
    # prefill then decode against the full forward over the same tokens
    # (those the bf16 steps pick), in bf16 (served) and in float32.  In
    # bf16 the two sides round differently through 48 layers, so the gates
    # are: float32 within CPU_LOGIT_TOL; and the bf16 steps no further
    # from the float32 forward than the bf16 forward is, by BF16_SPREAD
    batch = _left_padded(torch, np, toks, "cuda")
    B, P = batch.shape
    steps, full, fed = {}, {}, []
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dt)
        logits, cache = M.prefill(params, c, batch,
                                  M.init_cache(c, B, 1024, "cuda"))
        steps[dt] = [logits.float()]
        for t in range(MAMBA2_DECODE_CHECK):
            if dt == "bfloat16":
                fed.append(steps[dt][-1].argmax(-1)[:, None])
            logits, cache = M.decode_step(params, c, fed[t], cache, P + t)
            steps[dt].append(logits.float())
        lg, _, _ = M.forward(params, c, torch.cat([batch] + fed, dim=1))
        full[dt] = [lg[:, P - 1 + t].float()
                    for t in range(MAMBA2_DECODE_CHECK + 1)]
        del cache, lg
        torch.cuda.empty_cache()
    if not all(bool(torch.isfinite(x).all())
               for d in (steps, full) for v in d.values() for x in v):
        raise AssertionError("mamba2: non-finite logits")

    def dist(a, b):
        return max(float((x - y).abs().max()) for x, y in zip(a, b))

    err32 = dist(steps["float32"], full["float32"])
    err16 = dist(steps["bfloat16"], full["bfloat16"])
    served_off = dist(steps["bfloat16"], full["float32"])
    forward_off = dist(full["bfloat16"], full["float32"])
    log(f"families: {cfg.name}: prefill ({P} tokens, {P % cfg.ssm_chunk} "
        f"past the last whole chunk of {cfg.ssm_chunk}) then "
        f"{MAMBA2_DECODE_CHECK} decode steps against the full forward over "
        f"the same tokens (largest |logit| "
        f"{max(float(x.abs().max()) for x in full['float32']):.3f}): "
        f"float32 max abs err {err32} (tolerance {CPU_LOGIT_TOL}); bf16 "
        f"{err16}; from the float32 forward: bf16 steps {served_off}, bf16 "
        f"forward {forward_off} (steps within {BF16_SPREAD} x the "
        f"forward's); all finite")
    if not (err32 <= CPU_LOGIT_TOL and served_off <= BF16_SPREAD
            * forward_off):
        raise AssertionError(f"mamba2 prefill + decode vs forward: float32 "
                             f"{err32} (> {CPU_LOGIT_TOL}?) or bf16 steps "
                             f"{served_off} from float32 against the bf16 "
                             f"forward's {forward_off} (x {BF16_SPREAD})")
    del params
    torch.cuda.empty_cache()
    c2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    lg = {}
    for where in ("cpu", "cuda"):
        model = M.init_params(c2, torch.Generator().manual_seed(SEED),
                              device=where)
        lg[where] = M.prefill(model, c2, batch.to(where), M.init_cache(
            c2, B, 1024, where))[0].cpu()
    cpu_err = float((lg["cuda"] - lg["cpu"]).abs().max())
    if not (bool(torch.isfinite(lg["cuda"]).all())
            and cpu_err <= CPU_LOGIT_TOL):
        raise AssertionError(f"mamba2 2-layer float32 logits card vs CPU: "
                             f"max abs err {cpu_err} > {CPU_LOGIT_TOL}")
    log(f"families: {cfg.name}: 2 layers at full width, float32: last-token "
        f"logits on the card vs the CPU max abs err {cpu_err} (tolerance "
        f"{CPU_LOGIT_TOL})")
    return dict(res, logit_err=err16, logit_err32=err32,
                served_off=served_off, forward_off=forward_off,
                cpu_err=cpu_err)


def phase_families(torch, np):
    """RecurrentGemma-9B (RG-LRU + local attention, K6 on the windowed
    prefill), DeepSeek-V2-236B at 2 of 60 layers (MLA + MoE, K7) and
    Mamba2-780M (SSD) at full width behind the engine, one after the
    other (each model dropped before the next is made).  Returns each
    model's metrics and the kernel table's rows."""
    import gc

    out, failed = {}, []
    for name, fn in (("rg9b", _family_rg9b), ("deepseek", _family_deepseek),
                     ("mamba2", _family_mamba2)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            out[name] = fn(torch, np)
        except Exception:  # report it, then go on to the next model
            traceback.print_exc()
            failed.append(name)
        log(f"families: {name} {'FAILED' if name in failed else 'passed'} "
            f"in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"families: {failed} failed")
    out["rows"] = {"flash_attention.rg9b": out["rg9b"].pop("row"),
                   "grouped_matmul.deepseek": out["deepseek"].pop("row")}
    return out


# phase encdec: cross attention and the whisper encoder, each model whole
# at full width behind the engine, on stub frontend embeddings from SEED
WHISPER_PROMPTS = (400, 360, 300, 200)
WHISPER_MAX_SEQ = 448                    # Whisper's decoder context
VISION_PROMPTS = SERVE_PROMPTS
VISION_MAX_SEQ = 1024


def _frontend(np, cfg, B):
    """Stub frontend embeddings (B, num_frontend_tokens, D), float32
    standard normal from SEED (the reference's frontends are stubs)."""
    return np.random.default_rng(SEED + 1).standard_normal(
        (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)


def _k6_served_row(torch, k6, q, k, v, causal, what):
    """K6 on the wgmma route against its plain version within 3e-2 and one
    bf16 rounding, on the main path's inputs ``q, k, v`` (bf16, in the
    layout the model hands them), with the kernel's time (on the inputs
    the wrapper passes it), the wrapper's (any copy TMA's stride rules
    force included), the plain version's, SDPA's and the bound."""
    import torch.nn.functional as F

    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    ready = [k6.tma_ready(t.stride(), t.data_ptr()) for t in (q, k, v)]
    got = _k6_routed(torch, k6, q, k, v, causal=causal)
    want = k6.flash_attention_plain(q, k, v, causal=causal)
    # near zero the two float32 results may differ by the rounding of a
    # sum over Skv keys, in the worst case Skv ulps of the largest value
    # (an output that cancels over 1,500 keys differs by ~2.5e-6)
    floor = max(1e-6, Skv * 2 ** -24 * float(v.float().abs().max()))
    err = _k6_check(torch, f"K6 {what}", got, want, 3e-2, floor)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    lib_err = float((sdpa().transpose(1, 2).float() - want.float())
                    .abs().max())
    if not lib_err <= 3e-2:
        raise AssertionError(f"SDPA at {what}: max abs err {lib_err} > 3e-2")
    # (query, key) pairs: all of them, or the causal triangle (Sq = Skv)
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    ops = 4 * hd * B * H * pairs
    b, by = bound_ms(nbytes(q, k, v, got), ops, BF16_OPS_PER_S)
    qc, kc, vc = (t if ok else t.clone(memory_format=torch.contiguous_format)
                  for t, ok in zip((q, k, v), ready))
    out = torch.empty_like(qc)
    r = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k6.launch(qc, kc, vc, out, causal=causal,
                                            window=0, scale=hd ** -0.5)),
        wrapper_ms=time_ms(torch, lambda: k6.flash_attention(
            q, k, v, causal=causal)),
        plain_ms=time_ms(torch, lambda: k6.flash_attention_plain(
            q, k, v, causal=causal), reps=3, warmup=1),
        bound_ms=b, bound_by=by, library_ms=time_ms(torch, sdpa),
        shape=f"B={B} Sq={Sq} Skv={Skv} H={H} KVH={KVH} hd={hd} bf16 "
              f"{'causal' if causal else 'bidirectional'} (wgmma route)")
    r["tflops"] = ops / r["ms"] / 1e9
    log(f"encdec: K6 flash_attention.{what} {r['shape']} max_abs_err {err} "
        f"(within 3e-2 and one bf16 rounding of the plain version, "
        f"{floor:.3g} near zero; SDPA vs plain {lib_err}); q, k, v "
        f"TMA-ready in place {ready} (else copied by the wrapper, in "
        f"wrapper_ms); kernel_ms {r['ms']:.4f} "
        f"({r['tflops']:.1f} TFLOP/s) wrapper_ms {r['wrapper_ms']:.4f} "
        f"plain_ms {r['plain_ms']:.4f} bound_ms {b:.5f} ({by}) library_ms "
        f"{r['library_ms']:.4f} (SDPA, is_causal={causal})")
    return r


def _encdec_whisper(torch, np):
    """Whisper-small whole (12 encoder + 12 decoder layers): K6 at the
    encoder's shape on the first layer's projections, serving (K6 once
    per encoder and decoder layer, nothing else), the logit gates, and 2
    + 2 layers at full width in float32 on the card against the CPU."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.models import model as M
    from repro_torch.models.layers import rmsnorm

    cfg = dataclasses.replace(cb.get_config("whisper-small"),
                              attn_impl="pallas")
    B = len(WHISPER_PROMPTS)
    enc = _frontend(np, cfg, B)
    params = _family_model(torch, cfg, f"{cfg.name} ({cfg.encoder_layers} "
                           f"encoder layers)", phase="encdec")
    # K6 on what the first encoder layer hands it
    with torch.inference_mode():
        blk = params.encoder[0]
        x = torch.from_numpy(enc).cuda().to(torch.bfloat16)
        S = x.shape[1]
        pos = torch.arange(S, device="cuda")[None].expand(B, S)
        h = rmsnorm(x + M._sinusoid(pos, cfg.d_model, x.dtype),
                    blk.norm1.scale, cfg.norm_eps)
        q, k, v = blk.mixer.wq(h), blk.mixer.wk(h), blk.mixer.wv(h)
        row = _k6_served_row(torch, k6, q, k, v, False, "whisper_enc")
        del x, h, q, k, v
    n = cfg.encoder_layers + cfg.num_layers
    _, toks, res = _family_serve(
        torch, np, cfg, params, WHISPER_PROMPTS, WHISPER_MAX_SEQ,
        {"flash_attention": n, "flash_attention.wgmma": n}, cfg.name,
        enc=enc, phase="encdec")
    # the gates with a key block of the encoder's length: at the config's
    # 1,024 the plain attention pads 1,500 keys to 2,048 and, being
    # bidirectional, counts the 548 zero keys (the reference's blocked
    # attention masks padding only through the causal test), which K6 and
    # the reference's kernel do not
    res.update(_prefill_logit_gates(
        torch, np, cfg, params, toks, WHISPER_MAX_SEQ, cfg.name, "encdec",
        enc, attn_kv_block=cfg.num_frontend_tokens))
    del params
    torch.cuda.empty_cache()
    c2 = dataclasses.replace(cfg, num_layers=2, encoder_layers=2,
                             dtype="float32")
    batch = _left_padded(torch, np, toks, "cpu")
    lg = {}
    for where in ("cpu", "cuda"):
        model = M.init_params(c2, torch.Generator().manual_seed(SEED),
                              device=where)
        lg[where] = M.prefill(model, c2, batch.to(where), M.init_cache(
            c2, B, WHISPER_MAX_SEQ, where, enc_len=c2.num_frontend_tokens),
            enc_inp=torch.from_numpy(enc).to(where))[0].cpu()
    cpu_err = float((lg["cuda"] - lg["cpu"]).abs().max())
    if not (bool(torch.isfinite(lg["cuda"]).all())
            and cpu_err <= CPU_LOGIT_TOL):
        raise AssertionError(f"whisper 2 + 2 layer float32 logits card vs "
                             f"CPU: max abs err {cpu_err} > {CPU_LOGIT_TOL}")
    log(f"encdec: {cfg.name}: 2 encoder + 2 decoder layers at full width, "
        f"float32: last-token logits on the card (K6) vs the CPU (plain "
        f"version) max abs err {cpu_err} (tolerance {CPU_LOGIT_TOL})")
    return dict(res, row=row, cpu_err=cpu_err)


def _encdec_vision(torch, np):
    """Llama-3.2-Vision-11B's backbone whole (40 layers, every 5th with
    cross attention to 1,601 patch embeddings): K6 at its prefill shape,
    serving (K6 once per layer, nothing else) and the logit gates."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.kernels import flash_attention as k6

    cfg = dataclasses.replace(cb.get_config("llama-3.2-vision-11b"),
                              attn_impl="pallas")
    B, S = len(VISION_PROMPTS), VISION_PROMPTS[0]
    q, k, v = _attn_inputs(torch, np, np.random.default_rng(SEED), B, S, S,
                           cfg.num_heads, cfg.num_kv_heads,
                           cfg.resolved_head_dim, torch.bfloat16)
    row = _k6_served_row(torch, k6, q, k, v, True, "vision")
    del q, k, v
    enc = _frontend(np, cfg, B)
    params = _family_model(torch, cfg, cfg.name, phase="encdec")
    _, toks, res = _family_serve(
        torch, np, cfg, params, VISION_PROMPTS, VISION_MAX_SEQ,
        {"flash_attention": cfg.num_layers,
         "flash_attention.wgmma": cfg.num_layers}, cfg.name, enc=enc,
        phase="encdec")
    res.update(_prefill_logit_gates(torch, np, cfg, params, toks,
                                    VISION_MAX_SEQ, cfg.name, "encdec", enc))
    return dict(res, row=row)


def phase_encdec(torch, np):
    """Whisper-small (its encoder bidirectional through K6) and
    Llama-3.2-Vision-11B's backbone at full width behind the engine, one
    after the other (each model dropped before the next is made).
    Returns each model's metrics and the kernel table's rows."""
    import gc

    out, failed = {}, []
    for name, fn in (("whisper", _encdec_whisper),
                     ("vision", _encdec_vision)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            out[name] = fn(torch, np)
        except Exception:  # report it, then go on to the next model
            traceback.print_exc()
            failed.append(name)
        log(f"encdec: {name} {'FAILED' if name in failed else 'passed'} "
            f"in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"encdec: {failed} failed")
    out["rows"] = {"flash_attention.whisper_enc": out["whisper"].pop("row"),
                   "flash_attention.vision": out["vision"].pop("row")}
    return out


# phase train: the trainer on the card.  TinyLlama-1.1B whole through
# ``launch/train.train``; the resilient loop's resume and the card-vs-CPU
# gradients at 2 of its layers; DeepSeek-V2's forward and backward at 2 of
# 60 layers through K7's backward pass; K6 under autograd
TRAIN_BATCH, TRAIN_SEQ = 8, 2048    # TinyLlama's pretraining context
TRAIN_STEPS = 6
RESUME_LAYERS, RESUME_EVERY, RESUME_PREEMPT = 2, 3, 4
CPU_GRAD_BATCH, CPU_GRAD_SEQ = 1, 256
DEEPSEEK_TRAIN_B, DEEPSEEK_TRAIN_S = 4, 512  # the served prefill's shape
TRAIN_REL_TOL = 1e-4        # float32: card vs CPU, K7 vs plain, resumed


def _rel_err(torch, got, want) -> float:
    """max |got - want| over max |want| (0 when both are 0)."""
    got, want = got.detach(), want.detach()
    top = float(want.abs().max()) if want.numel() else 0.0
    err = float((got.float() - want.float()).abs().max()) \
        if want.numel() else 0.0
    return err / top if top else err


def _grads_rel_err(torch, names, got, want):
    """The largest :func:`_rel_err` over the parameters ``names`` of two
    gradient lists (``want`` may lie on the host); (err, its name)."""
    worst = (-1.0, None)
    for name, g, w in zip(names, got, want):
        e = _rel_err(torch, g, w.to(g.device))
        worst = max(worst, (e, name), key=lambda t: t[0])
    return worst


def _train_k6_raises(torch, np):
    """K6 on TinyLlama's prefill shape with q, k, v requiring gradients
    raises NotImplementedError and launches nothing."""
    from repro_torch.kernels import flash_attention as k6

    q, k, v = (t.requires_grad_() for t in _attn_inputs(
        torch, np, np.random.default_rng(SEED), 4, 512, 512, 32, 4, 64,
        torch.bfloat16))
    before = k6.flash_attention.launches
    try:
        k6.flash_attention(q, k, v)
    except NotImplementedError as e:
        log(f"train: K6 under autograd raised NotImplementedError: {e}")
    else:
        raise AssertionError("K6 returned a result under autograd")
    if k6.flash_attention.launches != before:
        raise AssertionError("K6 launched under autograd")


def _train_batch(torch, cfg, B, S, step=0):
    from repro_torch.data.pipeline import TokenDataset

    b = TokenDataset(cfg.vocab_size, S, B, seed=SEED).batch_at(step)
    return {k: torch.from_numpy(v).to("cuda").long() for k, v in b.items()}


def _train_tinyllama(torch, np):
    """TinyLlama-1.1B, all 22 layers (remat="block", float32 weights and
    moments, bf16 compute), TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens through ``train`` with no checkpoint; then one more step
    profiled.  Its main path launches none of the seven kernels."""
    from repro_torch.configs import base as cb
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import backend as kb
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FaultConfig

    cfg = cb.get_config("tinyllama-1.1b")
    mesh = make_host_mesh()  # the trainer's: (1, 1) on one card
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                decay_steps=TRAIN_STEPS,
                                state_dtype=cfg.opt_state_dtype)
    torch.cuda.reset_peak_memory_stats()
    kb.reset_launch_counts()
    t0 = time.perf_counter()
    state, hist = train(cfg, opt_cfg, FaultConfig(ckpt_dir=None),
                        num_steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                        seq_len=TRAIN_SEQ, mesh=mesh, seed=SEED, log_every=1)
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in kb.launch_counts().items() if n}
    if counts:
        raise AssertionError(f"TinyLlama's training launched {counts}")
    steps = hist["steps"]
    losses = [h["loss"] for h in steps]
    if len(steps) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: {len(steps)} steps, losses {losses}")
    step_s = statistics.median(h["step_s"] for h in steps[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(p.numel() for p in state["params"].parameters())
    # matmul weights: all but the embedding table (a gather); under
    # remat="block" the backward recomputes each layer's forward (2 N_layers
    # per token more), the head and the loss once
    n_mm = n_params - cfg.vocab_size * cfg.d_model
    n_layers = n_mm - cfg.d_model * cfg.vocab_size - cfg.d_model
    mfu = 6 * n_mm * tokens / step_s / BF16_OPS_PER_S
    hfu = (6 * n_mm + 2 * n_layers) * tokens / step_s / BF16_OPS_PER_S
    log(f"train: {cfg.name}: {cfg.num_layers} layers, {n_params:,} "
        f"{cfg.param_dtype} parameters, {cfg.opt_state_dtype} moments, "
        f"remat {cfg.remat}, compute {cfg.dtype}; {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {wall:.1f} s (the first "
        f"{steps[0]['step_s'] * 1e3:.1f} ms); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; no kernel launched")
    log(f"train: step_ms {step_s * 1e3:.3f} (median of steps 2-"
        f"{TRAIN_STEPS}: {[round(h['step_s'] * 1e3, 1) for h in steps]})")
    log(f"train: tokens_per_s {tokens / step_s:.1f}")
    log(f"train: model_flop_share {mfu:.4f} (6 N T, N = {n_mm:,} matmul "
        f"weights, over the bf16 dense peak); with the recompute "
        f"{hfu:.4f}")
    log(f"train: peak_gib {peak:.2f}")
    step_fn = st.make_train_step(cfg, opt_cfg)
    batch = _train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS)
    with shd.use_mesh(mesh):
        prof = _profiled(torch, f"{cfg.name} train step ({TRAIN_BATCH} x "
                         f"{TRAIN_SEQ} tokens)", lambda: step_fn(state, batch))
    if prof:  # the step's device time by kind of kernel
        kinds = {}
        for key, (n, ms) in prof["kernels"].items():
            kind = ("matmul" if any(t in key for t in ("gemm", "xmma",
                                                       "cutlass"))
                    else "elementwise" if "elementwise" in key
                    else "reduction" if "reduce" in key else "other")
            kinds[kind] = [a + b for a, b in zip(kinds.get(kind, (0, 0.0)),
                                                 (n, ms))]
        log("train: step device ms by kernel kind: " + ", ".join(
            f"{k} {ms:.1f} ({n} launches)"
            for k, (n, ms) in sorted(kinds.items(), key=lambda t: -t[1][1])))
    named = dict(state["params"].named_parameters())
    grads = {k: shd.distribute(torch.randn(p.shape, device="cuda"),
                               p.placements, mesh)
             for k, p in named.items()}
    adamw_ms = time_ms(torch, lambda: adamw.apply_updates(
        opt_cfg, {k: p.detach() for k, p in named.items()}, state["opt"],
        grads), reps=3, warmup=1)
    # the same update over the same tensors' local blocks (plain tensors):
    # what the DTensors add, in one run
    opt_local = {"step": shd.local(state["opt"]["step"]),
                 **{n: {k: shd.local(t) for k, t in state["opt"][n].items()}
                    for n in ("m", "v")}}
    adamw_plain_ms = time_ms(torch, lambda: adamw.apply_updates(
        opt_cfg, {k: shd.local(p.detach()) for k, p in named.items()},
        opt_local, {k: shd.local(g) for k, g in grads.items()}),
        reps=3, warmup=1)
    log(f"train: adamw_ms {adamw_ms:.3f} (apply_updates over {n_params:,} "
        f"float32 weights and moments, DTensors on the (1, 1) mesh); "
        f"adamw_plain_ms {adamw_plain_ms:.3f} (the same over their local "
        f"tensors)")
    return dict(step_ms=step_s * 1e3, tokens_per_s=tokens / step_s,
                model_flop_share=mfu, with_recompute=hfu, peak_gib=peak,
                adamw_ms=adamw_ms, adamw_plain_ms=adamw_plain_ms,
                launches=prof and prof["launches"],
                idle=prof and 1 - prof["busy"] / prof["wall"])


def _train_resume(torch, np):
    """TinyLlama at full width, RESUME_LAYERS of 22 layers: TRAIN_STEPS
    steps uninterrupted, then with a checkpoint every RESUME_EVERY steps
    and a preemption before step RESUME_PREEMPT + 1, which run_resilient
    resumes from the checkpoint: each step's loss within TRAIN_REL_TOL of
    the uninterrupted run's.  Then the same model's float32 loss and
    gradients on the card against the CPU's."""
    import dataclasses
    import tempfile

    from repro_torch.configs import base as cb
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FaultConfig, Preempted

    cfg = dataclasses.replace(cb.get_config("tinyllama-1.1b"),
                              num_layers=RESUME_LAYERS)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                decay_steps=TRAIN_STEPS)
    kw = dict(num_steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
              seq_len=TRAIN_SEQ, seed=SEED, log_every=TRAIN_STEPS)
    a, ha = train(cfg, opt_cfg, FaultConfig(ckpt_dir=None), **kw)
    fired = []

    def preempt(step):
        if step == RESUME_PREEMPT and not fired:
            fired.append(step)
            raise Preempted(f"preempted before step {step + 1}")

    with tempfile.TemporaryDirectory() as tmp:
        fcfg = FaultConfig(ckpt_dir=tmp, ckpt_every=RESUME_EVERY, keep=1,
                           async_save=False)
        b, hb = train(cfg, opt_cfg, fcfg, preempt_hook=preempt, **kw)
    order = [h["step"] for h in hb["steps"]]
    want = (list(range(RESUME_PREEMPT)) + list(range(RESUME_EVERY,
                                                      TRAIN_STEPS)))
    if hb["restarts"] != 1 or order != want or len(hb["restore_s"]) != 1:
        raise AssertionError(f"resume: restarts {hb['restarts']}, steps "
                             f"{order} (want {want}), restores "
                             f"{hb['restore_s']}")
    last = {h["step"]: h["loss"] for h in hb["steps"]}
    diffs = [abs(last[h["step"]] - h["loss"]) / abs(h["loss"])
             for h in ha["steps"]]
    pdiff = max(_rel_err(torch, pb, pa) for pa, pb in
                zip(a["params"].parameters(), b["params"].parameters()))
    state_gb = 3 * sum(p.numel() * 4 for p in a["params"].parameters()) / 1e9
    log(f"train: resume at {RESUME_LAYERS} of 22 layers ({state_gb:.2f} GB "
        f"of weights and moments a save): preempted before step "
        f"{RESUME_PREEMPT + 1}, resumed from step {RESUME_EVERY}; losses "
        f"{[round(h['loss'], 6) for h in ha['steps']]}; largest relative "
        f"loss difference to the uninterrupted run {max(diffs)} "
        f"({'zero' if max(diffs) == 0 else 'not zero'}; tolerance "
        f"{TRAIN_REL_TOL}); final weights {pdiff} apart")
    log(f"train: save_s {[round(s, 3) for s in hb['save_s']]} (blocking: the "
        f"copy to the host and the disk write), restore_s "
        f"{[round(s, 3) for s in hb['restore_s']]}")
    if not max(diffs) <= TRAIN_REL_TOL:
        raise AssertionError(f"resumed losses differ by {max(diffs)}")
    del a, b

    c32 = dataclasses.replace(cfg, dtype="float32")
    card = M.init_params(c32, torch.Generator(device="cuda").manual_seed(SEED))
    cpu = M.init_params(c32, torch.Generator().manual_seed(SEED))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = _train_batch(torch, c32, CPU_GRAD_BATCH, CPU_GRAD_SEQ)
    res = []
    for model, b in ((card, batch), (cpu, {k: v.cpu()
                                           for k, v in batch.items()})):
        names = [n for n, _ in model.named_parameters()]
        loss, _ = M.loss_fn(model, c32, b)
        res.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    loss_err = _rel_err(torch, res[0][0].cpu(), res[1][0])
    grad_err, worst = _grads_rel_err(torch, names, [g.cpu() for g in
                                                    res[0][1]], res[1][1])
    log(f"train: {RESUME_LAYERS} layers at full width, float32, "
        f"{CPU_GRAD_BATCH} x {CPU_GRAD_SEQ} tokens: loss card "
        f"{float(res[0][0])} vs CPU {float(res[1][0])} (relative "
        f"{loss_err}), gradients {grad_err} ({worst}); tolerance "
        f"{TRAIN_REL_TOL}")
    if not (loss_err <= TRAIN_REL_TOL and grad_err <= TRAIN_REL_TOL):
        raise AssertionError("card and CPU gradients differ")
    return dict(max_loss_diff=max(diffs), save_s=hb["save_s"],
                restore_s=hb["restore_s"], cpu_loss_err=loss_err,
                cpu_grad_err=grad_err)


def _train_deepseek(torch, np):
    """DeepSeek-V2 at full width, 2 of 60 layers (the dense lead layer and
    one MoE layer of 160 experts, top-6, MLA; remat="block"): one forward
    and backward of DEEPSEEK_TRAIN_B x DEEPSEEK_TRAIN_S tokens (no
    optimizer step: float32 weights and gradients take 43 GB) with the
    expert products through K7 and through the plain grouped matmul, in
    float32 and in bf16.  K7 launches 9 times (3 forward, 3 recomputed, 3
    dx), nothing else; float32 within TRAIN_REL_TOL of the plain run,
    bf16 within BF16_SPREAD of the plain bf16 run's distance from the
    float32 one; the float32 K7 run's peak memory beside the plain
    run's and beside the memory in use as its dx launches start.  Then K7's dx launch at this routing's counts on W1 as stored
    (no transposed copy on the path), timed beside torch.bmm's dW and
    torch.bmm's dx."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import base as cb
    from repro_torch.kernels import backend as kb
    from repro_torch.kernels import grouped_matmul as k7
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfg = dataclasses.replace(cb.get_config("deepseek-v2-236b"),
                              num_layers=DEEPSEEK_LAYERS)
    params = _family_model(torch, cfg, f"{cfg.name} ({DEEPSEEK_LAYERS} of 60 "
                           f"layers)", phase="train")
    names = [n for n, _ in params.named_parameters()]
    batch = _train_batch(torch, cfg, DEEPSEEK_TRAIN_B, DEEPSEEK_TRAIN_S)
    peaks, at_dx = {}, {}  # GiB, by (dtype, plain) and by dtype
    launch = k7.kernel_launch

    def recording(x, w, sizes, cap, route=None):
        if route == "backward":  # memory in use as a dx launch starts
            at_dx.setdefault(x.dtype, []).append(
                torch.cuda.memory_allocated() / 2**30)
        return launch(x, w, sizes, cap, route)

    def run(dtype, plain):
        c = dataclasses.replace(cfg, dtype=dtype)
        gmm = k7.grouped_matmul_plain if plain else k7.grouped_matmul
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kb.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(moe, "grouped_matmul", gmm), \
                mock.patch.object(k7, "kernel_launch", recording):
            loss, met = M.loss_fn(params, c, batch)
            grads = torch.autograd.grad(loss, list(params.parameters()))
        torch.cuda.synchronize()
        counts = {k: n for k, n in kb.launch_counts().items() if n}
        peaks[dtype, plain] = torch.cuda.max_memory_allocated() / 2**30
        log(f"train: deepseek {dtype} {'plain' if plain else 'K7'}: loss "
            f"{float(loss)} (ce {float(met['ce'])}, aux {float(met['aux'])})"
            f" forward and backward in {time.perf_counter() - t0:.2f} s, "
            f"peak {peaks[dtype, plain]:.2f} GiB, launched {counts}")
        return loss.detach(), grads, counts

    want = {"grouped_matmul": 9, "grouped_matmul.counts": 6,
            "grouped_matmul.backward": 3}
    ref_loss, ref, _ = run("float32", True)
    ref_loss, ref = ref_loss.cpu(), [g.cpu() for g in ref]
    out = {}
    for dtype, plain in (("float32", False), ("bfloat16", False),
                         ("bfloat16", True)):
        loss, grads, counts = run(dtype, plain)
        if counts != ({} if plain else want):
            raise AssertionError(f"deepseek {dtype}: launched {counts}, "
                                 f"want {want if not plain else {}}")
        if not plain:
            experts = params.layers[1].ffn.experts
            for w in ("w1", "w2", "w3"):
                g = grads[names.index(f"layers.1.ffn.experts.{w}")]
                live = int((g.flatten(1).abs().amax(1) > 0).sum())
                if not live:
                    raise AssertionError(f"deepseek: {w}'s gradient is 0")
                log(f"train: deepseek {dtype} K7: {live} of "
                    f"{experts.w1.shape[0]} experts have a nonzero {w} "
                    f"gradient")
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"deepseek {dtype}: non-finite gradient")
        label = f"{dtype} {'plain' if plain else 'K7'}"
        out[label] = (_rel_err(torch, loss.cpu(), ref_loss),
                      *_grads_rel_err(torch, names, grads, ref))
        log(f"train: deepseek {label} vs float32 plain: loss "
            f"{out[label][0]}, gradients {out[label][1]} ({out[label][2]})")
        if dtype == "float32":
            k7_counts = counts
        del grads
    f32, b16, b16p = (out["float32 K7"], out["bfloat16 K7"],
                      out["bfloat16 plain"])
    if not (f32[0] <= TRAIN_REL_TOL and f32[1] <= TRAIN_REL_TOL):
        raise AssertionError(f"deepseek float32: K7 vs plain {f32}")
    for i, what in ((0, "loss"), (1, "gradients")):
        if not b16[i] <= BF16_SPREAD * b16p[i]:
            raise AssertionError(f"deepseek bf16 {what}: K7 {b16[i]} from "
                                 f"float32, plain {b16p[i]}")
    log(f"train: deepseek gates: float32 K7 vs plain loss {f32[0]}, "
        f"gradients {f32[1]} (tolerance {TRAIN_REL_TOL}); bf16 K7 "
        f"{b16[0]} / {b16[1]} vs plain bf16 {b16p[0]} / {b16p[1]} from "
        f"float32 (factor {BF16_SPREAD})")
    w1_gib = params.layers[1].ffn.experts.w1.numel() * 4 / 2**30
    dx_gib = max(at_dx[torch.float32])
    log(f"train: deepseek float32 K7 run's peak {peaks['float32', False]:.2f}"
        f" GiB (plain run {peaks['float32', True]:.2f} GiB); in use as its "
        f"{len(at_dx[torch.float32])} dx launches start: up to {dx_gib:.2f} "
        f"GiB, so a transposed copy of W1 ({w1_gib:.2f} GiB) there would "
        f"reach {dx_gib + w1_gib:.2f} GiB; the launches read W1 in place")
    del ref

    # K7's dx launch at the prefill's w1 product: dy (E cap, F) noise, the
    # kept counts of a routing of this batch's shape, W1 as stored read as
    # W1^T in place
    ffn = params.layers[1].ffn
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    T = DEEPSEEK_TRAIN_B * DEEPSEEK_TRAIN_S
    xt = torch.randn((T, cfg.d_model), generator=gen,
                     device="cuda").to(torch.bfloat16)
    ids, _, _, cap, _, keep = moe._assign(ffn, xt, cfg)
    E, D, F = ffn.experts.w1.shape
    counts = torch.zeros(E, dtype=torch.int64, device="cuda")
    counts.scatter_add_(0, ids.reshape(-1).long(), keep.long())
    w = ffn.experts.w1.detach().to(torch.bfloat16)
    wt = w.transpose(1, 2)  # a view: the kernel reads W1 as it lies
    storage, k_major = k7.b_storage(wt)
    if not k_major or storage.data_ptr() != w.data_ptr():
        raise AssertionError("K7's dx launch would copy W1^T")
    dy = torch.randn((E * cap, F), generator=gen,
                     device="cuda").to(torch.bfloat16)
    x = torch.randn((E * cap, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    r = _k7_counts_row(torch, np, k7, "backward dx", dy, wt, cap,
                       counts.cpu().numpy())
    r["library_ms"] = time_ms(torch, lambda: torch.bmm(
        dy.view(E, cap, F), wt), reps=10)
    r["dw_ms"] = time_ms(torch, lambda: torch.bmm(
        x.view(E, cap, D).transpose(1, 2), dy.view(E, cap, F)), reps=10)
    log(f"train: K7 grouped_matmul.backward (dx = dy W1^T) {r['shape']} "
        f"max_abs_err {r['max_abs_err']} (vs the contiguous launch on the "
        f"kept rows {r['packed_err']}), unkept rows exactly zero; kernel_ms "
        f"{r['ms']:.4f} wrapper_ms {r['wrapper_ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} ({r['bound_by']})"
        f" library_ms {r['library_ms']:.4f} (torch.bmm over dy and W1's "
        f"transposed view); transposed copy of W1: none on the path (the "
        f"launch reads W1's {w.numel() * 2 / 1e9:.2f} GB as stored, "
        f"K-major); dW = x^T dy by torch.bmm {r['dw_ms']:.4f} ms")
    return dict(row=r, counts=k7_counts, gates=out,
                peak_gib={f"{d} {'plain' if p else 'K7'}": v
                          for (d, p), v in peaks.items()},
                float32_at_dx_gib=dx_gib)


def phase_train(torch, np):
    """K6 under autograd, TinyLlama-1.1B's training, the resume and
    card-vs-CPU gates at 2 layers, DeepSeek-V2's backward through K7, each
    model dropped before the next is made.  Returns each part's metrics
    and the kernel table's row of K7's backward route."""
    import gc

    _train_k6_raises(torch, np)
    out = {}
    for name, fn in (("tinyllama", _train_tinyllama),
                     ("resume", _train_resume),
                     ("deepseek", _train_deepseek)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = fn(torch, np)
        log(f"train: {name} passed in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    out["rows"] = {"grouped_matmul.backward": out["deepseek"].pop("row")}
    return out


MESH_DEEPSEEK_B, MESH_DEEPSEEK_S = 4, 512    # the served prefill's shape
MESH_TRAIN_B, MESH_TRAIN_S = 2, 512
MESH_DECODE_STEPS = 8
MESH_REL_TOL = 1e-4         # float32: the mesh path vs the path without one


def _mesh_deepseek(torch, np, mesh):
    """DeepSeek-V2 at full width, 2 of 60 layers, float32: one forward
    and backward of MESH_DEEPSEEK_B x MESH_DEEPSEEK_S tokens without a
    mesh (the einsum dispatch), then the same on ``mesh`` (the zipper
    dispatch, ``_shardmap_moe``: the all_to_all exchanges and the kept
    rows moved first, K7 on the rank's experts).  Logits and gradients
    within MESH_REL_TOL; K7 launches 9 times on either (3 forward, 3
    recomputed, 3 dx)."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import backend as kb
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cb.get_config("deepseek-v2-236b"),
                              num_layers=DEEPSEEK_LAYERS, dtype="float32")
    params = _family_model(torch, cfg, f"{cfg.name} ({DEEPSEEK_LAYERS} of 60 "
                           f"layers, float32 compute)", phase="mesh")
    names = [n for n, _ in params.named_parameters()]
    batch = _train_batch(torch, cfg, MESH_DEEPSEEK_B, MESH_DEEPSEEK_S)

    def run(label):
        torch.cuda.synchronize()
        kb.reset_launch_counts()
        shd.reset_collective_counts()
        t0 = time.perf_counter()
        loss, met = M.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss / shd.world_size(),
                                    list(params.parameters()))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: n for k, n in kb.launch_counts().items() if n}
        coll = shd.collective_counts()
        with torch.no_grad():
            logits = M.forward(params, cfg, batch["tokens"])[0]
        if shd.is_dtensor(logits):
            logits = logits.full_tensor()
        grads = [g.full_tensor() if shd.is_dtensor(g) else g for g in grads]
        loss = loss.detach()
        log(f"mesh: deepseek {label}: loss {float(loss)} (ce "
            f"{float(met['ce'])}, aux {float(met['aux'])}), forward and "
            f"backward in {secs:.2f} s; launched {counts}; collectives "
            f"{coll}")
        return loss, logits, grads, counts, coll

    ref_loss, ref_logits, ref, ref_counts, _ = run("without a mesh (einsum)")
    ref_loss, ref_logits = ref_loss.cpu(), ref_logits.cpu()
    ref = [g.cpu() for g in ref]
    with shd.use_mesh(mesh):
        shd.shard_model(params, cfg.fsdp)
        loss, logits, grads, counts, coll = run(
            f"on the {tuple(mesh.shape)} mesh (zipper, _shardmap_moe)")
    want = {"grouped_matmul": 9, "grouped_matmul.counts": 6,
            "grouped_matmul.backward": 3}
    if counts != want or ref_counts != want:
        raise AssertionError(f"deepseek: K7 launched {counts} on the mesh, "
                             f"{ref_counts} without, want {want}")
    if not coll.get("all_to_all"):
        raise AssertionError(f"deepseek: no all_to_all on the mesh: {coll}")
    loss_err = _rel_err(torch, loss.cpu(), ref_loss)
    logit_err = _rel_err(torch, logits.cpu(), ref_logits)
    grad_err, worst = _grads_rel_err(torch, names, grads, ref)
    log(f"mesh: deepseek gates: loss {loss_err}, logits {logit_err}, "
        f"gradients {grad_err} ({worst}) relative, tolerance {MESH_REL_TOL}")
    if not max(loss_err, logit_err, grad_err) <= MESH_REL_TOL:
        raise AssertionError(f"deepseek on the mesh: loss {loss_err}, logits"
                             f" {logit_err}, gradients {grad_err} ({worst})")
    return dict(counts=counts, collectives=coll, loss_err=loss_err,
                logit_err=logit_err, grad_err=grad_err)


def _mesh_tinyllama(torch, np):
    """TinyLlama-1.1B whole, float32: saved with no mesh, restored by
    ``elastic.reshard_restore`` onto ``elastic.remesh(1)``; one train step
    of MESH_TRAIN_B x MESH_TRAIN_S tokens there under the default
    ``layer_layout="tp"`` and one without a mesh from the same weights
    (loss and weights within MESH_REL_TOL), and one under ``"sp"`` from
    the same weights restored again (within MESH_REL_TOL of the "tp"
    step; both step times printed); then a prefill through K6
    (``attn_impl="pallas"``, its launches on the mesh counted) and
    MESH_DECODE_STEPS decode steps with the caches placed by
    ``cache_shardings`` beside the same without a mesh (float32 logits
    within CPU_LOGIT_TOL; the mesh's next token picked over the
    vocabulary by ``sharding.vocab_argmax``, which must be the argmax of
    the whole logits)."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import base as cb
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import backend as kb
    from repro_torch.launch import steps as st
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic

    cfg = dataclasses.replace(cb.get_config("tinyllama-1.1b"),
                              dtype="float32")
    if cfg.layer_layout != "tp":
        raise AssertionError(f"the default layout is {cfg.layer_layout}")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, decay_steps=10)
    plain = _family_model(torch, cfg, f"{cfg.name} (float32 compute)",
                          phase="mesh")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tmp, 0, {k: p.detach() for k, p in
                           plain.named_parameters()})
        t_save = time.perf_counter() - t0
        mesh = elastic.remesh(1)
        restored = []
        for seed in (1, 2):  # one model for each layout
            model = M.init_params(cfg, torch.Generator(device="cuda")
                                  .manual_seed(SEED + seed))
            t0 = time.perf_counter()
            restored.append(elastic.reshard_restore(tmp, model, mesh,
                                                    fsdp=cfg.fsdp))
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            del model
    sharded, sharded_sp = restored
    del restored
    with shd.use_mesh(mesh):
        want = shd.param_shardings(sharded, cfg.fsdp)
    wrong = [n for n, p in sharded.named_parameters()
             if tuple(p.placements) != want[n].placements]
    if wrong:
        raise AssertionError(f"reshard_restore: placements of {wrong[:4]}")
    log(f"mesh: tinyllama: {cfg.num_layers} layers saved with no mesh in "
        f"{t_save:.1f} s, restored onto {mesh} (elastic.remesh(1)) in "
        f"{t_restore:.1f} s, every parameter on its rule's placements")
    batch = _train_batch(torch, cfg, MESH_TRAIN_B, MESH_TRAIN_S)
    res, step_s = {}, {}
    sp = dataclasses.replace(cfg, layer_layout="sp")
    for label, model, m, c in (("without a mesh", plain, None, cfg),
                               ("on the mesh (tp)", sharded, mesh, cfg),
                               ("on the mesh (sp)", sharded_sp, mesh, sp)):
        with shd.use_mesh(m):
            state = {"params": model, "opt": adamw.init_state(
                opt_cfg, dict(model.named_parameters()))}
            shd.reset_collective_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = st.make_train_step(c, opt_cfg)(state, batch)
            res[label] = float(met["loss"])
            step_s[label] = time.perf_counter() - t0
        del state
        log(f"mesh: tinyllama train step {label}: loss {res[label]}, "
            f"grad_norm {float(met['grad_norm'])}, {step_s[label]:.2f} s "
            f"({smi()}); collectives {shd.collective_counts()}")

    def max_weight_err(a, b):
        return max(((_rel_err(torch, pa.detach().full_tensor()
                              if shd.is_dtensor(pa) else pa.detach(),
                              pb.detach().full_tensor()), n) for
                    (n, pa), pb in zip(a.named_parameters(), b.parameters())),
                   key=lambda t: t[0])

    loss_err = abs(res["on the mesh (tp)"] - res["without a mesh"]) / abs(
        res["without a mesh"])
    w_err, worst = max_weight_err(plain, sharded)
    sp_loss_err = abs(res["on the mesh (sp)"] - res["on the mesh (tp)"]) / \
        abs(res["on the mesh (tp)"])
    sp_w_err, sp_worst = max_weight_err(sharded, sharded_sp)
    del sharded_sp
    log(f"mesh: tinyllama train gates: tp vs without a mesh: loss "
        f"{loss_err}, weights {w_err} ({worst}); sp vs tp: loss "
        f"{sp_loss_err}, weights {sp_w_err} ({sp_worst}); relative, "
        f"tolerance {MESH_REL_TOL}; step s tp {step_s['on the mesh (tp)']:.3f}"
        f", sp {step_s['on the mesh (sp)']:.3f} | {smi()}")
    if not (loss_err <= MESH_REL_TOL and w_err <= MESH_REL_TOL):
        raise AssertionError(f"train step on the mesh: loss {loss_err}, "
                             f"weights {w_err} ({worst})")
    if not (sp_loss_err <= MESH_REL_TOL and sp_w_err <= MESH_REL_TOL):
        raise AssertionError(f"sp step vs tp step: loss {sp_loss_err}, "
                             f"weights {sp_w_err} ({sp_worst})")

    serve = dataclasses.replace(cfg, attn_impl="pallas")  # K6 in prefill
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        MESH_TRAIN_B, MESH_TRAIN_S))).cuda()
    smax = MESH_TRAIN_S + MESH_DECODE_STEPS
    errs = []
    with shd.use_mesh(mesh):
        cache = st.place_cache(M.init_cache(cfg, MESH_TRAIN_B, smax, "cuda"))
    cache_p = M.init_cache(cfg, MESH_TRAIN_B, smax, "cuda")
    shd.reset_collective_counts()
    t0 = time.perf_counter()
    kb.reset_launch_counts()
    with shd.use_mesh(mesh):
        lg, cache = M.prefill(sharded, serve, toks, cache)
    torch.cuda.synchronize()
    k6 = {k: n for k, n in kb.launch_counts().items() if n}
    lg_p, cache_p = M.prefill(plain, serve, toks, cache_p)
    errs.append(float((lg.full_tensor() - lg_p).abs().max()))
    for i in range(MESH_DECODE_STEPS):
        nxt = lg_p.argmax(-1)[:, None]
        if not torch.equal(shd.vocab_argmax(lg), lg.full_tensor().argmax(-1)):
            raise AssertionError("decode: vocab_argmax is not the argmax")
        with shd.use_mesh(mesh):
            lg, cache = M.decode_step(sharded, serve, nxt, cache,
                                      MESH_TRAIN_S + i)
        lg_p, cache_p = M.decode_step(plain, serve, nxt, cache_p,
                                      MESH_TRAIN_S + i)
        errs.append(float((lg.full_tensor() - lg_p).abs().max()))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with shd.use_mesh(mesh):
        placed = st.cache_shardings(cache)
    if any(tuple(t.placements) != placed[i][n].placements
           for i, c in enumerate(cache) for n, t in c.items()):
        raise AssertionError("decode: a cache left its placement")
    want_k6 = {"flash_attention": cfg.num_layers,
               "flash_attention.fma": cfg.num_layers}
    log(f"mesh: tinyllama prefill {MESH_TRAIN_B} x {MESH_TRAIN_S} (K6 on "
        f"the mesh: {k6}) + {MESH_DECODE_STEPS} decode steps, caches on "
        f"{placed[0]['k']}: float32 logits vs without a mesh, largest abs "
        f"diff per step {errs} (tolerance {CPU_LOGIT_TOL}); both paths "
        f"{secs:.2f} s; collectives {shd.collective_counts()}")
    if k6 != want_k6:
        raise AssertionError(f"prefill on the mesh launched {k6}, want "
                             f"{want_k6}")
    if not max(errs) <= CPU_LOGIT_TOL:
        raise AssertionError(f"decode on the mesh: logits {max(errs)} apart")
    return dict(loss_err=loss_err, weight_err=w_err, decode_err=max(errs),
                sp_loss_err=sp_loss_err, sp_weight_err=sp_w_err,
                tp_step_s=step_s["on the mesh (tp)"],
                sp_step_s=step_s["on the mesh (sp)"], save_s=t_save,
                restore_s=t_restore, counts=k6)


def phase_mesh(torch, np):
    """The sharded model paths on one card: the (1, 1) mesh of a
    one-process NCCL group (every collective issued), under the default
    ``layer_layout="tp"``: DeepSeek-V2's zipper dispatch over the
    all_to_all and TinyLlama-1.1B's reshard-on-restore, train step (and
    one under ``"sp"`` beside it) and sharded prefill (K6) and decode,
    each against the same without a mesh.  Returns the metrics and K6's
    and K7's launches."""
    import gc

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    backend = init_distributed()
    mesh = make_host_mesh()
    log(f"mesh: {mesh}, backend {backend} (default group), world size "
        f"{dist.get_world_size()}, model axis group "
        f"{dist.get_backend(mesh.get_group('model'))} | {smi()}")
    out = {}
    for name, fn in (("deepseek", lambda: _mesh_deepseek(torch, np, mesh)),
                     ("tinyllama", lambda: _mesh_tinyllama(torch, np))):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = fn()
        log(f"mesh: {name} passed in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the dry run's CLI cells at the production 16 x 16 mesh, traced at once
# (each its own process): the smallest full train cell, and DeepSeek-V2's
# decode, which reaches K7's shape-only path and _shardmap_moe's
# all_to_alls over a 16-rank model axis
DRYRUN_CELLS = (("tinyllama_1_1b", "train_4k"),
                ("deepseek_v2_236b", "decode_32k"),
                ("qwen1_5_0_5b", "decode_32k"),
                ("mamba2_780m", "decode_32k"))
DRYRUN_CLI_TIMEOUT_S = 80
# the calibration: the dry run on a (1, 1) mesh (a fake group of one)
# against the same steps on the card, TinyLlama-1.1B at phase train's
# shape and phase serve's prefill (K6) and one decode step
DRYRUN_CALIB = (("train", TRAIN_BATCH, TRAIN_SEQ, {}),
                ("prefill", 4, 512, {"attn_impl": "pallas"}),
                ("decode", 4, 1024, {"attn_impl": "pallas"}))
DRYRUN_PEAK_RANGE = (0.8, 1.25)   # predicted peak / max_memory_allocated
TOPK_SHARDS, TOPK_K = 16, 40
_RECORD_KEYS = {
    "memory": ("argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "peak_bytes_per_device"),
    "cost": ("flops_per_device", "bytes_per_device"),
    "collectives": ("total_bytes", "bytes", "bytes_by_axis", "counts"),
    "roofline": ("compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_lb_s", "roofline_fraction")}


def _record_complete(rec) -> bool:
    return "error" not in rec and all(
        k in rec for k in ("arch", "shape", "mesh", "n_chips", "trace_s",
                           "params", "active_params", "fits")) and all(
        rec.get(sec, {}).get(k) is not None
        for sec, keys in _RECORD_KEYS.items() for k in keys)


def _dryrun_cli(tmp):
    """Start ``python -m repro_torch.launch.dryrun`` on each of
    DRYRUN_CELLS (16 x 16), each with its own output file; returns the
    processes and their files."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(tmp, f"{arch}_{shape}.json")
        procs.append((arch, shape, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def _dryrun_cli_check(procs):
    """Wait for the CLI cells: each exits 0 with a complete record;
    DeepSeek-V2's decode traces K7 and _shardmap_moe's all_to_alls."""
    recs = {}
    for arch, shape, out, proc in procs:
        try:
            text, _ = proc.communicate(timeout=DRYRUN_CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"dryrun CLI {arch} x {shape}: past "
                                 f"{DRYRUN_CLI_TIMEOUT_S} s")
        with open(out) as f:
            rec = json.load(f)[f"{arch}|{shape}|16x16"]
        if proc.returncode != 0 or not _record_complete(rec):
            raise AssertionError(f"dryrun CLI {arch} x {shape}: exit "
                                 f"{proc.returncode}, record {rec}\n{text}")
        recs[f"{arch}|{shape}"] = rec
        log(f"dryrun: CLI {arch} x {shape} @ 16x16: exit 0, trace "
            f"{rec['trace_s']} s, peak "
            f"{rec['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB/card "
            f"(fits {rec['fits']}), args "
            f"{rec['memory']['argument_bytes_per_device'] / 2**30:.2f} GiB, "
            f"flops {rec['cost']['flops_per_device']:.4e}, kernel calls "
            f"{rec['cost']['kernel_calls']}, collectives "
            f"{rec['collectives']['counts']} "
            f"({rec['collectives']['total_bytes']:,} bytes), dominant "
            f"{rec['roofline']['dominant']}")
    ds = recs["deepseek_v2_236b|decode_32k"]
    if not (ds["cost"]["kernel_calls"]["grouped_matmul"]
            and ds["collectives"]["counts"].get("all_to_all")):
        raise AssertionError(f"dryrun: DeepSeek-V2's decode traced no K7 or "
                             f"no all_to_all: {ds['cost']} "
                             f"{ds['collectives']}")
    return recs


def _calib_real(torch, kind, B, S, over, mesh):
    """One TinyLlama step of ``kind`` on the card, on the (1, 1) mesh,
    from the inputs the dry run builds (``dryrun.step_inputs``, here
    with weights and tokens from SEED): the bytes its arguments
    allocate, its peak over that (``max_memory_allocated``), and its
    FLOPs (``FlopCounterMode`` around a second run, its module tracker
    off as in the dry run, ``dryrun.flop_counter``, plus the card FLOPs
    of its K6 and K7 launches, which ctypes makes invisible to it)."""
    import dataclasses
    import gc

    from repro_torch.configs import base as cb
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import flash_attention as k6
    from repro_torch.kernels import grouped_matmul as k7
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(cb.get_config("tinyllama-1.1b"), **over)
    shape = cb.ShapeConfig(f"calib_{kind}", S, B, kind)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    kflops = [0]
    real6, real7 = k6.launch, k7.launch

    def launch6(q, k, v, o, *, causal, window, scale):
        kflops[0] += k6.card_flops(
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
            causal=causal, window=window,
            route="wgmma" if q.dtype == torch.bfloat16 else "fma")
        real6(q, k, v, o, causal=causal, window=window, scale=scale)

    def launch7(x, w, sizes, out, *, cap=None, k_major=False):
        kflops[0] += k7.card_flops(x.shape[0], x.shape[1], out.shape[1],
                                   w.shape[0], cap)
        real7(x, w, sizes, out, cap=cap, k_major=k_major)

    # the arguments go to fresh segments, as in a fresh process: a block
    # cached by an earlier phase can hold a tensor with a remainder the
    # allocator does not split off (up to 1 MiB), counted as allocated
    pool = torch.cuda.MemPool()
    with shd.use_mesh(mesh):
        with torch.cuda.use_mem_pool(pool):
            step, args, _ = dryrun.step_inputs(
                cfg, shape, torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        arg_bytes = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        out = step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del out
        k6.launch, k7.launch = launch6, launch7
        try:
            with dryrun.flop_counter() as fc:
                step(*args)
            torch.cuda.synchronize()
        finally:
            k6.launch, k7.launch = real6, real7
    del args
    gc.collect()
    del pool
    torch.cuda.empty_cache()
    return dict(argument_bytes=arg_bytes, peak_bytes=peak,
                flops=fc.get_total_flops() + kflops[0],
                kernel_flops=kflops[0])


def _zipper_topk_check(torch, np):
    """``serving.sampler.zipper_topk`` on the card: TinyLlama's vocab of
    float32 logits (standard normal from SEED) in TOPK_SHARDS shards,
    top TOPK_K: the ids ``torch.topk``'s over the whole row, each value
    its logit, bit for bit the same call on the CPU; every merge a K5
    launch (counted).  Returns K5's row for the kernels line (one merge
    step's launch at this path's shape, S = 1, R = 64) and the
    launches."""
    from repro_torch.kernels import backend as kb
    from repro_torch.kernels import stream_merge as k5
    from repro_torch.serving.sampler import _chunk, zipper_topk

    V = 32000
    row = np.random.default_rng(SEED).standard_normal(V).astype(np.float32)
    shards = np.split(row, TOPK_SHARDS)
    card = [torch.from_numpy(s).cuda() for s in shards]
    zipper_topk(card, TOPK_K)  # warm
    torch.cuda.synchronize()
    kb.reset_launch_counts()
    t0 = time.perf_counter()
    vals, ids = zipper_topk(card, TOPK_K)
    torch.cuda.synchronize()
    z_ms = (time.perf_counter() - t0) * 1e3
    launches = kb.launch_counts()
    k5_n = launches["stream_merge"]
    if not k5_n or k5_n != launches["stream_merge.chunk"] or any(
            n for k, n in launches.items()
            if n and not k.startswith("stream_merge")):
        raise AssertionError(f"zipper_topk launched {launches}")
    cpu_vals, cpu_ids = zipper_topk(shards, TOPK_K, device="cpu")
    full = torch.from_numpy(row).cuda()
    want_v, want_i = torch.topk(full, TOPK_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.topk(full, TOPK_K)
    torch.cuda.synchronize()
    topk_ms = (time.perf_counter() - t0) * 1e3
    ids_c, vals_c = ids.cpu(), vals.cpu()
    if set(ids_c.tolist()) != set(want_i.cpu().tolist()) or not torch.equal(
            vals_c, torch.from_numpy(row)[ids_c]) or not torch.equal(
            ids_c, cpu_ids) or not torch.equal(vals_c, cpu_vals):
        raise AssertionError(f"zipper_topk: ids {ids_c.tolist()} vs "
                             f"torch.topk {want_i.tolist()}, CPU "
                             f"{cpu_ids.tolist()}")
    # one merge step at this path's shape: the first two shards' streams
    R = 1 << (TOPK_K - 1).bit_length()
    qa, qb = (torch.sort(torch.randperm(4 * R, device="cuda")[:TOPK_K]
                         .to(torch.int32))[0] * 2 + i for i in (0, 1))
    ga = torch.arange(TOPK_K, dtype=torch.float32, device="cuda")
    args = (*_chunk(qa, ga, 0, R), *_chunk(qb, ga + TOPK_K, 0, R))
    got = k5.stream_merge(*args)
    want = k5.stream_merge_plain(*args)
    err = max_abs_err(torch, got, want)
    b, by = bound_ms(nbytes(*args, *got), int(got[4].sum() + got[5].sum()))
    outs = [torch.empty_like(t) for t in got]
    row_ = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: k5.launch(*args, *outs), reps=50, warmup=5),
        wrapper_ms=time_ms(torch, lambda: k5.stream_merge(*args), reps=50,
                           warmup=5),
        plain_ms=time_ms(torch, lambda: k5.stream_merge_plain(*args),
                         reps=10, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"S=1 R={R}")
    log(f"dryrun: zipper_topk: {TOPK_SHARDS} shards of {V // TOPK_SHARDS} "
        f"float32 logits, k {TOPK_K} (R {R}): the ids of torch.topk over the "
        f"row, each value its logit, bit for bit the CPU run; {k5_n} K5 "
        f"launches (chunk form), nothing else; {z_ms:.3f} ms a call (host "
        f"clock, {k5_n} host reads), torch.topk over the row {topk_ms:.3f} "
        f"ms | K5 at S = 1, R = {R}: kernel_ms {row_['ms']:.4f} wrapper_ms "
        f"{row_['wrapper_ms']:.4f} plain_ms {row_['plain_ms']:.4f} bound_ms "
        f"{b:.6f} ({by}), bit for bit its plain version")
    return row_, k5_n, dict(zipper_topk_ms=z_ms, topk_ms=topk_ms)


def phase_dryrun(torch, np):
    """The dry run (``launch/dryrun.py``): (a) its CLI on DRYRUN_CELLS at
    16 x 16, each exiting 0 with a complete record; (b) the dry run on a
    (1, 1) mesh of TinyLlama-1.1B's train step (8 x 2,048, remat
    "block"), prefill (4 x 512, K6) and one decode step, against the
    same steps on the card: FLOPs equal, argument bytes equal to what
    the arguments allocate, the predicted peak within DRYRUN_PEAK_RANGE
    of ``max_memory_allocated`` over the step; (c) ``zipper_topk`` on
    the card (K5).  Returns the records, the gates' numbers, K5's row and
    its launches."""
    import concurrent.futures
    import dataclasses
    import tempfile

    from repro_torch.configs import base as cb
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    out = {"calib": {}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = _dryrun_cli(tmp)
        base = cb.get_config("tinyllama-1.1b")
        with concurrent.futures.ThreadPoolExecutor(len(DRYRUN_CALIB)) as ex:
            preds = {kind: ex.submit(
                dryrun.lower_cell, "tinyllama_1_1b",
                cb.ShapeConfig(f"calib_{kind}", S, B, kind),
                cfg_override=dataclasses.replace(base, **over),
                mesh_shape=(1, 1), verbose=False)
                for kind, B, S, over in DRYRUN_CALIB}
            mesh = make_host_mesh()
            real = {kind: _calib_real(torch, kind, B, S, over, mesh)
                    for kind, B, S, over in DRYRUN_CALIB}
            preds = {k: f.result() for k, f in preds.items()}
        out["cli"] = _dryrun_cli_check(procs)
        out["cli_s"] = time.perf_counter() - t0
    for kind, B, S, _ in DRYRUN_CALIB:
        p, r = preds[kind], real[kind]
        pred = dict(flops=p["cost"]["flops_per_device"],
                    argument_bytes=p["memory"]["argument_bytes_per_device"],
                    peak_bytes=p["memory"]["peak_bytes_per_device"])
        ratio = pred["peak_bytes"] / r["peak_bytes"]
        out["calib"][kind] = dict(pred=pred, real=r, peak_ratio=ratio,
                                  trace_s=p["trace_s"])
        log(f"dryrun: calibration {kind} {B} x {S} (TinyLlama-1.1B, (1, 1) "
            f"mesh): flops predicted {pred['flops']:,} card "
            f"{r['flops']:,} (K6/K7 {r['kernel_flops']:,}) | argument bytes "
            f"predicted {pred['argument_bytes']:,} card "
            f"{r['argument_bytes']:,} | peak predicted "
            f"{pred['peak_bytes']:,} card {r['peak_bytes']:,} "
            f"(max_memory_allocated over the step), ratio {ratio:.4f} | "
            f"trace {p['trace_s']} s")
        if pred["flops"] != r["flops"] or \
                pred["argument_bytes"] != r["argument_bytes"] or \
                not DRYRUN_PEAK_RANGE[0] <= ratio <= DRYRUN_PEAK_RANGE[1]:
            raise AssertionError(f"dryrun calibration {kind}: predicted "
                                 f"{pred}, card {r}")
    row, n, times = _zipper_topk_check(torch, np)
    out.update(rows={"stream_merge.zipper_topk": row}, zipper_launches=n,
               **times)
    return out


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
              ("attention", lambda: phase_attention(torch, np)),
              ("inputs", lambda: phase_inputs(np)),
              ("spgemm", lambda: phase_spgemm(torch, np, *res["inputs"])),
              ("host", lambda: phase_host(torch, np, res["inputs"][0],
                                          res["spgemm"][1])),
              ("engines", lambda: phase_engines(torch, np, *res["inputs"])),
              ("dispatch", lambda: phase_dispatch(torch, np, res["inputs"][0],
                                                  res["spgemm"][1])),
              ("service", lambda: phase_service(torch, np, res["inputs"][0],
                                                res["spgemm"][1])),
              ("pool", lambda: phase_pool(torch, np, res["inputs"][0],
                                          res["spgemm"][1])),
              ("learned", lambda: phase_learned(torch, np,
                                                res["inputs"][0])),
              ("serve", lambda: phase_serve(torch, np)),
              ("profile", lambda: phase_profile(torch, np, res["serve"])),
              ("moe", lambda: phase_moe(torch, np, res["serve"])),
              ("families", lambda: phase_families(torch, np)),
              ("encdec", lambda: phase_encdec(torch, np)),
              ("train", lambda: phase_train(torch, np)),
              ("mesh", lambda: phase_mesh(torch, np)),
              ("dryrun", lambda: phase_dryrun(torch, np)))
    # the serving phases run as the engine does, with autograd off
    serving = ("serve", "profile", "moe", "families", "encdec")
    for label, fn in phases:
        t0 = time.perf_counter()
        try:
            with torch.inference_mode(label in serving):
                res[label] = fn()
        except Exception:
            traceback.print_exc()
            log(f"{label}: FAILED")
            failed.append(label)
            if label in ("device", "inputs", "spgemm", "serve"):
                break  # the later phases need what these make
            continue
        log(f"{label}: passed in {time.perf_counter() - t0:.1f} s")
    import torch.distributed as dist
    if dist.is_initialized():  # the trainer's and phase mesh's group
        dist.destroy_process_group()
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    name = res["device"]
    kernel_rows, floor = res["kernel"]
    rows = {**kernel_rows, **res["attention"], **res["moe"]["rows"],
            **res["families"]["rows"], **res["encdec"]["rows"],
            **res["train"]["rows"], **res["dryrun"]["rows"]}
    # each kernel's launches on its own path's run
    counts = {k: v for k, v in res["spgemm"][0].items()
              if not k.startswith(("stream_", "flash_attention",
                                   "grouped_matmul"))}
    counts.update((k, res["host"][k]) for k in ("stream_sort", "stream_merge",
                                                "stream_merge.chunk"))
    counts["flash_attention"] = res["serve"]["counts"]["flash_attention"]
    counts["flash_attention.arctic"] = res["moe"]["counts"]["flash_attention"]
    counts["grouped_matmul"] = res["moe"]["counts"]["grouped_matmul"]
    fam = res["families"]
    counts["flash_attention.rg9b"] = fam["rg9b"]["counts"]["flash_attention"]
    counts["grouped_matmul.deepseek"] = \
        fam["deepseek"]["counts"]["grouped_matmul"]
    encdec = res["encdec"]
    counts["flash_attention.whisper"] = counts[
        "flash_attention.whisper_enc"] = \
        encdec["whisper"]["counts"]["flash_attention"]
    counts["flash_attention.vision"] = \
        encdec["vision"]["counts"]["flash_attention"]
    counts["grouped_matmul.backward"] = \
        res["train"]["deepseek"]["counts"]["grouped_matmul.backward"]
    counts["stream_merge.zipper_topk"] = res["dryrun"]["zipper_launches"]
    log("kernels: " + ", ".join(f"{k}={v}" for k, v in counts.items()))
    # K7 under _shardmap_moe, K6 in TinyLlama's prefill, both under "tp"
    mesh = {**res["mesh"]["deepseek"]["counts"],
            **res["mesh"]["tinyllama"]["counts"]}
    log("kernels: mesh path (DeepSeek-V2's step and TinyLlama's prefill on "
        "the (1, 1) mesh, layer_layout tp) " + ", ".join(
            f"{k}={v}" for k, v in mesh.items()))
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
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:72"),
        "grouped_matmul": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                           "src/repro/kernels/grouped_matmul.py:35"),
    }
    service = res["service"]["counts"]
    log("kernels: service path " + ", ".join(
        f"{k}={v}" for k, v in service.items()))
    pool = res["pool"]["counts"]
    log("kernels: pool path (in the workers) " + ", ".join(
        f"{k}={v}" for k, v in pool.items()))
    table = []
    for key, r in rows.items():
        kernel = key.split(".")[0]
        src, replaces = sources[kernel]
        launches = counts[key] if key in counts else counts[kernel]
        table.append({"name": key, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches,
                      "service_launches": service.get(
                          key, service.get(kernel, 0)),
                      "pool_launches": pool.get(key, pool.get(kernel, 0)),
                      "mesh_launches": mesh.get(key, mesh.get(kernel, 0)),
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "wrapper_ms": r["wrapper_ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"],
                      "library_ms": r["library_ms"],
                      **{x: r[x] for x in ("tflops", "fp32_ms", "payload_ms",
                                           "device_ms", "dw_ms")
                         if x in r}})
    print(f"launch_floor_ms {floor}")
    print(json.dumps({"kernels": table}))
    print(name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
