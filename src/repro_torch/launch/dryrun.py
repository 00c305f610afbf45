"""Multi-pod dry run of the port: trace every (arch x shape x mesh) cell.

Port of ``repro.launch.dryrun``.  For each cell this runs the port's
real step (train / prefill / decode, ``launch/steps.py``) as rank 0's
SPMD program on the production mesh (single-pod 16 x 16 = 256 cards,
multi-pod 2 x 16 x 16 = 512), with nothing allocated and no card, and
records:

  memory       argument bytes per card, exact: rank 0's shards of the
               state, batch and cache, each storage rounded up to the
               512-byte block of the card's caching allocator; the
               step's output bytes; the peak of the live bytes over the
               step (every storage an op makes is held until it is
               freed, rounded the same way), and whether it ``fits`` the
               card's 80 GB;
  cost         FLOPs: ``FlopCounterMode``'s count of the aten ops plus
               the FLOPs of the K6 and K7 launches the step would make
               (their wrappers count them on meta tensors:
               ``kernels.flash_attention.card_flops``,
               ``kernels.grouped_matmul.card_flops``); bytes: the
               operand and result bytes of every aten op but views and
               allocations, the traffic of the unfused eager program (an
               upper bound of what the card moves: a fused kernel reads
               its operands once);
  collectives  the bytes of each collective's whole tensor on rank 0
               (an all_gather's output, a reduce_scatter's input), by
               kind and by mesh axis, the parameters' all_gathers by mesh
               axis apart (``distributed.sharding``'s wrappers count
               them), and the calls by kind;
  roofline     the reference's three terms and useful-work fractions,
               with the card's constants below.

How: each cell runs in a process of its own (one process holds one
default process group), which starts a ``fake`` process group of the
mesh's size as rank 0 (every collective completes at once and moves
nothing), builds the mesh with ``launch.mesh.make_production_mesh``,
places the state and inputs by ``launch.steps``' shardings and runs the
step on tensors of the ``meta`` device (a shape and a dtype, no data).
The kernel wrappers treat a meta tensor as the card's, never as the
CPU's plain path.  Fake CUDA tensors (``FakeTensorMode``) are not used:
a CPU-only build of torch cannot index one (``Tensor.__getitem__`` takes
a CUDA device guard), and the dry run runs without a card.

No counterpart of the reference's ``_with_reps``, ``_extrapolate`` and
``parse_collective_bytes``: XLA's cost analysis counts a scanned layer
once, so the reference compiles 1- and 2-repeat variants and
extrapolates; the port runs its layers in a Python loop and counts
every layer as it runs, and it has no HLO to parse.

Results go to ``dryrun_torch_results.json`` (one record per cell key,
written after each cell) so a sweep resumes with ``--skip-done``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--jobs 6]
"""
from __future__ import annotations

import argparse
import ast
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import base as cb
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_attention as _k6
from repro_torch.kernels import grouped_matmul as _k7
from repro_torch.launch import steps as st
from repro_torch.models import model as M
from repro_torch.optim import adamw

# One NVIDIA H100 SXM at its full 700 W (NVIDIA H100 data sheet): dense
# bf16 tensor-core FLOP/s, HBM3 bytes/s and capacity.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
# The cluster: hosts of 8 cards (NVIDIA DGX H100), rank r on host r // 8,
# the mesh's ranks in row-major order.  Within a host each card reaches
# the others over NVLink 4 at 450 GB/s each way (900 GB/s both ways,
# H100 SXM data sheet); across hosts through its own 400 Gb/s NIC
# (ConnectX-7, DGX H100 data sheet): 50 GB/s.  On both production
# meshes every axis crosses hosts (the model axis's 16 consecutive
# ranks span two), so every collective runs at the NIC's rate there.
CARDS_PER_HOST = 8
NVLINK_BW = 450e9
NIC_BW = 50e9
# the card's caching allocator hands out blocks of multiples of 512 bytes
ALLOC_BLOCK = 512

GRAD_ACCUM = 1  # set by --grad-accum


def _block(nbytes: int) -> int:
    return -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK


def _local(t):
    return t._local_tensor if shd.is_dtensor(t) else t


class _Trace(TorchDispatchMode):
    """Live bytes and traffic of the ops run under it: each storage an op
    returns is counted once (rounded to the allocator's block) until it
    is freed, and ``traffic`` sums the bytes of every op's tensor
    operands and results (views and allocations excepted; a composite
    op is counted by its parts).  DTensors are counted by their local
    tensors (the rank's); host tensors (a step's index arithmetic on
    the CPU) are not the card's and are not counted."""

    _FREE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_local_scalar_dense"}

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.traffic = 0
        self._held: dict = {}

    def hold(self, tensors) -> None:
        """Count ``tensors``' storages as live (the step's arguments)."""
        for t in tensors:
            self._track(_local(t))

    def _track(self, t) -> None:
        st_ = t.untyped_storage()
        key = st_._cdata
        if key in self._held:
            return
        n = _block(st_.nbytes())
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st_, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        with self:  # a composite op runs as its parts
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        outs = [t for t in map(_local, tree_leaves(out))
                if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
        if not func.is_view and func.overloadpacket.__name__ not in self._FREE:
            ins = [t for t in map(_local, tree_leaves((args, kwargs)))
                   if isinstance(t, torch.Tensor) and t.device.type != "cpu"]
            self.traffic += sum(t.numel() * t.element_size()
                                for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


@contextlib.contextmanager
def flop_counter():
    """``FlopCounterMode`` with its module tracker off: the tracker's
    hooks hold every module's outputs until the backward (TinyLlama's
    ``train_4k`` traced to a 96 GiB peak with them, 7.7 GiB without),
    and the count is the same."""
    from torch.utils.flop_counter import FlopCounterMode

    fc = FlopCounterMode(display=False)
    with fc:
        fc.mod_tracker.__exit__(None, None, None)
        yield fc


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (DTensors: their
    local shards), each rounded up to the allocator's 512-byte block:
    what the card's ``torch.cuda.memory_allocated()`` counts for them."""
    seen = {}
    for t in tensors:
        s = _local(t).untyped_storage()
        seen[s._cdata] = _block(s.nbytes())
    return sum(seen.values())


def link_rate(mesh_shape, axis_names, axes: str) -> float:
    """Bytes/s per card of a collective over the mesh axes ``axes``
    (names joined by commas): NVLink's when every rank of rank 0's group
    lies on one host, else the NIC's."""
    strides = {}
    stride = 1
    for name, size in zip(reversed(axis_names), reversed(mesh_shape)):
        strides[name] = (stride, size)
        stride *= size
    ranks = [0]
    for a in axes.split(","):
        s, n = strides[a]
        ranks = [r + j * s for r in ranks for j in range(n)]
    hosts = {r // CARDS_PER_HOST for r in ranks}
    return NVLINK_BW if len(hosts) == 1 else NIC_BW


def roofline(cost, coll_s, n_chips, model_flops, min_bytes_per_chip=0.0):
    """The reference's three roofline terms and two useful-work
    fractions (``repro.launch.dryrun.roofline``), with the card's rates;
    ``coll_s`` is the collective term, already summed over the axes at
    each one's link rate.  ``hlo_flops_per_chip`` keeps the reference's
    key for the traced FLOPs per card."""
    flops = cost.get("flops", 0.0)
    bytes_acc = cost.get("bytes accessed", 0.0)
    terms = {"compute_s": flops / PEAK_FLOPS,
             "memory_s": bytes_acc / HBM_BW,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = (model_flops / n_chips) / PEAK_FLOPS if model_flops else 0.0
    return {
        **terms,
        "dominant": dom,
        "step_time_lb_s": bound,
        "model_flops_per_chip": model_flops / n_chips if model_flops else 0,
        "hlo_flops_per_chip": flops,
        "useful_flop_ratio": (model_flops / n_chips / flops)
        if flops and model_flops else 0.0,
        "roofline_fraction": useful / bound if bound > 0 else 0.0,
        "min_bytes_per_chip": min_bytes_per_chip,
        "memory_fraction": (min_bytes_per_chip / bytes_acc
                            if bytes_acc else 0.0),
    }


def model_flops_for(cfg, shape):
    """MODEL_FLOPS per executed step (6·N·D train; 2·N_active·B decode)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def min_bytes_for(cfg, shape, n_chips) -> float:
    """The reference's unavoidable traffic per card: the parameters once
    (train: read, written and read again, with the moments likewise);
    serving: the active parameters once plus the cache once (decode: the
    experts a batch can touch)."""
    isz = getattr(torch, cfg.param_dtype).itemsize
    pbytes = cfg.param_count() * isz
    if shape.kind == "train":
        opt_b = 2 * cfg.param_count() * getattr(
            torch, cfg.opt_state_dtype).itemsize
        return (3 * pbytes + 3 * opt_b) / n_chips
    cache_b = sum(math.prod(sh) * dt.itemsize
                  for c in M.cache_shapes(cfg, shape.global_batch,
                                          shape.seq_len,
                                          enc_len=cfg.num_frontend_tokens)
                  for sh, dt in c.values())
    act_pb = cfg.active_param_count() * isz
    if shape.kind == "prefill":
        return (act_pb + cache_b) / n_chips
    share = 1 if not cfg.moe else min(
        1.0, shape.global_batch * cfg.top_k / max(1, cfg.num_experts))
    return (act_pb * share + cache_b) / n_chips


def _placed(t, sh):
    return None if t is None else shd.distribute(t, sh.placements)


def step_inputs(cfg, shape, generator=None):
    """(step function, its arguments, the tensors among them) of ``cfg``
    at the ``ShapeConfig`` ``shape`` on the current mesh, placed by
    ``launch/steps.py``'s shardings.  With no ``generator`` every tensor
    is on ``meta`` (the dry run: ``train_state_shapes`` placed by
    ``state_shardings``, ``input_specs``); with one, the same tensors on
    its device, weights and tokens drawn from it and caches zero: the
    real step the dry run is held against."""
    dev = "meta" if generator is None else generator.device
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype,
                                grad_accum=GRAD_ACCUM)
    if generator is None:
        state = st.train_state_shapes(cfg, opt_cfg)
        params = shd.shard_model(state["params"], cfg.fsdp)
    else:
        params = shd.shard_model(M.init_params(cfg, generator), cfg.fsdp)
    tensors = list(params.parameters())
    spec = st.input_specs(cfg, shape, device=dev)
    if shape.kind == "train":
        if generator is None:
            shs = st.state_shardings(cfg, state["params"])
            opt = {"step": state["opt"]["step"],
                   **{n: {k: _placed(t, shs["opt"][n][k])
                          for k, t in state["opt"][n].items()}
                      for n in ("m", "v")}}
        else:  # each moment takes its parameter's placement
            opt = adamw.init_state(opt_cfg, dict(params.named_parameters()))
        _fill(spec, cfg, generator)
        bsh = st.batch_shardings(spec)
        batch = {k: _placed(v, bsh[k]) for k, v in spec.items()}
        tensors += ([opt["step"]] + list(opt["m"].values())
                    + list(opt["v"].values()) + list(batch.values()))
        return st.make_train_step(cfg, opt_cfg), \
            ({"params": params, "opt": opt}, batch), tensors
    key = "tokens" if shape.kind == "prefill" else "token"
    ins = {key: spec[key], "enc_inp": spec.get("enc_inp")}
    _fill(ins, cfg, generator)
    if generator is not None:
        for c in spec["cache"]:
            for t in c.values():
                t.zero_()
    bsh = st.batch_shardings(ins)
    ins = {k: _placed(v, bsh[k]) for k, v in ins.items()}
    cache = st.place_cache(spec["cache"])
    tensors += [t for c in cache for t in c.values()] + [
        t for t in ins.values() if t is not None]
    if shape.kind == "prefill":
        return st.make_prefill_step(cfg), (params, ins["tokens"], cache,
                                           ins["enc_inp"]), tensors
    return st.make_decode_step(cfg), (params, ins["token"], cache,
                                      spec["cache_len"]), tensors


def _fill(batch, cfg, generator):
    """Draw a real batch's tokens (ids below the vocab size) and frontend
    embeddings (standard normal) from ``generator``, in place; nothing
    on ``meta``."""
    if generator is None:
        return
    for k, t in batch.items():
        if t is None:
            continue
        if t.dtype == torch.int32:
            t.random_(0, cfg.vocab_size, generator=generator)
        else:
            t.normal_(generator=generator)


def trace_step(cfg, shape):
    """Run one step of ``cfg`` at ``shape`` on the current mesh on meta
    tensors; returns (trace seconds, the measures of the record's
    memory, cost and collectives)."""
    t0 = time.time()
    step, args, tensors = step_inputs(cfg, shape)
    arg_bytes = storage_bytes(tensors)
    for fn in (_k6.flash_attention, _k7.grouped_matmul):
        fn.traced_flops = fn.traced_calls = 0
    shd.reset_collective_counts()
    trace = _Trace()
    trace.hold(tensors)
    with trace, flop_counter() as fc:  # the composites fc leaves, trace
        out = step(*args)              # splits
    del args
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if isinstance(out[0], dict):  # the train state: the model's parameters
        outs += list(out[0]["params"].parameters())
    kernel_flops = {"flash_attention": _k6.flash_attention.traced_flops,
                    "grouped_matmul": _k7.grouped_matmul.traced_flops}
    coll = shd.collective_bytes()
    return time.time() - t0, {
        "argument_bytes": arg_bytes,
        "output_bytes": storage_bytes(outs),
        "peak_bytes": trace.peak,
        "aten_flops": fc.get_total_flops(),
        "kernel_flops": kernel_flops,
        "kernel_calls": {"flash_attention":
                         _k6.flash_attention.traced_calls,
                         "grouped_matmul":
                         _k7.grouped_matmul.traced_calls},
        "flops": fc.get_total_flops() + sum(kernel_flops.values()),
        "bytes": trace.traffic,
        "coll_bytes": coll["bytes"],
        "coll_by_axis": coll["by_axis"],
        "coll_weights": coll["weights"],
        "coll_counts": shd.collective_counts(),
    }


def _mesh_name(mesh_shape) -> str:
    return "x".join(str(s) for s in mesh_shape)


def _lower_here(arch, shape, multi_pod, cfg_override, mesh_shape,
                grad_accum):
    """The body of :func:`lower_cell`, in the process that runs it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    global GRAD_ACCUM
    GRAD_ACCUM = grad_accum
    cfg = cfg_override or cb.get_config(arch)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = (("pod", "data", "model") if len(mesh_shape) == 3
            else ("data", "model"))
    n_chips = math.prod(mesh_shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_chips)
    try:
        mesh = (make_production_mesh(multi_pod=multi_pod, device="cpu")
                if tuple(mesh_shape) in ((16, 16), (2, 16, 16))
                else make_mesh(mesh_shape, axes, device="cpu"))
        with shd.use_mesh(mesh):
            trace_s, m = trace_step(cfg, shape)
    finally:
        dist.destroy_process_group()
    coll_s = sum(b / link_rate(mesh_shape, axes, a)
                 for a, b in m["coll_by_axis"].items())
    mf = model_flops_for(cfg, shape)
    cost = {"flops": m["flops"], "bytes accessed": m["bytes"]}
    rl = roofline(cost, coll_s, n_chips, mf,
                  min_bytes_for(cfg, shape, n_chips))
    rec = {
        "arch": arch, "shape": shape.name, "mesh": _mesh_name(mesh_shape),
        "n_chips": n_chips,
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes_per_device": m["argument_bytes"],
            "output_bytes_per_device": m["output_bytes"],
            "temp_bytes_per_device": m["peak_bytes"] - m["argument_bytes"],
            "peak_bytes_per_device": m["peak_bytes"],
        },
        "cost": {"flops_per_device": m["flops"],
                 "aten_flops_per_device": m["aten_flops"],
                 "kernel_flops_per_device": m["kernel_flops"],
                 "kernel_calls": m["kernel_calls"],
                 "bytes_per_device": m["bytes"]},
        "collectives": {"total_bytes": sum(m["coll_bytes"].values()),
                        "bytes": m["coll_bytes"],
                        "bytes_by_axis": m["coll_by_axis"],
                        "weight_bytes_by_axis": m["coll_weights"],
                        "counts": m["coll_counts"]},
        "roofline": rl,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "fits": m["peak_bytes"] <= HBM_BYTES,
    }
    return rec


def lower_cell(arch: str, shape_name, *, multi_pod: bool = False,
               cfg_override=None, verbose: bool = True, mesh_shape=None):
    """Trace one cell in a process of its own and return its record.
    ``shape_name`` names a shape of ``configs.base.SHAPES`` or is a
    ``ShapeConfig``; ``mesh_shape`` replaces the production mesh (e.g.
    (1, 1), a fake group of one, to hold the dry run against one card)."""
    shape = (cb.SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    with _pool(1) as ex:
        rec = ex.submit(_lower_here, arch, shape, multi_pod, cfg_override,
                        mesh_shape, GRAD_ACCUM).result()
    if verbose:
        _report(rec)
    return rec


def _pool(jobs: int):
    """Up to ``jobs`` processes, a fresh one for each cell."""
    return concurrent.futures.ProcessPoolExecutor(
        jobs, mp_context=multiprocessing.get_context("spawn"),
        max_tasks_per_child=1)


def _report(rec) -> None:
    gb = 1 << 30
    rl = rec["roofline"]
    print(f"[{rec['arch']} x {rec['shape']} @ {rec['mesh']}] "
          f"trace {rec['trace_s']:.1f}s  "
          f"peak {rec['memory']['peak_bytes_per_device']/gb:.2f} GiB/dev  "
          f"args {rec['memory']['argument_bytes_per_device']/gb:.2f} GiB  "
          f"terms c/m/x = {rl['compute_s']:.4f}/{rl['memory_s']:.4f}/"
          f"{rl['collective_s']:.4f}s -> {rl['dominant']} "
          f"(roofline frac {rl['roofline_fraction']:.3f})", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_torch_results.json")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--override", default="",
                    help="cfg overrides, e.g. attn_impl=pallas,ce_chunk=2048")
    ap.add_argument("--tag", default="",
                    help="suffix for the result key")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args()
    global GRAD_ACCUM
    GRAD_ACCUM = args.grad_accum

    cells = (cb.cells() if args.all
             else [(cb.norm_id(args.arch), args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    overrides = {}
    if args.override:
        for kv in args.override.split(","):
            k, v = kv.split("=", 1)
            try:
                overrides[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                overrides[k] = v

    try:
        with open(args.out) as f:
            results = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        results = {}

    failures = []
    with _pool(args.jobs) as ex:
        todo = {}
        for arch, shape in cells:
            for mp in meshes:
                key = f"{arch}|{shape}|{'2x16x16' if mp else '16x16'}"
                if args.tag:
                    key += f"|{args.tag}"
                if args.skip_done and key in results:
                    continue
                cfg_ov = (dataclasses.replace(cb.get_config(arch),
                                              **overrides)
                          if overrides else None)
                todo[ex.submit(_lower_here, arch, cb.SHAPES[shape], mp,
                               cfg_ov, None, GRAD_ACCUM)] = (key, arch,
                                                             shape, mp)
        for fut in concurrent.futures.as_completed(todo):
            key, arch, shape, mp = todo[fut]
            try:
                rec = fut.result()
                _report(rec)
                if args.tag:
                    rec["tag"] = args.tag
                    rec["overrides"] = overrides
                results[key] = rec
            except Exception as e:
                traceback.print_exception(e)
                failures.append((key, str(e)[:200]))
                results[key] = {"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "error": str(e)[:500]}
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    print(f"\n{len(cells) * len(meshes) - len(failures)} cells OK, "
          f"{len(failures)} failed")
    for k, e in failures:
        print("FAIL", k, e)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
