"""Lane-sharded batched SpGEMM: balanced lane->device assignment.

Port of ``repro.distributed.spgemm_shard``.  SpArch's observation is
that merge-tree throughput multiplies across independent partitions, and
the RISC-V SpGEMM study shows that *load balance*, not raw FLOPs, decides
vectorized SpGEMM throughput.  A ``BatchedCSR`` request batch is
embarrassingly parallel across lanes, so this module scales
``spgemm_batched`` by (1) assigning lanes to devices with an LPT
(longest-processing-time-first) greedy pass over per-lane work — one
heavy matrix must not serialize a device — and (2) running each device's
lane group through the port's batched driver on that device.

There is no ``shard_map``: every engine, ``esc`` included, runs one
device group at a time (:func:`_execute_groups`).  The devices are a
tuple of ``torch.device`` (:func:`lane_devices`): every visible card by
default, or what the caller names — several ``"cpu"`` entries give the
CPU tests more than one "device".  The ``esc`` branch keeps the
reference's fault semantics (one launch over every device: the
``shard.worker`` site fires once per participant before it, and a lost
worker re-runs the groups without the dead device); the injected
``kernel.batched`` fault fires once per device group, where the
reference's one ``shard_map`` launch fires it once.

Results are bit-identical to ``execute_batched`` on the same base plan:
the same ``ExecutionPlan`` (static capacities included), only the
placement differs, and per-stream payloads do not depend on which
streams share a kernel launch (``core/spgemm.py``).  The spz family's
``SpzStats`` counters that are sums over streams (``sort_elems``,
``zip_elems``) are the unsplit flush's whatever the split; the lock-step
issue counts (``n_mssort``, ``n_mszip``, ``chunk_loads``,
``chunk_stores``) are group-wide, so with one device they are the
unsplit flush's and with several they are the sum of each device
group's own batched call.

The reference's ``_permute_to_slots`` (its padded device-major slot
layout, read by the ``shard_map`` launch) is not ported: no launch here
reads a slot layout; ``ShardPlan.slot_of_lane`` still records it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import dispatch as dp
from repro_torch.core import spgemm_engines as sg
from repro_torch.core.formats import BatchedCSR
from repro_torch.device import resolve_device
from repro_torch.runtime import faultinject as fi


class WorkerLost(RuntimeError):
    """A shard worker (one device's lane group) died mid-flush.

    Raised by the ``shard.worker`` fault site in chaos tests, and the
    exception a real multi-host transport would surface on a lost peer.
    The executors below treat it as recoverable: the dead worker's lanes
    are re-run on a surviving device (see :func:`_execute_groups`)."""

    def __init__(self, device: int, message: str = ""):
        self.device = device
        super().__init__(message or f"shard worker {device} lost")


def kill_worker_spec(device: int, *, rate: float = 1.0,
                     max_fires: Optional[int] = 1) -> fi.FaultSpec:
    """A :class:`~repro_torch.runtime.faultinject.FaultSpec` that kills
    shard worker ``device`` (default: once) — the chaos-test building
    block."""
    return fi.FaultSpec(
        site="shard.worker", kind="raise", rate=rate, max_fires=max_fires,
        match={"device": device},
        exc_factory=lambda site, ctx: WorkerLost(
            ctx.get("device", device), "injected worker kill"))


def lane_devices(device=None) -> tuple[torch.device, ...]:
    """The devices lanes are sharded over: every visible card by default
    (raises without one), or the caller's device, or list of devices —
    a list of several ``"cpu"`` entries is several CPU "devices".  A card
    named without an index is the current one (``cuda:0`` by default),
    the device its tensors report."""
    if device is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    if not isinstance(device, (list, tuple)):
        device = [device]
    if not device:
        raise ValueError("lane_devices needs at least one device")
    devs = [resolve_device(d) for d in device]
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devs)


# ---------------------------------------------------------------------------
# work-balanced lane assignment
# ---------------------------------------------------------------------------

def lane_works(A: BatchedCSR, B: BatchedCSR) -> np.ndarray:
    """Per-lane multiply work (sum of row_work); 0 for invalid lanes."""
    w = np.zeros(A.batch, np.int64)
    b_valid = B.valid.cpu().numpy()
    for i, a in A.lanes():
        if b_valid[i]:
            w[i] = int(sg.row_work(a, B[i]).sum())
    return w


def assign_lanes(works: np.ndarray, n_dev: int,
                 lanes_per_dev: Optional[int] = None) -> np.ndarray:
    """LPT greedy lane->device assignment.

    Heaviest lane first onto the least-loaded device that still has a
    free slot (each device takes at most ``lanes_per_dev`` =
    ceil(n/n_dev) lanes, the reference's equal slot count).  Returns the
    device id per lane."""
    n = len(works)
    cap = lanes_per_dev or -(-n // max(1, n_dev))
    dev = np.zeros(n, np.int64)
    load = np.zeros(n_dev, np.int64)
    counts = np.zeros(n_dev, np.int64)
    for i in np.argsort(-np.asarray(works, np.int64), kind="stable"):
        order = np.argsort(load, kind="stable")
        d = next(int(d) for d in order if counts[d] < cap)
        dev[i] = d
        load[d] += works[i]
        counts[d] += 1
    return dev


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A batched ExecutionPlan plus its lane->device placement.

    ``slot_of_lane[i]`` is lane i's position in the device-major slot
    layout (device d owns slots [d*lanes_per_dev, (d+1)*lanes_per_dev));
    ``devices[d]`` is the torch device of group d."""

    base: dp.ExecutionPlan
    devices: tuple
    n_dev: int
    lanes_per_dev: int
    slot_of_lane: tuple
    works: tuple

    @property
    def n_slots(self) -> int:
        return self.n_dev * self.lanes_per_dev

    def device_loads(self) -> list:
        """Planned per-device total work (for inspection/benchmarks)."""
        loads = [0] * self.n_dev
        for i, s in enumerate(self.slot_of_lane):
            loads[s // self.lanes_per_dev] += self.works[i]
        return loads


def plan_sharded(A: BatchedCSR, B: BatchedCSR, engine: str = "auto", *,
                 devices=None,
                 cache: Optional[dp.AutotuneCache] = None,
                 rules=dp.DEFAULT_HEURISTICS, **kw) -> ShardPlan:
    """Plan a batched multiply and its work-balanced lane placement over
    ``devices`` (see :func:`lane_devices`); the base plan runs on the
    first of them."""
    devs = lane_devices(devices)
    works = lane_works(A, B)
    base = dp.plan_batched(A, B, engine, device=devs[0], cache=cache,
                           rules=rules, lane_work_hint=works, **kw)
    n_dev = len(devs)
    lanes_per_dev = -(-A.batch // n_dev)
    dev = assign_lanes(works, n_dev, lanes_per_dev)
    next_slot = [d * lanes_per_dev for d in range(n_dev)]
    slot_of_lane = []
    for i in range(A.batch):
        slot_of_lane.append(next_slot[dev[i]])
        next_slot[dev[i]] += 1
    return ShardPlan(base=base, devices=devs, n_dev=n_dev,
                     lanes_per_dev=lanes_per_dev,
                     slot_of_lane=tuple(slot_of_lane),
                     works=tuple(int(w) for w in works))


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _lane_select(A: BatchedCSR, idx: list) -> BatchedCSR:
    ix = torch.as_tensor(idx, dtype=torch.int64, device=A.device)
    return BatchedCSR(A.indptr[ix], A.indices[ix], A.data[ix], A.valid[ix],
                      A.shape)


def add_stats(total: sg.SpzStats, part: sg.SpzStats) -> None:
    """Add every field of ``part`` into ``total``."""
    for f in dataclasses.fields(sg.SpzStats):
        setattr(total, f.name, getattr(total, f.name) + getattr(part, f.name))


def _execute_groups(sp: ShardPlan, A: BatchedCSR, B: BatchedCSR, *,
                    dead: Optional[set] = None,
                    max_worker_restarts: int = 3,
                    fire_workers: bool = True,
                    stats: Optional[sg.SpzStats] = None) -> list:
    """Run one device group at a time through the batched driver on that
    group's device (same plan kwargs, so same static shapes), each
    group's results brought to the base plan's device.

    Worker supervision: a device group whose worker dies
    (:class:`WorkerLost` — injected via the ``shard.worker`` fault site,
    which fires before each group unless ``fire_workers`` is False, or a
    real transport error) marks that device dead and collects its lanes;
    after the first pass, lost lanes are re-run on a surviving device,
    with bounded restarts.  Because per-stream payloads are independent
    of which streams share a kernel launch, re-running a lane group
    elsewhere is bit-identical to the uninterrupted flush.  With
    ``stats``, the spz family's counters of every group that ran are
    added into it."""
    driver = dp.get_batch_driver(sp.base.engine)
    want_stats = stats is not None and \
        dp.get_engine(sp.base.engine).returns_stats
    kw = sp.base.kwargs_dict
    home = kw["device"]
    slots = np.asarray(sp.slot_of_lane)
    outs: list = [None] * A.batch
    lane_ok = A.valid.cpu().numpy() & B.valid.cpu().numpy()
    dead = set() if dead is None else set(dead)

    def run(lanes: list, device: int) -> None:
        if fire_workers:
            fi.fire("shard.worker", device=device, engine=sp.base.engine)
        part = sg.SpzStats() if want_stats else None
        extra = {"stats": part} if want_stats else {}
        sub = driver(_lane_select(A, lanes), _lane_select(B, lanes),
                     **{**kw, "device": sp.devices[device]}, **extra)
        for j, i in enumerate(lanes):
            outs[i] = sub[j].to(home)
        if want_stats:
            add_stats(stats, part)

    lost: list = []
    for d in range(sp.n_dev):
        lo, hi = d * sp.lanes_per_dev, (d + 1) * sp.lanes_per_dev
        lanes = [i for i in range(A.batch)
                 if lo <= slots[i] < hi and lane_ok[i]]
        if not lanes:
            continue
        if d in dead:
            lost.extend(lanes)
            continue
        try:
            run(lanes, d)
        except WorkerLost:
            dead.add(d)
            lost.extend(lanes)
    restarts = 0
    while lost:
        alive = [d for d in range(sp.n_dev) if d not in dead]
        if not alive or restarts >= max_worker_restarts:
            raise WorkerLost(
                -1, f"{len(lost)} lanes unrecovered after {restarts} "
                    f"restarts ({sp.n_dev - len(alive)}/{sp.n_dev} "
                    f"workers dead)")
        restarts += 1
        try:
            run(lost, alive[0])
            lost = []
        except WorkerLost:
            dead.add(alive[0])
    return outs


def execute_sharded(sp: ShardPlan, A: BatchedCSR, B: BatchedCSR, *,
                    return_stats: bool = False):
    """Run a ShardPlan; bit-identical to ``execute_batched`` on the same
    base plan, with lanes placed per the balanced assignment.  With
    ``return_stats``, returns ``(BatchedCSR, SpzStats or None)`` (see the
    module docstring for which counters a split keeps)."""
    dp.check_batch(A, B)
    if A.shape != sp.base.a_shape or B.shape != sp.base.b_shape \
            or A.batch != sp.base.batch:
        raise ValueError(
            f"shard plan/operand mismatch: planned {sp.base.batch}x"
            f"{sp.base.a_shape} @ {sp.base.b_shape}, got "
            f"{A.batch}x{A.shape} @ {B.shape}")
    stats = sg.SpzStats() \
        if return_stats and dp.get_engine(sp.base.engine).returns_stats \
        else None
    if sp.base.engine == "esc":
        try:
            # one launch over every device: fire the worker site per
            # participant so a kill spec matched on any device id takes
            # the whole launch down
            for d in range(sp.n_dev):
                fi.fire("shard.worker", device=d, engine="esc")
            outs = _execute_groups(sp, A, B, fire_workers=False)
        except WorkerLost as e:
            # recover by re-running the lane groups per device, skipping
            # the dead worker
            outs = _execute_groups(sp, A, B, dead={e.device})
    else:
        outs = _execute_groups(sp, A, B, stats=stats)
    out = dp.assemble_batched(outs, A, B)
    return (out, stats) if return_stats else out


def spgemm_batched_sharded(A: BatchedCSR, B: BatchedCSR,
                           engine: str = "auto", *,
                           devices=None,
                           cache: Optional[dp.AutotuneCache] = None,
                           rules=dp.DEFAULT_HEURISTICS, **kw) -> BatchedCSR:
    """``spgemm_batched`` with lanes sharded over ``devices``.

    Exactly ``execute_sharded(plan_sharded(A, B, ...), A, B)``."""
    sp = plan_sharded(A, B, engine, devices=devices, cache=cache,
                      rules=rules, **kw)
    return execute_sharded(sp, A, B)
