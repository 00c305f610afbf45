"""Elastic lane partitioning for the worker-process coordinator.

Port of ``repro.runtime.elastic``'s ``remesh_lanes``, the one function
of that module the SpGEMM serving path uses.  Its other two functions,
``remesh`` (the largest (data, model) mesh for the devices left) and
``reshard_restore`` (a checkpoint restored onto a resized mesh), need a
mesh and wait for the port's sharding slice.
"""
from __future__ import annotations


def remesh_lanes(n_lanes: int, n_workers: int) -> list[range]:
    """Partition ``n_lanes`` device lanes over ``n_workers`` processes.

    Used by the process coordinator (``runtime/coordinator.py``) to
    (re)assign lane ownership when workers join or leave: contiguous
    slices, sizes differing by at most one, earlier workers taking the
    remainder.  With more workers than lanes, the surplus workers share
    lane 0 (every worker must own at least one lane to be schedulable —
    a lane-less worker could never run a flush).  Deterministic in
    (n_lanes, n_workers), so every process computes the same partition
    without coordination."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    if n_workers > n_lanes:
        # surplus workers share lane 0 rather than idling
        return [range(0, 1) if i >= n_lanes else range(i, i + 1)
                for i in range(n_workers)]
    base, rem = divmod(n_lanes, n_workers)
    out, lo = [], 0
    for i in range(n_workers):
        hi = lo + base + (1 if i < rem else 0)
        out.append(range(lo, hi))
        lo = hi
    return out
