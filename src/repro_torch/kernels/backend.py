"""Kernel-backend registry: one interface over the plain-torch and CUDA
implementations of the zipper stream primitives.

Port of ``repro.kernels.backend``.  A :class:`KernelBackend` bundles the
primitives the fused spz pipeline runs —

  ``chunk_sort``        (N, R) chunk sort/combine/compress
  ``merge_partitions``  full merge of two padded sorted-unique partitions
                        per stream, with the mszip counters
  ``fused_bucket``      sort + the whole zip-merge tree of one (S, L, R)
                        work bucket
  ``fused_expand_bucket``  the same with the bucket's expansion from the
                        CSR operands, its counters folded into a
                        lock-step group's accumulators (one K3 launch)
  ``stream_sort``       the host tier's mssort: one (S, R) front
  ``stream_merge``      the host tier's mszip: two (S, R) fronts
  ``stream_merge_ptr``  the same mszip as one issue of a merge round on
                        pointers into the padded partitions, in place

— and the registry resolves a backend once, at plan time.  Registered:

  ``torch``  the plain versions: torch tensor code, on the CPU or the card
  ``cuda``   the hand-written kernels (``csrc/*.cu``); CUDA tensors only
  ``ref``    the eager oracles (``kernels/ref.py``; the chunk sort is
             ``ref.stream_sort_ref``, the merge tree the plain one): a
             debugging tier, ``on_device=False``, never swept
             (``measure=False``)

``"auto"`` resolves to ``cuda`` for a CUDA device and ``torch`` for the
CPU, and :func:`measurable_backends` names the one an autotune sweep
times on each.  Asking for ``cuda`` on the CPU raises.  Every backend is
bit-compatible: same keys, values, lengths and counters on the same
inputs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import chunk_sort as _k1
from repro_torch.kernels import flash_attention as _k6
from repro_torch.kernels import fused_bucket as _k3
from repro_torch.kernels import grouped_matmul as _k7
from repro_torch.kernels import merge_partitions as _k2
from repro_torch.kernels import merge_tree, ref
from repro_torch.kernels import stream_merge as _k5
from repro_torch.kernels import stream_sort as _k4


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """A registered kernel implementation tier.

    ``device_type``: the only device type the backend runs on ("cuda"),
    or None for any device.  ``on_device``: its primitives run as device
    work (False for the eager oracles, which read the device between
    ops).  ``measure``: a candidate of autotune sweeps."""

    name: str
    chunk_sort: Callable
    merge_partitions: Callable
    fused_bucket: Callable
    fused_expand_bucket: Callable
    stream_sort: Callable
    stream_merge: Callable
    stream_merge_ptr: Callable
    device_type: Optional[str] = None
    on_device: bool = True
    measure: bool = True
    description: str = ""


_BACKENDS: dict[str, KernelBackend] = {}


def register_backend(**fields) -> KernelBackend:
    """Register (or replace) a backend; see :class:`KernelBackend`."""
    bk = KernelBackend(**fields)
    _BACKENDS[bk.name] = bk
    return bk


def get_backend(name: str) -> KernelBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel backend {name!r}; registered: "
            f"{sorted(_BACKENDS)} (or 'auto')") from None


def resolve_backend(backend: Union[str, KernelBackend] = "auto",
                    device: Union[str, torch.device] = "cpu",
                    ) -> KernelBackend:
    """Resolve a backend request — a registered name, "auto" (cuda for a
    CUDA device, torch elsewhere), or a resolved instance — for tensors
    on ``device``.  Unknown names raise ``ValueError`` listing the
    registered backends; a backend that cannot run on ``device`` raises
    ``ValueError`` too."""
    device = torch.device(device)
    if isinstance(backend, KernelBackend):
        bk = backend
    elif backend == "auto":
        bk = _BACKENDS["cuda" if device.type == "cuda" else "torch"]
    else:
        bk = get_backend(backend)
    if bk.device_type is not None and bk.device_type != device.type:
        raise ValueError(f"kernel backend {bk.name!r} runs on "
                         f"{bk.device_type} tensors, not on {device}")
    return bk


def available_backends() -> dict[str, KernelBackend]:
    """Snapshot of the registry (name -> backend)."""
    return dict(_BACKENDS)


def measurable_backends(device: Union[str, torch.device] = "cpu",
                        ) -> list[KernelBackend]:
    """Backends worth timing on ``device`` — the autotune sweep space.
    On a CUDA device only the backends bound to it (``cuda``): the plain
    ``torch`` tier repeats the kernels' arithmetic and is no yardstick
    of speed, so it never takes part in a sweep where a card is.  On the
    CPU the backends that run anywhere (``torch``).  A backend declared
    ``measure=False`` (``ref``) is never swept."""
    want = "cuda" if torch.device(device).type == "cuda" else None
    return [bk for bk in _BACKENDS.values()
            if bk.measure and bk.device_type == want]


def load() -> None:
    """Build (if this source hash is not built yet) and load every kernel
    library, so that a timed call after it does not time ``nvcc``."""
    _build.LIBS.get("fused_bucket")  # the first get loads all of them


# a kernel that did not build, a launch the card refused, or a fault the
# card reported: none of them is cured by running the same work again on
# another engine of the same card
KERNEL_ERRORS: tuple = tuple(
    e for e in (_build.KernelBuildError, _build.KernelLaunchError,
                getattr(torch, "AcceleratorError", None)) if e is not None)


# the kernel wrappers, by kernel name, whose ``launches`` count launches
KERNELS = {"chunk_sort": _k1.chunk_sort,
           "merge_partitions": _k2.merge_partitions,
           "fused_bucket": _k3.fused_bucket,
           "stream_sort": _k4.stream_sort,
           "stream_merge": _k5.stream_merge,
           "flash_attention": _k6.flash_attention,
           "grouped_matmul": _k7.grouped_matmul}


def launch_counts() -> dict:
    """Launches of each kernel, and per route of the kernels that have
    routes ("fused_bucket.expand", "flash_attention.wgmma",
    "grouped_matmul.counts", ...), since the last
    :func:`reset_launch_counts`."""
    out = {name: fn.launches for name, fn in KERNELS.items()}
    for name, fn in KERNELS.items():
        out.update({f"{name}.{r}": n
                    for r, n in getattr(fn, "routes", {}).items()})
    return out


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        for r in getattr(fn, "routes", {}):
            fn.routes[r] = 0


register_backend(
    name="torch",
    chunk_sort=merge_tree.sort_chunks_linear,
    merge_partitions=merge_tree.merge_partitions,
    fused_bucket=_k3.fused_bucket_plain,
    fused_expand_bucket=_k3.fused_expand_bucket_plain,
    stream_sort=ref.stream_sort_ref,
    stream_merge=ref.stream_merge_ref,
    stream_merge_ptr=ref.stream_merge_ptr_ref,
    description="plain torch oracles (sort_chunks_linear, the union merge "
                "and advance loop, zip_merge_tree and the expansion, "
                "stream_sort_ref, "
                "stream_merge_ref and its pointer form) on any device")
register_backend(
    name="cuda",
    chunk_sort=_k1.chunk_sort,
    merge_partitions=_k2.merge_partitions,
    fused_bucket=_k3.fused_bucket,
    fused_expand_bucket=_k3.fused_expand_bucket,
    stream_sort=_k4.stream_sort,
    stream_merge=_k5.stream_merge,
    stream_merge_ptr=_k5.stream_merge_ptr,
    device_type="cuda",
    description="hand-written sm_90a kernels: K1 chunk sort, K2 partition "
                "merge, K3 fused bucket (expand and streams entries; large "
                "buckets: K1 + K2 per round), "
                "K4 stream sort, K5 stream merge (chunk and pointer forms)")
register_backend(
    name="ref",
    chunk_sort=ref.stream_sort_ref,
    merge_partitions=merge_tree.merge_partitions,
    fused_bucket=functools.partial(_k3.fused_bucket_plain,
                                   chunk_sort=ref.stream_sort_ref),
    fused_expand_bucket=functools.partial(_k3.fused_expand_bucket_plain,
                                          chunk_sort=ref.stream_sort_ref),
    stream_sort=ref.stream_sort_ref,
    stream_merge=ref.stream_merge_ref,
    stream_merge_ptr=ref.stream_merge_ptr_ref,
    on_device=False,
    measure=False,
    description="eager oracles (stream_sort_ref as the chunk sort, the "
                "plain merge tree); debugging tier")
