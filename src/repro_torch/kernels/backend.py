"""Kernel-backend registry: one interface over the plain-torch and CUDA
implementations of the zipper stream primitives.

Port of ``repro.kernels.backend``.  A :class:`KernelBackend` bundles the
primitives the fused spz pipeline runs —

  ``chunk_sort``        (N, R) chunk sort/combine/compress
  ``merge_partitions``  full merge of two padded sorted-unique partitions
                        per stream, with the mszip counters
  ``fused_bucket``      sort + the whole zip-merge tree of one (S, L, R)
                        work bucket
  ``stream_sort``       the host tier's mssort: one (S, R) front
  ``stream_merge``      the host tier's mszip: two (S, R) fronts

— and the registry resolves a backend once, at plan time.  Registered:

  ``torch``  the plain versions: torch tensor code, on the CPU or the card
  ``cuda``   the hand-written kernels (``csrc/*.cu``); CUDA tensors only

``"auto"`` resolves to ``cuda`` for a CUDA device and ``torch`` for the
CPU.  Asking for ``cuda`` on the CPU raises.  Both backends are
bit-compatible: same keys, values, lengths and counters on the same
inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.kernels import chunk_sort as _k1
from repro_torch.kernels import fused_bucket as _k3
from repro_torch.kernels import merge_partitions as _k2
from repro_torch.kernels import merge_tree, ref
from repro_torch.kernels import stream_merge as _k5
from repro_torch.kernels import stream_sort as _k4


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """A registered kernel implementation tier.

    ``device_type``: the only device type the backend runs on ("cuda"),
    or None for any device."""

    name: str
    chunk_sort: Callable
    merge_partitions: Callable
    fused_bucket: Callable
    stream_sort: Callable
    stream_merge: Callable
    device_type: Optional[str] = None
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


# the kernel wrappers, by kernel name, whose ``launches`` count launches
KERNELS = {"chunk_sort": _k1.chunk_sort,
           "merge_partitions": _k2.merge_partitions,
           "fused_bucket": _k3.fused_bucket,
           "stream_sort": _k4.stream_sort,
           "stream_merge": _k5.stream_merge}


def launch_counts() -> dict:
    """Launches of each kernel, and buckets per fused_bucket route, since
    the last :func:`reset_launch_counts`."""
    out = {name: fn.launches for name, fn in KERNELS.items()}
    out.update({f"fused_bucket.{r}": n
                for r, n in _k3.fused_bucket.routes.items()})
    return out


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    for r in _k3.fused_bucket.routes:
        _k3.fused_bucket.routes[r] = 0


register_backend(
    name="torch",
    chunk_sort=merge_tree.sort_chunks_linear,
    merge_partitions=merge_tree.merge_partitions,
    fused_bucket=_k3.fused_bucket_plain,
    stream_sort=ref.stream_sort_ref,
    stream_merge=ref.stream_merge_ref,
    description="plain torch oracles (sort_chunks_linear, the union merge "
                "and advance loop, zip_merge_tree, stream_sort_ref, "
                "stream_merge_ref) on any device")
register_backend(
    name="cuda",
    chunk_sort=_k1.chunk_sort,
    merge_partitions=_k2.merge_partitions,
    fused_bucket=_k3.fused_bucket,
    stream_sort=_k4.stream_sort,
    stream_merge=_k5.stream_merge,
    device_type="cuda",
    description="hand-written sm_90a kernels: K1 chunk sort, K2 partition "
                "merge, K3 fused bucket (large buckets: K1 + K2 per round), "
                "K4 stream sort, K5 stream merge")
