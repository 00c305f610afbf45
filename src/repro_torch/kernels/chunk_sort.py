"""K1, the chunk sort: CUDA kernel wrapper and its plain version.

Port of the Pallas kernel ``repro.kernels.chunk_sort.chunk_sort_pallas``:
sort every (N, R) key-value chunk on (key, source lane), sum duplicate
runs left to right and compress the run totals to the front.  The kernel
is ``csrc/chunk_sort.cu`` (the chunk sort of ``csrc/zipper.cuh``, shared
with K4); its plain version is the oracle
``merge_tree.sort_chunks_linear``, bit-identical to it.

The kernel has two routes, chosen by :func:`sort_config`: a chunk of up
to 256 slots is sorted in registers by the lanes of one warp (``warp``),
a wider one in a block's shared memory (``block``).

:func:`chunk_sort` takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches the kernel (counting the launch in
``chunk_sort.launches`` and its route in ``chunk_sort.routes``) or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_inputs, stream_of
from repro_torch.kernels.merge_tree import sort_chunks_linear

chunk_sort_plain = sort_chunks_linear

# slots a lane may hold on the warp route; a chunk of up to 32 times that
# fits one warp
MAX_ITEMS = 8


def sort_config(E: int, R: int):
    """The warp route's launch shape for E slots in chunks of R (a power
    of two): (slots a lane, warps a block), or None for the block route
    (R > 256).  A lane holds min(R, max(ceil(R / 32), min(4, P))) slots,
    P the largest power of two <= E / 65,536: a chunk spans at most 32
    lanes, a small call keeps each lane's rank and carry short, and no
    call gives a lane 8 slots unless its chunks need them (the slowest
    choice at every size timed).  A block holds min(4, max(1, warps /
    256)) warps."""
    if R > 32 * MAX_ITEMS:
        return None
    items = 1
    while items < R and (32 * items < R
                         or (items < 4 and 2 * items * 65536 <= E)):
        items *= 2
    warps = -(-E // (32 * items))
    return items, min(4, max(1, warps // 256))


def chunk_lens(plens, C: int, R: int) -> torch.Tensor:
    """(S * C,) int32 valid counts of the R-chunks of (S, C * R) streams
    with ``plens`` valid products each: clip(plen - c * R, 0, R)."""
    offs = torch.arange(C, dtype=torch.int64, device=plens.device) * R
    return (plens.long()[:, None] - offs[None, :]).clamp(0, R) \
        .reshape(-1).to(torch.int32)


def chunk_sort(keys, vals, lens):
    """Sort/combine/compress N key-value chunks: keys (N, R) int32, vals
    (N, R) float32, lens (N,) int32 valid counts; R a power of two.
    Returns (keys (N, R), vals (N, R), lens (N,) int32)."""
    if keys.device.type == "cpu":
        return chunk_sort_plain(keys, vals, lens)
    N, R = keys.shape
    if R & (R - 1) or R == 0:
        raise ValueError(f"chunk width R={R} must be a power of two")
    if vals.shape != keys.shape or lens.shape != (N,):
        raise ValueError(f"shapes {tuple(keys.shape)}, {tuple(vals.shape)}, "
                         f"{tuple(lens.shape)} do not form (N, R) chunks")
    keys, vals, lens = cuda_inputs((keys, torch.int32), (vals, torch.float32),
                                   (lens, torch.int32))
    ok = torch.empty_like(keys)
    ov = torch.empty_like(vals)
    ol = torch.empty_like(lens)
    if N == 0:
        return ok, ov, ol
    launch(keys, vals, lens, ok, ov, ol)
    chunk_sort.launches += 1
    chunk_sort.routes["block" if R > 32 * MAX_ITEMS else "warp"] += 1
    return ok, ov, ol


chunk_sort.launches = 0
chunk_sort.routes = {"warp": 0, "block": 0}


def launch(keys, vals, lens, ok, ov, ol, config=None) -> None:
    """Launch K1 on checked, contiguous CUDA tensors (outputs allocated
    by the caller) on the current stream, in the shape ``config`` ((slots
    a lane, warps a block), ``sort_config``'s by default); raise on a
    launch error."""
    N, R = keys.shape
    items, warps = config or sort_config(N * R, R) or (0, 0)
    err = _build.entry("chunk_sort", "zipper_chunk_sort")(
        keys.data_ptr(), vals.data_ptr(), lens.data_ptr(), N, R, items,
        warps, ok.data_ptr(), ov.data_ptr(), ol.data_ptr(), stream_of(keys))
    if err:
        _build.check(_build.LIBS.get("chunk_sort"), err, "chunk_sort")
