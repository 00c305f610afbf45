"""K1, the chunk sort: CUDA kernel wrapper and its plain version.

Port of the Pallas kernel ``repro.kernels.chunk_sort.chunk_sort_pallas``:
sort every (N, R) key-value chunk on (key, source lane), sum duplicate
runs left to right and compress the run totals to the front.  The kernel
is ``csrc/chunk_sort.cu``; its plain version is the oracle
``merge_tree.sort_chunks_linear``, bit-identical to it.

:func:`chunk_sort` takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches the kernel (counting the launch in
``chunk_sort.launches``) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_inputs, stream_of
from repro_torch.kernels.merge_tree import sort_chunks_linear

chunk_sort_plain = sort_chunks_linear


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
    return ok, ov, ol


chunk_sort.launches = 0


def launch(keys, vals, lens, ok, ov, ol) -> None:
    """Launch K1 on checked, contiguous CUDA tensors (outputs allocated
    by the caller) on the current stream; raise on a launch error."""
    lib = _build.LIBS.get("chunk_sort")
    N, R = keys.shape
    err = lib.zipper_chunk_sort(keys.data_ptr(), vals.data_ptr(),
                                lens.data_ptr(), N, R, ok.data_ptr(),
                                ov.data_ptr(), ol.data_ptr(), stream_of(keys))
    _build.check(lib, err, "chunk_sort")
