"""K4, the stream sort: CUDA kernel wrapper and its plain version.

Port of the Pallas kernel ``repro.kernels.stream_sort.stream_sort_pallas``
(the host tier's mssortk + mssortv): sort one (S, R) chunk front — one
R-chunk per stream — on (key, source lane), sum each duplicate run and
compress the run totals to the front.  The kernel is
``csrc/stream_sort.cu`` (the chunk sort of ``csrc/zipper.cuh``, shared
with K1, with runs summed from zero); its plain version is
``ref.stream_sort_ref``, bit-identical to it for float32 and bfloat16
values.  Its two routes are K1's (``chunk_sort.sort_config``): a front
of up to 256 slots a stream in registers (``warp``), a wider one in
shared memory (``block``).

:func:`stream_sort` takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches the kernel (counting the launch in
``stream_sort.launches`` and its route in ``stream_sort.routes``) or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_inputs, stream_of
from repro_torch.kernels.chunk_sort import MAX_ITEMS, sort_config
from repro_torch.kernels.ref import stream_sort_ref

stream_sort_plain = stream_sort_ref


def stream_sort(keys, vals, lens):
    """Sort/combine/compress S key-value chunks: keys (S, R) int32, vals
    (S, R) float32 or bfloat16, lens (S,) int32 valid counts; R a power
    of two.  Returns (keys (S, R), vals (S, R), lens (S,) int32)."""
    if keys.device.type == "cpu":
        return stream_sort_plain(keys, vals, lens)
    S, R = keys.shape
    if R & (R - 1) or R == 0:
        raise ValueError(f"chunk width R={R} must be a power of two")
    if vals.shape != keys.shape or lens.shape != (S,):
        raise ValueError(f"shapes {tuple(keys.shape)}, {tuple(vals.shape)}, "
                         f"{tuple(lens.shape)} do not form an (S, R) front")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stream_sort takes float32 or bfloat16 values, "
                        f"not {vals.dtype}")
    keys, vals, lens = cuda_inputs((keys, torch.int32), (vals, vals.dtype),
                                   (lens.to(torch.int32), torch.int32))
    ok = torch.empty_like(keys)
    ov = torch.empty_like(vals)
    ol = torch.empty_like(lens)
    if S:
        launch(keys, vals, lens, ok, ov, ol)
        stream_sort.launches += 1
        stream_sort.routes["block" if R > 32 * MAX_ITEMS else "warp"] += 1
    return ok, ov, ol


stream_sort.launches = 0
stream_sort.routes = {"warp": 0, "block": 0}


def launch(keys, vals, lens, ok, ov, ol, config=None) -> None:
    """Launch K4 on checked, contiguous CUDA tensors (outputs allocated
    by the caller) on the current stream, in the shape ``config`` ((slots
    a lane, warps a block), ``sort_config``'s by default); raise on a
    launch error."""
    S, R = keys.shape
    items, warps = config or sort_config(S * R, R) or (0, 0)
    err = _build.entry("stream_sort", "zipper_stream_sort")(
        keys.data_ptr(), vals.data_ptr(), lens.data_ptr(), S, R,
        int(vals.dtype == torch.bfloat16), items, warps, ok.data_ptr(),
        ov.data_ptr(), ol.data_ptr(), stream_of(keys))
    if err:
        _build.check(_build.LIBS.get("stream_sort"), err, "stream_sort")
