"""K5, the stream merge: CUDA kernel wrapper and its plain version.

Port of the Pallas kernel ``repro.kernels.stream_merge.stream_merge_pallas``
(the host tier's mszipk + mszipv): per stream, merge two sorted,
duplicate-free R-chunks under the merge-bit cutoff min(max_a, max_b),
return the consumed count of each side and the merged uniques split into
a low and a high R-half with their length.  The kernel is
``csrc/stream_merge.cu``; its plain version is ``ref.stream_merge_ref``,
bit-identical to it in all seven outputs.

:func:`stream_merge` takes the plain version only for tensors on the
CPU; on CUDA tensors it launches the kernel (counting the launch in
``stream_merge.launches``) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_inputs, stream_of
from repro_torch.kernels.ref import stream_merge_ref

stream_merge_plain = stream_merge_ref


def stream_merge(ka, va, la, kb, vb, lb):
    """Merge two sorted duplicate-free chunks per stream: ka/kb (S, R)
    int32, va/vb (S, R) float32, la/lb (S,) valid counts; R a power of
    two.  Returns (k_lo, v_lo, k_hi, v_hi (S, R), consumed_a,
    consumed_b, out_lens (S,) int32)."""
    if ka.device.type == "cpu":
        return stream_merge_plain(ka, va, la, kb, vb, lb)
    S, R = ka.shape
    if R & (R - 1) or R == 0:
        raise ValueError(f"chunk width R={R} must be a power of two")
    if not (va.shape == kb.shape == vb.shape == ka.shape) \
            or la.shape != (S,) or lb.shape != (S,):
        raise ValueError("stream_merge takes (S, R) keys and values with "
                         "(S,) lengths on both sides")
    ka, va, la, kb, vb, lb = cuda_inputs(
        (ka, torch.int32), (va, torch.float32), (la.to(torch.int32), torch.int32),
        (kb, torch.int32), (vb, torch.float32), (lb.to(torch.int32), torch.int32))
    outs = (torch.empty_like(ka), torch.empty_like(va), torch.empty_like(ka),
            torch.empty_like(va), torch.empty_like(la), torch.empty_like(la),
            torch.empty_like(la))
    if S:
        launch(ka, va, la, kb, vb, lb, *outs)
        stream_merge.launches += 1
    return outs


stream_merge.launches = 0


def launch(ka, va, la, kb, vb, lb, klo, vlo, khi, vhi, ca, cb, ol) -> None:
    """Launch K5 on checked, contiguous CUDA tensors (outputs allocated
    by the caller) on the current stream; raise on a launch error."""
    lib = _build.LIBS.get("stream_merge")
    S, R = ka.shape
    err = lib.zipper_stream_merge(
        ka.data_ptr(), va.data_ptr(), la.data_ptr(), kb.data_ptr(),
        vb.data_ptr(), lb.data_ptr(), S, R, klo.data_ptr(), vlo.data_ptr(),
        khi.data_ptr(), vhi.data_ptr(), ca.data_ptr(), cb.data_ptr(),
        ol.data_ptr(), stream_of(ka))
    _build.check(lib, err, "stream_merge")
