"""K5, the stream merge: CUDA kernel wrapper and its plain version.

Port of the Pallas kernel ``repro.kernels.stream_merge.stream_merge_pallas``
(the host tier's mszipk + mszipv): per stream, merge two sorted,
duplicate-free R-chunks under the merge-bit cutoff min(max_a, max_b),
return the consumed count of each side and the merged uniques split into
a low and a high R-half with their length.  The kernel is
``csrc/stream_merge.cu``; its plain version is ``ref.stream_merge_ref``,
bit-identical to it in all seven outputs.

:func:`stream_merge_ptr` is the same merge in pointer form: one whole
issue of the host driver's merge round (fronts read at per-stream
pointers from the padded partitions, merged rows appended at the output
pointers, pointers, zip elements, a per-issue flag and the count of issues that
did work advanced on the card), one launch and no host wait; its plain
version is
``ref.stream_merge_ptr_ref``, the composition take_chunk ->
stream_merge_ref -> put_rows -> pointer updates.

Both wrappers take the plain version only for tensors on the CPU; on
CUDA tensors they launch the kernel (counting the launch in
``stream_merge.launches`` and its form in ``stream_merge.routes``:
"chunk" or "pointer") or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_inputs, stream_of
from repro_torch.kernels.ref import stream_merge_ptr_ref, stream_merge_ref

stream_merge_plain = stream_merge_ref
stream_merge_ptr_plain = stream_merge_ptr_ref


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
        stream_merge.routes["chunk"] += 1
    return outs


stream_merge.launches = 0
stream_merge.routes = {"chunk": 0, "pointer": 0}


def stream_merge_ptr(Ka, Va, lens_a, Kb, Vb, lens_b, pa, pb, optr, Ko, Vo,
                     zips, flag, worked, *, R: int):
    """One issue of a merge round in pointer form, in place: the contract
    of ``ref.stream_merge_ptr_ref``.  Ka/Va (S, La), Kb/Vb (S, Lb) int32 /
    float32 with unit stride along a row; lens_a, lens_b, pa, pb, optr,
    zips (S,) int64 (the last four updated); Ko/Vo (S, Lo + 1) with a
    spill column; flag one zeroed int32 word, ORed with bit 0 (a stream
    was live) and bit 1 (one still is); worked one int64 word, plus one
    when a stream was live."""
    if Ka.device.type == "cpu":
        return stream_merge_ptr_plain(Ka, Va, lens_a, Kb, Vb, lens_b, pa, pb,
                                      optr, Ko, Vo, zips, flag, worked,
                                      R=R)
    S = Ka.shape[0]
    if R & (R - 1) or R == 0:
        raise ValueError(f"chunk width R={R} must be a power of two")
    for K, V in ((Ka, Va), (Kb, Vb), (Ko, Vo)):
        if K.dtype != torch.int32 or V.dtype != torch.float32 \
                or K.shape != V.shape or K.shape[0] != S \
                or K.stride() != V.stride() or K.stride(1) != 1:
            raise ValueError("stream_merge_ptr takes (S, L) int32 keys and "
                             "float32 values of one shape and stride, unit "
                             "stride along a row")
    vecs = (lens_a, lens_b, pa, pb, optr, zips)
    if any(t.dtype != torch.int64 or t.shape != (S,) or t.stride(0) != 1
           for t in vecs) or flag.dtype != torch.int32 or flag.numel() != 1 \
            or worked.dtype != torch.int64 or worked.numel() != 1:
        raise ValueError("stream_merge_ptr takes (S,) int64 lengths, "
                         "pointers and zip counts, one int32 flag and one "
                         "int64 count")
    if any(t.device != Ka.device
           for t in (Va, Kb, Vb, Ko, Vo, flag, worked, *vecs)):
        raise ValueError("stream_merge_ptr inputs must share one CUDA device")
    if S:
        launch_ptr(Ka, Va, lens_a, Kb, Vb, lens_b, pa, pb, optr, Ko, Vo,
                   zips, flag, worked, R)
        stream_merge.launches += 1
        stream_merge.routes["pointer"] += 1


def launch_ptr(Ka, Va, lens_a, Kb, Vb, lens_b, pa, pb, optr, Ko, Vo, zips,
               flag, worked, R: int) -> None:
    """Launch K5's pointer form on checked CUDA tensors on the current
    stream; raise on a launch error."""
    lib = _build.LIBS.get("stream_merge")
    err = lib.zipper_stream_merge_ptr(
        Ka.data_ptr(), Va.data_ptr(), Ka.stride(0), lens_a.data_ptr(),
        Kb.data_ptr(), Vb.data_ptr(), Kb.stride(0), lens_b.data_ptr(),
        Ka.shape[0], R, pa.data_ptr(), pb.data_ptr(), optr.data_ptr(),
        Ko.data_ptr(), Vo.data_ptr(), Ko.stride(0), zips.data_ptr(),
        flag.data_ptr(), worked.data_ptr(), stream_of(Ka))
    _build.check(lib, err, "stream_merge_ptr")


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
