"""K7, grouped (per-expert) matmul: CUDA kernel wrapper and its plain
version.

Port of the Pallas kernel
``repro.kernels.grouped_matmul.grouped_matmul_pallas``: x (T, D) rows
grouped by expert, w (E, D, F), group_sizes (E,) int32 -> (T, F) in x's
dtype, each group's rows times its expert's weights.  Two layouts:

- contiguous (the Pallas kernel's): the groups' rows follow each other;
  rows at or past ``sum(group_sizes)`` are zero;
- counts (``cap`` given; the MoE block's capacity-padded buffer): group g
  owns rows ``[g cap, g cap + min(group_sizes[g], cap))``; its other
  rows and the rows past ``E cap`` are zero, and a group that holds no
  row costs no weight read.

The kernel is ``csrc/grouped_matmul.cu``; its plain version is
``ref.grouped_matmul_ref``.  Both sum in float32 and round once; they
agree to float32 rounding (the kernel sums in another order), not bit
for bit.

:func:`grouped_matmul` takes the plain version only for tensors on the
CPU; on CUDA tensors it launches the kernel (counting the launch in
``grouped_matmul.launches`` and its layout in ``grouped_matmul.routes``)
or raises.  On ``meta`` tensors (the dry run, ``launch/dryrun.py``) it
launches nothing: it returns the output the kernel would write and adds
the kernel's FLOPs (:func:`card_flops`) to
``grouped_matmul.traced_flops`` and one to
``grouped_matmul.traced_calls``, the backward's dx launch likewise.  The sizes stay on the card: the kernel maps rows to groups
itself, so a launch adds no host wait.

Backward (:class:`GroupedMatmul`, the wrapper's route on CUDA tensors
when autograd records; the reference differentiates its einsum products
in XLA, outside any Pallas kernel).  For y = x · W per group in the
counts layout:

- dx = dy · Wᵀ per group: one more K7 launch in the counts layout on
  ``w.transpose(1, 2)``, counted under the route ``"backward"``.  The
  wrapper sees from the strides that the view's storage is W itself and
  passes it as it lies (K-major for this product, :func:`b_storage`): no
  (E, F, D) copy of W is made.  Rows past a group's kept count come out
  zero, their true gradient: the forward never reads them.
- dW[g] = x[g]ᵀ · dy[g] over the group's kept rows: ``torch.bmm`` over
  the (E, cap, ·) views, dy's unkept rows masked to zero.
- The sizes get no gradient.  The contiguous layout's backward raises
  ``NotImplementedError``: no path trains through it.

The Function takes its forward launch as an argument, so that its
backward runs on the CPU over the plain version in the tests
(:func:`plain_launch`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import stream_of
from repro_torch.kernels.ref import grouped_matmul_ref

grouped_matmul_plain = grouped_matmul_ref

MAX_GRID_ROWS = 65535


def row_tile(T: int, E: int, dtype=torch.bfloat16) -> int:
    """The kernel's row tile at a mean group size of ceil(T / E) (in the
    counts layout T = E cap, so the group stride): the smallest that holds
    it of 64, 128, 192 and 256 (bf16: the wgmma route's tiles are 64-row
    blocks) or of 16, 32 and 64 (float32), so that one tile covers a
    group of up to 256 (float32: 64) rows and its expert's weights are
    read once per launch."""
    mean = -(-T // max(E, 1))
    tiles = (64, 128, 192, 256) if dtype == torch.bfloat16 else (16, 32, 64)
    return next((bm for bm in tiles if mean <= bm), tiles[-1])


def card_flops(T: int, K: int, N: int, E: int, cap: int | None) -> int:
    """The FLOPs (2 per multiply-add) one K7 launch of x (T, K) by W (E,
    K, N) is charged in the dry run: 2 T K N in the contiguous layout
    (every row belongs to one group, or is past them); 2 E cap K N in
    the counts layout, every group's whole capacity.  The counts layout's
    kernel skips the row tiles that hold no kept row, which depend on
    the routing (data that a traced run does not hold): this is the
    most it performs."""
    return 2 * (T if cap is None else E * cap) * K * N


def grid_rows(T: int, E: int, bm: int, cap: int | None = None) -> int:
    """Row tiles of one launch: an upper bound of the groups' tiles plus
    those of the rows past them, ceil(T / bm) + E + 1 (contiguous), or
    ceil(cap / bm) per group plus the tiles of the rows past E cap
    (counts)."""
    if cap is None:
        return -(-T // bm) + E + 1
    return E * -(-cap // bm) + -(-max(T - E * cap, 0) // bm)


def grouped_matmul(x, w, group_sizes, *, cap=None):
    """x: (T, D); w: (E, D, F) of x's dtype (float32 or bfloat16);
    group_sizes: (E,) integer sizes >= 0 on x's device, with sum <= T
    (contiguous layout) or, when ``cap`` (an int >= 1) is given, each
    group's kept rows at stride ``cap`` (counts layout).  D and F
    multiples of 8.  Returns (T, F) in x's dtype.  On CUDA tensors that
    autograd records, the launch goes through :class:`GroupedMatmul`
    and its backward pass."""
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_sizes, cap=cap)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmul.apply(x, w, group_sizes, cap, kernel_launch)
    return kernel_launch(x, w, group_sizes, cap)


def kernel_launch(x, w, group_sizes, cap, route=None):
    """K7 on CUDA tensors: check the inputs, launch, and count the launch
    under ``route`` (default: the layout, ``"contiguous"`` or
    ``"counts"``).  Returns (T, F) in x's dtype."""
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] \
            or group_sizes.shape != (w.shape[0],):
        raise ValueError(f"grouped_matmul takes x (T, D), w (E, D, F) and "
                         f"group_sizes (E,); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(group_sizes.shape)}")
    T, D = x.shape
    E, _, F = w.shape
    if D % 8 or F % 8:
        raise ValueError(f"D = {D} and F = {F} must be multiples of 8")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul takes float32 or bfloat16 x and w "
                        f"of one dtype, not {x.dtype} and {w.dtype}")
    if group_sizes.dtype.is_floating_point:
        raise TypeError(f"group sizes of dtype {group_sizes.dtype}")
    for t in (w, group_sizes):
        if t.device != x.device:
            raise ValueError(f"inputs on {x.device} and {t.device}")
    if cap is not None and (not isinstance(cap, int) or cap < 1):
        raise ValueError(f"group stride cap = {cap!r} is not an int >= 1")
    bm = row_tile(T if cap is None else E * cap, E, x.dtype)
    if grid_rows(T, E, bm, cap) > MAX_GRID_ROWS:
        raise ValueError(f"T = {T} rows in {E} groups exceed the grid's "
                         f"{MAX_GRID_ROWS} row tiles")
    ws, k_major = b_storage(w)
    x, ws = _aligned(x.contiguous()), _aligned(ws)
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    if T and F and x.is_meta:  # the dry run: no data, the card's work
        grouped_matmul.traced_flops += card_flops(T, D, F, E, cap)
        grouped_matmul.traced_calls += 1
    elif T and F:
        launch(x, ws, sizes, out, cap=cap, k_major=k_major)
        grouped_matmul.launches += 1
        grouped_matmul.routes[route or ("contiguous" if cap is None
                                        else "counts")] += 1
    return out


def b_storage(w):
    """The weights (E, K, N) as the kernel reads them: ``(storage,
    k_major)``.  A transposed view of a contiguous (E, N, K) tensor (the
    backward's ``w.transpose(1, 2)``) is passed as that tensor, in place,
    with ``k_major`` True; any other strides are made contiguous (E, K,
    N)."""
    if not w.is_contiguous() and w.transpose(1, 2).is_contiguous():
        return w.transpose(1, 2), True
    return w.contiguous(), False


def _aligned(t):
    """``t``, or a copy of it when its base is not 16-byte aligned: TMA
    and cp.async read 16 bytes at a time from there.  A fresh tensor, and
    a row slice of one (D and F are multiples of 8), is never copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


grouped_matmul.launches = 0
grouped_matmul.routes = {"contiguous": 0, "counts": 0, "backward": 0}
grouped_matmul.traced_flops = 0
grouped_matmul.traced_calls = 0


def plain_launch(x, w, group_sizes, cap, route=None):
    """The plain version in :func:`kernel_launch`'s signature (``route``
    unused): :class:`GroupedMatmul` over it runs on any device."""
    return grouped_matmul_plain(x, w, group_sizes, cap=cap)


class GroupedMatmul(torch.autograd.Function):
    """K7 under autograd: ``GroupedMatmul.apply(x, w, group_sizes, cap,
    fwd)`` computes ``fwd(x, w, group_sizes, cap)``; its backward is
    described in the module docstring (``fwd`` with route
    ``"backward"`` for dx, ``torch.bmm`` for dW)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, cap, fwd):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.cap, ctx.fwd = cap, fwd
        return fwd(x, w, group_sizes, cap)

    @staticmethod
    def backward(ctx, dy):
        cap = ctx.cap
        if cap is None:
            raise NotImplementedError(
                "grouped_matmul has a backward pass in the counts layout "
                "(cap given) only; the contiguous layout's is not written")
        x, w, group_sizes = ctx.saved_tensors
        E, D, F = w.shape
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the kernel reads W's storage as it lies (b_storage): no copy
            dx = ctx.fwd(dy, w.transpose(1, 2), group_sizes, cap, "backward")
        if ctx.needs_input_grad[1]:
            # (E, cap, .) views of the buffer, cut or zero-padded to E cap
            # rows (rows past T hold no kept row)
            pad = max(E * cap - x.shape[0], 0)
            xg = torch.nn.functional.pad(x[:E * cap], (0, 0, 0, pad))
            dyg = torch.nn.functional.pad(dy[:E * cap], (0, 0, 0, pad))
            kept = torch.arange(cap, device=dy.device) < group_sizes[:, None]
            dyg = dyg.view(E, cap, F) * kept[..., None].to(dy.dtype)
            dw = torch.bmm(xg.view(E, cap, D).transpose(1, 2), dyg)
        return dx, dw, None, None, None


def launch(x, w, sizes, out, *, cap=None, k_major=False) -> None:
    """Launch K7 on checked, contiguous, 16-byte-aligned CUDA tensors
    (``out`` allocated by the caller) on the current stream, in the
    counts layout when ``cap`` is given; ``w`` is the weights' storage,
    (E, K, N), or (E, N, K) when ``k_major`` (:func:`b_storage`).  Raise
    on a launch error."""
    lib = _build.LIBS.get("grouped_matmul")
    T, K = x.shape
    E, N = w.shape[0], out.shape[1]
    bm = row_tile(T if cap is None else E * cap, E, x.dtype)
    err = lib.zipper_grouped_matmul(
        x.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
        int(x.dtype == torch.bfloat16), int(k_major), T, K, N, E, cap or 0,
        bm, grid_rows(T, E, bm, cap), stream_of(x))
    _build.check(lib, err, "grouped_matmul")
