"""The chip's peaks and the least time of a product.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit.  A card set below 700 W reaches less; the run prints its limit.

The least time of ``C = A B`` is computed from the inputs and the exact
output, so it reads the same work whatever implements the product: each
operand read once and C written once, in the port's CSR layout (int32 row
pointers and column indices, float32 values), A and B counted apart even
when they are one matrix; and two operations (a multiply and an add) per
partial product at the float32 rate.  For these matrices the bytes bound.
"""
from __future__ import annotations

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,      # outside the tensor cores
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
    "hbm_bytes": 80e9,
}


def csr_bytes(n_rows: int, nnz: int) -> int:
    """Bytes of a CSR matrix: int32 row pointers, int32 indices, float32
    values."""
    return 4 * (n_rows + 1) + 8 * nnz


def spgemm_bytes(a: tuple[int, int], b: tuple[int, int],
                 c: tuple[int, int]) -> int:
    """Least bytes moved by ``C = A B``: A and B read once, C written once.
    Each argument is ``(n_rows, nnz)``."""
    return csr_bytes(*a) + csr_bytes(*b) + csr_bytes(*c)


def spgemm_flops(products: int) -> int:
    """Operations of ``C = A B``: a multiply and an add per product."""
    return 2 * products


def least_time(n_bytes: int, flops: int, peaks: dict = H100_SXM,
               ) -> tuple[float, str]:
    """(seconds, "bytes" or "ops"): the larger of the two bounds."""
    t_bytes = n_bytes / peaks["hbm_bytes_per_s"]
    t_ops = flops / peaks["fp32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
