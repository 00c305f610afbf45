"""PyTorch/CUDA port of the SparseZipper SpGEMM system.

The JAX package ``repro`` is the reference; this package imports torch
and nothing of it.  The main path is ``repro_torch.core.spgemm(A, B,
engine="spz")``, which runs on the card through the hand-written kernels
in ``repro_torch/kernels/csrc`` unless the caller passes
``device="cpu"``.
"""
