"""PyTorch/CUDA port of the SparseZipper SpGEMM system.

The JAX package ``repro`` is the reference; this package imports torch
and nothing of it.  The main path is ``repro_torch.core.spgemm(A, B,
engine="spz")``, which runs on the card through the hand-written kernels
in ``repro_torch/kernels/csrc`` unless the caller passes
``device="cpu"``.  The LLM substrate's dense serving path is
``repro_torch.serving.engine.Engine(cfg, params).generate(requests)``,
its prefill attention through the flash-attention kernel K6 when
``cfg.attn_impl == "pallas"``.  Training is
``repro_torch.launch.train.train`` (``launch/steps.py``'s step,
``runtime/fault.py``'s resilient loop, ``checkpoint/ckpt.py``), the MoE
expert products through K7 and its backward pass, always under a mesh
(``launch/mesh.py``, ``distributed/sharding.py``: one process per
device, the MoE block's zipper dispatch over an all_to_all).
"""
