"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Backbone only: every 5th layer cross-attends precomputed patch embeddings
(the vision-tower frontend is a stub supplying (B, 1601, d_model)).

Port of ``repro.configs.llama_3_2_vision_11b``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    group_pattern=("cross_attn", "attn", "attn", "attn", "attn"),
    num_frontend_tokens=1601, fsdp=True, remat="block",
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="vision-smoke", num_layers=10, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=160, vocab_size=384,
        num_frontend_tokens=17, fsdp=False, remat="none")
