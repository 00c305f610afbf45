"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064, rope_theta=10000.0,
    remat="block",
)


def smoke():
    return dataclasses.replace(
        CONFIG, remat="none", name="phi4-mini-smoke", num_layers=2, d_model=96,
        num_heads=6, num_kv_heads=2, d_ff=256, vocab_size=512)
