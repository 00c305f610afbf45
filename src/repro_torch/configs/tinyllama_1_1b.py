"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000, rope_theta=10000.0,
    remat="block",
)


def smoke():
    return dataclasses.replace(
        CONFIG, remat="none", name="tinyllama-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=160, vocab_size=256)
