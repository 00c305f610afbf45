"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060;
unverified]. Attention-free; runs long_500k.

Port of ``repro.configs.mamba2_780m``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    group_pattern=("ssd",), ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=256,
    remat="block",
)


def smoke():
    return dataclasses.replace(
        CONFIG, remat="none", name="mamba2-smoke", num_layers=2, d_model=64,
        vocab_size=384, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
