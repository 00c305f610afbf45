"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

Port of ``repro.configs.arctic_480b``: the same numbers.  At full width
one layer holds 13.61 G parameters (27.2 GB in bf16), so one card holds
two of the 35 layers; the card's smoke run cuts the depth only
(``dataclasses.replace(CONFIG, num_layers=2)``)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    moe=True, num_experts=128, top_k=2, moe_d_ff=4864,
    dense_residual=True,
    fsdp=True, remat="block",
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="arctic-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=384,
        num_experts=8, top_k=2, moe_d_ff=96, fsdp=False, remat="none",
        param_dtype="float32", opt_state_dtype="float32",
        moe_dispatch="einsum")
