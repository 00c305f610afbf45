"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]. First layer dense FFN (d_ff=12288).

Port of ``repro.configs.deepseek_v2_236b``: the same numbers.  At full
width one MoE layer holds 3.97 G parameters (15.9 GB in float32), so
the card's smoke run serves the dense lead layer and one MoE layer
(``dataclasses.replace(CONFIG, num_layers=2)``)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    moe=True, num_experts=160, top_k=6, moe_d_ff=1536,
    num_shared_experts=2, first_k_dense=1,
    mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    fsdp=True, remat="block", opt_state_dtype="bfloat16",
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="deepseek-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=384,
        num_experts=8, top_k=2, moe_d_ff=48, num_shared_experts=1,
        first_k_dense=1, kv_lora_rank=32, q_lora_rank=48,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        fsdp=False, remat="none", opt_state_dtype="float32",
        moe_dispatch="einsum")
