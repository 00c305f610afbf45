"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2
[arXiv:2402.19427; unverified]. 38 layers = 12×(rec,rec,attn) + (rec,rec).

Port of ``repro.configs.recurrentgemma_9b``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    group_pattern=("rglru", "rglru", "local_attn"),
    tail_pattern=("rglru", "rglru"),
    local_window=2048, rnn_width=4096, fsdp=True, remat="block",
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", num_layers=5, d_model=64,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=160, vocab_size=384,
        tail_pattern=("rglru", "rglru"), local_window=32, rnn_width=64,
        fsdp=False, remat="none")
