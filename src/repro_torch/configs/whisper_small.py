"""whisper-small [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified]. 12 encoder + 12 decoder layers; the conv
frontend is a stub: input_specs supplies (B, 1500, d_model) frame
embeddings. Decoder layers: self-attn + cross-attn + MLP.

Port of ``repro.configs.whisper_small``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    group_pattern=("cross_attn",), encoder_layers=12,
    num_frontend_tokens=1500, pos_emb="sinusoid",
    remat="block",
)


def smoke():
    return dataclasses.replace(
        CONFIG, remat="none", name="whisper-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=160, vocab_size=384,
        encoder_layers=2, num_frontend_tokens=20)
