"""Model configs of the port: the same ``ModelConfig`` as the reference.

Port of ``repro.configs.base``.  Every field keeps its name, type,
default and meaning, so one config describes the same model in both
packages.  Each architecture the port can build has a module
``repro_torch/configs/<id>.py`` exposing ``CONFIG`` (the published
numbers) and ``smoke()`` (a reduced config of the same family for CPU
tests); ``get_config`` resolves ids with dashes or underscores.

What the fields mean in the port, where it differs from the reference:

- ``attn_impl`` picks the full-sequence attention of a GQA layer (the
  prefill and training's forward): ``"xla"`` (the default) is the plain
  blocked online-softmax attention in torch
  (``models.attention.blocked_attention``, with ``attn_q_block``,
  ``attn_kv_block``, ``attn_block_skip`` and ``attn_p_bf16``);
  ``"pallas"`` is the hand-written flash-attention kernel K6
  (``kernels.flash_attention``), its plain version on CPU tensors; K6
  has no backward pass and raises under autograd, so a model trains with
  ``"xla"``, as the reference's does.  It
  acts on ``attn`` and ``local_attn`` layers alike (the latter with
  ``local_window``); an MLA layer always takes the plain blocked
  attention, as the reference's does.
- ``fsdp`` acts on a mesh (``distributed/sharding.py``): it adds the
  data axis to the parameters' placements (gathered over it on use).
- ``layer_layout`` picks how the model axis runs on a mesh
  (``distributed/sharding.py``).  ``"tp"`` (the default, the
  reference's): Megatron tensor parallelism with a sequence-parallel
  residual; weights stay on their model shard (heads, hidden units,
  vocabulary rows, channels), the batch splits over the batch axes
  only, and each sublayer all-gathers the sequence and reduce-scatters
  its output.  ``"sp"``: the port's earlier layout, every dense weight
  all-gathered on use over every axis (ZeRO-3 style) and, without a
  cache, the batch's rows split over the data and model axes together
  (where the reference's ``"sp"`` splits the sequence).
- ``prefill_cache_seqshard`` selects nothing that runs: it picks
  between two XLA lowerings of the same prefill cache in the reference;
  the port always moves a prefill's K/V from heads to the cache's
  sequence blocks in one all_to_all (``models/transformer.py``), the
  layout the flag pins.  ``remat`` acts only in training: ``"block"``
  checkpoints each decoder layer (``models.model.forward``).
- ``scan_unroll`` does nothing: the port runs its layers in a Python
  loop, not a scan, so its dry run (``launch/dryrun.py``) counts every
  layer as it runs and needs no unrolled variant.
- ``moe_dispatch`` picks the MoE block's path on a mesh: "zipper" (the
  default) the sort + all_to_all dispatch (``models.moe._shardmap_moe``),
  "einsum" the capacity-padded einsum dispatch over the global batch;
  with no mesh every MoE block takes the einsum dispatch, as the
  reference does.  Either runs its expert products through K7
  (``kernels.grouped_matmul``).
- ``dtype`` is the compute dtype of activations and of the KV cache;
  ``param_dtype`` the dtype parameters are stored in (each matmul casts
  its weight to the activation dtype, as the reference does).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# Layer kinds usable in group patterns:
#   attn        self-attention + MLP (pre-norm residual block)
#   local_attn  sliding-window self-attention + MLP
#   cross_attn  self-attention + cross-attention + MLP
#   rglru       RG-LRU recurrent block + MLP
#   ssd         Mamba-2 SSD block (standalone, no MLP)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    pos_emb: str = "rope"          # rope | sinusoid (whisper)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    group_pattern: Tuple[str, ...] = ("attn",)
    tail_pattern: Tuple[str, ...] = ()
    local_window: int = 0
    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    first_k_dense: int = 0         # deepseek: first layer uses dense FFN
    capacity_factor: float = 1.25
    moe_dispatch: str = "zipper"   # zipper (sort + all_to_all) | einsum
    # --- MLA (DeepSeek-V2) ---
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (Mamba-2) / RG-LRU ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    rnn_width: int = 0             # RG-LRU recurrence width (0 -> d_model)
    # --- enc-dec / VLM / audio stubs ---
    encoder_layers: int = 0        # whisper encoder depth
    num_frontend_tokens: int = 0   # stub frame/patch embedding count
    # --- numerics & memory policy ---
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"
    remat: str = "none"            # none | block (training only)
    fsdp: bool = False             # parameters also over the data axis
    # --- attention impl: xla (plain blocked attention) | pallas (K6) ---
    attn_impl: str = "xla"
    attn_q_block: int = 2048
    attn_kv_block: int = 1024
    # causal-block skipping in the blocked attention (halves its FLOPs)
    attn_block_skip: bool = False
    # the model axis's layout on a mesh: "tp" (Megatron TP + sequence-
    # parallel residual) | "sp" (weights gathered on use)
    layer_layout: str = "tp"
    # carry softmax probabilities in bf16 between the two matmuls of the
    # blocked attention (flash-attention-2 numerics)
    attn_p_bf16: bool = False
    # decode cache update: one-hot multiply (baseline; touches the whole
    # cache) vs a write of the one slot
    decode_dus: bool = False
    # chunked vocab head + cross-entropy (training; models.model._chunked_ce)
    ce_chunk: int = 0
    # pin prefill KV writes to the cache's sharding in the reference; read
    # by no code of the port
    prefill_cache_seqshard: bool = False
    # fully unroll layer scans in the reference; no effect in the port
    scan_unroll: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def groups(self):
        """((pattern, repeats), ...) covering num_layers exactly
        (excluding the first_k_dense unscanned lead units)."""
        n = len(self.group_pattern)
        body = self.num_layers - len(self.tail_pattern) - self.first_k_dense
        if body % n:
            raise ValueError(f"{self.name}: {body} body layers do not split "
                             f"into groups of {n}")
        out = [(self.group_pattern, body // n)]
        if self.tail_pattern:
            out.append((self.tail_pattern, 1))
        return tuple(out)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        D, V = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n = 2 * V * D  # embed + head
        kinds = [k for pat, rep in self.groups for k in pat * rep]
        for kind in kinds:
            if kind in ("attn", "local_attn", "cross_attn"):
                if self.mla:
                    r, qr = self.kv_lora_rank, self.q_lora_rank
                    qk = self.qk_nope_dim + self.qk_rope_dim
                    n += D * (r + self.qk_rope_dim) + D * qr
                    n += qr * self.num_heads * qk
                    n += r * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                    n += self.num_heads * self.v_head_dim * D
                else:
                    n += D * self.num_heads * hd * 2  # q, o
                    n += D * self.num_kv_heads * hd * 2  # k, v
                if kind == "cross_attn":
                    n += D * self.num_heads * hd * 2 + D * self.num_kv_heads * hd * 2
            if kind == "ssd":
                inner = self.ssm_expand * D
                n += D * (2 * inner + 2 * self.ssm_state +
                          inner // self.ssm_head_dim) + inner * D
                continue
            if kind == "rglru":
                w = self.rnn_width or D
                n += D * w * 2 + w * D  # branch in-projections + out
                n += 4 * w  # diagonal gates + conv-ish
            # FFN
            if self.moe:
                f = self.moe_d_ff
                n += D * f * 3 * self.num_experts
                n += D * self.num_experts  # router
                if self.num_shared_experts:
                    n += D * f * 3 * self.num_shared_experts
                if self.dense_residual:
                    n += D * self.d_ff * 3
            elif kind != "ssd":
                n += D * self.d_ff * 3
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        D, f = self.d_model, self.moe_d_ff
        kinds = [k for pat, rep in self.groups for k in pat * rep]
        n_moe_layers = sum(1 for k in kinds if k != "ssd") - self.first_k_dense
        inactive = n_moe_layers * D * f * 3 * (self.num_experts - self.top_k)
        return int(full - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# the reference's ten architectures, all of which the port builds
ARCH_IDS = ["tinyllama_1_1b", "phi4_mini_3_8b", "qwen1_5_0_5b",
            "granite_3_2b", "llama_3_2_vision_11b", "recurrentgemma_9b",
            "arctic_480b", "deepseek_v2_236b", "mamba2_780m",
            "whisper_small"]

# archs whose every layer is full quadratic attention: long_500k skipped
FULL_ATTENTION_ARCHS = {
    "tinyllama_1_1b", "phi4_mini_3_8b", "qwen1_5_0_5b", "granite_3_2b",
    "llama_3_2_vision_11b", "arctic_480b", "deepseek_v2_236b",
    "whisper_small",
}


def norm_id(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    arch = norm_id(name)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def list_configs():
    return list(ARCH_IDS)


def cells():
    """All assigned (arch, shape) cells, with documented skips applied."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if s == "long_500k" and a in FULL_ATTENTION_ARCHS:
                continue  # O(S^2) attention at 524288 — documented skip
            out.append((a, s))
    return out
