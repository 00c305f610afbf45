"""Parameters of the reference package, carried into the port's model.

``params_from_jax`` takes the reference's parameter tree as nested dicts
of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the
caller's side; nothing here imports JAX) and returns the port's
:class:`~repro_torch.models.model.Model` with the same weights: each
stacked group ``g{j}/s{k}`` is unstacked along its leading repeat dim
into one block per layer, in the reference's execution order, the
encoder's stack ``enc_g/s0`` likewise into ``encoder.{i}``, and
``embed/w``, ``norm/scale``, ``enc_norm/scale`` and ``lm_head/w`` are
copied as they are.
A block's subtree is carried path for path: the MoE FFN's
(``ffn.router.w``, ``ffn.experts.{w1,w3,w2}``, ``ffn.dense_mlp.*``,
``ffn.shared.*``), MLA's (``mixer.w_dq``, ``q_norm``, ``w_uq``,
``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``, ``wo``), RG-LRU's
(``mixer.gate_proj``, ``in_proj``, ``conv.w``, ``a_gate.{w,b}``,
``x_gate.{w,b}``, ``a_param``, ``out_proj``) and SSD's (``mixer.in_proj``,
``conv.w``, ``a_param``, ``dt_bias``, ``d_skip``, ``out_proj``,
``norm.scale``), and a ``cross_attn`` block's ``normx.scale`` and
``xattn.{wq,wk,wv,wo}`` beside its self-attention's.  Each array lands
in its parameter's dtype: bfloat16 arrays pass through float32
(exactly), and the float32 leaves stay float32 under a bfloat16
``param_dtype``, since the port makes them float32 as the reference
does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model, _groups


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _np32(arr) -> np.ndarray:
    """A numpy copy of ``arr`` that torch reads: bfloat16 (numpy has no
    such dtype of its own) widened to float32, which is exact."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return np.array(arr)


def _index(arr, i):
    return arr[i]


def per_layer(tree, cfg, index=_index) -> list:
    """[(layer, key, leaf), ...] of a tree keyed by the reference's
    decoder groups (``{group: {"s{k}": subtree}}``: its parameters', or
    its cache's), each stacked group unit cut along its leading repeat
    dim by ``index(leaf, repeat)`` into the port's layers, in execution
    order; ``key`` is the leaf's path in its unit, joined with dots."""
    out = []
    layer = 0
    for name, pattern, reps in _groups(cfg):
        for r in range(reps or 1):
            for s in range(len(pattern)):
                for key, arr in _flat(tree[name][f"s{s}"]):
                    out.append((layer, key,
                                arr if reps is None else index(arr, r)))
                layer += 1
    return out


def port_state(tree, cfg, index=_index) -> dict:
    """{the port's parameter name: leaf} of the reference's parameter tree
    ``tree``: the stacked units cut by ``index`` (:func:`per_layer`; the
    encoder's ``enc_g/s0`` likewise), the other leaves as they are."""
    state = {"embed.w": tree["embed"]["w"], "norm.scale": tree["norm"]["scale"],
             "lm_head.w": tree["lm_head"]["w"]}
    if cfg.encoder_layers:
        state["enc_norm.scale"] = tree["enc_norm"]["scale"]
        for key, arr in _flat(tree["enc_g"]["s0"]):
            for i in range(cfg.encoder_layers):
                state[f"encoder.{i}.{key}"] = index(arr, i)
    for layer, key, arr in per_layer(tree, cfg, index):
        state[f"layers.{layer}.{key}"] = arr
    return state


def params_from_jax(tree, cfg, *, device="cpu") -> Model:
    """The port's model for ``cfg`` holding the weights of the
    reference's parameter tree ``tree`` (nested dicts of numpy arrays),
    on ``device``.  Raises if a parameter is missing, left over, or of
    another shape."""
    state = port_state(tree, cfg)
    model = Model(cfg, generator=torch.Generator().manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(_np32(v))
                           for k, v in state.items()}, strict=True)
    return model.to(device)
