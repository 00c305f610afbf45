"""Step functions of the port: train, prefill, decode.

Port of ``repro.launch.steps`` on one device:

  train_step    forward + ``loss_fn`` + backward + AdamW update, with
                gradient accumulation over ``opt_cfg.grad_accum``
                micro-batches
  prefill_step  prompt -> (last-token logits, populated cache)
  decode_step   one token for every sequence of the batch

The train state is ``{"params": Model, "opt": {"step", "m", "v"}}``
(``optim.adamw``'s state over the model's parameter names).
``train_step`` writes the updated weights into the model in place (the
reference's functional step returns new arrays; holding one copy of the
weights is what lets TinyLlama-1.1B train with float32 moments on one
card) and returns the state with the new moments.

Under a mesh (``distributed.sharding.use_mesh``) the state's parameters
and moments are DTensors placed by ``state_shardings``; the step runs
the model as each rank's SPMD program (``distributed/sharding.py``, in
the layout ``cfg.layer_layout`` names: under ``"tp"`` the batch over the
batch axes, as ``batch_shardings`` places it, the sequence and the
weights over the model axis) and backpropagates the replicated global
loss divided by the world size, so the collectives' backward passes sum
each gradient over the ranks.
``batch_shardings``, ``cache_shardings`` and ``state_shardings`` give
the reference's specs (``Sharding(spec, placements)``) for the port's
trees: its cache is a list with one dict per layer, where the reference
stacks a group's layers along a leading dim, so a cache spec here is the
reference's without that dim's leading None.

The dry run's inputs (``launch/dryrun.py``) are tensors on the ``meta``
device, which hold a shape and a dtype and allocate nothing:
``train_state_shapes`` gives the train state (``init_train_state``'s
structure: the model's parameters under the port's names, the AdamW
step and moments), ``input_specs`` the batch, cache and ``cache_len``
of a ``configs.base.ShapeConfig``.
"""
from __future__ import annotations

import re

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models import model as M
from repro_torch.optim import adamw


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig):
    """train_step(state, batch) -> (state, metrics).  ``batch``: tensors
    on the model's device ({"tokens", "labels"} (B, S) int, plus
    "enc_inp"); with ``grad_accum`` k > 1 it is split into k micro-batches
    along B, their gradients summed in float32 and divided by k, as the
    reference's scan does (metrics "ce" the mean loss, "aux" 0).
    Metrics are float32 scalar tensors: "loss", "ce", "aux",
    "grad_norm", "lr"."""
    accum = max(1, opt_cfg.grad_accum)

    def grads_of(params, names, batch):
        loss, met = M.loss_fn(params, cfg, batch)
        # every rank holds the same global loss: each backpropagates its
        # share, and the collectives' backward passes sum the shares
        grads = torch.autograd.grad(loss / shd.world_size(),
                                    [p for _, p in names], allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for (_, p), g in zip(names, grads)]
        return loss.detach(), {k: v.detach() for k, v in met.items()}, grads

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        names = list(params.named_parameters())
        if shd.get_mesh() is not None:
            # micro-batches split the global batch, as the reference's do
            batch = {k: shd.full_tensor(v) for k, v in batch.items()}
        if accum == 1:
            loss, met, grads = grads_of(params, names, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum} micro-batches")
            m = B // accum
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for _, p in names]
            loss = torch.zeros((), dtype=torch.float32,
                               device=names[0][1].device)
            for i in range(accum):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                l, _, g = grads_of(params, names, mb)
                grads = [a + b.float() for a, b in zip(grads, g)]
                loss = loss + l
            grads = [g / accum for g in grads]
            loss = loss / accum
            met = {"ce": loss, "aux": torch.zeros_like(loss)}
        new_p, new_opt, om = adamw.apply_updates(
            opt_cfg, {k: p.detach() for k, p in names}, opt,
            {k: g for (k, _), g in zip(names, grads)})
        with torch.no_grad():
            for k, p in names:  # shard to shard: no DTensor dispatch
                shd.local(p).copy_(shd.local(new_p[k]))
        return {"params": params, "opt": new_opt}, {"loss": loss, **met, **om}

    return train_step


def init_train_state(cfg, opt_cfg: adamw.AdamWConfig,
                     generator: torch.Generator, device=None) -> dict:
    """A fresh model (weights drawn from ``generator``, stored on
    ``device``, default the generator's) and zero AdamW moments; under a
    mesh the parameters are placed by the rules (every rank draws the
    same weights, staged on the host, and moves its shard to ``device``:
    no card holds a whole model) and each moment takes its parameter's
    placement."""
    if shd.get_mesh() is None:
        params = M.init_params(cfg, generator, device=device)
    else:
        params = shd.shard_model(M.init_params(cfg, generator, device="cpu"),
                                 cfg.fsdp, device=device or generator.device)
    return {"params": params,
            "opt": adamw.init_state(opt_cfg, dict(params.named_parameters()))}


def train_state_shapes(cfg, opt_cfg: adamw.AdamWConfig) -> dict:
    """The train state of :func:`init_train_state` on the ``meta``
    device: {"params": the model (every parameter a meta tensor of its
    shape and dtype), "opt": {"step", "m", "v"}}.  Nothing is drawn or
    allocated.  The reference's stacked ``g{j}/s{k}`` leaves are one
    parameter per layer here (``models/convert.py``)."""
    params = M.init_params(cfg, torch.Generator(), device="meta")
    return {"params": params,
            "opt": adamw.init_state(opt_cfg, dict(params.named_parameters()))}


def input_specs(cfg, shape, device="meta") -> dict:
    """The step inputs of the ``ShapeConfig`` ``shape`` as empty tensors
    on ``device`` (default ``meta``: nothing allocated), the reference's
    keys and dtypes: train {"tokens", "labels"} (B, S) int32, plus
    "enc_inp" (B, frontend tokens, D) float32; prefill {"tokens", "cache",
    "enc_inp" (or None)}; decode {"token" (B, 1) int32, "cache",
    "cache_len"}.  The cache is the port's list of per-layer dicts
    (``model.cache_shapes`` for B sequences of S positions, the
    frontend's tokens in a ``cross_attn`` layer's), where the reference
    stacks a group's layers along a leading dim.  ``cache_len`` is an
    int, the position a decode step writes: S - 1, the step that reads
    a full cache."""
    B, S = shape.global_batch, shape.seq_len
    ids = torch.int32

    def enc():
        return (torch.empty((B, cfg.num_frontend_tokens, cfg.d_model),
                            dtype=torch.float32, device=device)
                if cfg.num_frontend_tokens else None)

    def cache():
        return [{n: torch.empty(sh, dtype=dt, device=device)
                 for n, (sh, dt) in c.items()}
                for c in M.cache_shapes(cfg, B, S,
                                        enc_len=cfg.num_frontend_tokens)]

    if shape.kind == "train":
        batch = {"tokens": torch.empty((B, S), dtype=ids, device=device),
                 "labels": torch.empty((B, S), dtype=ids, device=device)}
        if cfg.num_frontend_tokens:
            batch["enc_inp"] = enc()
        return batch
    if shape.kind == "prefill":
        return {"tokens": torch.empty((B, S), dtype=ids, device=device),
                "cache": cache(), "enc_inp": enc()}
    if shape.kind == "decode":
        return {"token": torch.empty((B, 1), dtype=ids, device=device),
                "cache": cache(), "cache_len": S - 1}
    raise ValueError(shape.kind)


def make_prefill_step(cfg):
    def prefill_step(params, tokens, cache, enc_inp=None):
        return M.prefill(params, cfg, tokens, cache, enc_inp=enc_inp)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, token, cache, cache_len):
        return M.decode_step(params, cfg, token, cache, cache_len)
    return decode_step


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _shape(leaf):
    """A leaf's shape: a tensor's, or the first entry of a (shape,
    dtype) pair (``model.cache_shapes``)."""
    return tuple(leaf.shape if hasattr(leaf, "shape") else leaf[0])


def batch_shardings(batch: dict) -> dict:
    """{key: Sharding} of a batch dict (None stays None): the leading
    dim over the batch axes when it divides, the rest replicated."""
    return {k: None if v is None else shd.sharding(shd._batch_spec(_shape(v)))
            for k, v in batch.items()}


_CACHE_RULES = [
    (r"/(k|v|c|kr|enc_k|enc_v)$", 1),   # sequence dim -> model
    (r"/slot_pos$", 1),
    (r"/h$", 1),                         # state width/head dim -> model
    (r"/conv$", 2),                      # channel dim -> model
]


def cache_shardings(cache_tree) -> list:
    """[{name: Sharding}, ...] for a cache (a list with one dict per
    layer of tensors or (shape, dtype) pairs): the batch dim over the
    batch axes and the rule's dim over the model axis, each where it
    divides."""
    ba = shd.batch_axes() or None
    msize = shd.model_axis_size()
    dsize = shd.data_axis_size()

    def one(path, leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape)
        if ba is not None and shape[0] % dsize == 0:
            spec[0] = ba
        for pat, dim in _CACHE_RULES:
            if re.search(pat, path):
                if dim < len(shape) and shape[dim] % msize == 0:
                    spec[dim] = "model"
                break
        return shd.sharding(spec)

    return [{name: one(f"/{i}/{name}", leaf) for name, leaf in c.items()}
            for i, c in enumerate(cache_tree)]


def place_cache(cache: list) -> list:
    """The cache's tensors as DTensors placed by :func:`cache_shardings`
    (each rank keeps its block of the same global tensors)."""
    shs = cache_shardings(cache)
    return [{n: shd.distribute(t, sh[n].placements) for n, t in c.items()}
            for c, sh in zip(cache, shs)]


def state_shardings(cfg, params) -> dict:
    """The train state's shardings: each parameter's by the rules, the
    step replicated, each moment its parameter's."""
    p_sh = shd.param_shardings(params, cfg.fsdp)
    return {"params": p_sh,
            "opt": {"step": shd.sharding(()), "m": dict(p_sh),
                    "v": dict(p_sh)}}
