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
card) and returns the state with the new moments.  The input specs and
shardings of the reference's meshes wait for the sharding slice.
"""
from __future__ import annotations

import torch

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
        grads = torch.autograd.grad(loss, [p for _, p in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for (_, p), g in zip(names, grads)]
        return loss.detach(), {k: v.detach() for k, v in met.items()}, grads

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        names = list(params.named_parameters())
        if accum == 1:
            loss, met, grads = grads_of(params, names, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % accum:
                raise ValueError(f"batch {B} does not split into "
                                 f"{accum} micro-batches")
            m = B // accum
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for _, p in names]
            loss = torch.zeros((), dtype=torch.float32,
                               device=grads[0].device)
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
            for k, p in names:
                p.copy_(new_p[k])
        return {"params": params, "opt": new_opt}, {"loss": loss, **met, **om}

    return train_step


def init_train_state(cfg, opt_cfg: adamw.AdamWConfig,
                     generator: torch.Generator, device=None) -> dict:
    """A fresh model (weights drawn from ``generator``, stored on
    ``device``, default the generator's) and zero AdamW moments."""
    params = M.init_params(cfg, generator, device=device)
    return {"params": params,
            "opt": adamw.init_state(opt_cfg, dict(params.named_parameters()))}


def make_prefill_step(cfg):
    def prefill_step(params, tokens, cache, enc_inp=None):
        return M.prefill(params, cfg, tokens, cache, enc_inp=enc_inp)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, token, cache, cache_len):
        return M.decode_step(params, cfg, token, cache, cache_len)
    return decode_step
