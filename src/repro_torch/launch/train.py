"""Training launcher: mesh, data, the resilient loop, checkpoints.

Port of ``repro.launch.train``.  Runs on the card unless ``--device
cpu`` is given (a CUDA request without a card raises; there is no
fallback to the CPU), always under a mesh, as the reference does: the
caller's, else ``launch.mesh.make_host_mesh`` over the process group
(one process: the (1, 1) mesh; under ``torchrun`` one process per
card).  Usage:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 100 --batch 8 --seq 2048 --ckpt-dir /path/to/ckpt

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch tinyllama-1.1b --steps 100 --batch 8 --seq 2048

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --device cpu --steps 40 --batch 8 --seq 64

Weights are random, drawn from a generator seeded by ``seed`` on the
device; the data is ``TokenDataset``'s synthetic stream from the same
seed.  A model trains with ``attn_impl="xla"`` (K6 has no backward).
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as cb
from repro_torch.data.pipeline import PrefetchLoader, TokenDataset
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultConfig, run_resilient


def train(cfg, opt_cfg, fcfg: FaultConfig, *, num_steps: int,
          global_batch: int, seq_len: int, device=None, mesh=None,
          seed: int = 0, preempt_hook=None, log_every: int = 10):
    """Train ``cfg`` from fresh weights for ``num_steps`` steps of
    ``global_batch`` x ``seq_len`` tokens on ``device`` (default: the
    card) under ``mesh`` (default: the host mesh), resuming from ``fcfg.ckpt_dir``'s latest checkpoint if it has
    one and checkpointing every ``fcfg.ckpt_every`` steps and after the
    last (none when ``fcfg.ckpt_dir`` is None).  Returns (state,
    history): ``run_resilient``'s history plus ``save_s`` and
    ``restore_s``, the host seconds of each checkpoint save (the
    device-to-host copy, and the disk write unless ``fcfg.async_save``)
    and restore; each step's metrics hold ``step_s``, its host seconds
    through the read of its loss.  The state comes back placed on the
    mesh (DTensor parameters and moments)."""
    device = resolve_device(device)
    if mesh is None:
        mesh = make_host_mesh(device=device)
    with shd.use_mesh(mesh):
        return _train(cfg, opt_cfg, fcfg, num_steps=num_steps,
                      global_batch=global_batch, seq_len=seq_len,
                      device=device, seed=seed, preempt_hook=preempt_hook,
                      log_every=log_every)


def _train(cfg, opt_cfg, fcfg, *, num_steps, global_batch, seq_len, device,
           seed, preempt_hook, log_every):
    step_fn = st.make_train_step(cfg, opt_cfg)
    state = st.init_train_state(
        cfg, opt_cfg, torch.Generator(device=device).manual_seed(seed))
    params = state["params"]
    timings = {"save_s": [], "restore_s": []}
    ds = TokenDataset(cfg.vocab_size, seq_len, global_batch, seed=seed,
                      enc_tokens=cfg.num_frontend_tokens, d_model=cfg.d_model)
    loader = PrefetchLoader(ds).start()

    def batch_fn(step):
        # step-addressable: after a restart the prefetcher rewinds to the
        # restored step, so resumed == uninterrupted training
        nonlocal loader
        b = next(loader)
        if b.get("_step") != step:
            loader.stop()
            loader = PrefetchLoader(ds).start(step)
            b = next(loader)
        return b

    def tree(state):
        return {"params": dict(state["params"].named_parameters()),
                "opt": state["opt"]}

    def save_fn(step, state):
        t0 = time.perf_counter()
        out = ckpt.save(fcfg.ckpt_dir, step, tree(state), keep=fcfg.keep,
                        blocking=not fcfg.async_save)
        timings["save_s"].append(time.perf_counter() - t0)
        return out

    def restore_fn():
        s = ckpt.latest_step(fcfg.ckpt_dir)
        if s is None:
            return None
        t0 = time.perf_counter()
        got = ckpt.restore(fcfg.ckpt_dir, tree(state), step=s,
                           shardings=st.state_shardings(cfg, params))
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(got["params"][name])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings["restore_s"].append(time.perf_counter() - t0)
        return s, {"params": params, "opt": got["opt"]}

    def wrapped(state, batch):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                 if not k.startswith("_")}
        for k in ("tokens", "labels"):
            batch[k] = batch[k].long()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_s"] = time.perf_counter() - t0
        return state, metrics

    def on_step(step, metrics):
        if step % log_every == 0 and dist.get_rank() == 0:
            print(f"step {step:5d}  loss {metrics['loss']:.4f}  "
                  f"gnorm {metrics['grad_norm']:.2f}  "
                  f"{metrics['step_s'] * 1e3:.0f} ms", flush=True)

    keep = fcfg.ckpt_dir is not None
    try:
        state, hist = run_resilient(
            wrapped, state, batch_fn, fcfg, num_steps=num_steps,
            save_fn=save_fn if keep else None,
            restore_fn=restore_fn if keep else None,
            preempt_hook=preempt_hook, on_step=on_step)
    finally:
        loader.stop()
    return state, {**hist, **timings}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=FaultConfig.ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = (cb.get_smoke_config(args.arch) if args.smoke
           else cb.get_config(args.arch))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, grad_accum=args.grad_accum,
                                warmup_steps=max(5, args.steps // 10),
                                decay_steps=args.steps,
                                state_dtype=cfg.opt_state_dtype)
    fcfg = FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    _, hist = train(cfg, opt_cfg, fcfg, num_steps=args.steps,
                    global_batch=args.batch, seq_len=args.seq,
                    device=args.device)
    losses = [h["loss"] for h in hist["steps"]]
    if dist.get_rank() == 0:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({hist['saves']} saves, {hist['restarts']} restarts)")


if __name__ == "__main__":
    main()
