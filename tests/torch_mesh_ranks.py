"""The rank program of ``tests/test_torch_mesh.py``: one of 8 gloo
processes on a (2, 4) ("data", "model") mesh of the CPU.

Imports torch and the port only (the reference's numbers are computed
by the parent).  Reads the cases' inputs from an npz file, runs every
case in turn, each under its own deadline, and writes what it computed,
and each case's status and seconds, to ``rank<r>.npz``.  The cases of
the port's earlier layout name ``layer_layout="sp"``; the ``tp_*`` cases
run the reference's default, ``"tp"`` (Megatron tensor and sequence
parallelism), and record the parameters' all-gathers by mesh axis.
"""
import dataclasses
import datetime
import os
import signal
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tcb
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as lm
from repro_torch.launch import steps as st
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.runtime import elastic

WORLD, MESH = 8, (2, 4)
CASE_DEADLINE_S = 60

# the cases' configs, shared with the parent (which builds the reference)
MOE_ARCH = "arctic_480b"
MOE_OV = dict(moe_dispatch="zipper", num_experts=8)
MOE_DROPLESS_CF, MOE_DROP_CF = 8.0, 1.0
MOE_X, MOE_DROP_X = (4, 16), (4, 512)          # (B, S); D is the config's
DEEPSEEK_ARCH, DEEPSEEK_TOKENS = "deepseek_v2_236b", (4, 16)
DEEPSEEK_ROWS = (8, 16)  # one row per rank: the model axis splits rows
TRAIN_ARCH, TRAIN_BATCH = "tinyllama_1_1b", (8, 32)
TRAIN_OPT = dict(lr=1e-3, eps=1e-4, warmup_steps=2, decay_steps=10)
DECODE_ARCH, DECODE_PROMPT, DECODE_SMAX = "granite_3_2b", (4, 16), 32
RESHARD_ARCH, RESHARD_TOKENS = "tinyllama_1_1b", (2, 16)
# "tp" prefill and decode: KV heads fewer than the model axis (granite:
# the query heads' group), as many (qwen: the cache's heads-to-sequence
# all_to_all), RG-LRU with local attention, and SSD
TP_DECODE_ARCHS = ("granite_3_2b", "qwen1_5_0_5b", "recurrentgemma_9b",
                   "mamba2_780m")
# the kept-set case: one Arctic layer at a factor that drops, 8 rows so
# that "sp" would split rows over all 8 ranks
KEPT_OV = dict(num_layers=1, capacity_factor=MOE_DROP_CF, **MOE_OV)
KEPT_TOKENS = (8, 256)


def config(arch, **ov):
    """The port's smoke config in float32 with ``ov``."""
    return dataclasses.replace(tcb.get_smoke_config(arch), dtype="float32",
                               **ov)


def tree(z, prefix):
    """The nested dict of numpy arrays under ``prefix/`` of a flat npz."""
    out = {}
    for key in z:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = out
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = z[key]
    return out


def _moe_module(cfg, params):
    ffn = tmoe.moe_init(cfg, torch.float32,
                        generator=torch.Generator().manual_seed(0))
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.")
            else:
                flat[pre + k] = torch.from_numpy(np.array(v))
    walk(params, "")
    ffn.load_state_dict(flat, strict=True)
    return shd.shard_model(ffn, cfg.fsdp)


def _block(x):
    """This rank's rows of the global batch x (the batch rule)."""
    return shd.local_batch(torch.from_numpy(x))


def case_moe(z, out, mesh):
    """_shardmap_moe at the dropless factor: the rank's output (its data
    block, all of the sequence) and every gradient of sum(y * ct)."""
    cfg = config(MOE_ARCH, capacity_factor=MOE_DROPLESS_CF, **MOE_OV)
    ffn = _moe_module(cfg, tree(z, "moe/params"))
    x = _block(z["moe/x"]).requires_grad_()
    ct = _block(z["moe/ct"])
    with shd.gathered(ffn):
        y, aux = tmoe._shardmap_moe(ffn, x, cfg)
    share = (y * ct).sum()
    loss = shd.all_reduce(share, shd.batch_axes())
    (loss / shd.world_size()).backward()
    out["moe/y"] = y.detach().numpy()
    out["moe/aux"] = aux.detach().numpy()
    # the rank's x gradient holds its sequence block: summed over the axis
    out["moe/gx"] = shd.all_reduce(x.grad, ("model",)).numpy()
    for name, p in ffn.named_parameters():
        if p.grad is not None:
            out[f"moe/g/{name}"] = p.grad.full_tensor().numpy()


def case_moe_drop(z, out, mesh):
    """_shardmap_moe at a factor that drops assignments, with the experts
    FSDP-sharded over the data axis."""
    cfg = config(MOE_ARCH, capacity_factor=MOE_DROP_CF, fsdp=True, **MOE_OV)
    ffn = _moe_module(cfg, tree(z, "moe/params"))
    out["moe_drop/w1_placements"] = np.array(
        str(tuple(ffn.experts.w1.placements)))
    x = _block(z["moe_drop/x"])
    with torch.no_grad(), shd.gathered(ffn):
        y, _ = tmoe._shardmap_moe(ffn, x, cfg)
    out["moe_drop/y"] = y.numpy()


def case_moe_einsum(z, out, mesh):
    """The einsum dispatch on the mesh at the dropping factor: the global
    batch's routing and capacity (its blocks all-gathered over the data
    axis), the rank keeping its rows."""
    cfg = config(MOE_ARCH, capacity_factor=MOE_DROP_CF, moe_dispatch="einsum",
                 num_experts=MOE_OV["num_experts"])
    ffn = _moe_module(cfg, tree(z, "moe/params"))
    x = _block(z["moe_drop/x"])
    with torch.no_grad(), shd.gathered(ffn):
        y, _ = tmoe._einsum_moe(ffn, x, cfg)
    out["moe_einsum/y"] = y.numpy()


def _weight_gathers(out, case):
    """The parameters' all-gather bytes by mesh axis since the last
    reset, as ``<case>/weights/<axis>``."""
    for axis, n in shd.collective_bytes()["weights"].items():
        out[f"{case}/weights/{axis}"] = np.array(n)


def case_tp_moe(z, out, mesh):
    """_shardmap_moe at the dropless factor on the "tp" partition: the
    rank routes its (batch block, sequence block) of tokens, as the
    residual hands them; its output and x gradient for them and every
    gradient of sum(y * ct)."""
    cfg = config(MOE_ARCH, capacity_factor=MOE_DROPLESS_CF, **MOE_OV)
    ffn = _moe_module(cfg, tree(z, "moe/params"))
    s = MOE_X[1] // MESH[1]
    x = shd.seq_part(_block(z["moe/x"]), s).clone().requires_grad_()
    ct = shd.seq_part(_block(z["moe/ct"]), s)
    with shd.gathered(ffn, keep=("model",)):
        y, aux = tmoe._shardmap_moe(ffn, x, cfg, own_tokens=True)
    loss = shd.all_reduce((y * ct).sum(), ("model",) + shd.batch_axes())
    (loss / shd.world_size()).backward()
    out["tp_moe/y"] = y.detach().numpy()
    out["tp_moe/gx"] = x.grad.numpy()
    for name, p in ffn.named_parameters():
        if p.grad is not None:
            out[f"tp_moe/g/{name}"] = p.grad.full_tensor().numpy()


def case_tp_moe_einsum(z, out, mesh):
    """The einsum dispatch under "tp" at the dropping factor: the rank's
    (batch block, sequence block) gathered to the global batch, whose
    routing and capacity it runs, the rank keeping its block."""
    cfg = config(MOE_ARCH, capacity_factor=MOE_DROP_CF, moe_dispatch="einsum",
                 num_experts=MOE_OV["num_experts"])
    ffn = _moe_module(cfg, tree(z, "moe/params"))
    S = MOE_DROP_X[1]
    x = shd.seq_part(_block(z["moe_drop/x"]), S // MESH[1])
    with torch.no_grad(), shd.gathered(ffn, keep=("model",)):
        y, _ = tmoe._einsum_moe(ffn, x, cfg, seq=S)
    out["tp_moe_einsum/y"] = y.numpy()


def case_tp_kept(z, out, mesh):
    """One Arctic layer's forward under "tp" at a factor that drops: the
    tokens the MoE block routed on this rank and the experts their
    assignments kept."""
    cfg = config(MOE_ARCH, **KEPT_OV)
    model = shd.shard_model(params_from_jax(tree(z, "kept/params"), cfg),
                            cfg.fsdp)
    with torch.no_grad(), tmoe.record_kept() as rec:
        TM.forward(model, cfg, torch.from_numpy(z["kept/tokens"]))
    out["tp_kept/tokens"] = rec[0]["tokens"].numpy()
    out["tp_kept/kept"] = rec[0]["kept"].numpy()


def case_deepseek(z, out, mesh, layout="sp"):
    """DeepSeek-V2 (MLA, shared experts, a leading dense layer) forward
    on the mesh, its MoE layer on the zipper dispatch."""
    cfg = config(DEEPSEEK_ARCH, moe_dispatch="zipper", layer_layout=layout)
    pre = "deepseek" if layout == "sp" else "tp_deepseek"
    rows = ("data", "model") if layout == "sp" else ("data",)
    model = shd.shard_model(params_from_jax(tree(z, "deepseek/params"), cfg),
                            cfg.fsdp)
    shd.reset_collective_counts()
    with torch.no_grad():
        logits, aux, _ = TM.forward(model, cfg,
                                    torch.from_numpy(z["deepseek/tokens"]))
        out[f"{pre}/logits"] = logits.full_tensor().numpy()
        assert shd.batch_split() == ("data",), shd.batch_split()
        logits, aux, _ = TM.forward(model, cfg,
                                    torch.from_numpy(z["deepseek/rows"]))
        assert shd.batch_split() == rows, shd.batch_split()
    out[f"{pre}/rows_logits"] = logits.full_tensor().numpy()
    _weight_gathers(out, pre)


def case_tp_deepseek(z, out, mesh):
    case_deepseek(z, out, mesh, "tp")


def case_train(z, out, mesh, layout="sp"):
    """One train step on the mesh from the reference's initial weights."""
    cfg = config(TRAIN_ARCH, layer_layout=layout)
    pre = "train" if layout == "sp" else "tp_train"
    opt_cfg = adamw.AdamWConfig(**TRAIN_OPT)
    model = shd.shard_model(params_from_jax(tree(z, "train/params"), cfg),
                            cfg.fsdp)
    state = {"params": model,
             "opt": adamw.init_state(opt_cfg, dict(model.named_parameters()))}
    tokens = torch.from_numpy(z["train/tokens"]).long()
    shd.reset_collective_counts()
    state, met = st.make_train_step(cfg, opt_cfg)(
        state, {"tokens": tokens, "labels": tokens})
    _weight_gathers(out, pre)
    out[f"{pre}/loss"] = met["loss"].numpy()
    out[f"{pre}/grad_norm"] = met["grad_norm"].numpy()
    out[f"{pre}/split"] = np.array(str(shd.batch_split()))
    sh = st.state_shardings(cfg, model)
    for name, p in model.named_parameters():
        out[f"{pre}/params/{name}"] = p.detach().full_tensor().numpy()
        m = state["opt"]["m"][name]
        assert tuple(m.placements) == sh["opt"]["m"][name].placements, name
        assert tuple(p.placements) == sh["params"][name].placements, name


def _prefill_decode(z, out, pre, arch, layout, inputs="decode"):
    """Prefill and one decode step of ``arch`` with the cache placed by
    cache_shardings (its sequence dim over the model axis), under
    ``layout``; the next token picked over the (split) vocabulary."""
    cfg = config(arch, layer_layout=layout)
    model = shd.shard_model(params_from_jax(tree(z, f"{inputs}/params"),
                                            cfg), cfg.fsdp)
    toks = torch.from_numpy(z[f"{inputs}/tokens"]).long()
    B = toks.shape[0]
    cache = st.place_cache(TM.init_cache(cfg, B, DECODE_SMAX))
    shd.reset_collective_counts()
    lg, cache = TM.prefill(model, cfg, toks, cache)
    d, cache = TM.decode_step(model, cfg, toks[:, :1], cache,
                              DECODE_PROMPT[1])
    _weight_gathers(out, pre)
    want = st.cache_shardings(cache)
    for c, w in zip(cache, want):
        for n, t in c.items():
            assert tuple(t.placements) == w[n].placements, (n, t.placements)
    out[f"{pre}/prefill"] = lg.full_tensor().numpy()
    out[f"{pre}/logits"] = d.full_tensor().numpy()
    out[f"{pre}/next"] = shd.vocab_argmax(d).numpy()  # the rank's rows


def case_decode(z, out, mesh):
    _prefill_decode(z, out, "decode", DECODE_ARCH, "sp")


def case_tp_decode(z, out, mesh):
    for arch in TP_DECODE_ARCHS:
        _prefill_decode(z, out, f"tp_decode/{arch}", arch, "tp",
                        inputs="decode" if arch == DECODE_ARCH
                        else f"tp_decode/{arch}")


def case_reshard(z, out, mesh):
    """A checkpoint saved with no mesh restored onto the mesh: every
    parameter carries its rule's placements; the forward."""
    cfg = config(RESHARD_ARCH, fsdp=True)
    model = TM.init_params(cfg, torch.Generator().manual_seed(1))
    model = elastic.reshard_restore(str(z["reshard/dir"]), model, mesh,
                                    fsdp=cfg.fsdp)
    with shd.use_mesh(mesh):
        shd.reset_collective_counts()
        want = shd.param_shardings(model, cfg.fsdp)
        wrong = [n for n, p in model.named_parameters()
                 if tuple(p.placements) != want[n].placements]
        assert not wrong, wrong
        assert any(p.placements[0].is_shard()
                   for p in model.parameters()), "nothing on the data axis"
        with torch.no_grad():
            logits, _, _ = TM.forward(model, cfg,
                                      torch.from_numpy(z["reshard/tokens"]))
        _weight_gathers(out, "reshard")
    out["reshard/logits"] = logits.full_tensor().numpy()
    # saved from the mesh: gathered to rank 0 alone, which writes
    again = os.path.join(os.path.dirname(str(z["reshard/dir"])),
                         "reshard-again")
    ckpt.save(again, 2, {n: p.detach()
                         for n, p in model.named_parameters()})
    assert ckpt.latest_step(again) == 2
    if dist.get_rank() == 0:
        names = [n for n, _ in model.named_parameters()]
        a = ckpt.restore(str(z["reshard/dir"]), dict.fromkeys(names),
                         step=1)
        b = ckpt.restore(again, dict.fromkeys(names), step=2)
        out["reshard/resaved_err"] = np.array(max(
            float((a[n] - b[n]).abs().max()) for n in names))


def case_save_fails(z, out, mesh):
    """A save whose write fails on rank 0 raises on every rank, and the
    ranks' next collective still pairs up."""
    blocker = os.path.join(os.path.dirname(str(z["reshard/dir"])), "a-file")
    if dist.get_rank() == 0:
        with open(blocker, "w") as f:
            f.write("not a directory")
    dist.barrier()
    w = shd.distribute(torch.ones(8, 4),
                       shd.placements(("data", "model"), mesh), mesh)
    try:
        ckpt.save(os.path.join(blocker, "ckpt"), 1, {"w": w})
        raised = "no"
    except Exception as e:
        raised = type(e).__name__
    out["save_fails/raised"] = np.array(raised)
    one = torch.ones(())
    dist.all_reduce(one)
    out["save_fails/after"] = one.numpy()


def case_tp_train(z, out, mesh):
    case_train(z, out, mesh, "tp")


CASES = [("moe", case_moe), ("moe_drop", case_moe_drop),
         ("moe_einsum", case_moe_einsum),
         ("deepseek", case_deepseek), ("train", case_train),
         ("decode", case_decode), ("reshard", case_reshard),
         ("save_fails", case_save_fails),
         ("tp_moe", case_tp_moe), ("tp_moe_einsum", case_tp_moe_einsum),
         ("tp_kept", case_tp_kept),
         ("tp_deepseek", case_tp_deepseek), ("tp_train", case_tp_train),
         ("tp_decode", case_tp_decode)]


class CaseTimeout(Exception):
    pass


def _alarm(signum, frame):
    raise CaseTimeout(f"case over its {CASE_DEADLINE_S} s deadline")


def run(rank, store_path, in_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=CASE_DEADLINE_S))
    signal.signal(signal.SIGALRM, _alarm)
    out = {}
    try:
        mesh = lm.make_host_mesh(device="cpu")
        assert tuple(mesh.shape) == MESH, mesh
        out["backend"] = np.array(lm.init_distributed("cpu"))
        with np.load(in_path) as f:
            z = dict(f)
        for name, fn in CASES:
            t0 = time.perf_counter()
            signal.alarm(CASE_DEADLINE_S)
            try:
                if name in ("reshard", "save_fails"):
                    fn(z, out, mesh)
                else:
                    with shd.use_mesh(mesh):
                        fn(z, out, mesh)
                out[f"{name}/status"] = np.array("ok")
            except Exception:
                out[f"{name}/status"] = np.array(traceback.format_exc())
            finally:
                signal.alarm(0)
            out[f"{name}/seconds"] = np.array(time.perf_counter() - t0)
    finally:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
