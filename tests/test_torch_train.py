"""The port's training path against the JAX reference, on the CPU.

``layers.cross_entropy``; ``model.loss_fn`` and every gradient against
``jax.value_and_grad(repro.models.model.loss_fn)`` on the smoke configs
of a dense model (TinyLlama, also with ``ce_chunk`` and with
``remat="block"``), an MoE with MLA, shared experts and a leading dense
layer (DeepSeek-V2, its aux loss included) and an MoE with a dense
residual (Arctic), in float32 within 1e-5 of each gradient's largest
magnitude; three ``make_train_step`` steps with ``grad_accum`` 1 and 2
against the reference's jitted ``train_step``, losses and parameters
within 1e-5.  The reference runs once per test session in a fresh
process (shared by the xdist workers through a lock, as in
``tests/test_torch_batched.py``), on weights from ``PRNGKey(0)`` that
``params_from_jax`` carries across.

Then the substrate: ``TokenDataset.batch_at`` equal to the reference's
bit for bit, the prefetcher, checkpoints, ``run_resilient`` (the
counterparts of ``tests/test_substrate.py``'s cases), ``train``
resuming a preempted run bit for bit and its loss falling, and the
CLI.  K7's backward pass (``grouped_matmul.GroupedMatmul``) runs here
over the plain forward and must give plain autograd's gradients; K6
raises under autograd.
"""
import dataclasses
import fcntl
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as tcb
from repro_torch.data.pipeline import PrefetchLoader, TokenDataset
from repro_torch.kernels import grouped_matmul as k7
from repro_torch.kernels._build import KernelLaunchError
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import steps as st
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultConfig, Preempted, run_resilient

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
# (case, arch, config overrides); every case in float32
LOSS_CASES = [("tinyllama", "tinyllama_1_1b", {}),
              ("tinyllama-ce_chunk", "tinyllama_1_1b", {"ce_chunk": 8}),
              ("tinyllama-remat", "tinyllama_1_1b", {"remat": "block"}),
              ("deepseek", "deepseek_v2_236b", {}),
              ("arctic", "arctic_480b", {})]
LOSS_BATCH, LOSS_SEQ = 2, 16
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "tinyllama_1_1b", 3, 4, 16
# eps 1e-4, not AdamW's 1e-8: the step divides by sqrt(v) + eps, so at
# 1e-8 an element whose gradient lies at float32's summation noise (an
# embedding entry of 8e-8 beside a noise of 2e-7 here) steps by about
# +-lr whichever sign the noise gives it, in the port and the reference
# alike (3e-5 apart after three steps); at 1e-4 its step stays
# proportional to its gradient, and the comparison sees the arithmetic
TRAIN_OPT = dict(lr=1e-3, eps=1e-4, warmup_steps=2, decay_steps=10)

_REFERENCE_CHILD = """
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro.configs import base as cb
from repro.data.pipeline import TokenDataset
from repro.launch import steps as st
from repro.models import model as M
from repro.optim import adamw

out = {}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                       for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)

def config(arch, **ov):
    return dataclasses.replace(cb.get_smoke_config(arch), dtype="float32",
                               **ov)

def batch(cfg, B, S, step):
    ds = TokenDataset(cfg.vocab_size, S, B, seed=0,
                      enc_tokens=cfg.num_frontend_tokens, d_model=cfg.d_model)
    return {k: jnp.asarray(v) for k, v in ds.batch_at(step).items()}

for case, arch, ov in %(loss_cases)r:
    cfg = config(arch, **ov)
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    (loss, met), grads = jax.jit(jax.value_and_grad(
        lambda p, b: M.loss_fn(p, cfg, b), has_aux=True))(
            params, batch(cfg, %(loss_b)d, %(loss_s)d, 0))
    put(f"{case}/params", params)
    put(f"{case}/grads", grads)
    out[f"{case}/loss"], out[f"{case}/ce"], out[f"{case}/aux"] = (
        np.asarray(loss), np.asarray(met["ce"]), np.asarray(met["aux"]))

cfg = config(%(train_arch)r)
for accum in (1, 2):
    opt_cfg = adamw.AdamWConfig(grad_accum=accum, **%(train_opt)r)
    state = st.init_train_state(cfg, opt_cfg, jax.random.PRNGKey(0))
    put(f"train{accum}/init", state["params"])
    step = jax.jit(st.make_train_step(cfg, opt_cfg))
    for i in range(%(train_steps)d):
        state, m = step(state, batch(cfg, %(train_b)d, %(train_s)d, i))
        for k in ("loss", "grad_norm", "lr"):
            out[f"train{accum}/{k}{i}"] = np.asarray(m[k])
    put(f"train{accum}/params", state["params"])
np.savez(sys.argv[1], **out)
""" % dict(loss_cases=LOSS_CASES, loss_b=LOSS_BATCH, loss_s=LOSS_SEQ,
           train_arch=TRAIN_ARCH, train_opt=TRAIN_OPT,
           train_steps=TRAIN_STEPS, train_b=TRAIN_BATCH, train_s=TRAIN_SEQ)


@pytest.fixture(scope="session")
def reference(tmp_path_factory):
    """The reference's losses, gradients and train steps, computed once
    for the session: the xdist workers share the session's temporary
    root, and the first to take the lock runs the one process."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out_dir = root / "train-reference"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = out_dir / "done.npz"
        if not done.exists():
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       PYTHONPATH=os.pathsep.join(
                           [str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")]))
            subprocess.run([sys.executable, "-c", _REFERENCE_CHILD,
                            str(out_dir / "ref.npz")],
                           env=env, check=True, timeout=600)
            os.replace(out_dir / "ref.npz", done)
    with np.load(done) as z:
        return dict(z)


def _tree(ref, prefix):
    """The nested dict of numpy arrays under ``prefix/`` of the
    reference's flat output."""
    tree = {}
    for key, arr in ref.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return tree


def _config(arch, **ov):
    return dataclasses.replace(tcb.get_smoke_config(arch), dtype="float32",
                               **ov)


def _batch(cfg, B, S, step):
    ds = TokenDataset(cfg.vocab_size, S, B, seed=0,
                      enc_tokens=cfg.num_frontend_tokens, d_model=cfg.d_model)
    out = {k: torch.from_numpy(v) for k, v in ds.batch_at(step).items()}
    out["tokens"], out["labels"] = out["tokens"].long(), out["labels"].long()
    return out


def _assert_close(got: dict, want: dict, what):
    """Every tensor of ``got`` within TOL of ``want``'s largest magnitude
    (float32 sums in another order: elementwise relative error is
    unbounded where a gradient cancels to near zero)."""
    assert sorted(got) == sorted(want), what
    for name, g in got.items():
        w = want[name]
        scale = max(float(w.abs().max()), 1e-30)
        err = float((g.detach().float() - w.float()).abs().max())
        assert err <= TOL * scale, (what, name, err, scale)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_reference_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :3] = labels[2, 5] = -1
    lt = torch.from_numpy(logits).requires_grad_()
    got = tlayers.cross_entropy(lt, torch.from_numpy(labels).long())
    got.backward()
    want, want_g = jax.value_and_grad(
        lambda x: jlayers.cross_entropy(x, jnp.asarray(labels)))(
            jnp.asarray(logits))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g),
                               rtol=TOL, atol=TOL * float(np.abs(want_g).max()))
    assert np.all(lt.grad.numpy()[0, :3] == 0)  # ignored labels: no gradient
    # every label ignored: the loss is 0, not a division by zero
    none = tlayers.cross_entropy(lt, torch.full((3, 7), -1))
    assert float(none) == 0.0
    # bf16 logits are taken in float32
    assert tlayers.cross_entropy(lt.detach().bfloat16(),
                                 torch.from_numpy(labels).long()).dtype \
        == torch.float32


@pytest.mark.parametrize("case,arch,ov", LOSS_CASES,
                         ids=[c for c, _, _ in LOSS_CASES])
def test_loss_and_grads_match_reference(case, arch, ov, reference):
    cfg = _config(arch, **ov)
    model = params_from_jax(_tree(reference, f"{case}/params"), cfg)
    want = params_from_jax(_tree(reference, f"{case}/grads"), cfg)
    loss, met = TM.loss_fn(model, cfg, _batch(cfg, LOSS_BATCH, LOSS_SEQ, 0))
    names = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in names])
    for k, v in (("loss", loss), ("ce", met["ce"]), ("aux", met["aux"])):
        assert v.dtype == torch.float32 and v.shape == ()
        np.testing.assert_allclose(float(v), reference[f"{case}/{k}"],
                                   rtol=TOL, atol=TOL)
    if cfg.moe:  # the aux loss enters the loss
        assert float(met["aux"]) > 0
        np.testing.assert_allclose(
            float(loss), float(met["ce"]) + TM.AUX_LOSS_COEF
            * float(met["aux"]), rtol=1e-6)
    _assert_close({n: g for (n, _), g in zip(names, grads)},
                  dict(want.named_parameters()), case)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum, reference):
    cfg = _config(TRAIN_ARCH)
    opt_cfg = adamw.AdamWConfig(grad_accum=accum, **TRAIN_OPT)
    model = params_from_jax(_tree(reference, f"train{accum}/init"), cfg)
    state = {"params": model,
             "opt": adamw.init_state(opt_cfg,
                                     dict(model.named_parameters()))}
    step = st.make_train_step(cfg, opt_cfg)
    for i in range(TRAIN_STEPS):
        state, m = step(state, _batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i))
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]),
                                       reference[f"train{accum}/{k}{i}"],
                                       rtol=TOL, atol=TOL)
        assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert state["params"] is model and int(state["opt"]["step"]) == 3
    want = params_from_jax(_tree(reference, f"train{accum}/params"), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), dict(want.named_parameters())[name].detach()
            .numpy(), rtol=0, atol=TOL, err_msg=name)


def test_remat_and_chunked_ce_on_an_moe():
    """On DeepSeek's MoE (K7's path), ``remat="block"`` leaves the loss
    and gradients bit for bit (checkpointing recomputes the same ops in
    the same order) and ``ce_chunk`` within TOL (its sums run per
    chunk)."""
    def run(**ov):
        cfg = _config("deepseek_v2_236b", **ov)
        model = TM.init_params(cfg, torch.Generator().manual_seed(3))
        loss, _ = TM.loss_fn(model, cfg, _batch(cfg, 2, 16, 1))
        grads = torch.autograd.grad(loss, model.parameters())
        return {"loss": loss, **{str(i): g for i, g in enumerate(grads)}}

    base = run()
    for k, v in run(remat="block").items():
        assert torch.equal(v, base[k]), k
    _assert_close(run(ce_chunk=4), base, "ce_chunk")


# ---------------------------------------------------------------------------
# K7's backward pass and K6 under autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [3, -4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_backward_matches_plain_autograd(dtype, extra):
    """GroupedMatmul over the plain forward gives plain autograd's dx and
    dW in the counts layout: experts keeping 0 rows, cap rows and more
    than cap (cut to cap), noise in every row no expert keeps (which must
    get no gradient and feed none), and rows past E cap (``extra`` 3) or
    a buffer short of E cap (-4)."""
    E, cap, D, F = 5, 6, 16, 24
    T = E * cap + extra
    counts = torch.tensor([0, 6, 2, 9, 1], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((T, D), generator=g).to(dtype)
    w = torch.randn((E, D, F), generator=g).to(dtype)
    dy = torch.randn((T, F), generator=g).to(dtype)
    calls = []

    def fwd(x, w, sizes, cap, route=None):
        calls.append((route, w))
        return k7.plain_launch(x, w, sizes, cap, route)

    grads = []
    for how in ("function", "plain"):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = (k7.GroupedMatmul.apply(xa, wa, counts, cap, fwd)
             if how == "function"
             else k7.grouped_matmul_plain(xa, wa, counts, cap=cap))
        y.backward(dy)
        grads.append((y.detach(), xa.grad, wa.grad))
        if how == "function":
            w_fwd, w_dx = calls[0][1], calls[1][1]
    assert [route for route, _ in calls] == [None, "backward"]
    # the dx call gets W's own storage, read in place as W^T (K-major)
    assert w_dx.data_ptr() == w_fwd.data_ptr()
    storage, k_major = k7.b_storage(w_dx)
    assert k_major and storage.data_ptr() == w_fwd.data_ptr()
    (y, dx, dw), (y_p, dx_p, dw_p) = grads
    assert torch.equal(y, y_p)
    tol = dict(rtol=1e-6, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-2)
    torch.testing.assert_close(dx, dx_p, **tol)
    torch.testing.assert_close(dw, dw_p, **tol)
    kept = torch.zeros(T, dtype=torch.bool)
    for e, n in enumerate(counts.tolist()):
        kept[e * cap:min(e * cap + min(n, cap), T)] = True
    assert bool((dx[~kept] == 0).all())
    assert bool((dw[0] == 0).all())  # expert 0 keeps no row
    # no dx launch when x needs no gradient
    calls.clear()
    k7.GroupedMatmul.apply(x, w.clone().requires_grad_(), counts, cap,
                           fwd).backward(dy)
    assert [route for route, _ in calls] == [None]


def test_grouped_matmul_contiguous_backward_raises():
    x = torch.randn(8, 8, requires_grad=True)
    w = torch.randn(2, 8, 8, requires_grad=True)
    y = k7.GroupedMatmul.apply(x, w, torch.tensor([3, 5]), None,
                               k7.plain_launch)
    with pytest.raises(NotImplementedError, match="counts layout"):
        y.sum().backward()


def test_moe_block_backward_through_the_function():
    """DeepSeek's MoE block with its expert products through
    GroupedMatmul (plain forward) has plain autograd's gradients."""
    cfg = _config("deepseek_v2_236b")
    ffn = tmoe.moe_init(cfg, torch.float32,
                        generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))

    def grads(gmm):
        xa = x.clone().requires_grad_()
        out, aux = tmoe.moe_block(ffn, xa, cfg, gmm=gmm)
        (out.square().sum() + aux).backward()
        got = [xa.grad] + [p.grad.clone() for p in ffn.parameters()]
        ffn.zero_grad()
        return got

    def function(x, w, sizes, cap):
        return k7.GroupedMatmul.apply(x, w, sizes, cap, k7.plain_launch)

    for a, b in zip(grads(function), grads(k7.grouped_matmul_plain)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_flash_attention_raises_under_autograd():
    q, k, v = (torch.randn(1, 8, 4, 16, requires_grad=True)
               for _ in range(3))
    with pytest.raises(NotImplementedError, match='attn_impl="xla"'):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == (1, 8, 4, 16)
    cfg = _config("tinyllama_1_1b", attn_impl="pallas")
    model = TM.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        TM.loss_fn(model, cfg, _batch(cfg, 2, 8, 0))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=7, n_shards=2,
                                                   shard_id=1),
                                dict(seed=3, enc_tokens=5, d_model=8)])
def test_token_dataset_matches_reference(kw):
    got = TokenDataset(1000, 16, 8, **kw)
    want = jpipe.TokenDataset(1000, 16, 8, **kw)
    for step in (0, 1, 9, 12345):
        a, b = got.batch_at(step), want.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_dataset_deterministic_and_sharded():
    ds0 = TokenDataset(1000, 16, 8, seed=7, n_shards=2, shard_id=0)
    ds1 = TokenDataset(1000, 16, 8, seed=7, n_shards=2, shard_id=1)
    a, b = ds0.batch_at(3), ds0.batch_at(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], ds1.batch_at(3)["tokens"])
    assert a["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    with pytest.raises(ValueError):
        TokenDataset(1000, 16, 7, n_shards=2)


def test_prefetch_loader_order_and_resume():
    ds = TokenDataset(100, 8, 4, seed=1)
    loader = PrefetchLoader(ds).start(step=5)
    try:
        for step in (5, 6, 7):
            b = next(loader)
            assert b["_step"] == step
            np.testing.assert_array_equal(b["tokens"],
                                          ds.batch_at(step)["tokens"])
    finally:
        loader.stop()
    assert not loader._thread.is_alive()


def test_straggler_backup_fetch():
    ds = TokenDataset(100, 8, 4, seed=1)
    calls = {"n": 0}

    def slow_fetch(step):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(1.0)  # the primary straggles past the deadline
        return ds.batch_at(step)

    loader = PrefetchLoader(ds, deadline_s=0.1, fetch_fn=slow_fetch).start()
    b = next(loader)
    loader.stop()
    assert loader.backup_fetches >= 1
    np.testing.assert_array_equal(b["tokens"], ds.batch_at(0)["tokens"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_ckpt_roundtrip_and_keep(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.linspace(-3, 3, 5).bfloat16(),
                  "layers.0.w": torch.tensor(7, dtype=torch.int32)}}
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert sorted(ckpt.all_steps(str(tmp_path))) == [3, 4]
    out = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert torch.equal(out["b"]["layers.0.w"], tree["b"]["layers.0.w"])
    with open(tmp_path / "step_4" / "tree.json") as f:
        assert '"b/layers.0.w"' in f.read()  # the port's parameter names
    with pytest.raises(ValueError, match="not the target"):
        ckpt.restore(str(tmp_path), {"a": tree["a"]})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


def test_ckpt_async_save(tmp_path):
    tree = {"a": torch.zeros(10)}
    t = ckpt.save(str(tmp_path), 7, tree, blocking=False)
    tree["a"] += 1  # the host copy was taken before save returned
    t.join()
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert float(ckpt.restore(str(tmp_path), tree)["a"].sum()) == 0


def test_ckpt_torn_write_invisible(tmp_path):
    # a .tmp directory is never listed as a checkpoint
    os.makedirs(tmp_path / ".tmp_step_9")
    assert ckpt.latest_step(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def _toy_loop(tmp_path, fail_at=None, max_restarts=3):
    state = {"x": torch.zeros(())}
    fired = {"done": False}

    def train_step(state, batch):
        return {"x": state["x"] + 1}, {"loss": 1.0 / (float(state["x"]) + 1)}

    def save_fn(step, state):
        return ckpt.save(str(tmp_path), step, state, blocking=True)

    def restore_fn():
        s = ckpt.latest_step(str(tmp_path))
        if s is None:
            return None
        return s, ckpt.restore(str(tmp_path), {"x": torch.zeros(())}, step=s)

    def preempt(step):
        if fail_at is not None and step == fail_at and not fired["done"]:
            fired["done"] = True
            raise Preempted(f"simulated preemption at {step}")

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=4,
                       max_restarts=max_restarts)
    return run_resilient(train_step, state, lambda step: {}, fcfg,
                         num_steps=10, save_fn=save_fn, restore_fn=restore_fn,
                         preempt_hook=preempt)


@pytest.mark.parametrize("fail_at", [None, 6])
def test_resilient_loop_completes_and_resumes(tmp_path, fail_at):
    state, hist = _toy_loop(tmp_path, fail_at=fail_at)
    assert float(state["x"]) == 10
    # preempted at 6: resumed from the step-4 checkpoint
    assert hist["restarts"] == (fail_at is not None)
    assert [h["step"] for h in hist["steps"]][-6:] == [4, 5, 6, 7, 8, 9]


def test_resilient_loop_gives_up(tmp_path):
    def always_preempt(step):
        raise Preempted("always")

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), max_restarts=2)
    with pytest.raises(RuntimeError, match="max_restarts"):
        run_resilient(lambda s, b: (s, {"loss": 0.0}), {"x": torch.zeros(())},
                      lambda step: {}, fcfg, num_steps=5,
                      save_fn=lambda s, st: None, restore_fn=lambda: None,
                      preempt_hook=always_preempt)


def test_resilient_loop_save_failure_does_not_burn_restarts(tmp_path):
    saves = {"n": 0}

    def bad_save(step, state):
        saves["n"] += 1
        raise RuntimeError("checkpoint disk full")

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2, max_restarts=0)
    state, hist = run_resilient(
        lambda s, b: ({"x": s["x"] + 1}, {"loss": 0.5}),
        {"x": torch.zeros(())}, lambda step: {}, fcfg, num_steps=6,
        save_fn=bad_save, restore_fn=lambda: None)
    assert float(state["x"]) == 6
    assert hist["restarts"] == 0 and hist["saves"] == 0
    assert hist["save_failures"] == saves["n"] == 3  # steps 2, 4, 6


def test_resilient_loop_restore_failure_cold_starts(tmp_path):
    armed = {"on": True}

    def preempt(step):
        if step == 3 and armed["on"]:
            armed["on"] = False
            raise Preempted("sim")

    def bad_restore():
        raise OSError("corrupt checkpoint dir")

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                       max_restarts=2)
    state, hist = run_resilient(
        lambda s, b: ({"x": s["x"] + 1}, {"loss": 0.5}),
        {"x": torch.zeros(())}, lambda step: {}, fcfg, num_steps=5,
        save_fn=lambda s, st: None, restore_fn=bad_restore,
        preempt_hook=preempt)
    assert hist["restarts"] == 1
    # a cold restart: the step counter back to 0, the state in memory kept
    # (3 steps before the preemption + 5 after)
    assert float(state["x"]) == 8


def test_resilient_loop_joins_flaky_async_save(tmp_path):
    joins = {"n": 0}

    class FlakyHandle:
        def join(self):
            joins["n"] += 1
            raise RuntimeError("async save died")

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=2, max_restarts=0)
    state, hist = run_resilient(
        lambda s, b: ({"x": s["x"] + 1}, {"loss": 0.5}),
        {"x": torch.zeros(())}, lambda step: {}, fcfg, num_steps=4,
        save_fn=lambda s, st: FlakyHandle(), restore_fn=lambda: None)
    assert float(state["x"]) == 4
    assert hist["saves"] == 2 and joins["n"] == 2


@pytest.mark.parametrize("exc", [NotImplementedError("no backward"),
                                 KernelLaunchError("refused")])
def test_resilient_loop_does_not_replay_what_a_replay_cannot_cure(tmp_path,
                                                                  exc):
    def step_fn(s, b):
        raise exc

    fcfg = FaultConfig(ckpt_dir=str(tmp_path), max_restarts=3)
    with pytest.raises(type(exc)):
        run_resilient(step_fn, {}, lambda step: {}, fcfg, num_steps=2,
                      save_fn=None, restore_fn=None)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _train(tmp, steps, *, ckpt_every=100, preempt_hook=None, lr=1e-3,
           device="cpu"):
    cfg = tcb.get_smoke_config("tinyllama_1_1b")
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=2, decay_steps=steps)
    fcfg = FaultConfig(ckpt_dir=None if tmp is None else str(tmp),
                       ckpt_every=ckpt_every, async_save=False)
    return ttrain.train(cfg, opt_cfg, fcfg, num_steps=steps, global_batch=4,
                        seq_len=32, device=device, preempt_hook=preempt_hook,
                        log_every=1000)


def test_train_resumes_preempted_run_bit_for_bit(tmp_path):
    """Train 6; vs train 4, preempted, resumed from the step-3
    checkpoint to 6: every step's loss and the final weights and moments
    equal, bit for bit."""
    a, ha = _train(None, 6)
    fired = []

    def preempt(step):
        if step == 4 and not fired:
            fired.append(step)
            raise Preempted("sim")

    b, hb = _train(tmp_path, 6, ckpt_every=3, preempt_hook=preempt)
    assert fired == [4] and hb["restarts"] == 1
    assert hb["saves"] == 2 and len(hb["save_s"]) == 2
    assert len(hb["restore_s"]) == 1 and ha["saves"] == 0
    last = {h["step"]: h["loss"] for h in hb["steps"]}
    assert [h["step"] for h in hb["steps"]] == [0, 1, 2, 3, 3, 4, 5]
    assert [last[s] for s in range(6)] == [h["loss"] for h in ha["steps"]]
    for (na, pa), (nb, pb) in zip(a["params"].named_parameters(),
                                  b["params"].named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    for k in ("m", "v"):
        for n in a["opt"][k]:
            assert torch.equal(a["opt"][k][n], b["opt"][k][n]), (k, n)
    assert int(b["opt"]["step"]) == 6
    # a second run in the same directory resumes from its last checkpoint
    c, hc = _train(tmp_path, 6)
    assert hc["steps"] == [] and len(hc["restore_s"]) == 1
    assert all(torch.equal(pa, pc) for pa, pc in
               zip(b["params"].parameters(), c["params"].parameters()))


def test_train_loss_falls():
    _, hist = _train(None, 30, lr=3e-3)
    losses = [h["loss"] for h in hist["steps"]]
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])
    assert all(np.isfinite(h["grad_norm"]) for h in hist["steps"])


def test_train_cli_and_device_rule(tmp_path, capsys):
    ttrain.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                 "--steps", "2", "--batch", "2", "--seq", "8",
                 "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert "done: loss" in capsys.readouterr().out
    assert sorted(ckpt.all_steps(str(tmp_path))) == [1, 2]
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _train(None, 1, device=None)
