"""The port's sharded model paths on a (2, 4) mesh of the CPU against the
JAX reference's single-device functions.

One ``torch.multiprocessing`` spawn of 8 gloo ranks
(``tests/torch_mesh_ranks.py``, rendezvous through a ``FileStore`` in
the session's temporary directory) runs every case, each under its own
deadline; the parent builds the inputs (the reference's weights from
``PRNGKey(0)``, numpy draws from a seed), computes the reference's
numbers while the ranks run, and each test here holds one case's
output.  The spawn runs once per session: the xdist workers share the
session's temporary root, and the first to take the lock runs it.

The reference's own sharded paths do not run on the installed JAX, so
each case holds the port to the functions they are compared with: the
zipper dispatch of one rank is the einsum dispatch on that rank's
tokens (the all_to_all moves rows, the expert FFN acts row by row), so
each rank's ``_shardmap_moe`` output equals the reference's
``_einsum_moe`` on its tokens, at a dropless factor and at one that
drops assignments; at the dropless factor the gathered output and the
gradients equal the single-device ``jax.grad``.  The einsum dispatch on
the mesh routes the global batch, as the reference's GSPMD does.  DeepSeek-V2's forward
on the mesh (MLA, shared experts, the zipper dispatch) equals the
reference's single-device forward; a TinyLlama train step equals the
reference's jitted step; Granite's prefill and decode with
``cache_shardings`` applied equal the reference's; a checkpoint saved
with no mesh and restored onto the mesh by ``elastic.reshard_restore``
carries each rule's placements and gives the single-device forward.
"""
import dataclasses
import fcntl
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_mesh_ranks as R
from repro.configs import base as jcb
from repro.launch import steps as jst
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt
from repro_torch.models.convert import params_from_jax

SEED = 0
JOIN_DEADLINE_S = 240
RANKS_ENV = {"OMP_NUM_THREADS": "1"}


def _jcfg(arch, **ov):
    return dataclasses.replace(jcb.get_smoke_config(arch), dtype="float32",
                               **ov)


def _put(z, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", "")))
                       for k in path)
        z[f"{prefix}/{key}"] = np.asarray(leaf)


def _blocks(x, fn):
    """fn over each (2 data x 4 model) rank's tokens of x (B, S, D),
    stitched back: the rows of data block d, the positions of model
    block m."""
    B, S = x.shape[:2]
    b, s = B // R.MESH[0], S // R.MESH[1]
    out = np.zeros(x.shape, np.float32)
    for d in range(R.MESH[0]):
        for m in range(R.MESH[1]):
            blk = (slice(d * b, (d + 1) * b), slice(m * s, (m + 1) * s))
            out[blk] = np.asarray(fn(jnp.asarray(x[blk])))
    return out


def _inputs(root):
    """The cases' inputs (and the reference's weights) as a flat dict."""
    rng = np.random.default_rng(SEED)
    key = jax.random.PRNGKey(0)
    z = {}
    cfg = _jcfg(R.MOE_ARCH, **R.MOE_OV)
    _put(z, "moe/params", jmoe.moe_init(key, cfg, jnp.float32))
    D = cfg.d_model
    z["moe/x"] = rng.standard_normal(R.MOE_X + (D,)).astype(np.float32)
    z["moe/ct"] = rng.standard_normal(R.MOE_X + (D,)).astype(np.float32)
    z["moe_drop/x"] = rng.standard_normal(R.MOE_DROP_X + (D,)).astype(
        np.float32)
    z["deepseek/rows"] = rng.integers(
        0, _jcfg(R.DEEPSEEK_ARCH).vocab_size, R.DEEPSEEK_ROWS).astype(np.int32)
    for case, arch, shape in (("deepseek", R.DEEPSEEK_ARCH, R.DEEPSEEK_TOKENS),
                              ("train", R.TRAIN_ARCH, R.TRAIN_BATCH),
                              ("decode", R.DECODE_ARCH, R.DECODE_PROMPT),
                              ("reshard", R.RESHARD_ARCH, R.RESHARD_TOKENS)
                              ) + tuple(
            (f"tp_decode/{a}", a, R.DECODE_PROMPT)
            for a in R.TP_DECODE_ARCHS if a != R.DECODE_ARCH):
        c = _jcfg(arch)
        _put(z, f"{case}/params", JM.init_params(c, key))
        z[f"{case}/tokens"] = rng.integers(0, c.vocab_size, shape).astype(
            np.int32)
    c = _jcfg(R.MOE_ARCH, **R.KEPT_OV)
    _put(z, "kept/params", JM.init_params(c, key))
    z["kept/tokens"] = rng.integers(0, c.vocab_size, R.KEPT_TOKENS).astype(
        np.int32)
    # the checkpoint reshard_restore reads: saved with no mesh
    ck = root / "reshard-ckpt"
    model = params_from_jax(_tree(z, "reshard/params"),
                            R.config(R.RESHARD_ARCH, fsdp=True))
    ckpt.save(str(ck), 1, {k: p.detach()
                           for k, p in model.named_parameters()})
    z["reshard/dir"] = np.array(str(ck))
    return z


def _tree(z, prefix):
    return R.tree(z, prefix)


def _reference(z):
    """The reference's numbers for every case."""
    ref = {}
    p = _tree(z, "moe/params")
    cfg = _jcfg(R.MOE_ARCH, capacity_factor=R.MOE_DROPLESS_CF, **R.MOE_OV)
    x, ct = jnp.asarray(z["moe/x"]), jnp.asarray(z["moe/ct"])
    ref["moe/y_local"] = _blocks(z["moe/x"],
                                 lambda t: jmoe._einsum_moe(p, t, cfg)[0])

    def f(p, x):
        return jnp.sum(jmoe._einsum_moe(p, x, cfg)[0] * ct)
    y, _ = jmoe._einsum_moe(p, x, cfg)
    gp, gx = jax.grad(f, argnums=(0, 1))(p, x)
    ref["moe/y"] = np.asarray(y)
    ref["moe/gx"] = np.asarray(gx)
    _put(ref, "moe/g", gp)
    cfg = _jcfg(R.MOE_ARCH, capacity_factor=R.MOE_DROP_CF, **R.MOE_OV)
    ref["moe_drop/y_local"] = _blocks(
        z["moe_drop/x"], lambda t: jmoe._einsum_moe(p, t, cfg)[0])
    # the factor drops: some rank's expert gets more than its capacity
    xd = z["moe_drop/x"].reshape(2, 2, 4, 128, -1).transpose(0, 2, 1, 3, 4)
    ids = np.argsort(-(xd.reshape(8, 256, -1) @ np.asarray(p["router"]["w"])),
                     axis=-1)[..., :cfg.top_k]
    cap = jmoe._capacity(256, cfg.top_k, cfg.num_experts, cfg.capacity_factor)
    ref["moe_einsum/y"] = np.asarray(jmoe._einsum_moe(
        p, jnp.asarray(z["moe_drop/x"]), cfg)[0])
    ref["moe_drop/most"] = max(int(np.bincount(r.ravel()).max()) for r in ids)
    ref["moe_drop/cap"] = cap

    cfg = _jcfg(R.DEEPSEEK_ARCH, moe_dispatch="einsum")
    fwd = jax.jit(lambda p, t: JM.forward(p, cfg, t)[0])
    for k in ("tokens", "rows"):
        ref[f"deepseek/{k}_logits"] = np.asarray(fwd(
            _tree(z, "deepseek/params"), jnp.asarray(z[f"deepseek/{k}"])))

    cfg = _jcfg(R.TRAIN_ARCH)
    opt_cfg = jadamw.AdamWConfig(**R.TRAIN_OPT)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(z, "train/params"))
    state = {"params": params, "opt": jadamw.init_state(opt_cfg, params)}
    toks = jnp.asarray(z["train/tokens"])
    state, m = jax.jit(jst.make_train_step(cfg, opt_cfg))(
        state, {"tokens": toks, "labels": toks})
    ref["train/loss"] = np.asarray(m["loss"])
    new = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                 state["params"]),
                          R.config(R.TRAIN_ARCH))
    for name, t in new.named_parameters():
        ref[f"train/params/{name}"] = t.detach().numpy()

    for arch in R.TP_DECODE_ARCHS:
        pre = "decode" if arch == R.DECODE_ARCH else f"tp_decode/{arch}"
        cfg = _jcfg(arch)
        params = _tree(z, f"{pre}/params")
        toks = jnp.asarray(z[f"{pre}/tokens"])
        cache = JM.init_cache(cfg, toks.shape[0], R.DECODE_SMAX)
        lg, cache = jax.jit(lambda p, t, c: JM.prefill(p, cfg, t, c))(
            params, toks, cache)
        d, _ = jax.jit(lambda p, t, c: JM.decode_step(
            p, cfg, t, c, jnp.int32(R.DECODE_PROMPT[1])))(
                params, toks[:, :1], cache)
        ref[f"{pre}/prefill"], ref[f"{pre}/logits"] = (np.asarray(lg),
                                                       np.asarray(d))

    # the MoE block's input in one Arctic layer (its moe_block wrapped to
    # hand what it is given to the host)
    cfg = _jcfg(R.MOE_ARCH, **R.KEPT_OV)
    seen = []
    block = jmoe.moe_block

    def keep_input(p, x, c, **kw):
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), x)
        return block(p, x, c, **kw)
    jmoe.moe_block = keep_input
    try:
        JM.forward(_tree(z, "kept/params"), cfg,
                   jnp.asarray(z["kept/tokens"]))
    finally:
        jmoe.moe_block = block
    ref["kept/moe_in"] = seen[0]
    w, = (v for k, v in z.items()
          if k.startswith("kept/params/") and k.endswith("ffn/router/w"))
    ref["kept/router"] = w.reshape(w.shape[-2:])  # the one layer's

    cfg = _jcfg(R.RESHARD_ARCH, fsdp=True)
    ref["reshard/logits"] = np.asarray(jax.jit(
        lambda p, t: JM.forward(p, cfg, t)[0])(
            _tree(z, "reshard/params"), jnp.asarray(z["reshard/tokens"])))
    return ref


def _run(root):
    z = _inputs(root)
    in_path = root / "inputs.npz"
    np.savez(in_path, **z)
    out_dir = root / "ranks"
    out_dir.mkdir()
    old = {k: os.environ.get(k) for k in RANKS_ENV}
    os.environ.update(RANKS_ENV)
    try:
        ctx = mp.start_processes(
            R.run, args=(str(root / "store"), str(in_path), str(out_dir)),
            nprocs=R.WORLD, join=False, start_method="spawn")
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    t0 = time.perf_counter()
    ref = _reference(z)
    ref_s = time.perf_counter() - t0
    deadline = time.monotonic() + JOIN_DEADLINE_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks ran past {JOIN_DEADLINE_S} s")
    ranks = []
    for r in range(R.WORLD):
        with np.load(out_dir / f"rank{r}.npz") as f:
            ranks.append(dict(f))
    return {"ref": ref, "ranks": ranks, "ref_s": ref_s,
            "wall_s": time.perf_counter() - t0}


@pytest.fixture(scope="session")
def mesh_run(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "torch-mesh"
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / "done.npz"
        if not done.exists():
            res = _run(root / f"run{os.getpid()}")  # a fresh store
            flat = {f"ref/{k}": v for k, v in res["ref"].items()}
            for r, out in enumerate(res["ranks"]):
                flat.update((f"rank{r}/{k}", v) for k, v in out.items())
            flat["wall_s"], flat["ref_s"] = res["wall_s"], res["ref_s"]
            np.savez(root / "tmp.npz", **flat)
            os.replace(root / "tmp.npz", done)
    with np.load(done) as f:
        flat = dict(f)
    ref = {k[4:]: v for k, v in flat.items() if k.startswith("ref/")}
    ranks = [{k[len(f"rank{r}/"):]: v for k, v in flat.items()
              if k.startswith(f"rank{r}/")} for r in range(R.WORLD)]
    return ref, ranks


def _ok(ranks, case):
    for r, out in enumerate(ranks):
        status = str(out[f"{case}/status"])
        assert status == "ok", f"rank {r}: {status}"


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) -
                        np.asarray(b, np.float32)).max())


def test_ranks_run_gloo_on_the_host_mesh(mesh_run):
    _, ranks = mesh_run
    assert all(str(out["backend"]) == "gloo" for out in ranks)
    for case, _ in R.CASES:
        for r, out in enumerate(ranks):
            assert float(out[f"{case}/seconds"]) < R.CASE_DEADLINE_S, (case, r)


def test_shardmap_moe_each_rank_is_einsum_on_its_tokens(mesh_run):
    ref, ranks = mesh_run
    _ok(ranks, "moe")
    b = R.MOE_X[0] // R.MESH[0]
    for r, out in enumerate(ranks):
        d = r // R.MESH[1]
        want = ref["moe/y_local"][d * b:(d + 1) * b]
        assert _err(out["moe/y"], want) < 1e-4, r
        # dropless: the output gathered over the data axis is the
        # single-device one too
        assert _err(out["moe/y"], ref["moe/y"][d * b:(d + 1) * b]) < 1e-3
    aux = [float(out["moe/aux"]) for out in ranks]
    assert max(aux) == min(aux)  # averaged over every rank


def test_shardmap_moe_gradients_match_single_device_grad(mesh_run):
    ref, ranks = mesh_run
    _ok(ranks, "moe")
    b = R.MOE_X[0] // R.MESH[0]
    for r, out in enumerate(ranks):
        d = r // R.MESH[1]
        assert _err(out["moe/gx"], ref["moe/gx"][d * b:(d + 1) * b]) < 1e-3
        for name in ("router/w", "experts/w1", "experts/w3", "experts/w2"):
            got = out[f"moe/g/{name.replace('/', '.')}"]
            assert _err(got, ref[f"moe/g/{name}"]) < 1e-3, (r, name)


def test_shardmap_moe_dropping_factor_fsdp_experts(mesh_run):
    ref, ranks = mesh_run
    _ok(ranks, "moe_drop")
    assert ref["moe_drop/most"] > ref["moe_drop/cap"]  # the factor drops
    b = R.MOE_DROP_X[0] // R.MESH[0]
    for r, out in enumerate(ranks):
        d = r // R.MESH[1]
        want = ref["moe_drop/y_local"][d * b:(d + 1) * b]
        assert _err(out["moe_drop/y"], want) < 1e-4, r
        # experts over the model axis, their D over the data axis
        assert str(out["moe_drop/w1_placements"]) == \
            "(Shard(dim=1), Shard(dim=0))"


def test_einsum_dispatch_on_mesh_routes_the_global_batch(mesh_run):
    ref, ranks = mesh_run
    _ok(ranks, "moe_einsum")
    b = R.MOE_DROP_X[0] // R.MESH[0]
    for r, out in enumerate(ranks):
        d = r // R.MESH[1]
        want = ref["moe_einsum/y"][d * b:(d + 1) * b]
        assert _err(out["moe_einsum/y"], want) < 1e-4, r


def test_deepseek_forward_on_mesh_matches_single_device(mesh_run):
    ref, ranks = mesh_run
    _ok(ranks, "deepseek")
    for out in ranks:
        assert _err(out["deepseek/logits"], ref["deepseek/tokens_logits"]) \
            < 1e-4


def test_deepseek_forward_with_rows_split_over_model_axis(mesh_run):
    """Under ``layer_layout="sp"`` a batch that divides by every rank is
    split over the data and the model axis together (one row per rank
    here): the zipper dispatch routes each rank's rows whole, and the
    logits are the same."""
    ref, ranks = mesh_run
    _ok(ranks, "deepseek")
    for out in ranks:
        assert _err(out["deepseek/rows_logits"], ref["deepseek/rows_logits"]) \
            < 1e-4


def test_sharded_train_step_matches_single_device(mesh_run):
    """Under ``layer_layout="sp"``: rows over the data and model axes."""
    ref, ranks = mesh_run
    _ok(ranks, "train")
    for out in ranks:
        assert str(out["train/split"]) == "('data', 'model')"
        assert abs(float(out["train/loss"]) - float(ref["train/loss"])) < 1e-4
        names = [k for k in ref if k.startswith("train/params/")]
        assert names and sorted(names) == sorted(
            k for k in out if k.startswith("train/params/"))
        for k in names:
            assert _err(out[k], ref[k]) < 1e-4, k


def test_decode_with_sharded_cache_matches_single_device(mesh_run):
    ref, ranks = mesh_run
    _ok(ranks, "decode")
    for out in ranks:
        assert _err(out["decode/prefill"], ref["decode/prefill"]) < 1e-4
        assert _err(out["decode/logits"], ref["decode/logits"]) < 1e-4


def test_tp_train_step_matches_single_device(mesh_run):
    """``"tp"``: the batch split over the data axis only, loss and every
    weight after the step within 1e-4 of the reference's jitted step."""
    ref, ranks = mesh_run
    _ok(ranks, "tp_train")
    for out in ranks:
        assert str(out["tp_train/split"]) == "('data',)"
        assert abs(float(out["tp_train/loss"]) - float(ref["train/loss"])) \
            < 1e-4
        names = [k for k in ref if k.startswith("train/params/")]
        for k in names:
            assert _err(out["tp_" + k], ref[k]) < 1e-4, k


def test_tp_deepseek_forward_matches_single_device(mesh_run):
    """``"tp"``: MLA on the rank's heads, the MoE layer routing the
    residual's sequence block, at 4 and 8 rows; within 1e-4."""
    ref, ranks = mesh_run
    _ok(ranks, "tp_deepseek")
    for out in ranks:
        assert _err(out["tp_deepseek/logits"],
                    ref["deepseek/tokens_logits"]) < 1e-4
        assert _err(out["tp_deepseek/rows_logits"],
                    ref["deepseek/rows_logits"]) < 1e-4


@pytest.mark.parametrize("arch", R.TP_DECODE_ARCHS)
def test_tp_prefill_and_decode_match_single_device(mesh_run, arch):
    """``"tp"``: the prefill's last logits and one decode step over the
    caches placed by ``cache_shardings`` within 1e-4; the next token
    picked over the vocabulary split by the model axis is the
    reference's argmax."""
    ref, ranks = mesh_run
    _ok(ranks, "tp_decode")
    pre = "decode" if arch == R.DECODE_ARCH else f"tp_decode/{arch}"
    b = R.DECODE_PROMPT[0] // R.MESH[0]
    for r, out in enumerate(ranks):
        got = f"tp_decode/{arch}"
        assert _err(out[f"{got}/prefill"], ref[f"{pre}/prefill"]) < 1e-4
        assert _err(out[f"{got}/logits"], ref[f"{pre}/logits"]) < 1e-4
        d = r // R.MESH[1]
        want = ref[f"{pre}/logits"].argmax(-1)[d * b:(d + 1) * b]
        assert np.array_equal(out[f"{got}/next"], want), r


def test_tp_shardmap_moe_gradients_match_single_device_grad(mesh_run):
    """``"tp"``: each rank routes its (batch block, sequence block) of
    tokens; its output and x gradient are those tokens' and the
    parameters' gradients the single-device ``jax.grad``'s, within
    1e-3."""
    ref, ranks = mesh_run
    _ok(ranks, "tp_moe")
    b, s = R.MOE_X[0] // R.MESH[0], R.MOE_X[1] // R.MESH[1]
    for r, out in enumerate(ranks):
        d, m = divmod(r, R.MESH[1])
        blk = (slice(d * b, (d + 1) * b), slice(m * s, (m + 1) * s))
        assert _err(out["tp_moe/y"], ref["moe/y"][blk]) < 1e-3, r
        assert _err(out["tp_moe/gx"], ref["moe/gx"][blk]) < 1e-3, r
        for name in ("router/w", "experts/w1", "experts/w3", "experts/w2"):
            got = out[f"tp_moe/g/{name.replace('/', '.')}"]
            assert _err(got, ref[f"moe/g/{name}"]) < 1e-3, (r, name)


def test_tp_einsum_dispatch_routes_the_global_batch(mesh_run):
    """``"tp"``: the einsum dispatch gathers the rank's (batch block,
    sequence block) to the global batch and keeps its block; within
    1e-4 of the reference's global routing at the dropping factor."""
    ref, ranks = mesh_run
    _ok(ranks, "tp_moe_einsum")
    b, s = R.MOE_DROP_X[0] // R.MESH[0], R.MOE_DROP_X[1] // R.MESH[1]
    for r, out in enumerate(ranks):
        d, m = divmod(r, R.MESH[1])
        want = ref["moe_einsum/y"][d * b:(d + 1) * b, m * s:(m + 1) * s]
        assert _err(out["tp_moe_einsum/y"], want) < 1e-4, r


def _ref_kept(p, xt, cfg):
    """The reference's kept set of the tokens xt (T, D), as its
    ``_einsum_moe`` computes it: the expert of each kept assignment,
    -1 for a dropped one, (T, k)."""
    E, k = cfg.num_experts, cfg.top_k
    ids, _, _ = jmoe._router(p, jnp.asarray(xt), cfg)
    T = xt.shape[0]
    cap = jmoe._capacity(T, k, E, cfg.capacity_factor)
    flat = ids.reshape(-1)
    _, perm = jmoe.kops.sort_tokens_by_key(flat, backend="xla")
    sid = flat[perm]
    hot = jax.nn.one_hot(sid, E, dtype=jnp.int32)
    pos_sorted = (jnp.cumsum(hot, axis=0) - hot)[jnp.arange(T * k), sid]
    pos = jnp.zeros(T * k, jnp.int32).at[perm].set(pos_sorted)
    return np.asarray(jnp.where(pos < cap, flat, -1)).reshape(T, k)


def test_tp_moe_kept_set_is_the_reference_partition(mesh_run):
    """At capacity factor 1.0, where assignments drop: on each rank the
    MoE block of one Arctic layer under ``"tp"`` routes the rank's
    (batch block, sequence block) of its input, the reference's
    ``shard_map`` partition (within 1e-4), and keeps bit for bit the
    experts the reference's routing keeps for those tokens.  Under
    ``"sp"`` the 8 rows split over all 8 ranks and each rank's tokens
    would be one whole row."""
    ref, ranks = mesh_run
    _ok(ranks, "tp_kept")
    cfg = _jcfg(R.MOE_ARCH, **R.KEPT_OV)
    router = {"router": {"w": jnp.asarray(ref["kept/router"])}}
    x = ref["kept/moe_in"]
    B, S = R.KEPT_TOKENS
    b, s = B // R.MESH[0], S // R.MESH[1]
    dropped = 0
    for r, out in enumerate(ranks):
        d, m = divmod(r, R.MESH[1])
        want = x[d * b:(d + 1) * b, m * s:(m + 1) * s].reshape(-1, x.shape[-1])
        assert _err(out["tp_kept/tokens"], want) < 1e-4, r
        kept = _ref_kept(router, out["tp_kept/tokens"], cfg)
        assert np.array_equal(out["tp_kept/kept"], kept), r
        dropped += int((kept == -1).sum())
    assert dropped > 0  # the factor drops


def test_tp_gathers_no_dense_weight_over_the_model_axis(mesh_run):
    """Under ``"tp"`` the train step, the forwards, prefill and decode
    all-gather no parameter over the model axis; FSDP's weights
    (TinyLlama restored with ``fsdp``) only over the data axis.  Under
    ``"sp"`` every dense weight is gathered over both."""
    _, ranks = mesh_run
    for out in ranks:
        for case in ("tp_train", "tp_deepseek", "reshard") + tuple(
                f"tp_decode/{a}" for a in R.TP_DECODE_ARCHS):
            assert f"{case}/weights/model" not in out, case
        assert int(out["reshard/weights/data"]) > 0
        for case in ("train", "deepseek", "decode"):
            assert int(out[f"{case}/weights/model"]) > 0, case


def test_reshard_restore_onto_mesh(mesh_run):
    ref, ranks = mesh_run
    _ok(ranks, "reshard")
    for out in ranks:
        assert _err(out["reshard/logits"], ref["reshard/logits"]) < 1e-5
    # saved again from the mesh (each array gathered to rank 0): the same
    assert float(ranks[0]["reshard/resaved_err"]) == 0.0


def test_failed_save_raises_on_every_rank(mesh_run):
    """Rank 0's write fails: every rank raises, none waits in a barrier,
    and the next collective pairs up on all eight."""
    _, ranks = mesh_run
    _ok(ranks, "save_fails")
    for r, out in enumerate(ranks):
        assert str(out["save_fails/raised"]) != "no", r
        assert float(out["save_fails/after"]) == R.WORLD, r
