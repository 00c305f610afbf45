"""The port's dry run and item 11's leftovers against the JAX reference,
on the CPU.

The dry run (``repro_torch.launch.dryrun``): ``configs.base``'s
``SHAPES``, ``ARCH_IDS``, ``FULL_ATTENTION_ARCHS``, ``cells()`` and
``list_configs()`` equal the reference's; ``param_count``,
``active_param_count`` and ``model_flops_for`` equal on every cell;
every leaf of ``launch.steps.train_state_shapes`` and ``input_specs`` has
the reference's shape and dtype (its stacked groups cut per layer, as
``models.convert`` maps them); the argument bytes per card that the dry
run places on the (16, 16) and (2, 16, 16) meshes (a ``fake`` process
group in a process of its own) equal those of the reference's parameter,
cache and batch specs at the same axis sizes, each per-layer tensor
rounded to the allocator's 512 bytes; ``lower_cell`` on a smoke config
at mesh (1, 1) counts the FLOPs and argument bytes of a real CPU step,
and on TinyLlama-1.1B's ``train_4k`` at 16 x 16 gives a complete record;
K6 and K7 on ``meta`` tensors return what their plain versions return
and add their card FLOPs.

Item 11: the ``ref`` kernel tier's ``spz`` equals the reference's ``ref``
tier bit for bit (CSR and the six counters) on three stand-ins and is
never swept by autotune; ``serving.sampler.zipper_topk`` equals the
reference's ids and values; ``core.spgemm.spgemm(method=)`` warns and
equals ``dispatch.spgemm(engine=)``.

The reference's ``model_flops_for`` (its module sets ``XLA_FLAGS`` when
imported), ``spz`` on the ``ref`` tier and ``zipper_topk`` run once per
session in one process, and the port's placements on the production
meshes in another; each is shared by the xdist workers through a lock.
"""
import dataclasses
import fcntl
import functools
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jcb
from repro.distributed import sharding as jshd
from repro.launch import steps as jst
from repro.optim import adamw as jadamw
from repro_torch.configs import base as tcb
from repro_torch.core import dispatch as dp
from repro_torch.core import spgemm_engines as tsg
from repro_torch.core.formats import csr_to_numpy, random_sparse
from repro_torch.data import table3
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import backend as kb
from repro_torch.kernels import flash_attention as k6
from repro_torch.kernels import grouped_matmul as k7
from repro_torch.launch import dryrun as dr
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.serving.sampler import zipper_topk

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = jcb.cells()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
REF_SPZ = ("m133-b3", "patents", "usroads")   # the lightest stand-ins
COUNTERS = ("n_mssort", "sort_elems", "n_mszip", "zip_elems", "chunk_loads",
            "chunk_stores")
TOPK_CASES = [(4, 8), (4, 40), (16, 8), (16, 40)]
TOPK_VOCAB = 4096

_REFERENCE_CHILD = """
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)
from repro.configs import base as cb
from repro.core.formats import CSR, csr_to_numpy
from repro.core.spgemm import spgemm_spz
from repro.serving.sampler import zipper_topk

out = {"spz": {}, "topk": {}}
z = np.load(sys.argv[1])
for name in %(spz)r:
    A = CSR(jnp.asarray(z[name + "/indptr"]), jnp.asarray(z[name + "/indices"]),
            jnp.asarray(z[name + "/data"]),
            tuple(int(x) for x in z[name + "/shape"]))
    C, stt = spgemm_spz(A, A, backend="ref", driver="fused")
    arrays = csr_to_numpy(C)
    np.savez(sys.argv[2] + "/spz_" + name + ".npz", indptr=arrays[0],
             indices=arrays[1], data=arrays[2])
    out["spz"][name] = [int(getattr(stt, c)) for c in %(counters)r]
for n_sh, k in %(topk)r:
    row = np.random.default_rng(n_sh * 100 + k).standard_normal(
        %(vocab)d).astype(np.float32)
    vals, ids = zipper_topk(np.split(row, n_sh), k)
    out["topk"][f"{n_sh},{k}"] = [np.asarray(vals).tolist(),
                                  np.asarray(ids).tolist()]
# last: importing the dry run sets XLA_FLAGS, too late to touch this
# process's backend
from repro.launch import dryrun
out["model_flops"] = {f"{a}|{s}": dryrun.model_flops_for(
    cb.get_config(a), cb.SHAPES[s]) for a, s in cb.cells()}
json.dump(out, open(sys.argv[2] + "/out.json", "w"))
""" % dict(spz=REF_SPZ, counters=COUNTERS, topk=TOPK_CASES,
           vocab=TOPK_VOCAB)

_PORT_CHILD = """
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import base as cb
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh

out = {}
for mp, name in ((False, "16x16"), (True, "2x16x16")):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if mp else 256)
    with shd.use_mesh(make_production_mesh(multi_pod=mp, device="cpu")):
        for arch, shape in cb.cells():
            _, _, tensors = dr.step_inputs(cb.get_config(arch),
                                           cb.SHAPES[shape])
            out[f"{arch}|{shape}|{name}"] = dr.storage_bytes(tensors)
    dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


def _shared(tmp_path_factory, name, make):
    """``make(out_dir)`` once per session (the xdist workers share the
    session's temporary root; the first to take the lock runs it), then
    its JSON output."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out_dir = root / name
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = out_dir / "done.json"
        if not done.exists():
            make(out_dir)
            os.replace(out_dir / "out.json", done)
    with open(done) as f:
        return json.load(f), out_dir


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="session")
def reference(tmp_path_factory):
    def make(out_dir):
        arrays = {}
        for name in REF_SPZ:
            ip, ix, d = csr_to_numpy(table3.build(name))
            arrays.update({f"{name}/indptr": ip, f"{name}/indices": ix,
                           f"{name}/data": d, f"{name}/shape": np.array(
                               table3.build(name).shape)})
        np.savez(out_dir / "ops.npz", **arrays)
        subprocess.run([sys.executable, "-c", _REFERENCE_CHILD,
                        str(out_dir / "ops.npz"), str(out_dir)],
                       env=_env(), check=True, timeout=600)
    return _shared(tmp_path_factory, "dryrun-reference", make)


@pytest.fixture(scope="session")
def port_arg_bytes(tmp_path_factory):
    def make(out_dir):
        subprocess.run([sys.executable, "-c", _PORT_CHILD,
                        str(out_dir / "out.json")],
                       env=_env(), check=True, timeout=600)
    return _shared(tmp_path_factory, "dryrun-port-args", make)[0]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_shapes_archs_and_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tcb.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcb.SHAPES.items()}
    assert tcb.ARCH_IDS == jcb.ARCH_IDS
    assert tcb.list_configs() == jcb.list_configs()
    assert tcb.FULL_ATTENTION_ARCHS == jcb.FULL_ATTENTION_ARCHS
    assert tcb.cells() == jcb.cells() and len(tcb.cells()) == 32


@pytest.mark.parametrize("arch, shape", CELLS)
def test_param_counts_and_model_flops_match_reference(arch, shape,
                                                      reference):
    t, j = tcb.get_config(arch), jcb.get_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert dr.model_flops_for(t, tcb.SHAPES[shape]) == \
        reference[0]["model_flops"][f"{arch}|{shape}"]


# ---------------------------------------------------------------------------
# train_state_shapes, input_specs
# ---------------------------------------------------------------------------

def _desc(leaf):
    """(shape, dtype name) of a tensor or a ShapeDtypeStruct."""
    return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")


def _cut(leaf, i):
    """A stacked ShapeDtypeStruct's per-layer (shape, dtype)."""
    return jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    cfg = jcb.get_config(arch)
    return jst.train_state_shapes(
        cfg, jadamw.AdamWConfig(state_dtype=cfg.opt_state_dtype))


def _ref_tree_by_port_name(tree, cfg):
    return {k: _desc(v) for k, v in
            convert.port_state(tree, cfg, index=_cut).items()}


@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_train_state_shapes_and_input_specs_match_reference(arch):
    jcfg, tcfg = jcb.get_config(arch), tcb.get_config(arch)
    ref = _ref_state(arch)
    got = st.train_state_shapes(
        tcfg, adamw.AdamWConfig(state_dtype=tcfg.opt_state_dtype))
    params = dict(got["params"].named_parameters())
    assert all(p.is_meta for p in params.values())
    assert {k: _desc(v) for k, v in params.items()} == \
        _ref_tree_by_port_name(ref["params"], jcfg)
    for n in ("m", "v"):
        assert {k: _desc(v) for k, v in got["opt"][n].items()} == \
            _ref_tree_by_port_name(ref["opt"][n], jcfg)
    assert _desc(got["opt"]["step"]) == _desc(ref["opt"]["step"])
    for name, shape in jcb.SHAPES.items():
        want = jst.input_specs(jcfg, shape)
        spec = st.input_specs(tcfg, tcb.SHAPES[name])
        for key, leaf in want.items():
            if key == "cache":
                layers = convert.per_layer(leaf, jcfg, _cut)
                assert sum(map(len, spec["cache"])) == len(layers)
                for i, k, sds in layers:
                    assert _desc(spec["cache"][i][k]) == _desc(sds), (i, k)
                    assert spec["cache"][i][k].is_meta
            elif key == "cache_len":
                assert spec["cache_len"] == shape.seq_len - 1
            elif leaf is None:
                assert spec[key] is None
            else:
                assert _desc(spec[key]) == _desc(leaf) and spec[key].is_meta
        assert sorted(spec) == sorted(want)


# ---------------------------------------------------------------------------
# argument bytes per card on the production meshes
# ---------------------------------------------------------------------------

def _block_bytes(shape, spec, dtype, sizes):
    """Bytes of the local block of a tensor of ``shape`` placed by
    ``spec`` on axes of ``sizes``, rounded to the allocator's block."""
    n = 1
    for d, a in zip(shape, tuple(spec) + (None,) * len(shape)):
        names = () if a is None else (a,) if isinstance(a, str) else a
        n *= d // math.prod(sizes[x] for x in names)
    return dr._block(n * jnp.dtype(dtype).itemsize)


def _ref_arg_bytes(arch, shape_name, mesh):
    """The reference's per-card argument bytes of a cell, from its
    parameter, cache and batch specs on an abstract mesh of the same axis
    sizes, each stacked leaf cut into per-layer tensors."""
    cfg = jcb.get_config(arch)
    shape = jcb.SHAPES[shape_name]
    sizes = dict(zip(mesh[1], mesh[0]))
    prev = jshd.get_mesh()
    jshd.set_mesh(JAbstractMesh(*mesh))
    try:
        state = _ref_state(arch)
        p_sh = jshd.param_shardings(state["params"], cfg.fsdp)
        specs = jst.input_specs(cfg, shape)
        total = 0

        def add(leaves, shardings, copies=1, dtype=None):
            nonlocal total
            for (path, sds), sh in zip(
                    jax.tree_util.tree_flatten_with_path(leaves)[0],
                    jax.tree_util.tree_leaves(shardings)):
                spec = tuple(sh.spec)
                # a scanned unit's leaves lead with the repeat dim
                stacked = re.fullmatch(r"g\d+|enc_g",
                                       str(getattr(path[0], "key", "")))
                assert not stacked or spec[0] is None
                reps = sds.shape[0] if stacked else 1
                shp = sds.shape[1:] if stacked else sds.shape
                spc = spec[1:] if stacked else spec
                total += copies * reps * _block_bytes(
                    shp, spc, dtype or sds.dtype, sizes)

        add(state["params"], p_sh)
        if shape.kind == "train":
            add(state["params"], p_sh, copies=2, dtype=cfg.opt_state_dtype)
            total += dr._block(4)  # the step
            add(specs, jst.batch_shardings(specs))
        else:
            add(specs["cache"], jst.cache_shardings(specs["cache"]))
            key = "tokens" if shape.kind == "prefill" else "token"
            ins = {key: specs[key]}
            if specs.get("enc_inp") is not None:
                ins["enc_inp"] = specs["enc_inp"]
            add(ins, jst.batch_shardings(ins))
        return total
    finally:
        jshd.set_mesh(prev)


@pytest.mark.parametrize("arch, shape", CELLS)
def test_argument_bytes_match_reference_specs(arch, shape, port_arg_bytes):
    for name, mesh in MESHES.items():
        assert port_arg_bytes[f"{arch}|{shape}|{name}"] == \
            _ref_arg_bytes(arch, shape, mesh), name


# ---------------------------------------------------------------------------
# lower_cell
# ---------------------------------------------------------------------------

def test_lower_cell_smoke_counts_a_real_cpu_step():
    """The dry run on mesh (1, 1) against the same step run on the CPU
    from weights and tokens: FLOPs (``FlopCounterMode``) and argument
    bytes equal."""
    cfg = dataclasses.replace(tcb.get_smoke_config("tinyllama_1_1b"),
                              remat="block")
    shape = tcb.ShapeConfig("smoke_train", 32, 4, "train")
    rec = dr.lower_cell("tinyllama_1_1b", shape, cfg_override=cfg,
                        mesh_shape=(1, 1), verbose=False)
    mesh = make_host_mesh(model_axis=1, device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    with shd.use_mesh(mesh):
        step, args, tensors = dr.step_inputs(
            cfg, shape, torch.Generator().manual_seed(0))
        arg_bytes = dr.storage_bytes(tensors)
        with FlopCounterMode(display=False) as fc:
            _, met = step(*args)
    assert math.isfinite(float(met["loss"]))
    assert rec["cost"]["flops_per_device"] == fc.get_total_flops() > 0
    assert rec["memory"]["argument_bytes_per_device"] == arg_bytes
    assert rec["mesh"] == "1x1" and rec["n_chips"] == 1
    assert rec["collectives"]["total_bytes"] == 0  # one rank sends nothing


def test_lower_cell_tinyllama_train_4k_record_is_complete():
    rec = dr.lower_cell("tinyllama_1_1b", "train_4k", verbose=False)
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    mem, cost, coll, rl = (rec[k] for k in ("memory", "cost", "collectives",
                                            "roofline"))
    assert 0 < mem["argument_bytes_per_device"] < \
        mem["peak_bytes_per_device"]
    assert mem["temp_bytes_per_device"] == \
        mem["peak_bytes_per_device"] - mem["argument_bytes_per_device"]
    assert mem["output_bytes_per_device"] > 0
    assert cost["flops_per_device"] > 0 and cost["bytes_per_device"] > 0
    assert coll["counts"]["all_gather"] and coll["counts"]["all_reduce"]
    # "tp": the sequence all-gathered and reduce-scattered around each
    # sublayer, no weight all-gathered over the model axis
    assert coll["counts"]["reduce_scatter"]
    assert "model" not in coll["weight_bytes_by_axis"]
    assert coll["total_bytes"] == sum(coll["bytes"].values()) == \
        sum(coll["bytes_by_axis"].values()) > 0
    assert rl["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rl["collective_s"] == sum(
        b / dr.NIC_BW for b in coll["bytes_by_axis"].values())
    assert rec["params"] == tcb.get_config("tinyllama_1_1b").param_count()
    assert rec["fits"] == (mem["peak_bytes_per_device"] <= dr.HBM_BYTES)


def test_link_rate_follows_the_host_layout():
    # (16, 16): the model axis's 16 consecutive ranks span two hosts of 8
    assert dr.link_rate((16, 16), ("data", "model"), "model") == dr.NIC_BW
    assert dr.link_rate((16, 16), ("data", "model"), "data") == dr.NIC_BW
    assert dr.link_rate((2, 8), ("data", "model"), "model") == dr.NVLINK_BW
    assert dr.link_rate((4, 2), ("data", "model"), "data,model") == \
        dr.NVLINK_BW
    assert dr.link_rate((4, 4), ("data", "model"), "data") == dr.NIC_BW


# ---------------------------------------------------------------------------
# the shape-only kernel paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, causal, window", [
    (torch.bfloat16, True, 0), (torch.float32, True, 48),
    (torch.bfloat16, False, 0)])
def test_k6_on_meta_returns_the_plain_output_and_counts_card_flops(
        dtype, causal, window):
    B, Sq, Skv, H, KVH, hd = 2, 200, 200, 4, 2, 20
    cpu = [torch.randn(B, S, h, hd, dtype=dtype)
           for S, h in ((Sq, H), (Skv, KVH), (Skv, KVH))]
    want = k6.flash_attention_plain(*cpu, causal=causal, window=window)
    k6.flash_attention.traced_flops = k6.flash_attention.traced_calls = 0
    launches = k6.flash_attention.launches
    with torch.no_grad():
        got = k6.flash_attention(*(t.to("meta") for t in cpu),
                                 causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_meta and k6.flash_attention.launches == launches
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert k6.flash_attention.traced_calls == 1
    assert k6.flash_attention.traced_flops == k6.card_flops(
        B, Sq, Skv, H, 24, causal=causal, window=window, route=route)


def test_k6_card_flops_counts_the_visited_tiles():
    # wgmma at hd 64: 128-row query tiles, 128-key tiles; causal S = 256
    # visits 1 + 2 tiles, each QK^T plus three PV parts at 2 x 128 x 128 x 64
    per_tile = 2 * 128 * 128 * 64 * 4
    assert k6.card_flops(1, 256, 256, 1, 64, causal=True, window=0,
                         route="wgmma") == 3 * per_tile
    assert k6.card_flops(1, 256, 256, 1, 64, causal=False, window=0,
                         route="wgmma") == 4 * per_tile
    # fma at hd 20 (head dim 32), 64 x 64 tiles, window 64 over S = 256:
    # each query tile sees its own key tile and the one before
    fma_tile = 2 * 64 * 64 * 32 * 2
    assert k6.card_flops(2, 256, 256, 3, 20, causal=True, window=64,
                         route="fma") == 2 * 3 * (1 + 2 * 3) * fma_tile


@pytest.mark.parametrize("cap", [None, 8])
def test_k7_on_meta_returns_the_plain_output_and_counts_card_flops(cap):
    E, D, F = 4, 16, 24
    T = 20 if cap is None else E * cap
    x, w = torch.randn(T, D), torch.randn(E, D, F)
    sizes = torch.tensor([5, 0, 8, 3], dtype=torch.int32)
    want = k7.grouped_matmul_plain(x, w, sizes, cap=cap)
    k7.grouped_matmul.traced_flops = k7.grouped_matmul.traced_calls = 0
    launches = k7.grouped_matmul.launches
    with torch.no_grad():
        got = k7.grouped_matmul(x.to("meta"), w.to("meta"),
                                sizes.to("meta"), cap=cap)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_meta and k7.grouped_matmul.launches == launches
    assert k7.grouped_matmul.traced_calls == 1
    assert k7.grouped_matmul.traced_flops == 2 * T * D * F
    # under autograd (counts layout) the backward's dx is one more
    xm = x.to("meta").requires_grad_()
    y = k7.grouped_matmul(xm, w.to("meta"), sizes.to("meta"), cap=T // E)
    y.sum().backward()
    assert k7.grouped_matmul.traced_calls == 3
    assert xm.grad.shape == x.shape and xm.grad.is_meta


# ---------------------------------------------------------------------------
# item 11: the ref tier, zipper_topk, the spgemm(method=) alias
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", REF_SPZ)
def test_ref_tier_spz_matches_reference_ref_tier(name, reference):
    want, out_dir = reference
    A = table3.build(name)
    out, stats = tsg.spgemm_spz(A, A, backend="ref", device="cpu")
    with np.load(out_dir / f"spz_{name}.npz") as z:
        for w, g in zip((z["indptr"], z["indices"], z["data"]),
                        csr_to_numpy(out)):
            np.testing.assert_array_equal(w, g)
            if g.dtype.kind == "f":
                np.testing.assert_array_equal(w.view(np.int32),
                                              g.view(np.int32))
    assert [getattr(stats, c) for c in COUNTERS] == want["spz"][name]


def test_ref_tier_is_never_swept(tmp_path):
    bk = kb.get_backend("ref")
    assert not bk.on_device and not bk.measure and bk.device_type is None
    assert "ref" not in [b.name for b in kb.measurable_backends("cpu")]
    assert kb.resolve_backend("ref", "cpu") is bk
    A = random_sparse(64, 64, 0.05, seed=3)
    cache = dp.AutotuneCache(str(tmp_path / "cache.json"))
    p = dp.plan(A, A, autotune=True, cache=cache, device="cpu", model=False)
    timings = cache.get(p.cache_key)["timings"]
    assert p.source == "autotune" and timings
    assert not any(c.endswith("|ref") for c in timings)


@pytest.mark.parametrize("n_shards, k", TOPK_CASES)
def test_zipper_topk_matches_reference(n_shards, k, reference):
    want_vals, want_ids = reference[0]["topk"][f"{n_shards},{k}"]
    row = np.random.default_rng(n_shards * 100 + k).standard_normal(
        TOPK_VOCAB).astype(np.float32)
    for shards in (np.split(row, n_shards),
                   list(torch.from_numpy(row).chunk(n_shards))):
        vals, ids = zipper_topk(shards, k, device="cpu")
        assert ids.tolist() == want_ids
        assert vals.numpy().tolist() == want_vals
        assert set(ids.tolist()) == set(
            torch.topk(torch.from_numpy(row), k).indices.tolist())


def test_spgemm_method_alias_warns_and_delegates():
    A = random_sparse(48, 48, 0.08, seed=1)
    for method in ("spz", "esc"):
        with pytest.warns(DeprecationWarning, match="deprecated"):
            got = tsg.spgemm(A, A, method=method, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            want = dp.spgemm(A, A, engine=method, device="cpu")
        for a, b in zip(csr_to_numpy(got), csr_to_numpy(want)):
            np.testing.assert_array_equal(a, b)
