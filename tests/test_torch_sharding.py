"""The port's sharding rules against the JAX reference's, in process.

For each of the ten architectures at its smoke size, on the meshes
(2, 4), (1, 8) and (2, 16, 16) as ``jax.sharding.AbstractMesh`` (no
devices) and the port's ``sharding.AbstractMesh``, with ``fsdp`` on and
off: every parameter's spec from ``repro_torch.distributed.sharding.
param_shardings`` equals the reference's ``param_shardings`` spec for
the same parameter (a stacked group's spec without its leading None),
and its DTensor placements are the spec's; likewise
``launch.steps.cache_shardings`` on each config's cache and
``batch_shardings`` on its batch; ``state_shardings`` gives each moment
its parameter's sharding; ``constrain`` is the identity without a mesh.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as jcb
from repro.distributed import sharding as jshd
from repro.launch import steps as jst
from repro.models import model as JM
from repro_torch.configs import base as tcb
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as st
from repro_torch.models import model as TM
from repro_torch.optim import adamw

ARCHS = jcb.list_configs()
MESHES = [((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_B, CACHE_S = 8, 64


def _mesh_id(m):
    return "x".join(map(str, m[0]))


def _ref_layers(cfg):
    """[(reference path prefix, stacked), ...] per port layer, in order
    (the pairing ``models.convert.params_from_jax`` makes)."""
    out = []
    for name, pattern, reps in JM._groups(cfg):
        for _ in range(reps or 1):
            for s in range(len(pattern)):
                out.append((f"{name}/s{s}", reps is not None))
    return out


def _ref_param_path(cfg, name):
    """(the reference's path of the port's parameter ``name``,
    stacked)."""
    parts = name.split(".")
    if parts[0] == "layers":
        prefix, stacked = _ref_layers(cfg)[int(parts[1])]
        return "/".join([prefix] + parts[2:]), stacked
    if parts[0] == "encoder":
        return "/".join(["enc_g/s0"] + parts[2:]), True
    return "/".join(parts), False


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _spec(named):
    """A reference NamedSharding's spec as a tuple."""
    return tuple(named.spec)


@functools.lru_cache(maxsize=None)
def _ref_param_shapes(arch):
    cfg = jcb.get_smoke_config(arch)
    return jax.eval_shape(functools.partial(JM.init_params, cfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return TM.init_params(tcb.get_smoke_config(arch),
                          torch.Generator().manual_seed(0))


def _with_meshes(shape, axes, fn):
    """fn() with the reference's and the port's abstract meshes set."""
    prev = jshd.get_mesh()
    jshd.set_mesh(JAbstractMesh(shape, axes))
    try:
        with shd.use_mesh(shd.AbstractMesh(shape, axes)):
            return fn()
    finally:
        jshd.set_mesh(prev)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, mesh, fsdp):
    cfg = jcb.get_smoke_config(arch)
    shapes = _ref_param_shapes(arch)
    model = _port_model(arch)

    def both():
        return (jshd.param_shardings(shapes, fsdp),
                shd.param_shardings(model, fsdp))
    ref, got = _with_meshes(*mesh, both)
    assert sorted(got) == sorted(n for n, _ in model.named_parameters())
    sharded = 0
    for name, sh in got.items():
        path, stacked = _ref_param_path(cfg, name)
        want = _spec(_leaf(ref, path))
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert sh.spec == want, (name, path, sh.spec, want)
        sharded += any(a is not None for a in sh.spec)
        for axis, plc in zip(mesh[1], sh.placements):
            dims = [d for d, a in enumerate(sh.spec) if a == axis]
            assert plc == (Shard(dims[0]) if dims else Replicate()), name
    assert sharded  # the rules place something on every mesh


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch, mesh):
    jcfg = jcb.get_smoke_config(arch)
    tcfg = tcb.get_smoke_config(arch)
    enc = jcfg.num_frontend_tokens
    ref_tree = JM.cache_shapes(jcfg, CACHE_B, CACHE_S, enc)
    port = TM.cache_shapes(tcfg, CACHE_B, CACHE_S, enc)

    def both():
        return jst.cache_shardings(ref_tree), st.cache_shardings(port)
    ref, got = _with_meshes(*mesh, both)
    layers = _ref_layers(jcfg)
    assert len(got) == len(layers)
    for i, (c, (prefix, stacked)) in enumerate(zip(got, layers)):
        assert sorted(c) == sorted(_leaf(ref, prefix)), i
        for name, sh in c.items():
            want = _spec(_leaf(ref, f"{prefix}/{name}"))
            if stacked:
                assert want[0] is None
                want = want[1:]
            assert sh.spec == want, (i, name, sh.spec, want)
            assert sh.placements == shd.placements(
                sh.spec, shd.AbstractMesh(*mesh))


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
def test_batch_shardings_match_reference(mesh):
    sds = jax.ShapeDtypeStruct
    ref_batch = {"tokens": sds((8, 32), jnp.int32),
                 "labels": sds((6, 32), jnp.int32),
                 "enc_inp": sds((32, 17, 64), jnp.float32), "none": None}
    port_batch = {k: None if v is None else torch.empty(v.shape)
                  for k, v in ref_batch.items()}

    def both():
        return jst.batch_shardings(ref_batch), st.batch_shardings(port_batch)
    ref, got = _with_meshes(*mesh, both)
    assert got["none"] is None and ref["none"] is None
    for k in ("tokens", "labels", "enc_inp"):
        assert got[k].spec == _spec(ref[k]), (k, got[k], ref[k])


def test_state_shardings_moments_take_their_parameter_sharding():
    cfg = tcb.get_smoke_config("deepseek_v2_236b")
    model = _port_model("deepseek_v2_236b")
    with shd.use_mesh(shd.AbstractMesh((2, 4), ("data", "model"))):
        sh = st.state_shardings(cfg, model)
        p_sh = shd.param_shardings(model, cfg.fsdp)
    assert sh["params"] == p_sh == sh["opt"]["m"] == sh["opt"]["v"]
    assert sh["opt"]["step"].spec == () and sh["opt"]["step"].placements == (
        Replicate(), Replicate())
    # experts over the model axis (expert parallelism)
    assert p_sh["layers.1.ffn.experts.w1"].spec == ("model", None, None)


def test_placements_split_a_dim_over_several_axes_in_mesh_order():
    mesh = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert shd.placements((None, None), mesh) == (Replicate(),) * 3


@pytest.mark.parametrize("batch, over_model, want", [
    (8, False, ("data",)), (8, True, ("data", "model")),
    (4, True, ("data",)), (3, True, None)])
def test_batch_rows_split_over_the_model_axis_when_they_divide(
        batch, over_model, want):
    """Under ``layer_layout="sp"``, without a cache the local program
    splits rows over the model axis too when they divide by every rank
    (``over_model``); the batch rule of ``batch_shardings`` does not,
    nor does ``"tp"``, whose model axis splits the sequence."""
    with shd.use_mesh(shd.AbstractMesh((2, 4), ("data", "model"))):
        assert shd._batch_spec((batch, 16), over_model) == (want, None)


def test_no_mesh_is_the_identity():
    assert shd.get_mesh() is None
    x = torch.randn(4, 6, 8)
    assert shd.constrain(x, "data", "model", None) is x
    assert shd.local_batch(x) is x and shd.from_local_batch(x, 4) is x
    assert shd.local_view(x) is x
    assert shd.world_size() == 1 and shd.batch_axes() == ()
    assert shd.model_axis_size() == 1 and shd.data_axis_size() == 1
    # the moments of a plain tensor are plain zeros of its shape
    st0 = adamw.init_state(adamw.AdamWConfig(), {"w": x})
    assert type(st0["m"]["w"]) is torch.Tensor
    assert torch.equal(st0["m"]["w"], torch.zeros_like(x))


def test_constrain_redistributes_a_dtensor_on_a_mesh():
    """On a real mesh (the one-process gloo group the trainer makes on the
    CPU): a DTensor moves to the spec, an axis that does not divide its
    dim is dropped, a plain block stays as it is; ``local_batch`` takes
    the rank's block of a global tensor or of a DTensor."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    with shd.use_mesh(mesh):
        x = torch.arange(24.0).reshape(4, 6)
        d = shd.distribute(x, shd.placements((None, None)))
        moved = shd.constrain(d, "data", "model")
        assert tuple(moved.placements) == (Shard(0), Shard(1))
        assert torch.equal(moved.full_tensor(), x)
        assert shd.constrain(moved, "data", "model") is moved
        odd = shd.distribute(torch.ones(3, 5), shd.placements((None, None)))
        assert tuple(shd.constrain(odd, "data", "model").placements) == (
            Shard(0), Shard(1))  # every axis divides on a (1, 1) mesh
        assert shd.constrain(x, "data", "model") is x
        assert torch.equal(shd.local_batch(x), x)
        assert torch.equal(shd.local_batch(moved), x) and shd.batch_split()
        back = shd.from_local_batch(x, 4)
        assert tuple(back.placements) == (Shard(0), Replicate())


@pytest.mark.parametrize("layout, seq, want", [
    ("tp", 16, 4), ("tp", 18, 18), ("tp", 1, 1), ("sp", 16, 16)])
def test_tp_residual_holds_a_sequence_block(layout, seq, want):
    """Under ``"tp"`` the residual holds seq / n_model positions when the
    sequence divides the model axis (the reference's ``_seq_shard``),
    else all of them; the weights stay split over the model axis.
    Without a mesh either layout is the one-device program."""
    cfg = dataclasses.replace(tcb.get_smoke_config("tinyllama_1_1b"),
                              layer_layout=layout)
    with shd.use_mesh(shd.AbstractMesh((2, 4), ("data", "model"))):
        assert shd.tp(cfg) == (layout == "tp")
        assert shd.residual_len(seq, cfg) == want
        assert shd.weight_keep(cfg) == (("model",) if layout == "tp"
                                        else ())
        assert shd.block_offset(8, 8) == 0  # a whole dim starts at 0
    assert not shd.tp(cfg) and shd.residual_len(seq, cfg) == seq
    with pytest.raises(ValueError):
        shd.tp(dataclasses.replace(cfg, layer_layout="pp"))
