"""Sharding rules: logical parameter/activation axes -> mesh axes.

Port of ``repro.distributed.sharding``.  Mesh axes (``launch/mesh.py``):

  pod    data-parallel across pods (multi-pod mesh only)
  data   data-parallel / FSDP (ZeRO) within a pod
  model  tensor/expert parallel

Parameters: TP dims -> model; when ``cfg.fsdp`` the non-TP dim also
shards over data.  A spec is the reference's ``PartitionSpec`` as a
tuple (one entry per tensor dim: a mesh axis, a tuple of them, or None);
:func:`placements` turns it into DTensor placements, one per mesh dim.

The mesh is a ``torch.distributed`` ``DeviceMesh`` (one process per
device; ``launch/mesh.py`` builds it), or an :class:`AbstractMesh`
(axis names and sizes only) when only the rules are wanted.  With no
mesh set every function here is the identity or returns the one-device
answer, so single-device code runs unchanged.

How the port runs on a mesh (the counterpart of GSPMD plus
``shard_map``): each process runs the model as one explicit SPMD
program, in the layout ``cfg.layer_layout`` names (:func:`tp`).

- Parameters are DTensors placed by the rules (:func:`shard_model`).
  A layer reads its weights through :func:`gathered`, which swaps each
  DTensor for a plain tensor (:func:`local_view`) for the block's
  length: under ``"tp"`` the rank's model shard, all-gathered over the
  data axis when ``cfg.fsdp`` puts it there; under ``"sp"`` the whole
  weight, all-gathered over every axis (ZeRO-3 style).  The MoE block
  reads its experts itself, the model axis kept local (expert
  parallelism).  The backward of either sums each weight's gradient
  over every rank that used the same values and keeps the rank's
  shard.
- ``"tp"`` is the reference's default, Megatron tensor parallelism with
  a sequence-parallel residual.  The batch is split over the batch axes
  only (the rule of ``batch_shardings``); the residual stream holds the
  rank's block of the sequence over the model axis when the sequence
  divides (else all of it, as the reference's constraint drops the
  axis).  Each mixer and MLP all-gathers its input's sequence
  (:func:`seq_gather`), runs the rank's heads, hidden units or
  channels on the rank's weight shards (column-parallel in,
  row-parallel out) and reduce-scatters its partial sums back onto the
  rank's sequence block (:func:`seq_scatter`): the all-gather and the
  reduce-scatter are each other's backward.  A weight whose dim does
  not divide the model axis is whole on every rank, and so is its
  output (taken, not reduced).  The embedding and the head are split
  by vocabulary (a masked lookup, a vocab-parallel loss).
- ``"sp"`` is the port's earlier layout (the counterpart of the
  reference's ``"sp"``): whole weights, and without a cache (training,
  a plain forward) the batch dim split over the batch axes and the
  model axis together when it divides by all of them, so every rank
  computes different rows; with a cache the batch is split over the
  batch axes and replicated over the model axis.  The reference splits
  the sequence there, not the rows.
- :func:`local_batch` takes the block from a global tensor or a DTensor
  at the model's entry and records the axes it was split over
  (:func:`batch_split`); :func:`from_local_batch` wraps an output back
  into a DTensor.  :func:`constrain` redistributes a DTensor (a cache)
  and returns a plain block unchanged.
- Caches are DTensors placed by ``launch.steps.cache_shardings`` (the
  sequence dim over the model axis; a recurrent state's width);
  attention reads and writes them in their local form
  (``models/attention.py``).
- A rank's loss is the global loss, replicated (its sums all-reduced
  over the batch axes); the step backpropagates loss / world size from
  every rank, and the autograd-aware collectives here sum gradients
  over ranks in their backward, so each parameter's gradient is the
  single-device one.

Collectives are counted by kind (:func:`collective_counts`), with the
bytes each moves on the rank by kind and by mesh axis, and the
parameters' all-gathers by mesh axis apart (:func:`collective_bytes`),
which the dry run reads in place of the reference's parse of the
compiled HLO.
"""
from __future__ import annotations

import contextlib
import re
from typing import NamedTuple

import torch
import torch.distributed as dist

_MESH = None
_COUNTS: dict = {}
_BYTES: dict = {}       # kind -> bytes on this rank
_AXIS_BYTES: dict = {}  # mesh axis (or "a,b" for several) -> bytes
_WEIGHT_BYTES: dict = {}  # mesh axis -> bytes of parameters all-gathered
_SPLIT = ()  # the mesh axes the last batch taken by local_batch split over


class AbstractMesh:
    """The names and sizes of a mesh's axes, with no devices or process
    group: enough for the rules (specs and placements)."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} vs axis names {axis_names}")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axis_names)

    def __repr__(self):
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def axis_sizes(mesh=None) -> dict:
    """{axis name: size} of ``mesh`` (default: the current one)."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes():
    """Mesh axes the global batch shards over (('pod','data') or ('data',))."""
    if _MESH is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in _MESH.mesh_dim_names)


def data_axis_size() -> int:
    s = 1
    for a in batch_axes():
        s *= axis_sizes()[a]
    return s


def model_axis_size() -> int:
    return axis_sizes().get("model", 1)


def model_rank() -> int:
    """This rank's coordinate on the model axis (0 without one)."""
    return _coord("model") if "model" in axis_sizes() else 0


def tp(cfg) -> bool:
    """Whether ``cfg`` runs the ``"tp"`` layout on the current mesh (see
    the module docstring); False without a mesh."""
    if cfg.layer_layout not in ("tp", "sp"):
        raise ValueError(f"layer_layout {cfg.layer_layout!r}")
    return _MESH is not None and cfg.layer_layout == "tp"


def weight_keep(cfg) -> tuple:
    """The mesh axes a layer's weights stay split over when it reads
    them (:func:`gathered`): the model axis under ``"tp"``."""
    return ("model",) if tp(cfg) and "model" in axis_sizes() else ()


def block_offset(local: int, full: int) -> int:
    """Where this rank's block of a dim of ``full`` entries starts, its
    ``local`` entries being the model axis's even split of it (or all of
    them, at 0)."""
    return model_rank() * local if local < full else 0


def _axis_size(a) -> int:
    sizes = axis_sizes()
    s = 1
    for name in ([a] if isinstance(a, str) else a):
        s *= sizes.get(name, 1)
    return s


def _clean(shape, spec) -> tuple:
    """``spec`` padded to ``shape``'s rank, each axis that does not divide
    its dim dropped (the reference's ``constrain`` rule)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(a if a is None or shape[i] % _axis_size(a) == 0 else None
                 for i, a in enumerate(spec))


class Sharding(NamedTuple):
    """A tensor's place on the mesh: the reference's spec as a tuple, and
    the DTensor placements it gives (one per mesh dim)."""
    spec: tuple
    placements: tuple


def placements(spec, mesh=None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (default: the current
    one): ``Shard(d)`` on each mesh dim that dim ``d`` names, else
    ``Replicate()``.  A dim that names several axes is split by them in
    mesh order, as DTensor splits it."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = mesh if mesh is not None else _MESH
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a is not None and
                name in ((a,) if isinstance(a, str) else a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def sharding(spec) -> Sharding:
    """The Sharding of ``spec``; a one-axis tuple entry is written as the
    axis (as ``PartitionSpec`` writes it)."""
    spec = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)
    return Sharding(spec, placements(spec))


def constrain(x, *spec):
    """The reference's ``with_sharding_constraint``: the identity without
    a mesh, and for a plain tensor (a rank's block of the local program,
    see the module docstring); a DTensor is redistributed to ``spec``
    with every axis that does not divide its dim dropped (e.g. batch-1
    decode shapes leave the data axes idle)."""
    from torch.distributed.tensor import DTensor

    if _MESH is None or not isinstance(x, DTensor):
        return x
    want = placements(_clean(x.shape, spec))
    if tuple(x.placements) == want:
        return x
    out = x.redistribute(_MESH, want)
    _count("redistribute", _nbytes(out.to_local()), ",".join(
        _MESH.mesh_dim_names), world_size())
    return out


# ---------------------------------------------------------------------------
# parameter partitioning rules
# ---------------------------------------------------------------------------

# (path regex, spec builder). ``f`` is the FSDP axis ('data' or None).
# The patterns match path ends, which the port's parameter names (dots
# read as slashes) share with the reference's tree paths.
_RULES = [
    (r"embed/w$",        lambda f: ("model", f)),            # (V, D)
    (r"lm_head/w$",      lambda f: (f, "model")),            # (D, V)
    (r"(wq|wk|wv)/w$",   lambda f: (f, "model", None)),      # (D, H, hd)
    (r"(wq|wk|wv)/b$",   lambda f: ("model", None)),         # (H, hd)
    (r"wo/w$",           lambda f: ("model", None, f)),      # (H, hd, D)
    (r"(w1|w3)/w$",      lambda f: (f, "model")),            # (D, F)
    (r"w2/w$",           lambda f: ("model", f)),            # (F, D)
    (r"experts/(w1|w3)$", lambda f: ("model", f, None)),     # (E, D, F)
    (r"experts/w2$",     lambda f: ("model", None, f)),      # (E, F, D)
    (r"router/w$",       lambda f: (f, None)),               # (D, E)
    # MLA
    (r"w_dq/w$",         lambda f: (f, None)),               # (D, q_lora)
    (r"w_dkv/w$",        lambda f: (f, None)),               # (D, r+rope)
    (r"w_uq/w$",         lambda f: (None, "model", None)),   # (q_lora, H, d)
    (r"(w_uk|w_uv)/w$",  lambda f: (None, "model", None)),   # (r, H, d)
    # SSM / RG-LRU
    (r"in_proj/w$",      lambda f: (f, "model")),            # (D, inner)
    (r"out_proj/w$",     lambda f: ("model", f)),            # (inner, D)
    (r"conv/w$",         lambda f: (None, "model")),         # (k, inner)
    (r"(a_param|dt_bias|d_skip)$", lambda f: ("model",)),    # per head/channel
    (r"(a_gate|x_gate)/w$", lambda f: (f, "model")),
    # norms, scalars, everything 1-D: replicate
]


def param_spec(path: str, shape, fsdp: bool) -> tuple:
    """The spec of the parameter at ``path`` (``/`` or ``.`` separated)
    of ``shape`` on the current mesh."""
    path = path.replace(".", "/")
    f = "data" if fsdp else None
    sizes = axis_sizes()
    if _MESH is not None and "data" not in sizes:
        f = None
    for pat, fn in _RULES:
        if re.search(pat, path):
            spec = fn(f)
            spec = spec + (None,) * (len(shape) - len(spec))
            # drop axes that would overshard tiny dims
            return tuple(
                (a if a is None or (_MESH is not None and
                                    shape[i] % sizes[a] == 0) else None)
                for i, a in enumerate(spec))
    return (None,) * len(shape)


def param_shardings(params, fsdp: bool) -> dict:
    """{name: Sharding} for a module's parameters, or for a dict of
    name -> shape (or tensor).  The port stores each layer's parameters
    apart (``layers.{i}.…``), where the reference stacks a group's
    repeats along a leading dim: a spec here is the reference's for the
    same parameter without that dim's leading None."""
    assert _MESH is not None, "set a mesh first"
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    out = {}
    for name, leaf in items:
        shape = tuple(getattr(leaf, "shape", leaf))
        out[name] = sharding(param_spec(name, shape, fsdp))
    return out


# ---------------------------------------------------------------------------
# the runtime: placing tensors, local blocks, autograd-aware collectives
# ---------------------------------------------------------------------------

def collective_counts() -> dict:
    """{kind: calls} since the last :func:`reset_collective_counts`."""
    return dict(_COUNTS)


def collective_bytes() -> dict:
    """{"bytes": {kind: bytes}, "by_axis": {axis: bytes}, "weights":
    {axis: bytes}} since the last :func:`reset_collective_counts`: the
    bytes of each collective's whole tensor on this rank (an
    all_gather's output, a reduce_scatter's input, an all_reduce's or
    all_to_all's tensor, rank 0's gathered blocks), counted where the
    group holds more than one rank (one rank exchanges nothing);
    ``by_axis`` keys a group of several mesh axes by their names joined
    with commas; ``weights`` holds the part of the all_gathers that
    gathered parameters (:func:`local_view`), by axis."""
    return {"bytes": dict(_BYTES), "by_axis": dict(_AXIS_BYTES),
            "weights": dict(_WEIGHT_BYTES)}


def reset_collective_counts() -> None:
    _COUNTS.clear()
    _BYTES.clear()
    _AXIS_BYTES.clear()
    _WEIGHT_BYTES.clear()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _count(kind, nbytes=0, axis=None, ranks=1):
    """One ``kind`` call; ``nbytes`` of result on the rank over ``axis``
    when the group holds more than one rank."""
    _COUNTS[kind] = _COUNTS.get(kind, 0) + 1
    if ranks > 1:
        _BYTES[kind] = _BYTES.get(kind, 0) + nbytes
        _AXIS_BYTES[axis] = _AXIS_BYTES.get(axis, 0) + nbytes


def _group(axis):
    return _MESH.get_group(axis)


def _coord(axis) -> int:
    return _MESH.get_local_rank(axis)


def world_size() -> int:
    """The number of ranks of the current mesh (1 without one)."""
    n = 1
    for s in axis_sizes().values():
        n *= s
    return n


def _local_slice(t, plc, mesh=None):
    """This rank's block of the global tensor ``t`` under placements
    ``plc`` (even splits: the rules only shard dims that divide)."""
    mesh = mesh if mesh is not None else _MESH
    for name, p in zip(mesh.mesh_dim_names, plc):
        if p.is_shard():
            n = dict(zip(mesh.mesh_dim_names, mesh.shape))[name]
            t = t.chunk(n, dim=p.dim)[mesh.get_local_rank(name)]
    return t


def distribute(t: torch.Tensor, plc, mesh=None, device=None):
    """A DTensor of the global tensor ``t`` (the same on every rank, e.g.
    drawn from one seed or read from one file) with placements ``plc``:
    each rank keeps its block, nothing is sent.  The block is cut where
    ``t`` lies and then moved to ``device`` (default: ``t``'s), so a
    tensor on the host never lies whole on the card; a block that is a
    view into ``t`` is copied out, so that it does not keep ``t`` alive."""
    from torch.distributed.tensor import DTensor

    mesh = mesh if mesh is not None else _MESH
    local = _local_slice(t, plc, mesh).contiguous()
    if device is not None:
        local = local.to(device)
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        local = local.clone()  # a block of ``t`` must not hold all of it
    return DTensor.from_local(local, mesh, plc, run_check=False)


def shard_model(model: torch.nn.Module, fsdp: bool,
                device=None) -> torch.nn.Module:
    """Replace each parameter of ``model`` by a DTensor parameter placed
    by the rules on the current mesh, in place, its block moved to
    ``device`` (default: where the parameter lies); returns ``model``."""
    shs = param_shardings(model, fsdp)
    for name, sh in shs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = mod._parameters[leaf]
        mod._parameters[leaf] = torch.nn.Parameter(
            distribute(p.detach(), sh.placements, device=device),
            requires_grad=p.requires_grad)
        del p  # a host-staged parameter is freed as its block is placed
    return model


def gather_to_root(t):
    """The whole of the DTensor ``t`` on the host of global rank 0, None
    on every other rank: each rank sends its block to rank 0 alone,
    which puts the blocks in place (a collective that every rank of
    ``t``'s mesh, which holds every rank of the group, calls)."""
    mesh = t.device_mesh
    block = t.to_local().contiguous()
    rank = dist.get_rank()
    parts = ([torch.empty_like(block) for _ in range(dist.get_world_size())]
             if rank == 0 else None)
    n = dist.get_world_size()
    _count("gather", _nbytes(block) * n, ",".join(mesh.mesh_dim_names), n)
    dist.gather(block, parts, dst=0)
    if rank != 0:
        return None
    full = torch.empty(t.shape, dtype=t.dtype)
    grid = mesh.mesh
    for r, part in enumerate(parts):
        coord = [int(c[0]) for c in torch.nonzero(grid == r, as_tuple=True)]
        start, length = [0] * t.ndim, list(t.shape)
        for i, (pl, c) in enumerate(zip(t.placements, coord)):
            if pl.is_shard():  # even splits, in mesh order (_local_slice)
                length[pl.dim] //= grid.shape[i]
                start[pl.dim] += c * length[pl.dim]
        full[tuple(slice(s, s + n) for s, n in zip(start, length))] = \
            part.cpu()
    return full


def _all_gather_dim(t, axis, dim, weight=False):
    g = _group(axis)
    n = dist.get_world_size(g)
    _count("all_gather", _nbytes(t) * n, axis, n)
    if weight and n > 1:
        _WEIGHT_BYTES[axis] = _WEIGHT_BYTES.get(axis, 0) + _nbytes(t) * n
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=g)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _reduce_scatter_dim(t, axis, dim):
    """The sum of ``t`` over ``axis``, this rank's block of ``dim``
    (even splits)."""
    g = _group(axis)
    n = dist.get_world_size(g)
    _count("reduce_scatter", _nbytes(t), axis, n)
    if n == 1:
        return t.contiguous().clone()
    src = t.movedim(dim, 0).contiguous()  # the blocks contiguous
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=g)
    return out.movedim(0, dim).contiguous()


def _all_reduce_(t, axes, op=dist.ReduceOp.SUM):
    for a in axes:
        _count("all_reduce", _nbytes(t), a, _axis_size(a))
        dist.all_reduce(t, op=op, group=_group(a))
    return t


class _View(torch.autograd.Function):
    """A parameter DTensor -> a plain tensor gathered over every mesh
    axis but ``keep`` (kept axes stay this rank's shard).  Backward: the
    gradient summed over every axis on which ranks used the same values
    (all but the kept sharded ones), then cut to this rank's shard."""

    @staticmethod
    def forward(ctx, p, keep):
        mesh = p.device_mesh
        names = mesh.mesh_dim_names
        ctx.p_meta = (mesh, tuple(p.placements))
        gather = [(n, pl.dim) for n, pl in zip(names, p.placements)
                  if pl.is_shard() and n not in keep]
        ctx.reduce = [n for n, pl in zip(names, p.placements)
                      if not (pl.is_shard() and n in keep)]
        ctx.gather = gather
        t = p.to_local()
        for name, dim in reversed(gather):
            t = _all_gather_dim(t, name, dim, weight=True)
        # a view, never the parameter's own local tensor: autograd marks
        # what this returns as the function's output
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        mesh, plc = ctx.p_meta
        g = _all_reduce_(g.contiguous().clone(), ctx.reduce)
        for name, dim in ctx.gather:
            n = dict(zip(mesh.mesh_dim_names, mesh.shape))[name]
            g = g.chunk(n, dim=dim)[mesh.get_local_rank(name)]
        return DTensor.from_local(g.contiguous(), mesh, plc,
                                  run_check=False), None


def local_view(p, keep=()):
    """``p`` as a plain tensor: a DTensor parameter gathered over every
    mesh axis not in ``keep``; anything else as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    return _View.apply(p, tuple(keep))


_EXPERTS = re.compile(r"(^|\.)experts\.w[123]$")


@contextlib.contextmanager
def gathered(*modules, keep=()):
    """Within the block, every DTensor parameter of ``modules`` reads as
    a plain tensor (:func:`local_view`: gathered over every mesh axis
    but ``keep``, :func:`weight_keep`), but the MoE experts, which the
    MoE block reads itself.  The identity without a mesh."""
    if _MESH is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    swapped = []
    for m in modules:
        for name, p in list(m.named_parameters()):
            if not isinstance(p, DTensor) or _EXPERTS.search(name):
                continue
            mod_name, _, leaf = name.rpartition(".")
            mod = m.get_submodule(mod_name) if mod_name else m
            swapped.append((mod, leaf, p))
            mod._parameters[leaf] = local_view(p, keep)
    try:
        yield
    finally:
        for mod, leaf, p in swapped:
            mod._parameters[leaf] = p


class _AllToAll(torch.autograd.Function):
    """Equal-split all_to_all over ``axis`` along dim 0 (its own inverse,
    so the backward is the same exchange)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        _count("all_to_all", _nbytes(x), axis, _axis_size(axis))
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=_group(axis))
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.axis), None


def all_to_all(x, axis):
    """x: (n, ...) with n the size of ``axis``: block j goes to rank j
    of the axis; block i of the result came from rank i."""
    return _AllToAll.apply(x, axis)


class _AllGather(torch.autograd.Function):
    """All-gather over ``axis`` along ``dim``; the backward is the
    reduce-scatter (each rank's gradient of the whole summed over the
    axis, the rank's block kept)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.axis, ctx.dim), None, None


def all_gather(x, axis, dim):
    return _AllGather.apply(x, axis, dim)


class _ReduceScatter(torch.autograd.Function):
    """Sum over ``axis``, the rank's block of ``dim`` kept; the backward
    is the all-gather."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _reduce_scatter_dim(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim(g, ctx.axis, ctx.dim), None, None


def reduce_scatter(x, axis, dim):
    return _ReduceScatter.apply(x, axis, dim)


def seq_gather(x, seq: int):
    """The whole sequence of ``x`` (B, s, ...), the residual's block of a
    sequence of ``seq`` positions: all-gathered over the model axis
    along dim 1 when ``x`` holds a block of it (``"tp"``), else ``x``."""
    return x if x.shape[1] == seq else all_gather(x, "model", 1)


def seq_part(t, s: int):
    """The rank's block of ``s`` positions of ``t`` (B, S, ...) along dim
    1 (all of ``t`` when ``s`` is S)."""
    S = t.shape[1]
    return t if s == S else t.narrow(1, model_rank() * s, s)


def seq_scatter(y, s: int, partial: bool):
    """``y`` (B, S, ...), a sublayer's output over the whole sequence, as
    the residual's block of ``s`` positions: when ``partial`` (a
    row-parallel product's share of the sum) reduce-scattered over the
    model axis along dim 1, or all-reduced when the residual holds all
    S positions; else the block taken."""
    if not partial:
        return seq_part(y, s)
    if s < y.shape[1]:
        return reduce_scatter(y, "model", 1)
    return all_reduce(y, ("model",))


def residual_len(seq: int, cfg) -> int:
    """The positions of a sequence of ``seq`` that this rank's residual
    holds: seq / n_model under ``"tp"`` when it divides (the reference's
    ``_seq_shard``), else all of them."""
    n = model_axis_size()
    return seq // n if tp(cfg) and n > 1 and seq % n == 0 else seq


def heads_to_seq(t):
    """``t`` (B, L, h, ...) holding this rank's block of heads over the
    model axis, L dividing by it -> (B, L / n, n h, ...): every head, at
    the rank's block of dim 1 (one all_to_all)."""
    n = model_axis_size()
    B, L = t.shape[:2]
    x = t.reshape((B, n, L // n) + tuple(t.shape[2:])).movedim(1, 0)
    x = all_to_all(x.contiguous(), "model")  # (src: head block, B, L/n, h..)
    return x.movedim(0, 2).reshape((B, L // n, n * t.shape[2]) +
                                   tuple(t.shape[3:]))


def vocab_argmax(logits):
    """The id of each row's largest logit, int64, (B,): ``logits`` a plain
    tensor or a DTensor whose last (vocab) dim may be split over the
    model axis; ties go to the lowest id, as ``torch.argmax``'s do.
    Each rank sends its block's best value and id, never its logits."""
    if not is_dtensor(logits):
        return logits.argmax(-1)
    dim, off, _ = model_shard(logits)
    loc = logits.to_local()
    if dim is None:
        return loc.argmax(-1)
    idx = loc.argmax(-1)
    val = loc.gather(-1, idx[..., None])[..., 0]
    both = torch.stack([val.float(), (idx + off).float()], -1)
    every = _all_gather_dim(both[None], "model", 0)  # (n, B, 2)
    best = every[..., 0].argmax(0)  # the first block holding the max
    return every[..., 1].gather(0, best[None])[0].long()


class _AllReduce(torch.autograd.Function):
    """Sum over ``axes``; the backward sums the gradients likewise."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _all_reduce_(x.contiguous().clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.axes), None


def all_reduce(x, axes):
    """The sum of ``x`` over the mesh axes ``axes`` (autograd-aware);
    ``x`` itself when ``axes`` is empty."""
    axes = tuple(axes)
    return _AllReduce.apply(x, axes) if axes else x


def all_reduce_max(x, axes):
    """The elementwise max over ``axes`` (no gradient: used for the
    softmax's shift, which cancels)."""
    return _all_reduce_(x.detach().contiguous().clone(), tuple(axes),
                        dist.ReduceOp.MAX)


def _batch_spec(shape, over_model: bool = False) -> tuple:
    """The batch rule of ``launch.steps.batch_shardings``: the leading
    dim over the batch axes when it divides, the rest replicated.  With
    ``over_model`` the leading dim goes over the batch axes and the model
    axis when it divides by all of them (the local program's layout
    without a cache, see the module docstring)."""
    spec = [None] * len(shape)
    ba = batch_axes()
    tries = [ba + ("model",)] if over_model and "model" in axis_sizes() \
        else []
    for axes in tries + [ba]:
        if spec and axes and shape[0] % _axis_size(axes) == 0:
            spec[0] = axes
            break
    return tuple(spec)


def local_batch(t, over_model: bool = False):
    """The rank's block of a batch input at the model's entry
    (:func:`_batch_spec`'s rule): a DTensor is redistributed to it and
    its local tensor taken; a plain tensor is the global batch, the same
    on every rank, and the rank's rows are taken.  The identity without
    a mesh (and for None)."""
    from torch.distributed.tensor import DTensor

    global _SPLIT
    if _MESH is None or t is None:
        return t
    spec = _batch_spec(t.shape, over_model)
    _SPLIT = spec[0] or ()
    if isinstance(t, DTensor):
        return constrain(t, *spec).to_local()
    return _local_slice(t, placements(spec))


def batch_split() -> tuple:
    """The mesh axes the batch the model took last (:func:`local_batch`)
    is split over: () when every rank holds all of it.  The einsum
    dispatch, which routes the global batch, gathers the blocks over
    them; the zipper dispatch splits the sequence over the model axis
    only when the batch is not split over it."""
    return _SPLIT


def batch_block(t):
    """The rank's rows of ``t``, a tensor of the global batch, as the
    batch the model took last is split (:func:`batch_split`)."""
    return _local_slice(t, placements((_SPLIT or None,)))


def from_local_batch(t, global_batch: int, last_over_model: bool = False):
    """A DTensor of the rank's block ``t`` of a batch output whose global
    batch is ``global_batch`` (split as the batch the model took last;
    with ``last_over_model`` the last dim split over the model axis, as
    ``"tp"`` splits the vocabulary; the rest replicated).  The identity
    without a mesh."""
    from torch.distributed.tensor import DTensor

    if _MESH is None:
        return t
    shape = (global_batch,) + tuple(t.shape[1:])
    spec = [_SPLIT or None] + [None] * (t.ndim - 1)
    if last_over_model:
        spec[-1] = "model"
        shape = shape[:-1] + (shape[-1] * model_axis_size(),)
    plc = placements(tuple(spec))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, _MESH, plc, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def full_tensor(t):
    """The whole of the DTensor ``t`` on every rank (``full_tensor``,
    DTensor's all_gather over the axes that shard it, counted as one
    all_gather of its global size); anything else as it is."""
    if not is_dtensor(t):
        return t
    axes = [n for n, p in zip(t.device_mesh.mesh_dim_names, t.placements)
            if p.is_shard()]
    ranks = 1
    for a in axes:
        ranks *= _axis_size(a)
    _count("all_gather", _nbytes(t), ",".join(axes), ranks)
    return t.full_tensor()


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t):
    """A DTensor's local tensor (this rank's shard); anything else as it
    is."""
    return t.to_local() if is_dtensor(t) else t


def like(t, ref):
    """``t``, a tensor of the shape and dtype of ``ref``'s local shard, as
    a DTensor of ``ref``'s mesh, placements and global shape (no
    gradient); ``t`` itself when ``ref`` is not a DTensor.  Built on
    ``ref``'s spec: ``DTensor.from_local`` costs ~10x more host time a
    call, which over every weight of a model outlasts an optimizer
    step's device work."""
    from torch.distributed.tensor import DTensor

    if not isinstance(ref, DTensor):
        return t
    loc = ref._local_tensor
    if t.shape != loc.shape or t.dtype != loc.dtype:
        raise ValueError(f"a {tuple(t.shape)} {t.dtype} block in place of "
                         f"a {tuple(loc.shape)} {loc.dtype} one")
    return DTensor(t, ref._spec, requires_grad=False)


def owns(t) -> bool:
    """Whether this rank holds the first copy of its shard of the DTensor
    ``t``: its coordinate is 0 on every mesh axis that replicates ``t``
    (a sum over ranks of the owners' shards counts each element once)."""
    mesh = t.device_mesh
    return all(mesh.get_local_rank(n) == 0
               for n, p in zip(mesh.mesh_dim_names, t.placements)
               if p.is_replicate())


def mesh_sum_(t, mesh):
    """``t`` summed in place over every rank of ``mesh`` (one all_reduce
    per mesh axis); returns ``t``."""
    for name in mesh.mesh_dim_names:
        _count("all_reduce", _nbytes(t), name, mesh.size(
            mesh.mesh_dim_names.index(name)))
        dist.all_reduce(t, group=mesh.get_group(name))
    return t


def model_shard(c) -> tuple:
    """(dim, offset, length) of the model-axis split of the DTensor
    ``c``: the tensor dim the model axis shards (None if it shards
    none), where this rank's block starts along it, and its length."""
    if "model" not in c.device_mesh.mesh_dim_names:
        return None, 0, None
    i = c.device_mesh.mesh_dim_names.index("model")
    pl = c.placements[i]
    if not pl.is_shard():
        return None, 0, None
    n = c.device_mesh.shape[i]
    length = c.shape[pl.dim] // n
    return pl.dim, c.device_mesh.get_local_rank("model") * length, length


def to_cache(value, like, block=False):
    """``value``, a tensor in the local program's layout (this rank's
    batch block, whole along every other dim, or with ``block`` already
    the rank's block along the model-axis dim), in the place of the
    cache entry ``like``: for a DTensor, a DTensor of its mesh and
    placements that keeps the rank's block along the model-axis dim;
    else ``value``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return value
    dim, off, length = model_shard(like)
    if dim is not None and not block:
        value = value.narrow(dim, off, length)
    return DTensor.from_local(value.contiguous(), like.device_mesh,
                              like.placements, run_check=False)


def from_cache(c, block=False):
    """A cache entry in the local program's layout: a DTensor's batch
    block all-gathered along the model-axis dim (where a step needs the
    whole state: the recurrent blocks' under ``"sp"``), or with
    ``block`` the rank's block as it is (``"tp"``, whose recurrent
    blocks run the rank's channels); a plain tensor as it is."""
    if not is_dtensor(c):
        return c
    dim, _, _ = model_shard(c)
    t = c.to_local()
    return t if dim is None or block else _all_gather_dim(t, "model", dim)
