"""SpGEMM engine registry and the plan/execute split (explicit engines).

Port of the explicit-engine slice of ``repro.core.dispatch``:

  * a **registry** of named engines with declared capabilities —
    :func:`register_engine`, :func:`get_engine`, :func:`available_engines`;
  * :func:`plan` — validates the operands and resolves everything about a
    multiply before it runs: the engine's kwargs, the device, and (for
    backend-aware engines) the kernel backend, frozen into a hashable
    :class:`ExecutionPlan`;
  * :func:`execute` — runs a plan against concrete operands;
    ``spgemm(A, B, ...)`` is exactly ``execute(plan(A, B, ...), A, B)``.

Automatic engine selection (``engine="auto"``), the autotune cache and
the learned dispatch model are not ported yet; asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.core import spgemm as sg
from repro_torch.core.formats import CSR, csr_to_numpy, validate_operands
from repro_torch.kernels import backend as kb

_NOT_PORTED = ("is not ported yet: automatic engine selection, the autotune "
               "cache and the learned dispatch model come with the dispatch "
               "slice (ROADMAP.md queue 1, item 7); name an engine instead")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """A registered SpGEMM engine and its declared capabilities.

    ``fn(A, B, *, device, **kw)`` returns a CSR on ``device``, or
    ``(CSR, stats)`` when ``returns_stats``; ``backend_aware`` engines
    take a ``backend=`` kernel-backend kwarg, resolved once at plan time
    from the registry in ``kernels/backend.py``."""

    name: str
    fn: Callable
    returns_stats: bool = False
    backend_aware: bool = False
    description: str = ""


_REGISTRY: dict[str, EngineSpec] = {}


def register_engine(name: str, fn: Callable, **caps) -> EngineSpec:
    """Register (or replace) an engine under ``name``; see EngineSpec."""
    spec = EngineSpec(name=name, fn=fn, **caps)
    _REGISTRY[name] = spec
    return spec


def get_engine(name: str) -> EngineSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_engines() -> dict[str, EngineSpec]:
    """Snapshot of the registry (name -> spec)."""
    return dict(_REGISTRY)


register_engine("scl-array",
                lambda A, B, *, device: sg.spgemm_scl_array(A, B).to(device),
                description="scalar row loop, dense accumulator row (oracle)")
register_engine("scl-hash",
                lambda A, B, *, device: sg.spgemm_scl_hash(A, B,
                                                           device=device),
                description="scalar row loop, hash-style unique/accumulate")
register_engine("esc", lambda A, B, **kw: sg.spgemm_esc(A, B, **kw),
                description="vectorized Expand-Sort-Compress (vec-radix)")
register_engine("spz", lambda A, B, **kw: sg.spgemm_spz(A, B, **kw),
                returns_stats=True, backend_aware=True,
                description="SparseZipper chunked stream sort + zip-merge "
                            "(device-resident fused driver)")
register_engine("spz-fused",
                lambda A, B, **kw: sg.spgemm_spz(A, B, driver="fused", **kw),
                returns_stats=True, backend_aware=True,
                description="spz with the device-resident fused driver "
                            "pinned")
register_engine("spz-host",
                lambda A, B, **kw: sg.spgemm_spz(A, B, driver="host", **kw),
                returns_stats=True, backend_aware=True,
                description="spz with the lock-step host driver (one K4/K5 "
                            "kernel issue per chunk; the Fig. 9-11 path)")
register_engine("spz-rsort",
                lambda A, B, **kw: sg.spgemm_spz(A, B, rsort=True, **kw),
                returns_stats=True, backend_aware=True,
                description="spz with rows pre-sorted by per-row work")


def _nnz_bucket(m: CSR) -> int:
    """log2 bucket of true nnz — shapes in the same bucket share a plan."""
    return int(csr_to_numpy(m)[0][-1]).bit_length()


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything planning decides about a multiply, frozen and hashable:
    the engine, the kwargs resolved for it (device and kernel backend
    included), and the operand structure.  ``jit_key`` is the static
    identity of the launches the plan routes to."""

    engine: str
    a_shape: tuple
    b_shape: tuple
    kwargs: tuple               # sorted (name, value) pairs, plan-resolved
    work_bucket: tuple          # (nnz bucket A, nnz bucket B)
    backend: Optional[str] = None  # resolved kernel backend (aware engines)

    @property
    def kwargs_dict(self) -> dict:
        return dict(self.kwargs)

    @property
    def jit_key(self) -> tuple:
        """Engine + kernel backend + operand structure + resolved kwargs."""
        return (self.engine, self.backend, self.a_shape, self.b_shape,
                self.work_bucket, self.kwargs)


def plan(A: CSR, B: CSR, engine: str = "auto", *, backend: str = "auto",
         device=None, autotune: bool = False, cache: Any = None,
         model: Any = None, **kw) -> ExecutionPlan:
    """Resolve a multiply of ``A @ B`` by a named engine without running
    it: validate the operands, resolve the device (the card unless
    ``device`` says otherwise) and, for backend-aware engines, the kernel
    backend ("auto": cuda on a CUDA device, torch on the CPU)."""
    if engine == "auto":
        raise NotImplementedError(f"engine='auto' {_NOT_PORTED}")
    if autotune or cache is not None or model is not None:
        raise NotImplementedError(f"autotune/cache/model selection {_NOT_PORTED}")
    if A.n_cols != B.n_rows:
        raise ValueError(f"inner dims differ: {A.shape} @ {B.shape}")
    spec = get_engine(engine)
    validate_operands(A, B)
    dev = sg.resolve_device(device)
    resolved = dict(kw, device=dev)
    plan_bk = None
    if spec.backend_aware:
        plan_bk = kb.resolve_backend(backend, dev).name
        resolved["backend"] = plan_bk
    elif backend != "auto":
        raise ValueError(f"engine {spec.name!r} does not take a kernel "
                         f"backend (requested {backend!r})")
    return ExecutionPlan(engine=engine, a_shape=A.shape, b_shape=B.shape,
                         kwargs=tuple(sorted(resolved.items())),
                         work_bucket=(_nnz_bucket(A), _nnz_bucket(B)),
                         backend=plan_bk)


def execute(p: ExecutionPlan, A: CSR, B: CSR, *, return_stats: bool = False):
    """Run a plan against concrete operands of the planned shapes."""
    if A.shape != p.a_shape or B.shape != p.b_shape:
        raise ValueError(
            f"plan/operand mismatch: planned {p.a_shape} @ {p.b_shape}, "
            f"got {A.shape} @ {B.shape}")
    spec = get_engine(p.engine)
    out = spec.fn(A, B, **p.kwargs_dict)
    out, stats = out if spec.returns_stats else (out, None)
    return (out, stats) if return_stats else out


def spgemm(A: CSR, B: CSR, engine: str = "auto", *, backend: str = "auto",
           device=None, return_stats: bool = False, **kw):
    """Multiply two padded CSR matrices through the engine registry:
    exactly ``execute(plan(A, B, ...), A, B)``.  Runs on the card unless
    ``device`` names another device; returns the CSR on that device
    (and the engine's stats with ``return_stats``)."""
    p = plan(A, B, engine, backend=backend, device=device, **kw)
    return execute(p, A, B, return_stats=return_stats)

