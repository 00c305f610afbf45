"""Deterministic, seedable fault injection for the SpGEMM serving stack.

Port of ``repro.runtime.faultinject``: the same sites, specs and
seed-deterministic firing (one ``numpy`` generator per injector); a
corrupted result is built as torch tensors on the result's device.

The serving path (plan -> execute -> backend -> shard -> serve) is only
trustworthy under failure if failures can be *manufactured on demand*:
a kernel that raises mid-call, an engine that returns NaN/garbage, a
shard worker that hangs or dies mid-flush, a scribbled-over autotune
cache.  This module is the single registry for those fault sites.

Design constraints:

  * **zero overhead when disabled** — production call sites call
    :func:`fire`/:func:`corrupt`, which are a module-global ``None``
    check when no injector is installed (no spec matching, no RNG);
  * **deterministic** — an installed :class:`FaultInjector` owns one
    seeded ``numpy`` generator; for a fixed seed and call order the
    exact sequence of fired faults is reproducible, so chaos tests can
    assert bit-exact recovery;
  * **structured** — every fired fault is recorded in
    ``injector.events`` (site, kind, call index, context), so tests can
    assert *what* fired, not just that something went wrong.

Fault sites currently threaded through the stack:

  ``dispatch.execute``        single-pair engine call (raise / hang /
                              output corruption) — ``core/dispatch.py``
  ``dispatch.execute_batched`` whole-batch engine call + output
                              corruption — ``core/dispatch.py``
  ``kernel.batched``          per batched driver call, once per device
                              group of a sharded flush (the injected
                              "kernel died mid-launch") —
                              ``core/dispatch.py`` batch drivers
  ``shard.worker``            per shard-worker launch; killing it raises
                              ``WorkerLost`` — ``distributed/spgemm_shard.py``
  ``dispatch.measure``        per autotune measurement —
                              ``core/dispatch.py``
  ``dispatch.warm``           per warmed pad bucket —
                              ``core/dispatch.py`` ``warm_bucket``
  ``autotune.flush``          cache write-out (cache-corruption site) —
                              ``core/dispatch.py`` AutotuneCache
  ``service.flush``           top of every service flush —
                              ``serving/spgemm_service.py``
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch


class InjectedFault(RuntimeError):
    """Raised at an armed fault site (the default ``kind="raise"``)."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        super().__init__(f"injected fault at {site}" +
                         (f": {detail}" if detail else ""))


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: where it fires, how, and how often.

    site:      exact site name (see module docstring).
    kind:      "raise"   -> raise ``exc_factory(site, ctx)``;
               "hang"    -> sleep ``delay_s`` (a stuck worker; pair with
                            a deadline policy);
               "call"    -> invoke ``action(**ctx)`` (escape hatch —
                            e.g. scribble garbage into a cache file);
               "kill_process" -> SIGKILL the *current process* — no
                            cleanup, no exception propagation, exactly
                            what a chaos test means by "the worker
                            process died mid-flush".  Unlike "call",
                            the spec stays picklable, so it can ride a
                            task payload into a spawned worker;
               "nan"     -> corrupt values of a CSR/BatchedCSR result
                            with non-finite payloads (:func:`corrupt`
                            sites only);
               "garbage" -> corrupt column indices out of range
                            (:func:`corrupt` sites only).
    rate:      probability each matching call fires (seeded RNG roll).
    max_fires: stop firing after this many hits (``1`` = kill-once).
    match:     context filter — every (key, value) must equal the
               ``fire``/``corrupt`` call's context for the spec to arm.
    """

    site: str
    kind: str = "raise"
    rate: float = 1.0
    max_fires: Optional[int] = None
    match: dict = dataclasses.field(default_factory=dict)
    exc_factory: Optional[Callable[[str, dict], BaseException]] = None
    action: Optional[Callable] = None
    delay_s: float = 0.0
    fires: int = 0  # mutable: how many times this spec has fired

    def matches(self, site: str, ctx: dict) -> bool:
        if site != self.site:
            return False
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        return all(ctx.get(k) == v for k, v in self.match.items())


class FaultInjector:
    """Holds armed :class:`FaultSpec`s plus the seeded RNG and event log."""

    def __init__(self, specs, *, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        self.specs = list(specs)
        self.rng = np.random.default_rng(seed)
        self.sleep = sleep
        self.events: list[dict] = []
        self.calls = 0

    def _arm(self, site: str, ctx: dict, kinds: tuple):
        """First matching spec whose rate-roll passes, with bookkeeping.

        ``kinds`` scopes the hook type: a value-corruption spec must not
        burn its ``max_fires`` (or its rate roll) on the ``fire()`` call
        that precedes the engine, and vice versa."""
        for spec in self.specs:
            if spec.kind not in kinds or not spec.matches(site, ctx):
                continue
            if spec.rate < 1.0 and float(self.rng.random()) >= spec.rate:
                continue
            spec.fires += 1
            self.events.append({"site": site, "kind": spec.kind,
                                "call": self.calls, **ctx})
            return spec
        return None

    def fire(self, site: str, **ctx) -> None:
        self.calls += 1
        spec = self._arm(site, ctx, ("raise", "hang", "call",
                                     "kill_process"))
        if spec is None:
            return
        if spec.kind == "raise":
            if spec.exc_factory is not None:
                raise spec.exc_factory(site, ctx)
            raise InjectedFault(site, spec.match and repr(spec.match) or "")
        if spec.kind == "hang":
            self.sleep(spec.delay_s)
        elif spec.kind == "kill_process":
            # the real thing, not a simulation: the process is gone
            # before the next Python bytecode runs
            import os
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        elif spec.action is not None:  # kind == "call"
            spec.action(**ctx)

    def corrupt(self, site: str, value, **ctx):
        self.calls += 1
        spec = self._arm(site, ctx, ("nan", "garbage"))
        if spec is None:
            return value
        return _corrupt_value(value, spec.kind)


def _corrupt_value(value, kind: str):
    """Return a corrupted copy of an engine result.

    Handles any padded-CSR-shaped object (``indices``/``data`` tensor
    fields on a dataclass — CSR and BatchedCSR both qualify) and lists of
    them; anything else is passed through untouched.  The corrupted
    tensors are built on the value's own device."""
    if isinstance(value, list):
        return [_corrupt_value(v, kind) for v in value]
    if isinstance(value, tuple):  # (csr, stats) engine results
        return (_corrupt_value(value[0], kind),) + tuple(value[1:])
    if not (dataclasses.is_dataclass(value) and hasattr(value, "data")
            and hasattr(value, "indices")):
        return value
    if kind == "nan":
        return dataclasses.replace(
            value, data=torch.full_like(value.data, float("nan")))
    # out-of-range column: must be caught, never served
    return dataclasses.replace(value,
                               indices=torch.full_like(value.indices, -7))


# ---------------------------------------------------------------------------
# module-level install point (the zero-overhead hook)
# ---------------------------------------------------------------------------

_INJECTOR: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    """The installed injector, or None (the production steady state)."""
    return _INJECTOR


def install(injector: Optional[FaultInjector]) -> None:
    global _INJECTOR
    _INJECTOR = injector


def clear() -> None:
    install(None)


def fire(site: str, **ctx) -> None:
    """Fault hook: no-op unless an injector is installed.

    Call sites pay one global load + ``is None`` test when disabled —
    cheap enough to leave compiled into every layer of the stack."""
    if _INJECTOR is not None:
        _INJECTOR.fire(site, **ctx)


def corrupt(site: str, value: Any, **ctx) -> Any:
    """Value-corruption hook: identity unless an injector is installed."""
    if _INJECTOR is not None:
        return _INJECTOR.corrupt(site, value, **ctx)
    return value


@contextlib.contextmanager
def injected(*specs: FaultSpec, seed: int = 0,
             sleep: Callable[[float], None] = time.sleep):
    """Install a fresh injector for the duration of a with-block."""
    inj = FaultInjector(specs, seed=seed, sleep=sleep)
    prev = _INJECTOR
    install(inj)
    try:
        yield inj
    finally:
        install(prev)
