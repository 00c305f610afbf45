"""SpGEMM engine registry, plan/execute dispatch, and batched execution.

Port of ``repro.core.dispatch``.  No single SpGEMM strategy wins
everywhere (the paper's Table III / Fig. 8): scalar hash accumulation,
vectorized Expand-Sort-Compress and the SparseZipper merge path trade off
by density, per-row work and work skew.  This module is the engine
layer, split into a **selection** phase and an **execution** phase:

  * a **registry** of named engines with declared capabilities
    (returns-stats, batchable, backend-aware, measured by autotune) —
    new engines plug in via :func:`register_engine`;
  * :func:`plan` — ``plan(A, B, engine="auto")`` resolves everything
    data-dependent about a multiply *before* it runs: the device (the
    card unless the caller names another), the engine (from cheap
    structural features through an overridable heuristic table, a cached
    prior selection, or one-shot measurement with ``autotune=True``), the
    kernel backend, and the resolved engine kwargs.  Plans are frozen,
    hashable and reusable across calls with matching operand structure;
  * :func:`execute` — runs a plan against concrete operands.
    ``spgemm(A, B, ...)`` is exactly ``execute(plan(A, B, ...), A, B)``;
  * an **autotune cache** persisted to disk and keyed by shape/nnz
    bucket, so repeated shapes (the serving steady state) skip
    re-selection, plus an in-process plan memo keyed on operand identity
    so repeat calls on the same matrices skip planning entirely;
  * **resilience** — :func:`execute_resilient` retries, honours a
    deadline and walks the plan's device's degradation ladder
    (:func:`degrade_chain`) on the caller's request, naming the tier
    that served in its :class:`ExecutionReport`.  On a card the ladder
    holds only the kernels and engines of the card, and a kernel that
    fails to build or launch raises.  :func:`spgemm`, :func:`execute`
    and :func:`execute_batched` never fall back;
  * :func:`plan_batched` / :func:`execute_batched` — the same split for a
    whole :class:`BatchedCSR`: ``esc`` lane by lane at one shared product
    capacity, ``spz`` through a lock-step driver that packs rows from
    every batch lane into shared groups of S streams.

The **learned dispatch model** (``models/dispatch_model.py``) is the
selection ladder's rung between a cache hit and measurement: a
``DispatchModel`` trained from the cache's timing vectors, kept next to
the cache file (``<cache>.model.json``, so processes sharing a cache
share its model), plans a cache miss at once (``source="model"``) when
it is confident, among the combos measurable on the plan's device; a
model that never saw those combos (one trained on the CPU, asked on a
card) abstains and selection falls through.

The serving layer's warm pool closes the module: :func:`warm_bucket` runs
one flush-shaped sharded pass over a pad bucket before its first request
and records its plan's ``jit_key`` (:func:`note_warmed`); each flush asks
:func:`jit_warmed`, and :func:`warm_stats` counts both.  On a card,
"warm" means the kernel libraries are built and loaded (``kb.load()``)
and the buffers of that flush shape have passed once through the caching
allocator.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import inspect
import json
import math
import os
import tempfile
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import spgemm as sg
from repro_torch.core.formats import (CSR, BatchedCSR, batch_csr,
                                      csr_from_coo, csr_to_numpy,
                                      validate_operands)
from repro_torch.device import resolve_device
from repro_torch.kernels import backend as kb
from repro_torch.runtime import faultinject as fi

try:  # best-effort file locking for the autotune-cache flush
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX platforms
    fcntl = None


# ---------------------------------------------------------------------------
# engine registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """A registered SpGEMM engine and its declared capabilities.

    ``fn(A, B, *, device, **kw)`` returns a CSR on ``device``, or
    ``(CSR, stats)`` when ``returns_stats``.  ``batchable`` engines have
    a driver for :func:`spgemm_batched`; ``measure`` engines are autotune
    candidates; ``backend_aware`` engines take a ``backend=``
    kernel-backend kwarg, resolved once at plan time from the registry
    in ``kernels/backend.py``; ``on_host`` engines compute with numpy on
    the CPU whatever ``device`` they return on."""

    name: str
    fn: Callable
    returns_stats: bool = False
    batchable: bool = False
    measure: bool = True  # candidate for autotune measurement
    backend_aware: bool = False
    on_host: bool = False
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
                on_host=True,
                description="scalar row loop, dense accumulator row (oracle)")
register_engine("scl-hash",
                lambda A, B, *, device: sg.spgemm_scl_hash(A, B,
                                                           device=device),
                on_host=True,
                description="scalar row loop, hash-style unique/accumulate")
register_engine("esc", sg.spgemm_esc, batchable=True,
                description="vectorized Expand-Sort-Compress (vec-radix)")
register_engine("spz", lambda A, B, **kw: sg.spgemm_spz(A, B, **kw),
                returns_stats=True, batchable=True, backend_aware=True,
                description="SparseZipper chunked stream sort + zip-merge "
                            "(device-resident fused driver)")
register_engine("spz-fused",
                lambda A, B, **kw: sg.spgemm_spz(A, B, driver="fused", **kw),
                returns_stats=True, batchable=True, backend_aware=True,
                measure=False,  # byte-identical to "spz": don't time it twice
                description="spz with the device-resident fused driver "
                            "pinned")
register_engine("spz-host",
                lambda A, B, **kw: sg.spgemm_spz(A, B, driver="host", **kw),
                returns_stats=True, batchable=True, backend_aware=True,
                measure=False,
                description="spz with the lock-step host driver (one K4/K5 "
                            "kernel issue per chunk; the Fig. 9-11 path; "
                            "never wins a measurement, so autotune skips it)")
register_engine("spz-rsort",
                lambda A, B, **kw: sg.spgemm_spz(A, B, rsort=True, **kw),
                returns_stats=True, batchable=True, backend_aware=True,
                description="spz with rows pre-sorted by per-row work")


# ---------------------------------------------------------------------------
# features + heuristic table
# ---------------------------------------------------------------------------

def _nnz(m: CSR) -> int:
    """True nnz: one element of ``indptr`` read from its device."""
    return int(m.indptr[-1])


class _OperandMemo:
    """Bounded memo keyed on operand identity + a request discriminator.

    Serving repeats the same matrix objects call after call, and the
    selection work (``work_stats`` recompute, cache lookups) dominates
    auto-dispatch.  The key is the operands' ``indices`` tensor ``id()``
    + shape + nnz + ``extra`` (the feature group, or the full plan
    request); entries pin the index tensors so an id cannot be recycled
    while its entry lives, and an ``is`` check on hit guards against
    lookups racing a rebuild.  One instance memoizes feature dicts,
    another whole ExecutionPlans.  Access is lock-guarded."""

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._mu = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()

    @staticmethod
    def _key(A: CSR, B: CSR, extra):
        return (id(A.indices), id(B.indices), A.shape, B.shape,
                _nnz(A), _nnz(B), extra)

    def get(self, A: CSR, B: CSR, extra) -> Optional[Any]:
        key = self._key(A, B, extra)
        with self._mu:
            hit = self._entries.get(key)
            if hit is not None and hit[1] is A.indices \
                    and hit[2] is B.indices:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit[0]
            self.misses += 1
            return None

    def put(self, A: CSR, B: CSR, extra, value) -> None:
        with self._mu:
            self._entries[self._key(A, B, extra)] = (value, A.indices,
                                                     B.indices)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
        self.hits = self.misses = 0


_feature_cache = _OperandMemo()
_plan_memo = _OperandMemo()


def clear_feature_cache() -> None:
    """Drop memoized features and plans (benchmarks measure cold selection)."""
    _feature_cache.clear()
    _plan_memo.clear()


def extract_features(A: CSR, B: CSR, group: int = 16) -> dict:
    """Cheap structural features driving engine choice (Table III columns).

    Memoized on the operands' tensor identity/shape/nnz so repeat calls
    on the same matrices (the serving steady state) skip the recompute."""
    feats = _feature_cache.get(A, B, group)
    if feats is None:
        feats = sg.work_stats(A, B, group=group)
        _feature_cache.put(A, B, group, feats)
    return dict(feats)  # callers may mutate their copy, not the cache


@dataclasses.dataclass(frozen=True)
class HeuristicRule:
    """First matching rule wins; ``predicate`` maps a feature dict to bool."""

    name: str
    predicate: Callable[[dict], bool]
    engine: str


# Ordered density-regime table (paper §V-B intuition):
#   tiny total work      -> scalar hash: vectorized setup cost dominates;
#   dense / heavy rows   -> esc: expansion+radix amortizes;
#   high work skew       -> spz-rsort: work-sorted rows fix lock-step
#                           imbalance (Fig. 9);
#   everything else      -> spz merge path (duplicates drop out early).
DEFAULT_HEURISTICS: tuple[HeuristicRule, ...] = (
    HeuristicRule("tiny-work", lambda f: f["total_work"] < 2048
                  and f["density"] < 2e-3, "scl-hash"),
    HeuristicRule("dense", lambda f: f["density"] >= 1.5e-2
                  or f["avg_work_per_row"] >= 128.0, "esc"),
    HeuristicRule("skewed", lambda f: f["work_var_per_group"] >= 1.0,
                  "spz-rsort"),
    HeuristicRule("default", lambda f: True, "spz"),
)


def choose_engine(feats: dict,
                  rules: Sequence[HeuristicRule] = DEFAULT_HEURISTICS,
                  ) -> tuple[str, str]:
    """Return (engine_name, rule_name) for a feature dict."""
    for rule in rules:
        if rule.predicate(feats):
            return rule.engine, rule.name
    raise ValueError("no heuristic rule matched (missing default rule?)")


# ---------------------------------------------------------------------------
# persistent autotune cache
# ---------------------------------------------------------------------------

def _nnz_bucket(m: CSR) -> int:
    """log2 bucket of true nnz — shapes in the same bucket share a plan."""
    return _nnz(m).bit_length()


def cache_key(A: CSR, B: CSR, backend: Optional[str] = None) -> str:
    """Shape/nnz bucket key, extended with the *requested* kernel backend
    so an explicitly pinned backend autotunes its own bucket (a "torch"
    measurement must never serve a "cuda" request, and vice versa).
    ``"auto"`` requests keep the bare key — the default bucket, whose
    entries may record the backend an autotune sweep picked."""
    key = (f"{A.n_rows}x{A.n_cols}@{_nnz_bucket(A)}"
           f"*{B.n_rows}x{B.n_cols}@{_nnz_bucket(B)}")
    return key if backend in (None, "auto") else f"{key}|bk={backend}"


# quarantine records ride in the same JSON file under a reserved key
# prefix (shape keys are "<rows>x<cols>@..." strings, so no collision)
_QUAR_PREFIX = "!quarantine:"

# the cache file's schema record (same reserved "!" namespace).  v1 files
# (no record) held winner-only selection entries and TTL-less quarantine
# records; v2 adds per-candidate timing vectors + feature dicts on
# autotune entries and per-combo quarantine timestamps/strike counts.
# Old entries are MIGRATED forward on load, never dropped: a winner-only
# v1 entry is a perfectly good v2 entry without a timing vector.
_SCHEMA_KEY = "!schema"
SCHEMA_VERSION = 2


def combo_str(engine: str, backend: Optional[str]) -> str:
    """The canonical "engine|backend" id shared by quarantine records and
    timing vectors ("" for a backend-less engine)."""
    return f"{engine}|{backend or ''}"


def split_combo(combo: str) -> tuple[str, Optional[str]]:
    engine, _, backend = combo.partition("|")
    return engine, (backend or None)


# returned by AutotuneCache._lock_file when a live holder kept the lock
# past the bounded acquire window (distinct from None = "no locking")
_LOCK_TIMEOUT = object()


def _default_cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "spgemm_autotune.json"))


class AutotuneCache:
    """Disk-backed map cache_key -> {engine, source[, backend]}.

    ``source`` records how the entry was made: "heuristic" entries are
    upgraded in place by a later ``autotune=True`` call; "autotune"
    entries are sticky.  ``backend`` (optional) records the winning
    kernel backend for backend-aware engines.  Default path:
    ``$REPRO_TORCH_AUTOTUNE_CACHE`` or
    ``~/.cache/repro_torch/spgemm_autotune.json`` — never the JAX
    package's file, whose backend names (``xla``, ``pallas``) are not
    the port's (a foreign file still loads: see
    :func:`_resolve_plan_backend`).

    Robustness (shared by concurrent serving processes): a corrupt or
    truncated file is moved aside to ``<path>.corrupt`` and the cache
    starts empty instead of crashing; writes go to a unique tempfile and
    are published with an atomic rename, so readers never observe a
    partial file; and every flush re-reads and merges the current
    on-disk entries (an "autotune" entry from another process is never
    downgraded by this process's "heuristic" one) under a best-effort
    ``fcntl`` file lock (``<path>.lock``) that serializes the
    read-merge-write critical section across processes — on platforms
    without ``fcntl`` the lock is a no-op and a dropped entry only costs
    a re-measurement, never correctness.  The lock acquire is *bounded*
    (``lock_timeout_s``, default 0.5s or
    ``$REPRO_AUTOTUNE_LOCK_TIMEOUT_S``): a hung — not dead — lock
    holder costs a skipped flush, never a stalled serving process.

    Cross-process propagation protocol: **push on quarantine** —
    ``quarantine()`` flushes immediately, so a combo poisoned by one
    process lands on disk right away; **pull on plan miss** —
    ``plan()``/``plan_batched()`` call :meth:`refresh` before giving up
    on a cache miss, so a fresh bucket picks up selections and poison
    other processes pushed since this process loaded the file."""

    def __init__(self, path: Optional[str] = None, *,
                 lock_timeout_s: Optional[float] = None,
                 quarantine_ttl_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        self.path = path or _default_cache_path()
        self._entries: Optional[dict] = None
        # bumped whenever a memoized plan may have been invalidated
        # (autotune upgrades, clears, pulled quarantines) — keyed into
        # the plan memo
        self.version = 0
        # serializes in-process access (threads may share one cache
        # object); the fcntl file lock covers cross-process
        self._mu = threading.RLock()
        if lock_timeout_s is None:
            lock_timeout_s = float(os.environ.get(
                "REPRO_AUTOTUNE_LOCK_TIMEOUT_S", "0.5"))
        self.lock_timeout_s = lock_timeout_s
        if quarantine_ttl_s is None:
            quarantine_ttl_s = float(os.environ.get(
                "REPRO_QUARANTINE_TTL_S", "3600"))
        self.quarantine_ttl_s = quarantine_ttl_s
        self.clock = clock
        # (st_mtime_ns, st_size, st_ino) of the last disk state we
        # parsed — lets refresh() skip the JSON re-parse when nothing
        # was flushed since (the plan-miss pull runs per miss)
        self._disk_stat: Optional[tuple] = None
        # schema version of the file as loaded (pre-migration), for
        # inspection tools; None until the file is first read
        self.loaded_schema_version: Optional[int] = None

    def _migrate(self, data: dict) -> dict:
        """Normalize entries from any prior schema version in place.

        Migration is strictly additive — a version bump must never
        discard winner entries another (older) process wrote:
          * selection entries (winner-only v1 or timing-vectored v2)
            pass through unchanged;
          * v1 quarantine records carry no per-combo timestamps; they
            are stamped *now* so a combo poisoned before TTLs existed
            gets one full TTL from this load instead of being poisoned
            forever."""
        now = float(self.clock())
        for k, v in data.items():
            if not k.startswith(_QUAR_PREFIX):
                continue
            ts = v.setdefault("ts", {})
            for combo in v.get("combos", ()):
                ts.setdefault(combo, now)
        return data

    def _read_disk(self) -> Optional[dict]:
        """Parse + migrate the on-disk file; {} when missing, None when
        corrupt.  Records the file's stat identity for refresh()."""
        try:
            with open(self.path) as f:
                st = os.fstat(f.fileno())
                data = json.load(f)
        except FileNotFoundError:
            self._disk_stat = None
            return {}
        except (OSError, ValueError):
            return None
        if not isinstance(data, dict):
            return None
        self._disk_stat = (st.st_mtime_ns, st.st_size, st.st_ino)
        schema = data.pop(_SCHEMA_KEY, None)
        self.loaded_schema_version = int(schema.get("version", 1)) \
            if isinstance(schema, dict) else 1
        return self._migrate(
            {k: v for k, v in data.items() if isinstance(v, dict)})

    def _load(self) -> dict:
        if self._entries is None:
            disk = self._read_disk()
            if disk is None:
                # corrupted/truncated: preserve the evidence, start empty
                try:
                    os.replace(self.path, self.path + ".corrupt")
                except OSError:
                    pass
                disk = {}
            self._entries = disk
        return self._entries

    def get(self, key: str) -> Optional[dict]:
        with self._mu:
            return self._load().get(key)

    def put(self, key: str, engine: str, source: str,
            backend: Optional[str] = None, *,
            timings: Optional[dict] = None,
            features: Optional[dict] = None) -> None:
        """Record a selection; autotune sweeps additionally log the FULL
        per-candidate timing vector (``timings``: combo string ->
        seconds) and the feature dict that drove it."""
        with self._mu:
            entry: dict[str, Any] = {"engine": engine, "source": source}
            if backend is not None:
                entry["backend"] = backend
            if timings:
                entry["timings"] = {k: float(v) for k, v in timings.items()}
            if features:
                entry["features"] = {k: (float(v) if isinstance(v, float)
                                         else int(v))
                                     for k, v in features.items()}
            self._load()[key] = entry
            if source == "autotune":
                self.version += 1
            self._flush()

    def entries(self) -> dict:
        """Snapshot of every record (selections + ``!quarantine:`` keys)."""
        with self._mu:
            return {k: dict(v) for k, v in self._load().items()}

    # -- quarantine: poisoned (engine, backend) combos per shape bucket --

    def _quarantine_ttl(self, q: dict, combo: str) -> float:
        """Effective TTL for a combo: the base TTL doubled per strike
        (capped at 16x) — the re-probe budget."""
        strikes = int(q.get("strikes", {}).get(combo, 1))
        return self.quarantine_ttl_s * min(2.0 ** (strikes - 1), 16.0)

    def _quarantine_active(self, q: dict, combo: str) -> bool:
        """Whether a combo is currently poisoned (listed and unexpired).

        An expired combo is *re-admitted*: dropped from the active list
        (its strike count survives, so a re-crash re-quarantines it for
        longer) lazily here rather than by a sweeper.  The removal is
        in-memory only — the next flush persists it."""
        if combo not in q.get("combos", ()):
            return False
        ts = q.get("ts", {}).get(combo)
        if ts is None:  # unmigrated record mid-merge: stamp, stay active
            q.setdefault("ts", {})[combo] = float(self.clock())
            return True
        if float(self.clock()) - float(ts) < self._quarantine_ttl(q, combo):
            return True
        q["combos"] = [c for c in q["combos"] if c != combo]
        q.get("ts", {}).pop(combo, None)
        return False

    def quarantine(self, key: str, engine: str,
                   backend: Optional[str] = None,
                   reason: str = "") -> None:
        """Mark (engine, backend) poisoned for this shape bucket.

        A kernel that crashes (or returns garbage) for a bucket must not
        be re-selected on the next plan: quarantined combos are skipped
        by cache hits, heuristic selection and autotune sweeps.  With
        ``backend=None`` the engine is poisoned for every backend.  Each
        combo carries a timestamp and the quarantine expires after
        ``quarantine_ttl_s`` (doubled per repeat offense)."""
        with self._mu:
            entries = self._load()
            qk = _QUAR_PREFIX + key
            q = entries.setdefault(qk, {"combos": []})
            combo = combo_str(engine, backend)
            if combo not in q["combos"]:
                q["combos"].append(combo)
            q.setdefault("ts", {})[combo] = float(self.clock())
            strikes = q.setdefault("strikes", {})
            strikes[combo] = int(strikes.get(combo, 0)) + 1
            if reason:
                q.setdefault("reasons", {})[combo] = reason
            # a selection entry routing to the poisoned combo is dropped
            # so the next plan re-selects among healthy candidates
            sel = entries.get(key)
            if sel is not None and sel.get("engine") == engine and \
                    backend in (None, sel.get("backend")):
                entries.pop(key)
            self.version += 1  # invalidate memoized plans
            self._flush()

    def is_quarantined(self, key: str, engine: str,
                       backend: Optional[str] = None) -> bool:
        with self._mu:
            q = self._load().get(_QUAR_PREFIX + key)
            if not q:
                return False
            return (self._quarantine_active(q, combo_str(engine, backend))
                    or self._quarantine_active(q, combo_str(engine, None)))

    def quarantined(self, key: str) -> list[tuple[str, Optional[str]]]:
        """The (engine, backend) combos actively quarantined for a
        bucket (expired combos are re-admitted, not listed)."""
        with self._mu:
            q = self._load().get(_QUAR_PREFIX + key, {})
            return [split_combo(c) for c in list(q.get("combos", ()))
                    if self._quarantine_active(q, c)]

    def _lock_file(self):
        """Open + exclusively lock ``<path>.lock``.

        Returns the locked file object, ``None`` when locking is
        unavailable (no ``fcntl``, open failure — the unlocked merge
        proceeds), or the :data:`_LOCK_TIMEOUT` sentinel when a live
        holder kept the lock past ``lock_timeout_s`` — the caller skips
        the flush rather than stalling behind a hung peer.  Purely
        best-effort: any failure degrades to a skipped or unlocked
        merge, never to a failed multiply."""
        if fcntl is None:
            return None
        try:
            f = open(self.path + ".lock", "a")
        except OSError:
            return None
        deadline = time.monotonic() + max(0.0, self.lock_timeout_s)
        while True:
            try:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                return f
            except OSError:
                if time.monotonic() >= deadline:
                    try:
                        f.close()
                    except OSError:
                        pass
                    return _LOCK_TIMEOUT
                time.sleep(0.01)

    def _merge_from(self, disk: dict) -> bool:
        """Merge on-disk entries into memory; True when anything changed.

        Entries concurrent processes flushed since we loaded are kept;
        their measured plans beat our heuristics (quarantine records
        merge by union — a combo poisoned by any process stays
        poisoned).  After the merge, selections routing to poisoned
        combos are swept."""
        changed = False
        for k, v in disk.items():
            ours = self._entries.get(k)
            if k.startswith(_QUAR_PREFIX):
                if ours is None:
                    self._entries[k] = v
                    changed = True
                else:
                    for c in v.get("combos", ()):
                        if c not in ours["combos"]:
                            ours["combos"].append(c)
                            changed = True
                    # timestamps merge by max (the most recent poisoning
                    # wins the TTL clock), strike counts by max
                    for fld in ("ts", "strikes"):
                        theirs = v.get(fld, {})
                        mine = ours.setdefault(fld, {})
                        for c, val in theirs.items():
                            if float(val) > float(mine.get(c, -math.inf)):
                                mine[c] = val
                                changed = True
                continue
            if ours is None or (v.get("source") == "autotune"
                                and ours.get("source") != "autotune"):
                if ours != v:
                    self._entries[k] = v
                    changed = True
            elif ours.get("source") == v.get("source"):
                # same-rank entries: union in the dataset fields a peer
                # recorded that we lack — measurements are never discarded
                for fld in ("timings", "features"):
                    if fld in v and fld not in ours:
                        ours[fld] = v[fld]
                        changed = True
                theirs_t = v.get("timings")
                ours_t = ours.get("timings")
                if theirs_t and ours_t:
                    for c, t in theirs_t.items():
                        if c not in ours_t:
                            ours_t[c] = t
                            changed = True
        for qk, q in list(self._entries.items()):
            if not qk.startswith(_QUAR_PREFIX):
                continue
            sk = qk[len(_QUAR_PREFIX):]
            sel = self._entries.get(sk)
            if sel is None:
                continue
            eng = sel.get("engine", "")
            if (self._quarantine_active(q, combo_str(eng,
                                                       sel.get("backend")))
                    or self._quarantine_active(q, combo_str(eng, None))):
                self._entries.pop(sk, None)
                changed = True
        return changed

    def refresh(self) -> bool:
        """Pull entries other processes flushed since our last read.

        Merges the current on-disk state into memory without writing
        anything back; bumps :attr:`version` when the merge changed
        anything, so memoized plans built on the stale view are
        invalidated.  Returns whether anything changed."""
        with self._mu:
            if self._entries is None:
                self._load()
                return True
            # stat short-circuit: the pull runs on every plan-cache
            # miss, so an unchanged file must cost a stat, not a parse
            try:
                st = os.stat(self.path)
                if self._disk_stat == (st.st_mtime_ns, st.st_size,
                                       st.st_ino):
                    return False
            except OSError:
                pass
            disk = self._read_disk()
            if not disk:
                return False
            changed = self._merge_from(disk)
            if changed:
                self.version += 1
            return changed

    def _flush(self, merge: bool = True) -> None:
        """Merge the on-disk entries in and publish the result; callers
        hold ``self._mu``.  ``merge=False`` writes the in-memory view
        verbatim — maintenance rewrites (``compact --drop-timings``)
        that must NOT re-union the on-disk dataset fields they just
        stripped."""
        tmp = None
        lock = None
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            lock = self._lock_file()
            if lock is _LOCK_TIMEOUT:
                # a hung (not dead) holder: skip this flush — the
                # entries stay in memory and the next flush retries
                lock = None
                return
            fi.fire("autotune.flush", path=self.path)
            if merge:
                self._merge_from(self._read_disk() or {})
            fd, tmp = tempfile.mkstemp(
                dir=os.path.dirname(self.path) or ".",
                prefix=os.path.basename(self.path) + ".tmp.")
            payload = {_SCHEMA_KEY: {"version": SCHEMA_VERSION},
                       **self._entries}
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=0, sort_keys=True)
            os.replace(tmp, self.path)
            try:
                st = os.stat(self.path)
                self._disk_stat = (st.st_mtime_ns, st.st_size, st.st_ino)
            except OSError:
                self._disk_stat = None
        except Exception:
            # the cache is an optimization; never fail the multiply over
            # it (OSError, a scribbled-on file, or an injected write fault)
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        finally:
            if lock is not None:
                try:
                    fcntl.flock(lock.fileno(), fcntl.LOCK_UN)
                    lock.close()
                except OSError:
                    pass

    def clear(self) -> None:
        """Drop all entries, in memory and on disk (no merge-back)."""
        with self._mu:
            self._entries = {}
            self._disk_stat = None
            self.version += 1
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __len__(self) -> int:
        with self._mu:
            return len(self._load())


_default_cache: Optional[AutotuneCache] = None


def default_cache() -> AutotuneCache:
    global _default_cache
    if _default_cache is None:
        _default_cache = AutotuneCache()
    return _default_cache


# ---------------------------------------------------------------------------
# learned cost-model selection (models/dispatch_model.py artifacts)
# ---------------------------------------------------------------------------

# the model artifact lives NEXT TO the cache file it was trained from:
# the cache is the dataset, the model is its fitted view, and serving
# processes that share the cache path automatically share the model
MODEL_SUFFIX = ".model.json"


def model_path_for(cache: AutotuneCache) -> str:
    """Default on-disk path of the dispatch model trained from ``cache``."""
    return cache.path + MODEL_SUFFIX


_model_mu = threading.Lock()
# path -> (mtime_ns, model-or-None): a retrained artifact (new mtime) is
# picked up on the next plan without a restart; a corrupt one caches as
# None so selection does not re-parse it per plan
_model_memo: dict[str, tuple[int, Any]] = {}


def _artifact_mtime_ns(path: str) -> Optional[int]:
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return None


def resolve_model(model, cache: AutotuneCache):
    """Resolve plan()'s ``model`` request to a DispatchModel or None.

    ``"auto"`` loads (and memoizes, keyed on file mtime) the artifact
    next to the cache file — absent or unreadable artifacts resolve to
    None and selection falls through to measurement/heuristics; a
    DispatchModel instance is used as-is; False/None disables."""
    if model in (False, None):
        return None
    if model != "auto":  # an explicit DispatchModel (tests, notebooks)
        return model
    path = model_path_for(cache)
    mtime = _artifact_mtime_ns(path)
    if mtime is None:
        return None
    with _model_mu:
        hit = _model_memo.get(path)
        if hit is not None and hit[0] == mtime:
            return hit[1]
    from repro_torch.models import dispatch_model as dm
    try:
        loaded = dm.DispatchModel.load(path)
    except Exception:
        # a corrupt/foreign artifact must never fail a plan
        loaded = None
    with _model_mu:
        _model_memo[path] = (mtime, loaded)
    return loaded


def _model_token(model, cache: AutotuneCache) -> Optional[tuple]:
    """Hashable identity of the model a plan would consult — keyed into
    the plan memo so a retrained artifact invalidates memoized plans."""
    if model in (False, None):
        return None
    if model != "auto":
        return ("obj", id(model))
    return ("file", _artifact_mtime_ns(model_path_for(cache)))


def _model_candidates(key: str, backend: str, cache: AutotuneCache,
                      device) -> set:
    """Combo strings ("engine|backend") legal for this request on
    ``device``: every candidate the autotune sweep would measure there
    (``_measure_candidates``) minus quarantined combos, and on a card
    minus the engines that compute on the host, so that the model never
    moves a card's multiply to the CPU.  A pinned backend restricts
    backend-aware engines to it, exactly like the sweep.

    One ``quarantined()`` snapshot instead of per-combo
    ``is_quarantined`` checks: this runs on the plan hot path and each
    check is a lock round-trip."""
    poisoned = {combo_str(e, b) for e, b in cache.quarantined(key)}
    on_card = torch.device(device).type == "cuda"
    allowed = set()
    for name, bk_name in _measure_candidates(backend, device):
        if on_card and _REGISTRY[name].on_host:
            continue
        c = combo_str(name, bk_name)
        # an engine-wide quarantine (backend=None) poisons every backend
        if c in poisoned or combo_str(name, None) in poisoned:
            continue
        allowed.add(c)
    return allowed


def _model_select(model, feats: dict, key: str, backend: str,
                  cache: AutotuneCache, device):
    """One model-based selection attempt; None when the model abstains
    (no healthy candidate it knows, or a prediction failure)."""
    if model is None:
        return None
    try:
        return model.select(feats, allowed=_model_candidates(
            key, backend, cache, device))
    except Exception:
        return None  # a broken model must never fail a plan


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _measure(spec: EngineSpec, A: CSR, B: CSR, repeat: int = 1,
             backend: Optional[str] = None, device=None) -> float:
    """Seconds of the best of ``repeat`` calls, each timed as a user pays
    for it: the host clock around one call that ends, on a card, in
    ``torch.cuda.synchronize()``.  The kernels are built and loaded
    before the first timed call, so a sweep's first candidate does not
    time the build."""
    device = resolve_device(device)
    kw = {"device": device}
    if backend is not None:
        kw["backend"] = backend
    on_card = device.type == "cuda"
    if on_card:
        kb.load()
    best = math.inf
    for _ in range(repeat):
        fi.fire("dispatch.measure", engine=spec.name, backend=backend)
        t0 = time.perf_counter()
        out = spec.fn(A, B, **kw)
        if spec.returns_stats:
            out = out[0]
        if on_card:
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_candidates(backend: str, device,
                        ) -> list[tuple[str, Optional[str]]]:
    """(engine, backend) pairs autotune times on ``device``.  With
    ``backend="auto"`` the backend becomes part of the search space:
    every backend-aware engine is measured once per kernel backend
    measurable there (``kb.measurable_backends(device)`` — ``cuda`` on
    a card, never the plain ``torch`` tier; ``torch`` on the CPU).  A
    pinned backend is measured as-is."""
    cands: list[tuple[str, Optional[str]]] = []
    for name, spec in _REGISTRY.items():
        if not spec.measure:
            continue
        if not spec.backend_aware:
            cands.append((name, None))
        elif backend == "auto":
            cands.extend((name, bk.name)
                         for bk in kb.measurable_backends(device))
        else:
            cands.append((name, kb.resolve_backend(backend, device).name))
    return cands


# ---------------------------------------------------------------------------
# plan / execute dispatch
# ---------------------------------------------------------------------------

def _filter_kwargs(fn: Callable, kw: dict) -> dict:
    """Keep only kwargs ``fn`` accepts (everything, if it takes **kw).

    Auto-selection may route to any engine, so engine-specific kwargs
    (e.g. spz's ``R``) must not crash a plan that picked a different
    engine; explicitly named engines still get strict kwargs.  Runs once
    at *plan* time — execution never re-inspects signatures."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return kw
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        return kw
    names = {p.name for p in params}
    return {k: v for k, v in kw.items() if k in names}


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything selection decides about a multiply, frozen and hashable.

    A plan captures the engine choice, the kwargs resolved against that
    engine's signature (the device and, for backend-aware engines, the
    kernel backend among them), and the operand structure (shapes, nnz
    work bucket, batch lane count) — ``jit_key`` is the identity of the
    launches execution lands on.  Plans are inspectable (``engine``,
    ``source``, ``rule``), reusable across calls whose operands match
    the planned structure, and cacheable by hash."""

    engine: str                 # resolved engine (post fallback remap)
    batched: bool               # single CSR pair vs BatchedCSR lanes
    a_shape: tuple
    b_shape: tuple
    kwargs: tuple               # sorted (name, value) pairs, plan-resolved
    work_bucket: tuple          # (nnz bucket A, nnz bucket B)
    cache_key: str              # autotune-cache key the selection used
    # "explicit" | "heuristic" | "cache" | "model" | "autotune" | "fallback"
    source: str
    rule: Optional[str] = None  # heuristic rule that fired (source="heuristic")
    batch: Optional[int] = None  # lane capacity (batched plans only)
    backend: Optional[str] = None  # resolved kernel backend (aware engines)

    @property
    def kwargs_dict(self) -> dict:
        return dict(self.kwargs)

    @property
    def jit_key(self) -> tuple:
        """Static identity of the launches this plan routes to: engine +
        kernel backend + operand structure + resolved kwargs (the device
        among them)."""
        return (self.engine, self.backend, self.batched, self.batch,
                self.a_shape, self.b_shape, self.work_bucket, self.kwargs)


def _sorted_kwargs(kw: dict) -> tuple:
    return tuple(sorted(kw.items()))


def _plan_backend_name(engine: str, backend: str,
                       device) -> Optional[str]:
    """The backend name a plan for ``engine`` on ``device`` would resolve
    ``backend`` to — for quarantine checks *before* the plan is built.
    None for non-backend-aware engines or unknown requests."""
    spec = _REGISTRY.get(engine)
    if spec is None or not spec.backend_aware:
        return None
    try:
        return kb.resolve_backend(backend, device).name
    except ValueError:
        return None


def _dequarantine(selected: str, key: str, backend: str,
                  cache: "AutotuneCache", device) -> tuple[str, bool]:
    """If the selected engine is quarantined for this bucket, walk
    ``device``'s degradation order to the first healthy engine.  Returns
    (engine, was_remapped)."""
    if not cache.is_quarantined(key, selected,
                                _plan_backend_name(selected, backend,
                                                   device)):
        return selected, False
    for eng, _ in degrade_chain(device):
        if eng != selected and not cache.is_quarantined(
                key, eng, _plan_backend_name(eng, backend, device)):
            return eng, True
    return selected, False  # everything poisoned: keep the original pick


def _resolve_plan_backend(spec: EngineSpec, backend: str,
                          cached: Optional[str], kw: dict, device, *,
                          strict: bool = True) -> tuple[Optional[str], dict]:
    """Fold the kernel backend into an engine's plan-time kwargs.

    Backend-aware engines get ``kwargs["backend"] = <resolved name>``
    (cache/autotune outcome beats the "auto" default; an explicit pin
    always wins); other engines carry no backend.  Requesting a pinned
    backend for an explicitly named engine that cannot use one is a
    planning error; under auto selection (``strict=False``) the pin is
    simply irrelevant to a non-aware winner and is dropped.

    A ``cached`` backend name comes from the shared on-disk cache and is
    NOT trusted blindly: a name that is not one the autotune sweep would
    measure on ``device`` (:func:`kb.measurable_backends`) falls back to
    the "auto" default — an unknown name (a foreign file's ``pallas`` or
    ``xla``, version skew), ``cuda`` replayed on the CPU, or the plain
    ``torch`` tier replayed on a card.  A cache hit must never raise or
    degrade execution."""
    if not spec.backend_aware:
        if backend != "auto" and strict:
            raise ValueError(
                f"engine {spec.name!r} does not take a kernel backend "
                f"(requested {backend!r})")
        return None, kw
    name = None
    if backend == "auto" and cached is not None and cached in {
            bk.name for bk in kb.measurable_backends(device)}:
        name = cached
    if name is None:
        name = kb.resolve_backend(backend, device).name
    kw = dict(kw)
    kw["backend"] = name
    return name, kw


def plan(A: CSR, B: CSR, engine: str = "auto", *,
         backend: str = "auto",
         device=None,
         autotune: bool = False,
         cache: Optional[AutotuneCache] = None,
         rules: Sequence[HeuristicRule] = DEFAULT_HEURISTICS,
         model: Any = "auto",
         **kw) -> ExecutionPlan:
    """Select an engine and resolve kwargs for ``A @ B`` without running it.

    engine:  a registered name, or "auto" to select by cached plan /
             heuristic features / measurement.
    backend: kernel-backend request for the stream primitives — "cuda",
             "torch" or "auto" (cuda on a CUDA device, torch on the
             CPU).  Resolved HERE, once: the chosen backend rides in the
             plan's kwargs/``jit_key`` and suffixes the autotune-cache
             key, so a pinned backend autotunes its own bucket.
    device:  where the multiply runs: the card unless the caller names
             another device (``device="cpu"``); resolved here and kept
             in the plan's kwargs.
    autotune: with engine="auto", time every registered engine (and, for
             backend-aware engines, every measurable backend) on this
             input once and cache the winner for the shape/nnz bucket.
    cache:   AutotuneCache override (default: process-wide disk cache).
             Non-default ``rules`` bypass the cache entirely.
    model:   learned-selection request.  "auto" (default) consults the
             trained dispatch model artifact next to the cache file, if
             one exists; a DispatchModel instance uses it directly;
             False/None disables learned selection.  The model sits
             between cache-hit and measurement in the ladder: a
             confident prediction among the combos measurable on
             ``device`` plans immediately (``source="model"``), a
             low-confidence one falls through to measurement
             (``autotune=True``) or heuristics.

    Repeat plans on the *same matrix objects* are memoized on operand
    identity and skip selection entirely."""
    if A.n_cols != B.n_rows:
        raise ValueError(f"inner dims differ: {A.shape} @ {B.shape}")
    dev = resolve_device(device)
    kb.resolve_backend(backend, dev)  # validate the request up front
    use_cache = rules is DEFAULT_HEURISTICS
    if cache is None:  # NB: `or` would drop an *empty* caller cache
        cache = default_cache()
    memo_extra = None
    if engine == "auto" and use_cache and cache is default_cache():
        try:
            memo_extra = ("plan", backend, dev, autotune, cache.version,
                          _model_token(model, cache), _sorted_kwargs(kw))
            hit = _plan_memo.get(A, B, memo_extra)
            if hit is not None:
                return hit
        except TypeError:  # unhashable kwarg value: skip the memo
            memo_extra = None
    # structural screen sits behind the memo: repeat plans on validated
    # operands (the serving steady state) skip the O(nnz) host checks
    validate_operands(A, B)
    key = cache_key(A, B, backend=backend)
    selected, source, rule, sel_bk = engine, "explicit", None, None
    if engine == "auto":
        hit = cache.get(key) if use_cache else None
        if hit is None and use_cache:
            # pull-on-plan-miss: another process may have measured (or
            # poisoned) this bucket since we loaded the file
            cache.refresh()
            hit = cache.get(key)
        if hit is not None and cache.is_quarantined(
                key, hit["engine"], hit.get("backend")):
            hit = None  # a poisoned prior selection must not be replayed
        if hit is not None and hit["engine"] not in _REGISTRY:
            hit = None  # a foreign file's engine: select anew
        if hit is not None and (hit["source"] == "autotune" or not autotune):
            selected, source = hit["engine"], "cache"
            sel_bk = hit.get("backend")
        else:
            # the learned-model rung: a cache miss asks the trained cost
            # model for an argmin over predicted runtimes.  A confident
            # prediction plans right here; a low-confidence one (or no
            # artifact) falls through to measurement / heuristics
            sel = None
            if use_cache:
                mdl = resolve_model(model, cache)
                sel = _model_select(mdl, extract_features(A, B), key,
                                    backend, cache, dev)
                if sel is not None and not sel.confident:
                    sel = None
            if sel is not None:
                selected, sel_bk, source = sel.engine, sel.backend, "model"
            elif autotune:
                timings: dict[tuple, float] = {}
                for name, bk_name in _measure_candidates(backend, dev):
                    if cache.is_quarantined(key, name, bk_name):
                        continue
                    try:
                        timings[(name, bk_name)] = _measure(
                            get_engine(name), A, B, backend=bk_name,
                            device=dev)
                    except kb.KERNEL_ERRORS:
                        raise  # a kernel that cannot run is a fault
                    except Exception as e:
                        # a candidate that dies mid-sweep is quarantined
                        # and the sweep continues on the healthy ones
                        cache.quarantine(key, name, bk_name,
                                         reason=f"{type(e).__name__}: {e}")
                if timings:
                    (selected, sel_bk), source = \
                        min(timings, key=timings.get), "autotune"
                    cache.put(key, selected, "autotune", backend=sel_bk,
                              timings={combo_str(n, b): t
                                       for (n, b), t in timings.items()},
                              features=extract_features(A, B))
                else:  # nothing measurable survived: heuristic fallback
                    selected, rule = choose_engine(extract_features(A, B),
                                                   rules)
                    selected, _ = _dequarantine(selected, key, backend,
                                                cache, dev)
                    source = "heuristic"
            else:
                selected, rule = choose_engine(extract_features(A, B),
                                               rules)
                source = "heuristic"
                if use_cache:
                    remapped, was_q = _dequarantine(selected, key, backend,
                                                    cache, dev)
                    if was_q:
                        selected, rule = remapped, "quarantine-fallback"
                    cache.put(key, selected, "heuristic")
    spec = get_engine(selected)
    resolved = _filter_kwargs(spec.fn, kw) if engine == "auto" else dict(kw)
    resolved["device"] = dev
    plan_bk, resolved = _resolve_plan_backend(spec, backend, sel_bk,
                                              resolved, dev,
                                              strict=engine != "auto")
    p = ExecutionPlan(engine=selected, batched=False,
                      a_shape=A.shape, b_shape=B.shape,
                      kwargs=_sorted_kwargs(resolved),
                      work_bucket=(_nnz_bucket(A), _nnz_bucket(B)),
                      cache_key=key, source=source, rule=rule,
                      backend=plan_bk)
    if memo_extra is not None:
        _plan_memo.put(A, B, memo_extra, p)
    return p


def execute(p: ExecutionPlan, A: CSR, B: CSR, *,
            return_stats: bool = False):
    """Run a plan against concrete operands.

    The operands must match the planned structure (shapes; the nnz
    bucket may drift).  A plan made once can be executed against every
    request with matching structure — the selection cost is paid at
    plan time only.  Never falls back to another engine: a failure
    raises (see :func:`execute_resilient`)."""
    if p.batched:
        raise ValueError("batched plan passed to execute(); "
                         "use execute_batched()")
    if A.shape != p.a_shape or B.shape != p.b_shape:
        raise ValueError(
            f"plan/operand mismatch: planned {p.a_shape} @ {p.b_shape}, "
            f"got {A.shape} @ {B.shape}")
    spec = get_engine(p.engine)
    fi.fire("dispatch.execute", engine=p.engine, backend=p.backend)
    out = spec.fn(A, B, **p.kwargs_dict)
    out, stats = out if spec.returns_stats else (out, None)
    out = fi.corrupt("dispatch.execute", out,
                     engine=p.engine, backend=p.backend)
    return (out, stats) if return_stats else out


# ---------------------------------------------------------------------------
# failure policies: deadline + retry + graceful degradation
# ---------------------------------------------------------------------------

# The degradation ladder (the serving analogue of the RISC-V SpGEMM
# fallback-to-scalar path): planned engine/backend first, then the tiers
# below, each removing a class of failure.  On the CPU, the reference's
# chain: the device-resident zipper pipeline on the plain torch tier, then
# vectorized ESC, then the dense-accumulator oracle (per-row accumulation
# on the host).  On a card, only what runs there without the plain
# versions of the kernels: the zipper pipeline on the kernels (the
# planned tier's autotuned choices and kwargs dropped), then ESC on the
# card.  Neither the plain tier nor the host stands in for a kernel.
DEGRADE_CHAIN: tuple[tuple[str, Optional[str]], ...] = (
    ("spz-fused", "torch"),
    ("esc", None),
    ("scl-array", None),
)
DEGRADE_CHAIN_CUDA: tuple[tuple[str, Optional[str]], ...] = (
    ("spz-fused", "cuda"),
    ("esc", None),
)


def degrade_chain(device) -> tuple[tuple[str, Optional[str]], ...]:
    """The degradation tiers of a plan on ``device``."""
    return (DEGRADE_CHAIN_CUDA if torch.device(device).type == "cuda"
            else DEGRADE_CHAIN)


class CorruptOutput(RuntimeError):
    """An engine returned structurally invalid output (non-finite values
    or out-of-range indices) without raising.  The resilience layer
    treats this exactly like a crash: retry, then degrade."""


class DeadlineExceeded(RuntimeError):
    """A resilient execution ran past its per-request deadline."""


class ExhaustedFallbacks(RuntimeError):
    """Every tier of the degradation ladder failed; ``report`` carries
    the per-attempt error trail."""

    def __init__(self, message: str, report: "ExecutionReport"):
        self.report = report
        super().__init__(message)


def check_result(out: CSR) -> None:
    """Structural screen of an engine's output, on the host over the
    first ``nnz`` entries only: non-finite payloads or out-of-range
    column indices raise :class:`CorruptOutput` so the degradation
    ladder treats silent garbage as a failed attempt."""
    nnz = _nnz(out)
    if nnz == 0:
        return
    data = out.data[:nnz].cpu().numpy()
    if not np.isfinite(data).all():
        raise CorruptOutput(f"non-finite values in output ({nnz} nnz)")
    idx = out.indices[:nnz].cpu().numpy()
    if int(idx.min()) < 0 or int(idx.max()) >= out.n_cols:
        raise CorruptOutput(
            f"output column index out of range [0, {out.n_cols})")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Failure policy for the resilient execute path.

    max_attempts:   attempts per tier (first try included).
    backoff_base_s / backoff_factor: deterministic exponential backoff
                    between same-tier retries (no jitter).
    deadline_s:     total budget measured on ``clock`` from the first
                    attempt; None disables the deadline.
    fallback:       (engine, backend) tiers walked after the planned
                    tier exhausts its retries; None: the plan's device's
                    chain (:func:`degrade_chain`).
    verify_output:  run :func:`check_result` on every result so silent
                    garbage counts as a failure.
    sleep / clock:  injectable for deterministic tests."""

    max_attempts: int = 3
    backoff_base_s: float = 0.005
    backoff_factor: float = 4.0
    deadline_s: Optional[float] = None
    fallback: Optional[tuple] = None
    verify_output: bool = True
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    def backoff_s(self, retry: int) -> float:
        """Backoff before retry number ``retry`` (1-based)."""
        return self.backoff_base_s * self.backoff_factor ** (retry - 1)


@dataclasses.dataclass
class ExecutionReport:
    """What actually served a resilient execution: the tier, the attempt
    count, and the error trail that got it there."""

    tier: int                    # 0 = the planned engine/backend
    engine: str
    backend: Optional[str]
    attempts: int                # total attempts across all tiers
    errors: list = dataclasses.field(default_factory=list)
    quarantined: list = dataclasses.field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return self.tier > 0

    @property
    def tier_label(self) -> str:
        if self.tier == 0:
            return "planned"
        bk = f"/{self.backend}" if self.backend else ""
        return f"degraded:{self.engine}{bk}"


def fallback_plan(p: ExecutionPlan, engine: str,
                  backend: Optional[str]) -> ExecutionPlan:
    """Re-target a plan at a degradation tier: same operand structure and
    device, fallback engine/backend, kwargs re-filtered against the new
    engine's signature."""
    spec = get_engine(engine)
    kw = {k: v for k, v in p.kwargs_dict.items() if k != "backend"}
    kw = _filter_kwargs(spec.fn, kw)
    bk = None
    if spec.backend_aware:
        bk = kb.resolve_backend(backend or "auto", kw["device"]).name
        kw["backend"] = bk
    return dataclasses.replace(p, engine=engine, backend=bk,
                               kwargs=_sorted_kwargs(kw),
                               source="fallback", rule=None)


def execute_resilient(p: ExecutionPlan, A: CSR, B: CSR, *,
                      policy: Optional[RetryPolicy] = None,
                      cache: Optional[AutotuneCache] = None,
                      return_stats: bool = False):
    """Run a plan under the failure policy: bounded same-tier retries
    with exponential backoff, a per-request deadline, and graceful
    degradation down the plan's device's :func:`degrade_chain`.

    Returns ``(result, report)`` (or ``((result, stats), report)`` with
    ``return_stats``); the report records which tier actually served.
    A tier that exhausts its retries has its (engine, backend, bucket)
    combo quarantined in the autotune cache.  Raises
    :class:`ExhaustedFallbacks` when every tier fails, or
    :class:`DeadlineExceeded` when the budget runs out first.  A kernel
    that fails to build or launch, or a fault the card reports
    (``kb.KERNEL_ERRORS``), is raised at once: no tier retries it."""
    policy = policy or RetryPolicy()
    if cache is None:
        cache = default_cache()
    start = policy.clock()
    fallback = policy.fallback
    if fallback is None:
        fallback = degrade_chain(p.kwargs_dict["device"])
    tiers: list[tuple[str, Optional[str]]] = [(p.engine, p.backend)]
    for eng, bk in fallback:
        if (eng, bk) != tiers[0]:
            tiers.append((eng, bk))
    report = ExecutionReport(tier=0, engine=p.engine, backend=p.backend,
                             attempts=0)

    def out_of_time() -> bool:
        return (policy.deadline_s is not None
                and policy.clock() - start >= policy.deadline_s)

    for tier_i, (eng, bk) in enumerate(tiers):
        tp = p if tier_i == 0 else fallback_plan(p, eng, bk)
        report.tier, report.engine, report.backend = tier_i, eng, tp.backend
        for attempt in range(1, policy.max_attempts + 1):
            if out_of_time():
                raise DeadlineExceeded(
                    f"deadline {policy.deadline_s}s exceeded after "
                    f"{report.attempts} attempts "
                    f"(errors: {report.errors})")
            report.attempts += 1
            try:
                out = execute(tp, A, B, return_stats=return_stats)
                if policy.verify_output:
                    check_result(out[0] if return_stats else out)
                return out, report
            except kb.KERNEL_ERRORS:
                raise
            except Exception as e:
                report.errors.append(
                    f"{tp.engine}/{tp.backend or '-'}#{attempt}: "
                    f"{type(e).__name__}: {e}")
                if attempt < policy.max_attempts and not out_of_time():
                    policy.sleep(policy.backoff_s(attempt))
        # tier exhausted: poison this combo for the bucket so replanning
        # does not walk straight back into the crashing kernel
        cache.quarantine(p.cache_key, eng, tp.backend,
                         reason=report.errors[-1])
        report.quarantined.append((eng, tp.backend))
    raise ExhaustedFallbacks(
        f"all {len(tiers)} tiers failed after {report.attempts} attempts "
        f"(errors: {report.errors})", report)


def spgemm(A: CSR, B: CSR, engine: str = "auto", *,
           backend: str = "auto",
           device=None,
           autotune: bool = False,
           cache: Optional[AutotuneCache] = None,
           rules: Sequence[HeuristicRule] = DEFAULT_HEURISTICS,
           model: Any = "auto",
           return_stats: bool = False,
           **kw):
    """Multiply two padded CSR matrices through the engine registry.

    Exactly ``execute(plan(A, B, ...), A, B)`` — see :func:`plan` for
    the selection knobs and :func:`execute` for the run semantics.  Runs
    on the card unless ``device`` names another device; returns the CSR
    on that device (and the engine's stats with ``return_stats``)."""
    p = plan(A, B, engine, backend=backend, device=device,
             autotune=autotune, cache=cache, rules=rules, model=model, **kw)
    return execute(p, A, B, return_stats=return_stats)


def explain(A: CSR, B: CSR,
            rules: Sequence[HeuristicRule] = DEFAULT_HEURISTICS, *,
            backend: str = "auto",
            device=None,
            cache: Optional[AutotuneCache] = None,
            model: Any = "auto") -> dict:
    """Dry-run selection: features + the rule and engine 'auto' would pick
    (ignoring any cached *engine* plan) — for benchmarks and debugging.

    ``backend`` is the kernel backend a plan for this (engine, request)
    would run on ``device`` — an autotuned backend recorded for the
    bucket beats the "auto" default, exactly as in :func:`plan`; ``None``
    for engines that take no kernel backend.  ``model`` is the learned
    dispatch view of the same request when a trained model resolves:
    predicted winner, calibrated confidence, whether that clears the
    confidence floor (whether :func:`plan` would take it), predicted
    costs in seconds per combo measurable on ``device``, and the
    artifact version; ``None`` when no model is available."""
    dev = resolve_device(device)
    feats = extract_features(A, B)
    engine, rule = choose_engine(feats, rules)
    key = cache_key(A, B, backend=backend)
    if cache is None:
        cache = default_cache()
    hit = cache.get(key)
    cached_bk = hit.get("backend") if hit else None
    plan_bk, _ = _resolve_plan_backend(get_engine(engine), backend,
                                       cached_bk, {}, dev, strict=False)
    mdl = resolve_model(model, cache)
    sel = _model_select(mdl, feats, key, backend, cache, dev)
    model_info = None
    if sel is not None:
        model_info = {"engine": sel.engine, "backend": sel.backend,
                      "confidence": sel.confidence,
                      "confident": sel.confident,
                      "costs": dict(sel.costs),
                      "version": getattr(mdl, "version", None)}
    return {"engine": engine, "rule": rule, "backend": plan_bk,
            "features": feats, "cache_key": key, "model": model_info}


# ---------------------------------------------------------------------------
# batched execution
# ---------------------------------------------------------------------------

def _pow2_at_least(n: int) -> int:
    return 1 << max(4, int(n - 1).bit_length())


def _lane_ok(A: BatchedCSR, B: BatchedCSR) -> np.ndarray:
    return A.valid.cpu().numpy() & B.valid.cpu().numpy()


def _esc_batched(A: BatchedCSR, B: BatchedCSR,
                 cap_products: Optional[int] = None, *, device=None) -> list:
    """ESC over a batch, lane by lane on ``device`` at one shared
    power-of-two product capacity.  Returns one CSR per lane (None for
    an invalid lane)."""
    fi.fire("kernel.batched", engine="esc", lanes=A.batch)
    device = resolve_device(device)
    if cap_products is None:
        works = [int(sg.row_work(a, B[i]).sum()) for i, a in A.lanes()]
        cap_products = _pow2_at_least(max(works + [1]))
    lane_ok = _lane_ok(A, B)
    A, B = A.to(device), B.to(device)
    shape = (A.n_rows, B.n_cols)
    outs = []
    for i in range(A.batch):
        if not lane_ok[i]:
            outs.append(None)
            continue
        r, c, v, valid, _ = sg.esc_core_impl(
            A.indptr[i], A.indices[i], A.data[i], B.indptr[i], B.indices[i],
            B.data[i], cap_products, A.n_rows, B.n_cols)
        # the valid slots are sorted by (row, col) and unique
        outs.append(sg.sorted_coo_to_csr(r[valid], c[valid], v[valid],
                                         shape))
    return outs


def _spz_batched(A: BatchedCSR, B: BatchedCSR, *, R: int = 16,
                 S: Optional[int] = None, rsort: bool = False,
                 backend="auto", driver: str = "fused",
                 device=None, stats: Optional[sg.SpzStats] = None) -> list:
    """Batched SparseZipper driver: rows from *every* valid lane are packed
    into shared lock-step groups of S streams.  The default "fused" driver
    feeds each group through the device-resident pipeline straight from
    the stacked BatchedCSR arrays (each stream's lane id indexes the
    batch axis: K3's expand entry on the card, or past L = 8,192 the
    expansion and K1 + K2 per merge round); ``driver="host"`` keeps the
    chunk-at-a-time lock-step loop (K4/K5).  Every bucket's output stays
    on the device and the whole call is assembled once, split per lane.
    Returns one CSR per lane (None for an invalid lane).  With ``stats``,
    the call's counters are added into it (the merge counters read from
    the card once, at the end), as one single-matrix call of the same
    rows in the same lock-step groups counts them."""
    S = S or 32 * R
    if driver not in ("fused", "host"):
        raise ValueError(f"unknown spz driver {driver!r}; use 'fused'|'host'")
    fi.fire("kernel.batched", engine="spz", driver=driver, lanes=A.batch)
    device = resolve_device(device)
    bk = kb.resolve_backend(backend, device)  # unknown names raise
    count = stats is not None
    stats = stats if count else sg.SpzStats()
    lane_ok = _lane_ok(A, B)
    valid_lanes = [i for i in range(A.batch) if lane_ok[i]]
    items = [(i, r) for i in valid_lanes for r in range(A.n_rows)]
    work = None
    if rsort or driver == "fused":
        work = {i: sg.row_work(A[i], B[i]) for i in valid_lanes}
    if rsort:
        items.sort(key=lambda it: int(work[it[0]][it[1]]))
    A, B = A.to(device), B.to(device)
    coo: list = []
    totals = torch.zeros(4, dtype=torch.int64, device=device) \
        if count else None
    if driver == "fused":
        mats = (A.indptr, A.indices, A.data, B.indptr, B.indices, B.data)
        geometry = sg.geometry_once(mats)
        for g0 in range(0, len(items), S):
            group = items[g0:g0 + S]
            plens = np.array([work[ln][r] for ln, r in group], np.int64)
            merged = sg.fused_process_group(group, plens, mats, R, bk,
                                            stats, coo, geometry)
            if count and merged is not None:
                totals += merged
        if count:
            totals[2] += totals[3]
            n_zip, zip_elems, tails = totals[:3].tolist()
            sg.fold_merge_counters(stats, n_zip, zip_elems, tails)
    else:
        # only the host driver walks per-lane numpy copies
        lanes = {i: (*csr_to_numpy(A[i]), *csr_to_numpy(B[i]))
                 for i in valid_lanes}
        for g0 in range(0, len(items), S):
            group = items[g0:g0 + S]
            products = []
            for lane, row in group:
                products.extend(sg.expand_group([row], *lanes[lane]))
            parts = sg.sort_phase(products, R, len(group), bk, stats,
                                  cap_s=S, device=device)
            acc = torch.zeros((3, len(group)), dtype=torch.int64,
                              device=device)
            final = sg.merge_tree_host(parts, R, bk, stats, acc)
            if final is not None:
                ids = sg.to_device(np.array(group, np.int64).T.copy(),
                                   device)
                coo.append((ids[1], ids[0], *final[:3]))
                if count:
                    totals[:3] += acc.sum(1)
        if count:
            zip_elems, tails, worked = totals[:3].tolist()
            sg.fold_merge_counters(stats, worked, zip_elems, tails)
    by_lane = sg.coo_parts_to_lanes(coo, valid_lanes, (A.n_rows, B.n_cols),
                                    device)
    return [by_lane.get(i) for i in range(A.batch)]


# auto selection for batches maps any single-matrix choice onto the nearest
# batchable engine (the scalar engines have no batched driver)
_BATCH_FALLBACK = {"scl-array": "esc", "scl-hash": "esc"}

# batched drivers per engine — every batchable registry entry routes here
_BATCH_DRIVERS: dict[str, Callable] = {
    "esc": _esc_batched,
    "spz": _spz_batched,
    "spz-fused": functools.partial(_spz_batched, driver="fused"),
    "spz-host": functools.partial(_spz_batched, driver="host"),
    "spz-rsort": functools.partial(_spz_batched, rsort=True),
}


def get_batch_driver(name: str) -> Callable:
    """The batched driver callable for a (batchable) engine name."""
    try:
        return _BATCH_DRIVERS[name]
    except KeyError:
        raise ValueError(f"engine {name!r} has no batched driver") from None


def check_batch(A: BatchedCSR, B: BatchedCSR) -> np.ndarray:
    if A.batch != B.batch or A.n_cols != B.n_rows:
        raise ValueError(f"batch mismatch: {A.batch}x{A.shape} @ "
                         f"{B.batch}x{B.shape}")
    lane_ok = _lane_ok(A, B)
    if not lane_ok.any():
        raise ValueError("no valid lanes in batch")
    return lane_ok


def plan_batched(A: BatchedCSR, B: BatchedCSR, engine: str = "auto", *,
                 backend: str = "auto",
                 device=None,
                 cache: Optional[AutotuneCache] = None,
                 rules: Sequence[HeuristicRule] = DEFAULT_HEURISTICS,
                 model: Any = "auto",
                 lane_work_hint: Optional[Sequence[int]] = None,
                 **kw) -> ExecutionPlan:
    """Select a batchable engine and resolve static capacities for a batch.

    engine: "esc", "spz", "spz-rsort", "spz-fused", "spz-host", or
    "auto" (features of the heaviest valid lane pick the engine —
    consulting and feeding the same autotune cache as the single-matrix
    path, keyed on that lane — then map onto a batchable one).  The
    resolved plan carries the shared product capacity (esc), the device
    and the kernel backend (spz), resolved exactly like :func:`plan`.

    lane_work_hint: per-lane total row_work, if the caller already
    computed it — skips the recompute when sizing the esc capacity.

    model: as in :func:`plan`, on the heaviest lane's features."""
    check_batch(A, B)
    dev = resolve_device(device)
    kb.resolve_backend(backend, dev)  # validate the request up front
    i_heavy = max((i for i, _ in A.lanes()), key=lambda i: _nnz(A[i]))
    key = cache_key(A[i_heavy], B[i_heavy], backend=backend)
    selected, source, rule, sel_bk = engine, "explicit", None, None
    if engine == "auto":
        use_cache = rules is DEFAULT_HEURISTICS
        if cache is None:
            cache = default_cache()
        hit = cache.get(key) if use_cache else None
        if hit is None and use_cache:
            # pull-on-plan-miss (see plan()): pick up selections and
            # quarantines flushed by sibling processes
            cache.refresh()
            hit = cache.get(key)
        if hit is not None and cache.is_quarantined(
                key, hit["engine"], hit.get("backend")):
            hit = None  # a poisoned prior selection must not be replayed
        if hit is not None and hit["engine"] not in _REGISTRY:
            hit = None  # a foreign file's engine: select anew
        if hit is not None:
            selected, source = hit["engine"], "cache"
            sel_bk = hit.get("backend")
        else:
            # same model rung as plan(): a confident learned prediction
            # (on the heaviest lane's features) beats the rules table;
            # the selection flows through _BATCH_FALLBACK below like
            # every other source
            # one lane view per call: the feature memo keys on identity
            feats = extract_features(A[i_heavy], B[i_heavy])
            sel = None
            if use_cache:
                mdl = resolve_model(model, cache)
                sel = _model_select(mdl, feats, key, backend, cache, dev)
                if sel is not None and not sel.confident:
                    sel = None
            if sel is not None:
                selected, sel_bk, source = sel.engine, sel.backend, "model"
            else:
                selected, rule = choose_engine(feats, rules)
                source = "heuristic"
                if use_cache:
                    remapped_q, was_q = _dequarantine(
                        _BATCH_FALLBACK.get(selected, selected), key,
                        backend, cache, dev)
                    if was_q:
                        selected, rule = remapped_q, "quarantine-fallback"
                    cache.put(key, selected, "heuristic")
    remapped = _BATCH_FALLBACK.get(selected, selected)
    spec = get_engine(remapped)
    if not spec.batchable or remapped not in _BATCH_DRIVERS:
        raise ValueError(f"engine {remapped!r} has no batched path")
    driver = _BATCH_DRIVERS[remapped]
    # auto selection / fallback remap may land on any driver: drop kwargs
    # it can't take (explicitly named engines keep strict kwargs)
    if engine == "auto" or remapped != engine:
        kw = _filter_kwargs(driver, kw)
    kw["device"] = dev
    if remapped == "esc" and kw.get("cap_products") is None:
        # shared power-of-two product capacity, resolved at plan time so
        # the plan's jit_key fully determines the launches
        works = ([int(w) for w in lane_work_hint]
                 if lane_work_hint is not None else
                 [int(sg.row_work(a, B[i]).sum()) for i, a in A.lanes()])
        kw["cap_products"] = _pow2_at_least(max(works + [1]))
    plan_bk, kw = _resolve_plan_backend(spec, backend, sel_bk, kw, dev,
                                        strict=engine != "auto")
    return ExecutionPlan(engine=remapped, batched=True, batch=A.batch,
                         a_shape=A.shape, b_shape=B.shape,
                         kwargs=_sorted_kwargs(kw),
                         work_bucket=(_nnz_bucket(A[i_heavy]),
                                      _nnz_bucket(B[i_heavy])),
                         cache_key=key, source=source, rule=rule,
                         backend=plan_bk)


def assemble_batched(outs: list, A: BatchedCSR, B: BatchedCSR) -> BatchedCSR:
    """Stack per-lane results (None = invalid lane) into the output
    BatchedCSR, on the results' device, whose lane capacity is the max
    output nnz."""
    done = [o for o in outs if o is not None]
    dev = done[0].device
    empty = csr_from_coo([], [], [], (A.n_rows, B.n_cols)).to(dev)
    cap = max(_nnz(o) for o in done)
    batched = batch_csr([o if o is not None else empty for o in outs],
                        nnz_cap=max(cap, 1))
    return BatchedCSR(batched.indptr, batched.indices, batched.data,
                      A.valid.to(dev) & B.valid.to(dev), batched.shape)


def execute_batched(p: ExecutionPlan, A: BatchedCSR, B: BatchedCSR, *,
                    return_stats: bool = False):
    """Run a batched plan.  Invalid lanes pass through as empty matrices
    with ``valid=False``.  Never falls back to another engine.  With
    ``return_stats``, returns ``(BatchedCSR, stats)``: the spz family's
    ``SpzStats`` of the whole call, None for esc."""
    if not p.batched:
        raise ValueError("single-pair plan passed to execute_batched(); "
                         "use execute()")
    check_batch(A, B)
    if A.shape != p.a_shape or B.shape != p.b_shape or A.batch != p.batch:
        raise ValueError(
            f"plan/operand mismatch: planned {p.batch}x{p.a_shape} @ "
            f"{p.b_shape}, got {A.batch}x{A.shape} @ {B.shape}")
    fi.fire("dispatch.execute_batched", engine=p.engine, backend=p.backend)
    stats = sg.SpzStats() \
        if return_stats and get_engine(p.engine).returns_stats else None
    extra = {"stats": stats} if stats is not None else {}
    outs = _BATCH_DRIVERS[p.engine](A, B, **p.kwargs_dict, **extra)
    outs = fi.corrupt("dispatch.execute_batched", outs,
                      engine=p.engine, backend=p.backend)
    out = assemble_batched(outs, A, B)
    return (out, stats) if return_stats else out


def spgemm_batched(A: BatchedCSR, B: BatchedCSR, engine: str = "auto", *,
                   device=None,
                   cache: Optional[AutotuneCache] = None,
                   rules: Sequence[HeuristicRule] = DEFAULT_HEURISTICS,
                   model: Any = "auto",
                   **kw) -> BatchedCSR:
    """Multiply a batch of same-shape CSR pairs.

    Exactly ``execute_batched(plan_batched(A, B, ...), A, B)``; see
    those for selection and execution semantics.  Runs on the card
    unless ``device`` names another device."""
    p = plan_batched(A, B, engine, device=device, cache=cache, rules=rules,
                     model=model, **kw)
    return execute_batched(p, A, B)


# ---------------------------------------------------------------------------
# plan warming ahead of traffic (the serving layer's warm pool)
# ---------------------------------------------------------------------------

_warm_mu = threading.Lock()
_warmed_jit_keys: set = set()
_warm_counters = {"warmed": 0, "hits": 0, "misses": 0}


def note_warmed(jit_key: tuple) -> None:
    """Record a plan identity as warmed in *this* process."""
    with _warm_mu:
        _warmed_jit_keys.add(jit_key)
        _warm_counters["warmed"] += 1


def jit_warmed(jit_key: tuple, count: bool = True) -> bool:
    """Whether ``jit_key`` was warmed ahead of traffic here.

    With ``count=True`` (the serving layer's per-flush check) the
    outcome lands on the warm hit/miss counters."""
    with _warm_mu:
        hit = jit_key in _warmed_jit_keys
        if count:
            _warm_counters["hits" if hit else "misses"] += 1
        return hit


def warm_stats() -> dict:
    """{"warmed": plans warmed ahead, "hits"/"misses": flush checks}."""
    with _warm_mu:
        return dict(_warm_counters)


def reset_warm_stats() -> None:
    with _warm_mu:
        _warmed_jit_keys.clear()
        _warm_counters.update(warmed=0, hits=0, misses=0)


def _synthetic_csr(shape: tuple, nnz_cap: int) -> CSR:
    """Deterministic stand-in operand landing in pad bucket ``nnz_cap``.

    nnz is pinned to ``nnz_cap - 1`` (clamped to the shape's capacity):
    a pad bucket holds nnz in (cap/2, cap], and ``cache_key``'s
    ``bit_length`` bucket puts cap-1 — but not cap itself — in the same
    plan bucket as that dominant range.  Entries spread uniformly with
    strictly increasing columns per row, so the operand is valid CSR
    without any RNG (warming must be deterministic and cheap)."""
    n_rows, n_cols = int(shape[0]), int(shape[1])
    nnz = int(max(1, min(nnz_cap - 1, n_rows * n_cols)))
    base, extra = divmod(nnz, n_rows)
    counts = np.full(n_rows, base, np.int64)
    counts[:extra] += 1
    counts = np.minimum(counts, n_cols)
    rows = np.repeat(np.arange(n_rows), counts)
    cols = (np.concatenate([(np.arange(c) * n_cols) // c
                            for c in counts if c > 0])
            if counts.sum() else np.zeros(0, np.int64))
    vals = np.ones(int(counts.sum()), np.float32)
    return csr_from_coo(rows, cols, vals, (n_rows, n_cols))


def synthetic_bucket_operands(bucket: tuple) -> tuple[CSR, CSR]:
    """A deterministic (A, B) pair on the CPU whose serving pad bucket is
    ``bucket`` (``(A.shape, B.shape, nnz_cap_a, nnz_cap_b)``)."""
    a_shape, b_shape, cap_a, cap_b = bucket
    return _synthetic_csr(a_shape, cap_a), _synthetic_csr(b_shape, cap_b)


def warm_bucket(bucket: tuple, *, engine: str = "auto", max_batch: int = 8,
                cache: Optional[AutotuneCache] = None, devices=None,
                rules: Sequence[HeuristicRule] = DEFAULT_HEURISTICS,
                sample: Optional[tuple] = None,
                sticky_cap: Optional[int] = None,
                cap_headroom: int = 2) -> dict:
    """Warm one serving pad bucket ahead of its first request.

    Runs a flush-shaped pass — ``batch_csr`` at the bucket's pad
    capacities, ``plan_sharded``, ``execute_sharded`` on ``devices``
    (every card by default) — over a sampled real pair (``sample``) or a
    synthetic stand-in, so the plan lands in the autotune cache and, on
    a card, the kernel libraries are loaded and the flush's buffers have
    been through the caching allocator before traffic hits the bucket.

    esc capacity handling: the resulting ``cap_products`` is raised by
    ``cap_headroom`` (a pow2 factor; the sample may not be the bucket's
    heaviest traffic) and by ``sticky_cap`` (the caller's running
    per-bucket max).  The caller seeds its sticky cap from the returned
    ``"cap"`` so real flushes pin to the warmed plan identity.

    Returns ``{"bucket", "engine", "backend", "source", "cap",
    "wall_s"}``."""
    from repro_torch.distributed import spgemm_shard as shard
    if cache is None:
        cache = default_cache()
    devs = shard.lane_devices(devices)
    _, _, cap_a, cap_b = bucket
    A, B = sample if sample is not None else synthetic_bucket_operands(bucket)
    t0 = time.perf_counter()
    fi.fire("dispatch.warm", bucket=tuple(bucket))
    if devs[0].type == "cuda":
        kb.load()
    Ab = batch_csr([A.to(devs[0])], nnz_cap=cap_a, batch_cap=max_batch)
    Bb = batch_csr([B.to(devs[0])], nnz_cap=cap_b, batch_cap=max_batch)
    sp = shard.plan_sharded(Ab, Bb, engine, devices=devs, cache=cache,
                            rules=rules)
    cap = None
    if sp.base.engine == "esc":
        cap = int(sp.base.kwargs_dict.get("cap_products", 0))
        cap = max(cap * max(int(cap_headroom), 1), int(sticky_cap or 0))
        kwargs = _sorted_kwargs({**sp.base.kwargs_dict,
                                 "cap_products": cap})
        sp = dataclasses.replace(
            sp, base=dataclasses.replace(sp.base, kwargs=kwargs))
    shard.execute_sharded(sp, Ab, Bb)
    if devs[0].type == "cuda":
        torch.cuda.synchronize(devs[0])
    note_warmed(sp.base.jit_key)
    return {"bucket": tuple(bucket), "engine": sp.base.engine,
            "backend": sp.base.backend, "source": sp.base.source,
            "cap": cap, "wall_s": time.perf_counter() - t0}
