"""Plan warming ahead of traffic: predict the serving pad buckets traffic
is about to hit and warm their plans before the first unlucky request.

Port of ``repro.serving.plan_warmer``, host-only bookkeeping keyed by the
port's :func:`~repro_torch.serving.spgemm_service.bucket_key`.  A fresh
pad bucket pays its first plan (features, the heuristic table, the
autotune cache) and, on a card, the first allocation of its flush shape
inline, and every queued request behind it inherits that latency.  A
:class:`PlanWarmer` closes the gap from two prediction sources:

  * **configured shapes** — the operator registers representative
    operand pairs (or bare bucket keys) for the traffic classes they
    expect; these warm before the first request arrives;
  * **admission-stream frequency** — every ``submit`` reports its
    bucket; observed buckets (and, for nnz-jittered traffic, their
    neighbouring pow2 pad buckets) are warmed in the background so the
    *next* capacity boundary is already warm when traffic drifts
    across it.

The warmer itself is pure bookkeeping — deterministic, clock-free, and
trivially testable.  Execution is the service's job:
``SpGemmService._dispatch_warm`` routes each due bucket onto the local
flush executor, or runs it inline, both calling
:func:`repro_torch.core.dispatch.warm_bucket`.
"""
from __future__ import annotations

import collections
from typing import Iterable, Optional

from repro_torch.core.formats import CSR
from repro_torch.serving.spgemm_service import bucket_key


def neighbor_buckets(bucket: tuple) -> list[tuple]:
    """The adjacent pow2 pad buckets nnz-jittered traffic lands in next.

    A bucket holds nnz in (cap/2, cap]; traffic whose density drifts a
    few percent crosses into (cap, 2cap] or (cap/4, cap/2].  Buckets
    whose capacity cannot be reached by the operand shape (cap >= rows *
    cols) are skipped — no real operand lands there."""
    a_shape, b_shape, cap_a, cap_b = bucket
    out = []
    up = (a_shape, b_shape, cap_a * 2, cap_b * 2)
    if cap_a < a_shape[0] * a_shape[1] or cap_b < b_shape[0] * b_shape[1]:
        out.append(up)
    if cap_a > 16 or cap_b > 16:
        out.append((a_shape, b_shape, max(cap_a // 2, 16),
                    max(cap_b // 2, 16)))
    return out


class PlanWarmer:
    """Predicts which pad buckets to warm ahead, and tracks outcomes.

    configured:   operand pairs ``(A, B)`` (or bare bucket-key tuples)
                  known ahead of traffic; always first in priority.
    neighbors:    also predict the pow2-adjacent buckets of observed
                  traffic (guards the capacity boundaries).
    history:      admission-stream window for frequency ranking.
    min_count:    observations before a bucket is predicted.
    max_warms:    total warm budget (predicted buckets past it wait).
    """

    def __init__(self, *, configured: Iterable = (), neighbors: bool = True,
                 history: int = 256, min_count: int = 1,
                 max_warms: int = 64):
        self.neighbors = neighbors
        self.min_count = max(int(min_count), 1)
        self.max_warms = int(max_warms)
        self._recent: collections.deque = collections.deque(maxlen=history)
        self._counts: collections.Counter = collections.Counter()
        self._samples: dict[tuple, tuple] = {}   # bucket -> (A, B)
        self._sample_nnz: dict[tuple, int] = {}
        self._configured: list[tuple] = []
        self._warmed: set = set()
        self._pending: set = set()
        self._failed: dict[tuple, str] = {}
        for item in configured:
            if isinstance(item, tuple) and len(item) == 2 \
                    and isinstance(item[0], CSR):
                self.configure(*item)
            else:
                self.configure_bucket(tuple(item))

    # -- intake ----------------------------------------------------------

    def configure(self, A: CSR, B: CSR) -> tuple:
        """Register a representative operand pair for an expected traffic
        class; its bucket warms ahead of any admission."""
        b = bucket_key(A, B)
        if b not in self._configured:
            self._configured.append(b)
        self._keep_sample(b, A, B)
        return b

    def configure_bucket(self, bucket: tuple) -> None:
        """Register a bare bucket key (synthetic operands will warm it)."""
        if bucket not in self._configured:
            self._configured.append(bucket)

    def _keep_sample(self, bucket: tuple, A: CSR, B: CSR) -> None:
        # keep the heaviest pair seen: its capacities upper-bound the
        # bucket's traffic best, so the warmed plan covers more flushes
        nnz = int(A.indptr[-1]) + int(B.indptr[-1])
        if nnz >= self._sample_nnz.get(bucket, -1):
            self._samples[bucket] = (A, B)
            self._sample_nnz[bucket] = nnz

    def observe(self, bucket: tuple, A: Optional[CSR] = None,
                B: Optional[CSR] = None) -> None:
        """Feed one admission (called by ``SpGemmService.submit``)."""
        self._recent.append(bucket)
        self._counts[bucket] += 1
        if A is not None and B is not None:
            self._keep_sample(bucket, A, B)

    # -- prediction ------------------------------------------------------

    def predict(self) -> list[tuple]:
        """Buckets worth warming, in priority order: configured first,
        then observed by recent frequency, then pow2 neighbors of the
        observed set."""
        out = list(self._configured)
        recent = collections.Counter(self._recent)
        for b, n in recent.most_common():
            if n >= self.min_count and b not in out:
                out.append(b)
        if self.neighbors:
            for b in list(out):
                for nb in neighbor_buckets(b):
                    if nb not in out:
                        out.append(nb)
        return out

    def due(self) -> list[tuple]:
        """The predicted buckets that still need a warm dispatch (not
        warmed, not in flight, not failed, within budget)."""
        budget = self.max_warms - len(self._warmed) - len(self._pending)
        if budget <= 0:
            return []
        out = [b for b in self.predict()
               if b not in self._warmed and b not in self._pending
               and b not in self._failed]
        return out[:budget]

    def sample(self, bucket: tuple) -> Optional[tuple]:
        """The retained (A, B) pair for a bucket, if any was seen."""
        return self._samples.get(bucket)

    # -- outcome tracking ------------------------------------------------

    def mark_pending(self, bucket: tuple) -> None:
        self._pending.add(bucket)

    def mark_warmed(self, bucket: tuple) -> None:
        self._pending.discard(bucket)
        self._failed.pop(bucket, None)
        self._warmed.add(bucket)

    def mark_failed(self, bucket: tuple, why: str = "") -> None:
        self._pending.discard(bucket)
        self._failed[bucket] = why

    def is_warmed(self, bucket: tuple) -> bool:
        return bucket in self._warmed

    def stats(self) -> dict:
        return {"configured": len(self._configured),
                "observed": len(self._counts),
                "warmed": len(self._warmed),
                "pending": len(self._pending),
                "failed": len(self._failed)}
