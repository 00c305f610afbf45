"""Training data: deterministic synthetic token streams and a prefetching
loader.

Port of ``repro.data.pipeline`` (numpy and threads only, as there).
Each batch is drawn from a generator seeded by (seed, step, shard), so
any worker can regenerate any batch: resumed training replays exactly
the batches an uninterrupted run would have seen.  The loader prefetches
on a background thread; a fetch that misses its deadline gets a backup
fetch of the same step, and whichever finishes first wins (fetches are
deterministic: duplicate work, never duplicate data).  Batches are numpy
arrays; the trainer moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np


class TokenDataset:
    """Deterministic synthetic LM token stream with skip-to-step resume:
    ``batch_at(step)`` equals the reference's bit for bit."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, seed: int = 0, n_shards: int = 1, shard_id: int = 0,
                 enc_tokens: int = 0, d_model: int = 0):
        if global_batch % n_shards:
            raise ValueError(f"batch {global_batch} does not split over "
                             f"{n_shards} shards")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = global_batch // n_shards
        self.seed = seed
        self.n_shards = n_shards
        self.shard_id = shard_id
        self.enc_tokens = enc_tokens
        self.d_model = d_model

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"}: (batch, seq_len) int32, labels the tokens
        shifted by one; plus "enc_inp" (batch, enc_tokens, d_model)
        float32 when the model has a frontend."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard_id)
        # each token mixes in its predecessor, so the stream has structure
        # a model can learn (the loss falls)
        base = rng.integers(0, self.vocab_size,
                            (self.batch, self.seq_len + 1), np.int32)
        mixed = base.copy()
        mixed[:, 1:] = (base[:, 1:] + 3 * base[:, :-1]) % self.vocab_size
        out = {"tokens": mixed[:, :-1], "labels": mixed[:, 1:]}
        if self.enc_tokens:
            out["enc_inp"] = rng.standard_normal(
                (self.batch, self.enc_tokens, self.d_model)).astype(np.float32)
        return out


class PrefetchLoader:
    """Background-thread prefetch, ``depth`` batches ahead, with a backup
    fetch for a step whose fetch misses ``deadline_s``.  Each batch
    carries its step under ``"_step"``; ``start(step)`` begins there."""

    def __init__(self, dataset: TokenDataset, *, depth: int = 2,
                 deadline_s: float = 5.0,
                 fetch_fn: Optional[Callable[[int], dict]] = None):
        self.ds = dataset
        self.depth = depth
        self.deadline_s = deadline_s
        self.fetch_fn = fetch_fn or dataset.batch_at
        self.backup_fetches = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = 0
        self._thread: Optional[threading.Thread] = None

    def start(self, step: int = 0):
        self._step = step
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _fetch_with_backup(self, step: int) -> dict:
        result: dict = {}
        done = threading.Event()

        def attempt():
            try:
                r = self.fetch_fn(step)
                if not done.is_set():
                    result.update(r)
                    done.set()
            except Exception:  # the other attempt may still deliver
                pass

        threading.Thread(target=attempt, daemon=True).start()
        if not done.wait(self.deadline_s):
            # the primary missed its deadline: issue a backup fetch
            self.backup_fetches += 1
            threading.Thread(target=attempt, daemon=True).start()
            done.wait()
        return result

    def _run(self):
        while not self._stop.is_set():
            batch = self._fetch_with_backup(self._step)
            batch["_step"] = self._step
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._step += 1

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
