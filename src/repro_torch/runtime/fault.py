"""Fault tolerance: the supervised training loop with checkpoint/restart.

Port of ``repro.runtime.fault`` (plain Python; the same semantics).  A
step that raises (device failure, preemption) or gives a NaN loss makes
the supervisor restore the last committed checkpoint and go on from its
step, within ``max_restarts``; a restore that itself raises counts as no
checkpoint (a cold restart from step 0 with the state in memory); a save
that raises is logged and does not burn a restart; a pending async save
is always joined.  Unlike the reference's, the loop does not replay a
step that failed for a reason a replay cannot cure: a kernel that did
not build, a launch the card refused or a fault it reported
(``kernels.backend.KERNEL_ERRORS``), or a missing backward pass
(``NotImplementedError``) raise out of it at once.  The data path's
straggler policy is in ``data/pipeline.py``.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Any, Callable, Optional

from repro_torch.kernels.backend import KERNEL_ERRORS

log = logging.getLogger("repro_torch.fault")

# failures that replaying the step from a checkpoint cannot cure
NOT_RETRIED = (NotImplementedError, *KERNEL_ERRORS)


@dataclasses.dataclass
class FaultConfig:
    """``ckpt_dir`` None: the trainer writes and reads no checkpoint."""
    ckpt_dir: Optional[str] = os.path.join(tempfile.gettempdir(),
                                           "repro_torch_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    async_save: bool = True


class Preempted(RuntimeError):
    """Raised by the preemption hook (tests, SIGTERM handlers)."""


def _safe_restore(restore_fn: Optional[Callable]):
    """``restore_fn()``, hardened: a restore that raises (a corrupt
    checkpoint, an unreadable directory) means "no usable checkpoint",
    and the supervisor restarts cold instead of leaving the loop."""
    if restore_fn is None:
        return None
    try:
        return restore_fn()
    except Exception as e:
        log.warning("restore failed (%s); treating as no checkpoint", e)
        return None


def _safe_join(pending_save) -> None:
    """Join an async save, swallowing its failure: a checkpoint is an
    optimisation, and a failed one must neither end the run nor leak its
    handle."""
    if pending_save is None:
        return
    try:
        pending_save.join()
    except Exception as e:
        log.warning("pending checkpoint save failed on join (%s)", e)


def run_resilient(train_step: Callable, state: Any, batch_fn, fcfg: FaultConfig,
                  *, num_steps: int, save_fn: Optional[Callable],
                  restore_fn: Optional[Callable],
                  preempt_hook: Optional[Callable[[int], None]] = None,
                  on_step: Optional[Callable] = None):
    """The supervised loop.

    train_step(state, batch) -> (state, metrics); batch_fn(step) ->
    batch, step-addressable, so that a restart replays exactly the
    batches after the restored step (resumed training then equals
    uninterrupted training); save_fn(step, state) -> a handle to join or
    None, every ``fcfg.ckpt_every`` steps and after the last; restore_fn()
    -> (step, state) or None.  ``save_fn`` and ``restore_fn`` None: no
    checkpoints.  Returns (state, history).

    Only step failures (an exception out of the step, a NaN loss, a
    preemption) count against ``max_restarts``; a save that raises is
    counted under ``hist["save_failures"]`` and training goes on; a
    restore that raises restarts at step 0; ``NOT_RETRIED`` failures
    raise at once.  The pending async save is joined on every path."""
    restarts = 0
    hist = {"steps": [], "restarts": 0, "saves": 0, "save_failures": 0}
    resumed = _safe_restore(restore_fn)
    step = 0
    if resumed is not None:
        step, state = resumed
        log.info("resumed at step %d", step)
    pending_save = None
    try:
        while step < num_steps:
            try:
                if preempt_hook is not None:
                    preempt_hook(step)
                batch = batch_fn(step)
                state, metrics = train_step(state, batch)
                loss = float(metrics.get("loss", 0.0))
                if loss != loss:  # NaN: a corrupt step, restart
                    raise FloatingPointError(f"non-finite loss at step {step}")
                hist["steps"].append(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()}})
                if on_step is not None:
                    on_step(step, metrics)
                step += 1
                if save_fn is not None and (step % fcfg.ckpt_every == 0
                                            or step == num_steps):
                    # a failed save is logged, not restarted: the step has
                    # committed, and re-running it for a disk problem would
                    # double its work
                    try:
                        _safe_join(pending_save)
                        pending_save = save_fn(step, state)
                        hist["saves"] += 1
                    except Exception as e:
                        pending_save = None
                        hist["save_failures"] += 1
                        log.warning("checkpoint save at step %d failed "
                                    "(%s); continuing", step, e)
            except NOT_RETRIED:
                raise
            except (Preempted, FloatingPointError, RuntimeError) as e:
                restarts += 1
                hist["restarts"] = restarts
                if restarts > fcfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={fcfg.max_restarts}") from e
                log.warning("step %d failed (%s); restarting (%d/%d)",
                            step, e, restarts, fcfg.max_restarts)
                _safe_join(pending_save)
                pending_save = None
                resumed = _safe_restore(restore_fn)
                if resumed is None:
                    step = 0
                else:
                    step, state = resumed
    finally:
        _safe_join(pending_save)
    return state, hist
