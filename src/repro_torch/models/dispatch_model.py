"""Learned cost-model dispatch: per-candidate runtime regression.

Port of ``repro.models.dispatch_model``.  The autotune cache accumulates,
per shape/nnz bucket, the full timing vector of every ``_measure`` sweep
(every "engine|backend" combo timed) plus the structural feature dict
the sweep saw.  This module turns that dataset into the selection model
``core/dispatch.py`` consults between cache-hit and heuristics: a tiny
log-linear regressor

    log t(combo) = w[combo] . z + b[combo]

over standardized log-transformed ``work_stats`` features, one weight
row per candidate combo, trained with the port's AdamW
(``repro_torch/optim/adamw.py``) by autograd on masked squared error (a
sweep only times the combos that were healthy at the time, so the target
matrix is ragged).  Selection is an argmin over predicted runtimes with
a calibrated confidence — the probability the top pick truly beats the
runner-up, given the model's residual noise ``sigma`` on log-runtime:

    confidence = Phi((log t2 - log t1) / (sigma * sqrt(2)))

A prediction below the confidence floor abstains, and ``plan()`` falls
through to measurement (which feeds the dataset) or heuristics.

Trained models persist as a small versioned JSON artifact next to the
cache file (``<cache>.model.json``), in the reference's schema: an
artifact written by either package loads in the other, and ``predict``/
``select`` are the reference's plain Python, so they predict the same
bits.  A model trained on the CPU knows the CPU's combos (``spz|torch``)
and abstains on a card, whose combos (``spz|cuda``) it never saw.
``train_and_save`` bumps the artifact version monotonically so
dispatch's mtime-keyed memo and the plan memo both see retrains.  This
module does not import ``core/dispatch`` (dispatch lazily imports
*us*); the only shared contract is the "engine|backend" combo string and
the entry schema ``{"timings": {combo: seconds}, "features": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import adamw

FORMAT_VERSION = 1          # artifact schema (load refuses newer formats)
ARTIFACT_KIND = "dispatch-cost-model"

# feature order is part of the artifact contract — new features append
FEATURE_NAMES: tuple[str, ...] = (
    "nnz", "density", "avg_work_per_row", "avg_work_per_group",
    "work_var_per_group", "total_work",
)

# work_var_per_group is already a dimensionless ratio; everything else
# spans orders of magnitude and regresses on a log scale
_LOG1P = {"nnz", "avg_work_per_row", "avg_work_per_group", "total_work"}
_LOG_EPS = {"density": 1e-12}

_SIGMA_FLOOR = 0.05         # log-runtime noise floor (≈5% runtime)
_T_FLOOR = 1e-9             # sub-ns timings are clock noise


def split_combo(combo: str) -> tuple[str, Optional[str]]:
    """"engine|backend" → (engine, backend-or-None); mirrors dispatch."""
    engine, _, backend = combo.partition("|")
    return engine, (backend or None)


def featurize(feats: dict) -> list[float]:
    """Raw feature dict → the model's (d,) transformed input vector.

    Plain-Python on purpose: this runs on the plan hot path, where at
    d=6 the per-call numpy dispatch overhead costs more than the math."""
    out = []
    for name in FEATURE_NAMES:
        v = float(feats.get(name, 0.0))
        if not math.isfinite(v):
            v = 0.0
        if name in _LOG1P:
            v = math.log1p(max(v, 0.0))
        elif name in _LOG_EPS:
            v = math.log(max(v, 0.0) + _LOG_EPS[name])
        out.append(v)
    return out


def samples_from_entries(entries: dict) -> list[dict]:
    """Extract the training dataset from an autotune-cache snapshot
    (``AutotuneCache.entries()`` or a raw loaded cache file): one sample
    per bucket that recorded a timing vector + features.  Winner-only
    entries (heuristic puts, migrated v1 entries) and reserved keys
    ("!quarantine:", "!schema") carry no regression target and are
    skipped."""
    samples = []
    for key in sorted(entries):
        e = entries[key]
        if key.startswith("!") or not isinstance(e, dict):
            continue
        timings, feats = e.get("timings"), e.get("features")
        if not timings or not feats:
            continue
        clean = {c: float(t) for c, t in timings.items()
                 if isinstance(t, (int, float)) and math.isfinite(t)
                 and t > 0.0}
        if not clean:
            continue
        samples.append({"key": key, "features": dict(feats),
                        "timings": clean})
    return samples


@dataclasses.dataclass(frozen=True)
class Selection:
    """One model-based selection: the argmin combo, how sure the model
    is, and the full predicted cost surface (seconds per combo)."""

    engine: str
    backend: Optional[str]
    combo: str
    confidence: float           # P(top pick beats the runner-up)
    confident: bool             # clears the floor AND covers all combos
    costs: dict                 # combo -> predicted seconds


def _train_step(cfg: adamw.AdamWConfig, params: dict, opt_state: dict,
                Z: torch.Tensor, Y: torch.Tensor, M: torch.Tensor):
    """One AdamW step on masked squared error over log-runtimes."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    pred = Z @ p["w"].T + p["bias"]
    se = torch.square(pred - Y) * M
    loss = se.sum() / torch.clamp(M.sum(), min=1.0)
    gw, gb = torch.autograd.grad(loss, [p["w"], p["bias"]])
    params, opt_state, _ = adamw.apply_updates(
        cfg, {k: v.detach() for k, v in p.items()}, opt_state,
        {"w": gw, "bias": gb})
    return params, opt_state, loss.detach()


class DispatchModel:
    """Per-candidate log-linear runtime model with calibrated argmin."""

    def __init__(self, *, candidates: list, w: np.ndarray, bias: np.ndarray,
                 mean: np.ndarray, std: np.ndarray, sigma: float,
                 confidence_floor: float = 0.7, version: int = 1,
                 n_samples: int = 0, train_loss: Optional[float] = None):
        self.candidates = list(candidates)
        self.w = np.asarray(w, np.float64).reshape(len(candidates),
                                                   len(FEATURE_NAMES))
        self.bias = np.asarray(bias, np.float64).reshape(len(candidates))
        self.mean = np.asarray(mean, np.float64).reshape(len(FEATURE_NAMES))
        self.std = np.asarray(std, np.float64).reshape(len(FEATURE_NAMES))
        self.sigma = max(float(sigma), _SIGMA_FLOOR)
        self.confidence_floor = float(confidence_floor)
        self.version = int(version)
        self.n_samples = int(n_samples)
        self.train_loss = train_loss
        # plain-list mirrors of the parameters for the hot inference
        # path: at (C≈5, d=6) python loops beat numpy dispatch overhead
        # by ~30µs per plan, which is most of the select budget
        self._w_rows = [list(r) for r in self.w]
        self._bias_l = list(self.bias)
        self._mean_l = list(self.mean)
        self._inv_std_l = [1.0 / s if s > 1e-12 else 1.0
                           for s in self.std]

    # -- inference ---------------------------------------------------------

    def predict(self, feats: dict) -> dict:
        """Predicted runtime in seconds for every known combo."""
        x = featurize(feats)
        z = [(xi - m) * s for xi, m, s in zip(x, self._mean_l,
                                              self._inv_std_l)]
        out = {}
        for c, row, b in zip(self.candidates, self._w_rows, self._bias_l):
            t = b + sum(wi * zi for wi, zi in zip(row, z))
            out[c] = math.exp(min(t, 50.0))
        return out

    def select(self, feats: dict,
               allowed: Optional[Iterable[str]] = None) -> Optional[Selection]:
        """Argmin over predicted runtimes, restricted to ``allowed``
        combos (the caller's healthy candidate set).

        Confidence is the probability the winner truly beats the
        runner-up under independent N(0, sigma^2) errors on the two
        log-runtime predictions.  The selection is only ``confident``
        when that clears the floor AND the model has costs for *every*
        allowed combo — a combo the model never saw cannot be ranked,
        so the caller should measure instead.  Returns None when no
        allowed combo is known at all."""
        costs = self.predict(feats)
        unknown: set = set()
        if allowed is not None:
            allowed = set(allowed)
            unknown = allowed - set(costs)
            costs = {c: t for c, t in costs.items() if c in allowed}
        if not costs:
            return None
        order = sorted(costs, key=costs.get)
        best = order[0]
        if len(order) == 1:
            confidence = 1.0
        else:
            gap = math.log(costs[order[1]]) - math.log(costs[best])
            confidence = 0.5 * (1.0 + math.erf(
                gap / (self.sigma * math.sqrt(2.0) * math.sqrt(2.0))))
        engine, backend = split_combo(best)
        return Selection(engine=engine, backend=backend, combo=best,
                         confidence=confidence,
                         confident=(not unknown
                                    and confidence >= self.confidence_floor),
                         costs=costs)

    # -- training ----------------------------------------------------------

    @classmethod
    def train(cls, samples: list, *, steps: int = 400, lr: float = 0.05,
              weight_decay: float = 1e-4, confidence_floor: float = 0.7,
              version: int = 1, device=None) -> Optional["DispatchModel"]:
        """Fit from ``samples_from_entries`` output; None when empty.

        The target matrix is ragged (each sweep only timed the combos
        healthy at the time), so the loss masks unobserved cells.  The
        fit runs in float64 on ``device``: the card unless the caller
        names another (``device="cpu"``); without a card it raises.  In
        float32 (the reference's), rounding that differs between devices
        is magnified by Adam's normalised step along the directions the
        samples leave flat, and a fit on the card and one on the CPU from
        the same samples can disagree near a tie; in float64 they agree
        to rounding."""
        dev = resolve_device(device)
        samples = [s for s in samples
                   if s.get("timings") and s.get("features")]
        if not samples:
            return None
        candidates = sorted({c for s in samples for c in s["timings"]})
        cidx = {c: j for j, c in enumerate(candidates)}
        n, C, d = len(samples), len(candidates), len(FEATURE_NAMES)
        X = np.stack([featurize(s["features"]) for s in samples])
        std = X.std(0)
        mean, std = X.mean(0), np.where(std < 1e-6, 1.0, std)
        Z = (X - mean) / std
        Y = np.zeros((n, C))
        M = np.zeros((n, C))
        for i, s in enumerate(samples):
            for c, t in s["timings"].items():
                Y[i, cidx[c]] = math.log(max(float(t), _T_FLOOR))
                M[i, cidx[c]] = 1.0
        col_n = np.maximum(M.sum(0), 1.0)
        b0 = (Y * M).sum(0) / col_n   # start at per-candidate mean log-t
        params = {"w": torch.zeros((C, d), dtype=torch.float64, device=dev),
                  "bias": torch.tensor(b0, dtype=torch.float64, device=dev)}
        cfg = adamw.AdamWConfig(lr=lr, weight_decay=weight_decay,
                                clip_norm=1.0, state_dtype="float64",
                                compute_dtype="float64",
                                warmup_steps=max(1, steps // 20),
                                decay_steps=steps)
        opt = adamw.init_state(cfg, params)
        Zt, Yt, Mt = (torch.tensor(a, dtype=torch.float64, device=dev)
                      for a in (Z, Y, M))
        loss = torch.zeros(())
        for _ in range(max(1, steps)):
            params, opt, loss = _train_step(cfg, params, opt, Zt, Yt, Mt)
        w = params["w"].cpu().numpy().astype(np.float64)
        bias = params["bias"].cpu().numpy().astype(np.float64)
        resid = (Z @ w.T + bias - Y) * M
        sigma = math.sqrt(float((resid ** 2).sum()) / max(float(M.sum()), 1.0))
        return cls(candidates=candidates, w=w, bias=bias, mean=mean,
                   std=std, sigma=sigma, confidence_floor=confidence_floor,
                   version=version, n_samples=n,
                   train_loss=float(loss))

    # -- persistence -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "kind": ARTIFACT_KIND,
            "model_version": self.version,
            "feature_names": list(FEATURE_NAMES),
            "candidates": self.candidates,
            "w": self.w.tolist(),
            "bias": self.bias.tolist(),
            "mean": self.mean.tolist(),
            "std": self.std.tolist(),
            "sigma": self.sigma,
            "confidence_floor": self.confidence_floor,
            "n_samples": self.n_samples,
            "train_loss": self.train_loss,
        }

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename), like the cache flush — a reader
        never sees a half-written artifact."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".model.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_dict(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @classmethod
    def from_dict(cls, data: dict) -> "DispatchModel":
        if data.get("kind") != ARTIFACT_KIND:
            raise ValueError(f"not a {ARTIFACT_KIND} artifact: "
                             f"kind={data.get('kind')!r}")
        fv = int(data.get("format_version", -1))
        if fv > FORMAT_VERSION or fv < 1:
            raise ValueError(f"unsupported artifact format_version {fv} "
                             f"(this build reads <= {FORMAT_VERSION})")
        if list(data.get("feature_names", [])) != list(FEATURE_NAMES):
            raise ValueError("artifact feature set does not match this "
                             "build; retrain the model")
        return cls(candidates=list(data["candidates"]),
                   w=np.asarray(data["w"]),
                   bias=np.asarray(data["bias"]),
                   mean=np.asarray(data["mean"]),
                   std=np.asarray(data["std"]),
                   sigma=float(data["sigma"]),
                   confidence_floor=float(data.get("confidence_floor", 0.7)),
                   version=int(data.get("model_version", 1)),
                   n_samples=int(data.get("n_samples", 0)),
                   train_loss=data.get("train_loss"))

    @classmethod
    def load(cls, path: str) -> "DispatchModel":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def train_and_save(entries: dict, path: str, device=None,
                   **train_kw) -> Optional[DispatchModel]:
    """Offline (re)train from a cache snapshot on ``device`` (the card
    unless the caller names another) and persist next to it.

    The artifact version is bumped past any existing artifact's, so
    dispatch's mtime-keyed loader AND version-aware consumers both see
    the retrain as a new model.  Returns the model, or None when the
    snapshot holds no timing vectors yet."""
    version = 1
    try:
        version = DispatchModel.load(path).version + 1
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        pass
    model = DispatchModel.train(samples_from_entries(entries),
                                version=version, device=device, **train_kw)
    if model is not None:
        model.save(path)
    return model
