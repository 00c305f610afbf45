"""Inspect, validate, compact, export, and train from the port's autotune
cache file.

The counterpart of ``tools/dump_autotune.py`` for the PyTorch/CUDA port
(``repro_torch``): the same commands, output and file schema, on the
port's cache (``$REPRO_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/repro_torch/spgemm_autotune.json`` by default).  ``train``
fits the dispatch model on ``--device``: the card unless another is
named (``--device cpu``).

The disk-backed ``AutotuneCache`` (``core/dispatch.py``) accumulates one
entry per shape/nnz bucket — the selected engine/backend, the source
that selected it, and (for autotune sweeps) the full per-candidate
timing vector + feature dict the learned dispatch model trains on —
plus reserved ``!quarantine:<bucket>`` records and the ``!schema``
version stamp.  This CLI is the operator's window into that file:

  show      — human summary: schema version, entries by source, timing
              coverage, active/expired quarantine combos (``--json``
              for machine output)
  validate  — structural screen of every record; exit 1 with one line
              per problem (unknown schema, missing fields, non-finite
              timings, malformed quarantine records)
  compact   — rewrite the file through the current schema: migrate
              old-format records forward, drop expired quarantine
              combos, optionally strip timing vectors (--drop-timings)
              once a model has been trained from them
  export    — the offline-training dataset (``samples_from_entries``)
              as JSON: one sample per bucket with a timing vector
  train     — fit the dispatch cost model from the cache and write the
              versioned artifact next to it (``<cache>.model.json``)

Usage: python tools/dump_autotune_torch.py <cmd> [path] [options]
The default path is the process-default cache location.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

if "src" not in sys.path:  # repo-root invocation without PYTHONPATH=src
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src"))

from repro_torch.core import dispatch as dp           # noqa: E402
from repro_torch.models import dispatch_model as dm   # noqa: E402

_QUAR = "!quarantine:"


def _load_raw(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    if not isinstance(data, dict):
        raise SystemExit(f"{path}: not a JSON object")
    return data


def _split(data: dict) -> tuple[int, dict, dict]:
    """(schema_version, selection entries, quarantine records)."""
    schema = data.get("!schema")
    version = int(schema["version"]) if isinstance(schema, dict) \
        and "version" in schema else 1
    sels = {k: v for k, v in data.items()
            if not k.startswith("!") and isinstance(v, dict)}
    quar = {k: v for k, v in data.items()
            if k.startswith(_QUAR) and isinstance(v, dict)}
    return version, sels, quar


def cmd_show(args) -> int:
    data = _load_raw(args.path)
    version, sels, quar = _split(data)
    by_source: dict = {}
    with_timings = 0
    n_points = 0
    for e in sels.values():
        by_source[e.get("source", "?")] = \
            by_source.get(e.get("source", "?"), 0) + 1
        if e.get("timings"):
            with_timings += 1
            n_points += len(e["timings"])
    now = time.time()
    q_rows = []
    for k, q in sorted(quar.items()):
        for combo in q.get("combos", ()):
            ts = q.get("ts", {}).get(combo)
            q_rows.append({
                "bucket": k[len(_QUAR):], "combo": combo,
                "strikes": int(q.get("strikes", {}).get(combo, 1)),
                "age_s": round(now - float(ts), 1) if ts else None,
                "reason": q.get("reasons", {}).get(combo, ""),
            })
    summary = {
        "path": args.path, "schema_version": version,
        "selection_entries": len(sels), "by_source": by_source,
        "entries_with_timings": with_timings,
        "timing_points": n_points,
        "quarantine_buckets": len(quar), "quarantined": q_rows,
    }
    if args.json:
        json.dump(summary, sys.stdout, indent=1, sort_keys=True)
        print()
        return 0
    print(f"{args.path}: schema v{version}, {len(sels)} selection "
          f"entries ({by_source or '{}'}), {with_timings} with timing "
          f"vectors ({n_points} measured points)")
    for r in q_rows:
        age = f"{r['age_s']}s ago" if r["age_s"] is not None else "unstamped"
        print(f"  quarantined {r['bucket']}: {r['combo']} "
              f"(strikes={r['strikes']}, {age}) {r['reason']}")
    if not q_rows:
        print("  no quarantined combos")
    return 0


def cmd_validate(args) -> int:
    data = _load_raw(args.path)
    version, sels, quar = _split(data)
    problems = []
    if version > dp.SCHEMA_VERSION:
        problems.append(f"!schema: version {version} is newer than this "
                        f"build's {dp.SCHEMA_VERSION}")
    for k, v in data.items():
        if not isinstance(v, dict):
            problems.append(f"{k}: entry is not an object")
    for k, e in sels.items():
        if not e.get("engine") or not e.get("source"):
            problems.append(f"{k}: missing engine/source")
        for combo, t in (e.get("timings") or {}).items():
            if not isinstance(t, (int, float)) or not math.isfinite(t) \
                    or t <= 0:
                problems.append(f"{k}: timing {combo}={t!r} not a "
                                "positive finite number")
        for name, val in (e.get("features") or {}).items():
            if not isinstance(val, (int, float)) \
                    or not math.isfinite(float(val)):
                problems.append(f"{k}: feature {name}={val!r} not finite")
    for k, q in quar.items():
        combos = q.get("combos")
        if not isinstance(combos, list):
            problems.append(f"{k}: quarantine combos is not a list")
            continue
        for combo in combos:
            if "|" not in str(combo):
                problems.append(f"{k}: malformed combo {combo!r}")
            ts = q.get("ts", {}).get(combo)
            if ts is not None and (not isinstance(ts, (int, float))
                                   or not math.isfinite(ts)):
                problems.append(f"{k}: bad timestamp for {combo!r}: {ts!r}")
    for p in problems:
        print(f"INVALID: {p}", file=sys.stderr)
    print(f"{args.path}: {len(sels)} entries, {len(quar)} quarantine "
          f"records: {'OK' if not problems else f'{len(problems)} problems'}")
    return 1 if problems else 0


def cmd_compact(args) -> int:
    cache = dp.AutotuneCache(args.path)
    before = os.path.getsize(args.path) if os.path.exists(args.path) else 0
    entries = cache.entries()
    dropped_combos = 0
    for k in list(entries):
        if k.startswith(_QUAR):
            # quarantined() re-admits expired combos in memory as a side
            # effect; the flush below persists the pruned record
            bucket = k[len(_QUAR):]
            active = cache.quarantined(bucket)
            dropped_combos += len(entries[k].get("combos", ())) - len(active)
    if args.drop_timings:
        with cache._mu:  # noqa: SLF001 - maintenance tool, exact rewrite
            for k, e in cache._load().items():  # noqa: SLF001
                if not k.startswith("!"):
                    e.pop("timings", None)
                    e.pop("features", None)
    # merge=False: the default flush re-unions on-disk dataset fields,
    # which would resurrect the timing vectors we just stripped
    cache._flush(merge=False)  # noqa: SLF001
    after = os.path.getsize(args.path) if os.path.exists(args.path) else 0
    print(f"{args.path}: compacted {before} -> {after} bytes "
          f"(schema v{dp.SCHEMA_VERSION}, {dropped_combos} expired "
          f"quarantine combos dropped"
          f"{', timing vectors stripped' if args.drop_timings else ''})")
    return 0


def cmd_export(args) -> int:
    cache = dp.AutotuneCache(args.path)
    samples = dm.samples_from_entries(cache.entries())
    out = {"source": args.path, "n_samples": len(samples),
           "feature_names": list(dm.FEATURE_NAMES), "samples": samples}
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {len(samples)} samples -> {args.output}")
    else:
        json.dump(out, sys.stdout, indent=1)
        print()
    return 0


def cmd_train(args) -> int:
    cache = dp.AutotuneCache(args.path)
    artifact = args.artifact or dp.model_path_for(cache)
    model = dm.train_and_save(cache.entries(), artifact, device=args.device,
                              steps=args.steps)
    if model is None:
        print(f"{args.path}: no timing vectors to train from "
              "(run autotune sweeps first)", file=sys.stderr)
        return 1
    print(f"trained v{model.version} on {model.n_samples} buckets "
          f"({len(model.candidates)} candidates, sigma={model.sigma:.3f}) "
          f"-> {artifact}")
    return 0


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    # same resolution as the dispatch layer ($REPRO_TORCH_AUTOTUNE_CACHE
    # or the ~/.cache/repro_torch default)
    default_path = dp.AutotuneCache().path

    def add(name, fn, **extra):
        p = sub.add_parser(name)
        p.add_argument("path", nargs="?", default=default_path,
                       help=f"cache file (default {default_path})")
        p.set_defaults(fn=fn)
        for flag, kw in extra.items():
            p.add_argument(flag, **kw)
        return p

    add("show", cmd_show, **{"--json": {"action": "store_true"}})
    add("validate", cmd_validate)
    add("compact", cmd_compact,
        **{"--drop-timings": {"action": "store_true",
                              "help": "strip timing vectors + features "
                                      "(keeps the winners)"}})
    add("export", cmd_export,
        **{"--output": {"default": None, "help": "write here, not stdout"}})
    add("train", cmd_train,
        **{"--artifact": {"default": None,
                          "help": "artifact path (default: next to cache)"},
           "--steps": {"type": int, "default": 400},
           "--device": {"default": "cuda",
                        "help": "where to fit the model (default: the "
                                "card; cpu on a host without one)"}})
    args = ap.parse_args(argv[1:])
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
