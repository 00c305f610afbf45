"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The cell, its
configuration, traffic mix and metrics are read from ``BENCHMARK.json``.
The last line of standard output is the result as one JSON object; the
last lines of standard error are the compared numbers beside their limits.
Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, the run prints no
result and exits with another code than 0.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THREADS = "1"
# glibc's mallopt parameters a configuration may fix (malloc.h)
MALLOPT = {"M_TRIM_THRESHOLD": -1, "M_MMAP_THRESHOLD": -3}


def set_host_malloc(cfg: dict) -> dict:
    """Fix the host allocator's thresholds where the configuration states
    them (``host_malloc``, part of its deployment): glibc's default mmap
    threshold rises as large blocks are freed, so whether a call's host
    temporaries of a few MB come from fresh, page-faulting mappings or from
    the heap would depend on the process's history.  Returns the settings
    the allocator took ({} off glibc)."""
    want = cfg.get("host_malloc") or {}
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return {}
    return {k: v for k, v in want.items()
            if libc.mallopt(MALLOPT[k], int(v))}


def pin_environment() -> None:
    """Fixed host threads, and the program's autotune cache under the
    ``TMPDIR`` the run is given.  The program's kernel build cache is
    ``build/`` inside the checkout, a fixed place."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = THREADS
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        tempfile.gettempdir(), "perfbench", "spgemm_autotune.json")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return res.stdout.strip() or f"not read (exit {res.returncode})"


def main(argv=None) -> int:
    args = parse(argv)
    pin_environment()
    from perfbench import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = harness.find_cell(manifest, args.workload)
    malloc = set_host_malloc(cfg)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        harness.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"this machine has {cards}")
        return 2
    torch.set_num_threads(int(THREADS))
    harness.log(f"card: {power_limit()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}; host allocator: "
                f"{malloc or 'glibc defaults'}")
    result = harness.run_cell(
        cfg, traffic,
        harness.cell_metrics(manifest, args.workload, bool(args.trace)),
        seed=args.seed, seconds=args.seconds, trace_on=bool(args.trace),
        device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded after the window: {', '.join(bad)}; no result")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
