"""95th percentile of a call's time on the benchmark's clock (plan, execute
and the synchronize that lands the output), over the window's calls
(Python's ``statistics.quantiles``, exclusive method)."""
import statistics
import sys


def read(ctx):
    times = [r["call_s"] * 1e3 for r in ctx["calls"]]
    if len(times) < 2:
        return None
    print(f"perfbench: call_p95_ms over {len(times)} calls", file=sys.stderr)
    return statistics.quantiles(times, n=100)[94]
