"""Mean time of ``plan`` a call, on the benchmark's clock: all the window's
plan time over its calls."""


def read(ctx):
    calls = ctx["calls"]
    if not calls:
        return None
    return sum(r["plan_s"] for r in calls) / len(calls) * 1e6
