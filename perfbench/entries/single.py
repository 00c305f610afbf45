"""One product a call through the program's main entry: ``plan`` then
``execute`` (``dispatch.spgemm``), with the engine the traffic mix names."""
import sys
import time


def make_call(traffic, lanes, shape, device):
    """The operand on ``device`` and a function that makes one call:
    ``call() -> (plan_s, call_s, output, stats)``."""
    import torch
    from torch.profiler import record_function

    from repro_torch.core import dispatch
    from repro_torch.core.formats import csr_from_numpy

    if len(lanes) != 1:
        raise ValueError("a single-product mix has one lane")
    A = csr_from_numpy(*lanes[0], shape, device=device)
    engine = traffic["engine"]
    on_card = torch.device(device).type == "cuda"
    first = dispatch.plan(A, A, engine, device=device)
    print(f"perfbench: plan: engine {first.engine} ({first.source}"
          f"{', rule ' + first.rule if first.rule else ''})",
          file=sys.stderr, flush=True)

    def call():
        t0 = time.perf_counter()
        with record_function("perfbench.plan"):
            p = dispatch.plan(A, A, engine, device=device)
        t1 = time.perf_counter()
        with record_function("perfbench.execute"):
            out, stats = dispatch.execute(p, A, A, return_stats=True)
        with record_function("perfbench.sync"):
            if on_card:
                torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t0, out, stats
    return call


def outputs(out, n_lanes):
    """The output as one numpy ``(indptr, indices, data)``, cut to its
    nnz."""
    from perfbench.harness import csr_arrays
    return [csr_arrays(out)]
