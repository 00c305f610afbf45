"""Quickstart for the PyTorch/CUDA port: the SparseZipper primitives and
SpGEMM, on the card by default.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

On the card the zipper primitives run the hand-written kernels (K4
stream sort, K5 stream merge) and ``spgemm`` the ones its engine takes;
on the CPU every primitive runs its plain torch version.  It does on the
port what ``examples/quickstart.py`` does on the JAX package, and then
lets ``spgemm(A, B)`` choose its engine.
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import dispatch, spgemm, spgemm_engines as sg
from repro_torch.core.formats import random_sparse
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where to run (default: the card)")
    dev = resolve_device(ap.parse_args().device)

    # --- 1. the zipper primitives ---------------------------------------
    # Four streams of key-value tuples (one per matrix-register row in the
    # paper); sort each chunk, accumulating duplicate keys.
    keys = torch.tensor([[5, 2, 5, 9], [7, 7, 7, 7], [3, 1, 4, 1],
                         [0, 0, 0, 0]], dtype=torch.int32, device=dev)
    vals = torch.arange(16, dtype=torch.float32, device=dev).reshape(4, 4)
    lens = torch.tensor([4, 4, 4, 2], dtype=torch.int32, device=dev)
    k, v, n = ops.stream_sort(keys, vals, lens)
    print("mssort  keys:", k.cpu().numpy())
    print("        vals:", v.cpu().numpy())
    print("        lens:", n.cpu().numpy(), " (duplicates were accumulated)")

    # Merge two sorted chunks with data-dependent advancement (mszip).
    ka = torch.tensor([[1, 3, 5, 9]], dtype=torch.int32, device=dev)
    kb = torch.tensor([[2, 3, 4, 100]], dtype=torch.int32, device=dev)
    va = torch.ones((1, 4), dtype=torch.float32, device=dev)
    vb = torch.full((1, 4), 10.0, dtype=torch.float32, device=dev)
    l4 = torch.tensor([4], dtype=torch.int32, device=dev)
    klo, vlo, khi, vhi, ca, cb, ol = ops.stream_merge(ka, va, l4, kb, vb, l4)
    print("\nmszip   merged:", klo[0].cpu().numpy(), "+",
          khi[0].cpu().numpy())
    print("        consumed a,b:", int(ca[0]), int(cb[0]),
          "(the 100 waits for the next chunk — merge bit unset)")

    # --- 2. SpGEMM end-to-end --------------------------------------------
    A = random_sparse(256, 256, 0.02, seed=1, pattern="powerlaw")
    C_ref = sg.spgemm_scl_array(A, A)          # scalar oracle (host)
    C_spz, stats = spgemm(A, A, engine="spz", device=dev, return_stats=True)
    err = (C_ref.to_dense() - C_spz.to_dense().cpu()).abs().max().item()
    print(f"\nSpGEMM 256x256 A@A: max err vs oracle = {err:.2e}")
    print(f"dynamic instructions: {stats.n_mssort} mssort, "
          f"{stats.n_mszip} mszip")
    print(f"chunk traffic: {stats.chunk_loads} loads, "
          f"{stats.chunk_stores} stores")
    assert err < 1e-4

    # --- 3. engine="auto": the dispatch layer picks ----------------------
    # an autotune cache of this run's own, so the example leaves no file
    with tempfile.TemporaryDirectory() as tmp:
        auto(A, C_ref, dev, dispatch.AutotuneCache(
            os.path.join(tmp, "autotune.json")))


def auto(A, C_ref, dev, cache) -> None:
    for pattern, density in (("uniform", 0.002), ("uniform", 0.05),
                             ("powerlaw", 0.02), ("banded", 0.008)):
        M = random_sparse(96, 96, density, seed=3, pattern=pattern)
        p = dispatch.plan(M, M, device=dev, cache=cache)
        out = dispatch.execute(p, M, M)
        want = sg.spgemm_scl_array(M, M).to_dense()
        err = (want - out.to_dense().cpu()).abs().max().item()
        print(f"auto {pattern:8s} density {density}: engine {p.engine} "
              f"(rule {p.rule}), max err {err:.2e}")
        assert err < 1e-4
    info = dispatch.explain(A, A, device=dev, cache=cache)
    feats = {k: round(v, 4) if isinstance(v, float) else v
             for k, v in info["features"].items()}
    print(f"explain 256x256: {info['engine']} by rule {info['rule']}, "
          f"features {feats}")
    np.testing.assert_allclose(
        spgemm(A, A, device=dev, cache=cache).to_dense().cpu().numpy(),
        C_ref.to_dense().numpy(), rtol=1e-4, atol=1e-4)


if __name__ == "__main__":
    main()
