"""Core SpGEMM substrate of the port: formats, engines, plan/execute.

The canonical multiply entry point is ``repro_torch.core.spgemm`` — the
dispatch-layer function (``spgemm(A, B)``, which selects an engine, or
``spgemm(A, B, engine="spz")``).  The engines *module*
``repro_torch.core.spgemm`` stays importable under the alias
``repro_torch.core.spgemm_engines``; the alias must bind before
``dispatch.spgemm`` shadows the submodule name on the package.
"""
from repro_torch.core import spgemm as spgemm_engines
from repro_torch.core.dispatch import (AutotuneCache, ExecutionPlan,
                                       available_engines, execute,
                                       execute_batched, explain, plan,
                                       plan_batched, register_engine, spgemm,
                                       spgemm_batched)
from repro_torch.core.formats import BatchedCSR, CSR, batch_csr, random_sparse

__all__ = [
    "AutotuneCache", "BatchedCSR", "CSR", "ExecutionPlan",
    "available_engines", "batch_csr", "execute", "execute_batched",
    "explain", "plan", "plan_batched", "random_sparse", "register_engine",
    "spgemm", "spgemm_batched", "spgemm_engines",
]
