"""Core SpGEMM substrate of the port: formats, engines, plan/execute.

The canonical multiply entry point is ``repro_torch.core.spgemm`` — the
dispatch-layer function (``spgemm(A, B, engine="spz")``).  The engines
*module* ``repro_torch.core.spgemm`` stays importable under the alias
``repro_torch.core.spgemm_engines``; the alias must bind before
``dispatch.spgemm`` shadows the submodule name on the package.
"""
from repro_torch.core import spgemm as spgemm_engines
from repro_torch.core.dispatch import execute, plan, spgemm
from repro_torch.core.formats import CSR, random_sparse

__all__ = ["CSR", "execute", "plan", "random_sparse", "spgemm",
           "spgemm_engines"]
