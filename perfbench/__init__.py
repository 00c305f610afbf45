"""The benchmark of ``repro_torch``: see ``run`` and ``BENCHMARK.json``."""
import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_module(kind: str, name: str):
    """The benchmark's module ``<kind>/<name>.py``: a pattern generator
    (``patterns``), a caller (``entries``) or a per-layer metric's reader
    (``metrics``), found by the name a file of data gives."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind} module {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
