"""Put the repository's root and ``src`` on the path, and give the tests
small stand-ins of the benchmark's configurations."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402


def small_config(name: str, rows: int = 1500) -> dict:
    """The configuration ``name`` at about ``rows`` rows, its pattern
    generator kept: a stencil on a smaller cube, a graph with a smaller
    head degree."""
    cfg = copy.deepcopy(harness.load_json(
        ROOT / "perfbench" / "configs" / f"{name}.json"))
    if cfg["pattern"] == "stencil27":
        g = max(3, round(rows ** (1 / 3)))
        cfg.update(nx=g, ny=g, nz=g, rows=g ** 3, cols=g ** 3)
    else:
        cfg.update(rows=rows, cols=rows, degree_head=rows / 25,
                   pattern_seed=11)
    return cfg


@pytest.fixture
def manifest():
    return harness.load_json(ROOT / "BENCHMARK.json")
