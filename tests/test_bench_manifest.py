"""The benchmark's manifest (``BENCHMARK.json``) against the files the
harness finds by name (``h100_bench/harness/manifest.py``): each cell's
configuration, traffic mix, limits and driver, and the reader of each
per-layer metric it reports, each found and imported. A cheap guard, in
tier-1, of what ``h100_bench/tests`` covers at length."""

import importlib
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1] / "h100_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import manifest  # noqa: E402

MAN = manifest.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_names_units_and_files_of_the_manifest():
    assert manifest.problems(MAN) == []


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_finds_its_files_and_imports_its_code(cell):
    w = manifest.workload(cell, MAN)
    cfg = manifest.config(w["config"])
    assert cfg["name"] == w["config"]
    assert any(c["name"] == w["config"] and Path(manifest.ROOT / c["file"]).is_file()
               for c in MAN["configs"])
    tr = manifest.traffic(w["traffic"])
    driver = manifest.driver(tr["driver"])
    assert callable(driver.run)
    limits = manifest.limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    mod, cls = cfg["reference"].rsplit(".", 1)
    assert callable(getattr(importlib.import_module(mod), cls))
    e2e = {m["name"] for m in manifest.metrics_of(cell, MAN, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.metrics_of(cell, MAN, "per_layer")
    assert layers and all(m["moves"] in e2e for m in layers)
    for m in layers:
        assert callable(manifest.reader(m["name"])), m["name"]
