"""BENCHMARK.json, its names and units, and the files each cell finds by
name; a cell added as files alone is picked up."""

import json
import shutil

import pytest

from harness import manifest

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_manifest_parses_with_the_contract_keys():
    man = manifest.manifest()
    assert set(man) == TOP_KEYS
    assert man["paths"] == ["h100_bench"]
    assert man["command"] == ["python3", "h100_bench/run.py"]
    assert 1 <= man["run_seconds"] <= 51
    for e in man["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert e["file"].startswith("h100_bench/") and not e["reduced"]
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_files():
    assert manifest.problems(manifest.manifest()) == []


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.manifest()["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    man = manifest.manifest()
    e2e = {m["name"] for m in manifest.metrics_of(cell, man, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.metrics_of(cell, man, "per_layer")
    assert layers and all(m["moves"] in e2e for m in layers)
    cfg = manifest.config(manifest.workload(cell, man)["config"])
    assert cfg["name"] == manifest.workload(cell, man)["config"]
    for m in layers:
        assert callable(manifest.reader(m["name"]))


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    bench = tmp_path / "h100_bench"
    shutil.copytree(manifest.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = manifest.manifest()
    (bench / "traffic" / "batch2.json").write_text(json.dumps(
        {**manifest.traffic("batch4"), "gop_batch": 2}))
    (bench / "limits" / "camvid-bise18.batch2.json").write_text(json.dumps({"gap_q9999": 0.2}))
    (bench / "metrics" / "steps.serve2.py").write_text("def read(run):\n    return 1.0\n")
    man["workloads"].append({"name": "camvid-bise18.batch2", "config": "camvid-bise18",
                             "traffic": "batch2", "chips": 1, "why": "a new mix"})
    man["per_layer"].append({"name": "steps.serve2", "unit": "ms", "better": "lower",
                             "source": "host_clock", "layer": "gop/pipeline",
                             "moves": "frames_per_s", "workloads": ["camvid-bise18.batch2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    got = manifest.manifest(tmp_path)
    assert manifest.problems(got, bench) == []
    assert manifest.traffic(manifest.workload("camvid-bise18.batch2", got)["traffic"],
                            bench)["gop_batch"] == 2
    assert [m["name"] for m in manifest.metrics_of("camvid-bise18.batch2", got, "per_layer")] \
        == ["steps.serve2"]
    assert manifest.reader("steps.serve2", bench)(None) == 1.0


def test_a_missing_file_is_named():
    man = manifest.manifest()
    man["workloads"].append({"name": "camvid-bise18.nope", "config": "camvid-bise18",
                             "traffic": "batch4", "chips": 1, "why": "x"})
    assert any("limits/camvid-bise18.nope.json" in p for p in manifest.problems(man))
