"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``, whose
``driver`` names the general loop in ``drivers/`` that reads it), the
limits of its correctness check (``limits/<cell>.json``) and the reader of
each per-layer metric (``metrics/<metric>.py``). Everything is found by the
names in the manifest, so a cell, a mix or a metric is added as files and
an entry, and no file that is there changes."""

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def workload(name, man=None):
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[w['name'] for w in man['workloads']]}")


def config(name, bench=BENCH):
    return load_json(Path(bench) / "configs" / f"{name}.json")


def traffic(name, bench=BENCH):
    return load_json(Path(bench) / "traffic" / f"{name}.json")


def limits(cell, bench=BENCH):
    return load_json(Path(bench) / "limits" / f"{cell}.json")


def metrics_of(cell, man, kind):
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those that list it, or that list no cells at all."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def reader(metric, bench=BENCH):
    """``read(run)`` of ``metrics/<metric>.py``."""
    path = Path(bench) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name):
    return importlib.import_module(f"drivers.{name}")


def problems(man, bench=BENCH):
    """What in ``man`` breaks the naming rules or names a missing file."""
    out = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[kind]]
        if len(set(names)) != len(names):
            out.append(f"{kind}: a name repeats")
        for n in names:
            if not NAME.match(n):
                out.append(f"{kind}: bad name {n!r}")
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better is {m['better']!r}")
    configs = {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"{w['name']}: bad {key} {w[key]!r}")
        if w["config"] not in configs:
            out.append(f"{w['name']}: config {w['config']} not declared")
        for path in (Path(bench) / "configs" / f"{w['config']}.json",
                     Path(bench) / "traffic" / f"{w['traffic']}.json",
                     Path(bench) / "limits" / f"{w['name']}.json"):
            if not path.is_file():
                out.append(f"{w['name']}: missing {path.relative_to(bench)}")
        if not (Path(bench) / "drivers" / f"{traffic(w['traffic'], bench)['driver']}.py").is_file():
            out.append(f"{w['name']}: missing driver")
    for m in man["per_layer"]:
        if not (Path(bench) / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: missing reader")
    return out
