"""Find a cell by its name in BENCHMARK.json, with the files it names.

A cell joins one configuration file (`configs[].file`) with one traffic
file (`benchmark/traffic/<traffic>.json`); a per-layer metric's reader is
`benchmark/layer_metrics/<metric>.py`.  Adding a cell, a traffic mix or
a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(work))})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def reader(metric: str):
    """The `read(trace)` function of a per-layer metric, from the file
    named after it, else (a quantity split by cells, "encode_ms.cigar")
    from its quantity's file; loaded by path, as a name may hold dots."""
    path = os.path.join(HERE, "layer_metrics", metric + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "layer_metrics",
                            metric.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.layer_metrics._" + metric.replace(".", "_").replace(
            "-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
