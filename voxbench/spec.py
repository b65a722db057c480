"""The benchmark's definition, read from ``BENCHMARK.json`` and the files it
names: a cell's configuration (``configs[].file``), its traffic mix
(``voxbench/traffic/<traffic>.json``) and the reader of each per-layer
metric (``voxbench/metrics/<name>.py``).  Adding any of these is adding a
file and an entry; no code changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

VOXBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(VOXBENCH)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: str = ROOT,
         traffic_dir: str | None = None) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; there are {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    traffic_dir = traffic_dir or os.path.join(VOXBENCH, "traffic")
    with open(os.path.join(traffic_dir, w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, metrics_dir: str | None = None):
    """The reader of a per-layer metric: ``<metric>.py`` in ``metrics_dir``,
    else in ``voxbench/metrics``.  Its ``read(trace)`` gives the metric or
    None, its ``MOVES`` names the end-to-end metric it should move."""
    dirs = [metrics_dir] if metrics_dir else []
    dirs.append(os.path.join(VOXBENCH, "metrics"))
    path = next((p for p in (os.path.join(d, metric + ".py") for d in dirs)
                 if os.path.exists(p)), None)
    if path is None:
        raise FileNotFoundError(f"no reader for {metric} in {dirs}")
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"voxbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
