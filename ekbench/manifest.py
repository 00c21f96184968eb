"""Finding a cell's files by the names in `BENCHMARK.json`.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
the configuration's entry names its file.  The traffic mix, the cell's
limits and each per-layer metric's reader live under `ekbench/` by name,
so a cell, a configuration or a metric is added with new files and new
entries alone."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<cell>.json: {number: limit}
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    root: str


def _read(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell: str, root: str = ROOT) -> Cell:
    """The cell `cell` of `<root>/BENCHMARK.json` with its files."""
    bench = _read(os.path.join(root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(cell)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in {root}/BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    here = os.path.join(root, "ekbench")
    return Cell(
        name=cell, chips=int(entry["chips"]),
        config=_read(os.path.join(root, conf["file"])),
        traffic=_read(os.path.join(here, "traffic", entry["traffic"] + ".json")),
        limits=_read(os.path.join(here, "limits", cell + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, cell)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, cell)],
        root=root)


def reader(cell: Cell, metric: str):
    """The module of `ekbench/metrics/<metric>.py` (names may hold dots)."""
    path = os.path.join(cell.root, "ekbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "ekbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_overrides(config: dict) -> dict:
    """The configuration file's grid, physics and run values, flat: the
    keyword overrides of `ekpnp_torch.config.preset`, so the program runs
    every number the file states."""
    flat = {}
    for group in ("grid", "physics", "run"):
        flat.update(config[group])
    return flat
