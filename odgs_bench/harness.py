"""What a cell is made of, found by the names in BENCHMARK.json.

  configs/<config>.json    the configuration as run (its `file` entry)
  traffic/<traffic>.json   the traffic mix: numbers the generator reads;
                           its `kind` names the module kinds/<kind>.py
                           that runs it
  workloads/<cell>.json    the cell's check: its limits and traced calls
  metrics/<metric>.py      a per-layer reader, read(ctx) -> number | None;
                           where there is none, metrics/<quantity>.py,
                           the quantity being the name up to its first
                           dot (`mfu` of `mfu.obj256.train_b4`)
  reference/<name>.py      the plain reference a configuration names

A later cell, configuration or metric is new files and new entries in
BENCHMARK.json; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def cell(spec: dict, root: Path, name: str, here: Path = HERE) -> dict:
    """The cell `name`: its entry, configuration, traffic, check and the
    metrics it reports, by kind ("end_to_end", "per_layer")."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    out = {
        "entry": entry,
        "config_entry": conf,
        "config": _json(root / conf["file"]),
        "traffic": _json(here / "traffic" / f"{entry['traffic']}.json"),
        "check": _json(here / "workloads" / f"{name}.json"),
    }
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    out["metrics"] = {"end_to_end": e2e, "per_layer": per_layer}
    return out


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def kind(cell: dict):
    """The module kinds/<kind>.py that runs the cell's traffic."""
    name = cell["traffic"]["kind"]
    if not name.isidentifier() or not (HERE / "kinds" / f"{name}.py"
                                       ).is_file():
        raise KeyError(f"no kind of cell {name!r} in odgs_bench/kinds")
    return importlib.import_module(f"odgs_bench.kinds.{name}")


def reader(metric: str, here: Path = HERE):
    """The per-layer reader of `metric`: metrics/<metric>.py, or else
    metrics/<quantity>.py."""
    path = here / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = here / "metrics" / f"{metric.split('.')[0]}.py"
    return _module(path, "odgs_bench_metric_" + path.stem.replace(".", "_"))


def reference(name: str, here: Path = HERE):
    """The plain reference reference/<name>.py."""
    return _module(here / "reference" / f"{name}.py",
                   "odgs_bench_reference_" + name)


def read_metrics(metrics: list, ctx: dict, here: Path = HERE) -> dict:
    """Each per-layer metric's reading; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in metrics:
        v = reader(m["name"], here).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
