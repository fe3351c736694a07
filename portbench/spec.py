"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file under this folder (``configs/<config>.json``,
``traffic/<traffic>.json``), and each per-layer metric is a reader of its
own (``metrics/<metric>.py``, a ``read(trace)`` function).  Nothing here
knows a cell by name: a later change adds a cell by adding files and
entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Cell:
    """One cell: its entry, its configuration's and traffic mix's data, and
    the metrics it reports in each kind of run."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list


def validate(bench: dict, root: pathlib.Path = ROOT) -> None:
    """Raise where a name of ``bench`` does not resolve: a cell's
    configuration, its configuration's file, its mix, a metric's reader or
    a metric's cell.  The contract's other limits are the driver's to
    check."""
    configs = {c["name"]: c for c in bench["configs"]}
    names = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        if w["config"] not in configs:
            raise ValueError(f"cell {w['name']}: no configuration "
                             f"{w['config']}")
        if not (root / configs[w["config"]]["file"]).is_file():
            raise ValueError(f"no file {configs[w['config']]['file']}")
        if not (PKG / "traffic" / f"{w['traffic']}.json").is_file():
            raise ValueError(f"cell {w['name']}: no traffic/"
                             f"{w['traffic']}.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        for w in m.get("workloads", []):
            if w not in names:
                raise ValueError(f"{m['name']}: no cell {w}")
    for m in bench["per_layer"]:
        if not (PKG / "metrics" / f"{m['name']}.py").is_file():
            raise ValueError(f"{m['name']}: no reader metrics/"
                             f"{m['name']}.py")


def _reports(m: dict, cell: str) -> bool:
    return "workloads" not in m or cell in m["workloads"]


def load(root: pathlib.Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the checkout's root, validated."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    validate(bench, root)
    return bench


def cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    # a per-layer metric without a cell list is reported wherever its
    # end-to-end metric is
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (_reports(m, name) if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic_name=w["traffic"],
                traffic=json.loads(
                    (PKG / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=e2e, per_layer=per)


def reader(metric: str):
    """The ``read(trace)`` function of ``metrics/<metric>.py``: it returns
    the metric's value, or None where the trace holds nothing to read."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
