"""Finds everything by name: a cell's entry in ``BENCHMARK.json`` (at the
root of the checkout), its workload file (``workloads/<cell>.json``: its
configuration, its traffic and the limits of its check), the configuration
(``configs/<config>.json``, which names its model kind,
``kinds/<kind>.py``), the traffic mix (``traffic/<traffic>.json``, which
names its driver, ``drivers/<driver>.py``) and the per-layer metric
readers (``metrics/<metric>.py``).  Adding a cell, a configuration, a
model kind or a metric is adding files."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Dict, List

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def config(name: str, pkg: str = PKG) -> dict:
    return _json(pkg, "configs", name + ".json")


def traffic(name: str, pkg: str = PKG) -> dict:
    return _json(pkg, "traffic", name + ".json")


def _reported(metric: dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """A metric is reported in the cells its ``workloads`` lists; without
    the key, an end-to-end metric in every cell, a per-layer one in every
    cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def cell(name: str, root: str = ROOT, pkg: str = PKG) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry, workload file,
    configuration, traffic, and the names of the end-to-end and per-layer
    metrics it reports."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = _json(pkg, "workloads", name + ".json")
    if (work["config"], work["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"{name}: workloads/{name}.json and BENCHMARK.json "
                         "name different configurations or traffic")
    e2e = [m["name"] for m in bench["end_to_end"]
           if _reported(m, name, [])]
    layer = [m["name"] for m in bench["per_layer"]
             if _reported(m, name, e2e)]
    tr = traffic(entry["traffic"], pkg)
    return {"name": name, "chips": entry["chips"], "entry": entry,
            "config": config(entry["config"], pkg), "traffic": tr,
            "driver": tr["driver"], "limits": work.get("limits", {}),
            "end_to_end": e2e, "per_layer": layer}


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def kind(name: str):
    """The model kind ``name`` (``kinds/<name>.py``; ``kinds/__init__.py``
    says what it gives)."""
    return importlib.import_module(f"portbench.kinds.{name}")


def metric_reader(name: str, pkg: str = PKG):
    """``read(ctx)`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(pkg, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def metric_units(root: str = ROOT) -> Dict[str, str]:
    bench = benchmark(root)
    return {m["name"]: m["unit"] for m in bench["end_to_end"]
            + bench["per_layer"]}
