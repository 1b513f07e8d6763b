"""``BENCHMARK.json`` and the files it names, found by name:

* a configuration: the ``file`` of its entry in ``configs``;
* a traffic mix ``<traffic>``: ``slam_bench/traffic/<traffic>.json``;
* an entry adapter ``<entry>`` (the configuration's ``entry``):
  ``slam_bench/entries/<entry>.py``;
* a metric ``<name>`` (end to end or per layer):
  ``slam_bench/metrics/<name>.py``;
* a cell's limits for ``correct``: ``slam_bench/limits/<cell>.json``.

Adding a deployment, a mix, an entry or a metric adds files and entries
and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List, NamedTuple

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


class Cell(NamedTuple):
    workload: dict
    config: dict  # the configuration file's contents
    traffic: dict
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # ... with --trace 1
    limits: dict


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load() -> dict:
    return _json(BENCHMARK)


def reports(metric: dict, workload: str, bench: dict) -> bool:
    """Whether ``workload`` reports ``metric``: listed under its
    ``workloads``, or, without that key, for a per-layer metric every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        moved = [m for m in bench["end_to_end"] if m["name"] == metric["moves"]]
        return bool(moved) and reports(moved[0], workload, bench)
    return True


def cell(name: str, bench: dict = None) -> Cell:
    bench = bench or load()
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(workloads)}")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return assemble(w, configs[w["config"]]["file"], bench,
                    _json(os.path.join(PACKAGE_DIR, "limits", name + ".json")))


def assemble(w: dict, config_file: str, bench: dict, limits: dict) -> Cell:
    """A cell from its workload entry, its configuration's file (relative
    to the repository) and its limits."""
    return Cell(
        workload=w, config=_json(os.path.join(ROOT, config_file)),
        traffic=_json(os.path.join(PACKAGE_DIR, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, w["name"], bench)],
        per_layer=[m for m in bench["per_layer"] if reports(m, w["name"], bench)],
        limits=limits,
    )


def _module(kind: str, name: str):
    path = os.path.join(PACKAGE_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"slam_bench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(name: str):
    """The entry adapter module ``entries/<name>.py``."""
    return _module("entries", name)


def metric(name: str):
    """The reader module ``metrics/<name>.py`` (its ``read(run)``)."""
    return _module("metrics", name)
