"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name; no module of the benchmark imports JAX or the JAX package,
and the plain references import nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from slam_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = manifest.load()


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["slam_bench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(group):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert set(e) <= allowed[group], set(e) - allowed[group]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in e.get("reduced", []):
            assert NAME.match(key)
    if group == "end_to_end":
        assert "setup_s" in names
        for e in BENCH[group]:
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25


def test_cells_report_what_they_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        cell = manifest.cell(w["name"], BENCH)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for name in m.get("workloads", []):
            assert name in {w["name"] for w in BENCH["workloads"]}


def test_metrics_of_one_layer_share_its_name():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"entry", "ingest", "tracker", "kernel", "back end", "device"}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_files_found_by_name(workload):
    cell = manifest.cell(workload, BENCH)
    assert cell.config["name"] == cell.workload["config"]
    assert callable(manifest.entry(cell.config["entry"]).judge)
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] != "setup_s":
            assert callable(manifest.metric(m["name"]).read)
    assert cell.limits
    conf = {c["name"]: c for c in BENCH["configs"]}[cell.workload["config"]]
    assert conf["file"].startswith("slam_bench/")
    assert set(conf["reduced"]) == set(cell.config["reduced"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def _sources(sub=""):
    root = os.path.join(manifest.PACKAGE_DIR, sub)
    for base, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "dvo_slam_tpu"}, tops


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, manifest.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "torch", "numpy"}, tops
