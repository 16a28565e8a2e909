"""BENCHMARK.json resolves to files of its own, keeps the contract's
names, and the benchmark imports neither JAX nor the JAX package."""

from __future__ import annotations

import ast
import importlib
import json
import re
import subprocess
import sys

import pytest

from portbench import metrics
from portbench.tests.conftest import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
PKG = ROOT / "portbench"


def line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= len(b["command"]) <= 32 and all(map(line, b["command"]))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024


def test_configs_resolve():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert all((ROOT / e["file"]).is_file() for e in cfg["assets"])


def test_workloads_resolve():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads(
            (PKG / "traffic" / f"{w['traffic']}.json").read_text())
        from portbench.loop import ENTRIES

        assert traffic["entry"] in ENTRIES
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_metrics_resolve():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert m["source"] in SOURCES
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        mod = importlib.import_module(metrics.module_name(m["name"]))
        assert callable(mod.read)
        layers.setdefault(m.get("layer"), set())
    from portbench.run import load_cell

    for cell in cells:
        spec = load_cell(cell, b)
        assert "setup_s" in spec["end_to_end"]
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]


def imports(path):
    """Top-level names of every module the file imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], node.module


def test_no_jax_and_a_standalone_reference():
    files = sorted(PKG.rglob("*.py"))
    assert files
    for path in files:
        for top, full in imports(path):
            assert top not in ("jax", "jaxlib", "flax", "heif_tpu"), (path, full)
            if "reference" in path.relative_to(PKG).parts[:1]:
                assert top != "heif_tpu_torch", (path, full)
            if path.name in ("judge.py", "inputs.py", "mux.py"):
                assert top != "heif_tpu_torch", (path, full)


def test_no_fixed_paths_outside_the_checkout():
    fixed = ("/" + "tmp", "/dev/" + "shm")
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not node.value.startswith(fixed), path


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "flagship.decode", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 3 and p.stdout == ""
