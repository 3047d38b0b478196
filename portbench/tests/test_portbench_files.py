"""BENCHMARK.json and the files it names: each parses, each metric's
``moves`` is reported by all its cells, and nothing under portbench/
imports JAX, the JAX package, or (from the reference) the system."""

import importlib
import json
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys_and_budget():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and all(NAME.match(k) for k in cfg["reduced"])
    assert cfg["file"].startswith("portbench/configs/")
    data = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    _, c = run.load_cell(cell["name"])
    importlib.import_module(f"portbench.drivers.{c.traffic['kind']}")
    assert c.limits and all(v > 0 for v in c.limits.values())
    e2e = run.metrics_of(BENCH, cell["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert run.metrics_of(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        return
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    (moved,) = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell])
    assert run.read_metric(m["name"], {}) is None


def test_cell_pairs_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_no_forbidden_imports():
    assert run.source_violations() == []


def test_import_check_catches(tmp_path, monkeypatch):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "x.py").write_text("import tdgs_torch.rendering\n")
    (tmp_path / "y.py").write_text("from jax import numpy\nimport tdgs.ops\nimport tdgs_torch\n")
    monkeypatch.setattr(run, "HERE", str(tmp_path))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    assert sorted(run.source_violations()) == [
        ("reference/x.py", "tdgs_torch"), ("y.py", "jax"), ("y.py", "tdgs")]


def test_run_without_card_fails(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", str(2**31 + 5),
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
