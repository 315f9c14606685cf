"""BENCHMARK.json and every configuration, traffic and reader file:
present, parsed, and named from the allowed characters."""
import json
import os
import re

import pytest

from portbench.tests.helpers import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 65536


def test_configs_parse_and_are_used():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        # a cut names a key of the file, never a width
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not re.search(r"(_dim|_rank|ngf|ndf|nf|_nc|size)$", k)
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert os.path.exists(os.path.join(
            REPO, "portbench", "drivers", f"{cfg['driver']}.py"))
        assert set(cfg["limits"]) and all(
            NAME.match(k) for k in cfg["limits"])


def test_workloads_parse():
    b = bench()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(REPO, "portbench", "traffic",
                               f"{w['traffic']}.json")) as f:
            json.load(f)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics_parse(kind):
    b = bench()
    names = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b[kind]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= names
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e
            assert os.path.exists(os.path.join(
                REPO, "portbench", "metrics", f"{m['name']}.py"))
    if kind == "end_to_end":
        assert "setup_s" in e2e


def test_every_cell_reports_setup_another_metric_and_a_layer():
    from portbench import harness

    for w in bench()["workloads"]:
        cell = harness.load_cell(w["name"], REPO)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
