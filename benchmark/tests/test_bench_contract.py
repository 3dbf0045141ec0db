"""BENCHMARK.json against the benchmark's rules, and the files it names."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.cells import BENCH_DIR, ROOT, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _metrics(bench):
    return bench["end_to_end"] + bench["per_layer"]


def test_names_and_units_use_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in _metrics(bench)]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in _metrics(bench))
    assert all(m["better"] in ("lower", "higher") for m in _metrics(bench))
    for group in (bench["configs"], bench["workloads"], _metrics(bench)):
        assert len({x["name"] for x in group}) == len(group)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_moves_is_reported_by_each_of_its_cells(bench):
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert sum(reports(m, cell) for m in bench["end_to_end"]) >= 2
        assert any(reports(m, cell) for m in bench["per_layer"])


def test_bounds_and_run_length(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert 1 <= bench["run_seconds"] <= 51
    # a full check with the 24 cells later PRs may add fits the driver's day
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_every_named_file_exists_and_each_layer_is_named_alike(bench):
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert set(cfg["limits"]) == {"latent_rel_l2", "image_rms"}
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
        assert w["chips"] == 1
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers == {"engine", "model step", "kernels", "device"}


def test_each_cell_loads_with_its_metrics(bench):
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.config["family"] in ("sd15", "sdxl")
        assert [m["name"] for m in cell.end_to_end][-1] == "setup_s"
        assert cell.per_layer
