"""Finding a cell's parts by name: ``BENCHMARK.json`` names them, files hold them.

* a configuration ``<c>`` is ``benchmark/configs/<c>.json``: widths, the
  served dtype and stream options, the output check's limits;
* a traffic mix ``<t>`` is ``benchmark/traffic/<t>.json`` (``camera.py``
  reads ``kind: camera``; another kind of client brings
  ``benchmark/traffic/<kind>.py`` with a ``run_clients`` of the same form);
* a per-layer metric ``<m>`` is read by ``benchmark/metrics/<m>.py``, whose
  ``read(record)`` returns a number, or None where it finds nothing to read.

So a cell is added by adding files and an entry of ``workloads``; no file of
the harness changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

__all__ = ["Cell", "load_cell", "reader", "ROOT", "BENCH_DIR"]

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: str | None = None, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (default: the checkout's) with
    its configuration and traffic files read from ``bench_dir``."""
    with open(bench_file or os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    with open(os.path.join(bench_dir, "configs", w["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The ``read(record)`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
