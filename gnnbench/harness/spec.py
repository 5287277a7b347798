"""The benchmark's definition and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the cells; a cell
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``). The mix names its generator
(``generators/<generator>.py``) and its driver (``drivers/<driver>.py``);
the configuration names its task adapter (``tasks/<task>.py``) and, by its
own name, its plain reference (``reference/<config>.py``); each per-layer
metric is read by ``metrics/<metric>.py``. Everything is found by name, so a
later change adds a configuration, a mix, a driver or a metric as new files.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
PACKAGE = BENCH_DIR.name


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]  # this cell's end-to-end metrics
    per_layer: List[Dict[str, Any]]  # this cell's per-layer metrics

    @property
    def ranks(self) -> int:
        return int(self.traffic.get("ranks", 1))


def _load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Optional[Path] = None) -> Dict[str, Any]:
    return _load_json(path or ROOT / "BENCHMARK.json")


def load_config(name: str) -> Dict[str, Any]:
    return _load_json(BENCH_DIR / "configs" / f"{name}.json")


def load_traffic(name: str) -> Dict[str, Any]:
    return _load_json(BENCH_DIR / "traffic" / f"{name}.json")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    listed = metric.get("workloads")
    return listed is None or cell in listed


def cell(name: str, benchmark: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    benchmark = benchmark or load_benchmark()
    for w in benchmark["workloads"]:
        if w["name"] == name:
            return Cell(
                name=name,
                config=load_config(w["config"]),
                traffic=load_traffic(w["traffic"]),
                chips=int(w["chips"]),
                end_to_end=[m for m in benchmark["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in benchmark["per_layer"] if _applies(m, name)],
            )
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _module(kind: str, name: str):
    return importlib.import_module(f"{PACKAGE}.{kind}.{name}")


def generator(name: str):
    return _module("generators", name)


def driver(name: str):
    return _module("drivers", name)


def task(name: str):
    return _module("tasks", name)


def reference(config_name: str):
    return _module("reference", config_name)


def metric_reader(name: str):
    return _module("metrics", name)
