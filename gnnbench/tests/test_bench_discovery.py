"""Every name in BENCHMARK.json resolves to its files, by name alone."""
import json

import pytest

from gnnbench.harness import spec

BENCH = spec.load_benchmark()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(name):
    cell = spec.cell(name, BENCH)
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert hasattr(spec.generator(cell.traffic["generator"]), "generate")
    assert hasattr(spec.driver(cell.traffic["driver"]), "run")
    task = spec.task(cell.config["task"])
    for fn in ("build", "minibatch", "layout", "edge_types"):
        assert hasattr(task, fn)
    ref = spec.reference(cell.config["name"])
    for fn in ("Context", "Batch", "loss"):
        assert hasattr(ref, fn)
    assert (spec.BENCH_DIR / "limits" / f"{name}.json").exists()
    assert cell.per_layer and cell.end_to_end


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader(name):
    reader = spec.metric_reader(name)
    assert callable(reader.read)
    assert getattr(reader, "COMBINE", "rank0") in ("max", "mean", "rank0")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    with open(spec.ROOT / entry["file"]) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert config["source"] == entry["source"]


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == [spec.PACKAGE]
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
