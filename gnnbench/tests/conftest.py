"""Small cells for the CPU tests: the shipped configurations and mixes at
a size a test run holds (small padding, small graphs, few batches)."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gnnbench.harness import spec  # noqa: E402

E2E = [{"name": "train_edges_per_s", "unit": "edges/s"}, {"name": "train_step_p95_ms", "unit": "ms"},
       {"name": "setup_s", "unit": "s"}]


def small_cell(name: str, ranks: int = 1) -> spec.Cell:
    """The benchmark's cell ``name`` cut to a test's size."""
    cell = copy.deepcopy(spec.cell(name))
    p = cell.config["padding"]
    if cell.config["task"] == "graph2class":
        p.update(max_nodes=512, max_edge_slots=6144, stop_extending_after_nodes=512,
                 reference_budgets={"supernodes": 64, "token-sequence": 512})
        cell.traffic["params"].update(mean_nodes=120, max_nodes=300)
    else:
        p.update(max_nodes=384, max_edge_slots=384 * 30, stop_extending_after_nodes=300)
        cell.traffic["params"].update(mean_nodes=120)
    cell.traffic["pool_batches"] = 4
    cell.traffic["ranks"] = ranks
    cell.end_to_end = E2E
    return cell


@pytest.fixture
def small():
    return small_cell
