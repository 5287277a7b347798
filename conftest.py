"""Repo-wide pytest settings.

``tests/reference_parity/conftest.py`` adds a "reference checkout not found"
skip to every collected item when the reference checkout is absent, though
only the items of its own package import that checkout. This hook runs after
it and takes that marker off every item outside ``tests/reference_parity/``,
so that the rest of the suite runs and counts."""
import os
from pathlib import Path

import pytest

# Under pytest-xdist every worker is a process of its own; left to itself,
# each one's OpenMP and MKL pools take every core, and n workers then run
# n times as many threads as there are cores. Each worker gets its share of
# the cores instead (unless the caller set the pools' sizes).
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    _SHARE = str(max(1, (os.cpu_count() or 1) // _WORKERS))
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, _SHARE)

_REFERENCE_PARITY = Path(__file__).resolve().parent / "tests" / "reference_parity"
_REFERENCE_SKIP = "reference checkout not found"


def _is_reference_skip(mark) -> bool:
    return mark.name == "skip" and str(mark.kwargs.get("reason", "")).startswith(_REFERENCE_SKIP)


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if _REFERENCE_PARITY in Path(str(item.path)).resolve().parents:
            continue
        item.own_markers[:] = [m for m in item.own_markers if not _is_reference_skip(m)]
