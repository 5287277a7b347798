"""An installed port builds what it needs: every source that the port
compiles at first use (the CUDA kernels and their shared headers, read by
``ops/cuda_build.py``; the C++ layout assembler, read by ``native/``) is
package data in ``pyproject.toml``, so a built wheel carries it. Checked
against the package-data patterns as setuptools reads them (a pattern is a
glob relative to its package's directory); no wheel is built."""
import fnmatch
import pathlib
import tomllib

import pytest

from ptgnn_tpu_torch import native
from ptgnn_tpu_torch.ops import cuda_build

ROOT = pathlib.Path(__file__).resolve().parents[1]


def built_at_first_use():
    kernels = {cuda_build.CSRC_DIR / source for source, _, _ in cuda_build._SIGNATURES.values()}
    headers = set(cuda_build.CSRC_DIR.glob("*.cuh"))
    return sorted(kernels | headers | {native.SOURCE})


def package_data_patterns(path: pathlib.Path):
    """(package, pattern relative to it) of every package-data pattern that
    could hold ``path``: those of each enclosing package, and the ``*`` key."""
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"]
    for parent in path.parents:
        if parent == ROOT:
            break
        if (parent / "__init__.py").exists():
            package = ".".join(parent.relative_to(ROOT).parts)
            relative = path.relative_to(parent).as_posix()
            for key in (package, "*"):
                for pattern in data.get(key, ()):
                    yield package, pattern, relative


def test_the_list_covers_every_kernel_source_and_the_assembler():
    names = {p.relative_to(ROOT).as_posix() for p in built_at_first_use()}
    on_disk = {p.relative_to(ROOT).as_posix() for p in (ROOT / "ptgnn_tpu_torch" / "csrc").iterdir()}
    assert on_disk <= names
    assert "ptgnn_tpu_torch/native/batch_assembler.cc" in names


@pytest.mark.parametrize("source", built_at_first_use(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_source_built_at_first_use_is_package_data(source):
    assert source.exists()
    matches = [(package, pattern) for package, pattern, relative in package_data_patterns(source)
               if fnmatch.fnmatchcase(relative, pattern)]
    assert matches, f"{source.relative_to(ROOT)} matches no [tool.setuptools.package-data] pattern"
