"""An installed port builds what it needs: every source that the port
compiles at first use (the CUDA kernels and their shared headers, read by
``ops/cuda_build.py``; the C++ layout assembler, read by ``native/``) is
package data in ``pyproject.toml``, so a built wheel carries it. Checked
against the package-data patterns as setuptools reads them (a pattern is a
glob relative to its package's directory).

The libraries built at first use go inside the package, under
``ptgnn_tpu_torch/_build/`` (``kernels/`` and ``native/``), beside its
sources as the JAX package builds beside ``ptgnn_tpu/native/``: never into
a directory that two installs share. ``.gitignore`` lists it, and a wheel
built from a tree that holds built libraries does not carry them (one wheel
is built, with pip, offline, from a copy of the package)."""
import fnmatch
import pathlib
import shutil
import subprocess
import sys
import tomllib
import zipfile

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


BUILD_ROOT = ROOT / "ptgnn_tpu_torch" / "_build"


def test_both_build_directories_lie_inside_the_package():
    assert cuda_build.BUILD_DIR == BUILD_ROOT / "kernels"
    assert native.BUILD_DIR == BUILD_ROOT / "native"


def test_gitignore_lists_the_build_directory():
    lines = {line.strip() for line in (ROOT / ".gitignore").read_text().splitlines()}
    assert "ptgnn_tpu_torch/_build/" in lines


def test_the_packaging_excludes_the_build_directory():
    tools = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]
    assert "ptgnn_tpu_torch._build*" in tools["packages"]["find"]["exclude"]
    patterns = tools["exclude-package-data"]["ptgnn_tpu_torch"]
    for built in ("_build/kernels/sum-0123456789abcdef.so", "_build/native/build.lock"):
        assert any(fnmatch.fnmatchcase(built, pattern) for pattern in patterns), built


def test_a_built_wheel_carries_the_sources_and_no_built_library(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(ROOT / name, tree / name)
    shutil.copytree(ROOT / "ptgnn_tpu_torch", tree / "ptgnn_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    for part in ("kernels/sum-0123456789abcdef.so", "native/batch_assembler-0123456789abcdef.so",
                 "native/build.lock"):
        built = tree / "ptgnn_tpu_torch" / "_build" / part
        built.parent.mkdir(parents=True, exist_ok=True)
        built.write_bytes(b"built")
    done = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation", "--no-index",
                           "-q", "-w", str(tmp_path / "dist"), str(tree)], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = zipfile.ZipFile(wheel).namelist()
    assert not [n for n in names if "/_build/" in n or n.endswith(".so")]
    for source in built_at_first_use():
        assert source.relative_to(ROOT).as_posix() in names
