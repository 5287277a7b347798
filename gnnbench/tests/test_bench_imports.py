"""No JAX, and nothing of the JAX package, by whole top-level name; the
reference loads nothing of the program."""
import subprocess
import sys

from gnnbench.harness import imports
from .conftest import ROOT


def test_whole_top_level_names():
    assert imports.forbidden_loaded(["ptgnn_tpu_torch", "ptgnn_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert imports.forbidden_loaded(["ptgnn_tpu", "ptgnn_tpu.ops.x"]) == ["ptgnn_tpu"]
    assert imports.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def _loaded(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    return out.stdout.strip()


def test_harness_and_port_load_no_jax():
    code = ("import gnnbench.run, gnnbench.drivers.train_single, gnnbench.drivers.train_dp, gnnbench.calibrate;"
            "import ptgnn_tpu_torch.core.trainer, ptgnn_tpu_torch.parallel.dp;"
            "import ptgnn_tpu_torch.implementations.typilus.train, ptgnn_tpu_torch.implementations.ppi.train;"
            "from gnnbench.harness import imports; print(imports.forbidden_loaded())")
    assert _loaded(code) == "[]"


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, gnnbench.reference.common, gnnbench.reference.g2c_typilus_mlp, "
            "gnnbench.reference.ppi_mlp_sum;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'ptgnn_tpu_torch', 'ptgnn_tpu', 'jax'}))")
    assert _loaded(code) == "[]"
