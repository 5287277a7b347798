"""The port's packages export the counterpart of every name that the
matching ``__init__`` of the JAX package exports (its ``__all__``; for a
package without one, the functions and classes it defines), so code
written against the JAX package's imports runs on the port. The JAX
package's Pallas package (``ops/pallas``) maps to the port's module
``ops/segment_kernels``. ``NO_COUNTERPART`` lists each JAX name that the
port does not have, with the reason."""
import importlib
import inspect

import pytest

PACKAGES = {
    "ptgnn_tpu": "ptgnn_tpu_torch",
    "ptgnn_tpu.core": "ptgnn_tpu_torch.core",
    "ptgnn_tpu.graph": "ptgnn_tpu_torch.graph",
    "ptgnn_tpu.graph.messagepassing": "ptgnn_tpu_torch.graph.messagepassing",
    "ptgnn_tpu.ops": "ptgnn_tpu_torch.ops",
    "ptgnn_tpu.ops.pallas": "ptgnn_tpu_torch.ops.segment_kernels",
    "ptgnn_tpu.nn": "ptgnn_tpu_torch.nn",
    "ptgnn_tpu.parallel": "ptgnn_tpu_torch.parallel",
    "ptgnn_tpu.reduceops": "ptgnn_tpu_torch.reduceops",
    "ptgnn_tpu.sequence": "ptgnn_tpu_torch.sequence",
    "ptgnn_tpu.native": "ptgnn_tpu_torch.native",
}

NO_COUNTERPART = {
    ("ptgnn_tpu.nn", "Params"): "a parameter pytree's type; a torch module owns its parameters",
    ("ptgnn_tpu.nn", "fold"): "folds data into a JAX PRNG key; the port draws from a seeded torch.Generator",
    ("ptgnn_tpu.nn", "split_init"): "splits a PRNG key over child inits; the port's init_parameters walks "
                                    "the module tree with one generator",
    ("ptgnn_tpu.parallel", "default_data_mesh"): "builds a jax.sharding.Mesh; the port's ranks form a "
                                                 "torch.distributed process group",
    ("ptgnn_tpu.parallel", "node_data_mesh"): "builds the (data, node) mesh; the port's node_data_groups "
                                              "makes the process groups",
    ("ptgnn_tpu.parallel", "stack_minibatches"): "stacks one host's minibatches for its local devices; a "
                                                 "port process drives one card and steps one minibatch",
    ("ptgnn_tpu.ops.pallas", "build_aggregation_plan"): "the TPU kernels' plan of unsorted receivers in "
                                                        "512-slot tiles; the port's kernels walk the batcher's "
                                                        "layout by its row index (plan_from_adjacency)",
    ("ptgnn_tpu.ops.pallas", "plan_num_tiles"): "the tile budget of that TPU plan",
    ("ptgnn_tpu.native", "get_assembler"): "returns the library or None to fall back to numpy; the port's "
                                           "native.load() raises instead: nothing falls back quietly",
}


def exported(module) -> list:
    if hasattr(module, "__all__"):
        return list(module.__all__)
    return sorted(name for name, value in vars(module).items()
                  if not name.startswith("_") and (inspect.isfunction(value) or inspect.isclass(value))
                  and value.__module__ == module.__name__)


CASES = [(jax_name, name) for jax_name in PACKAGES for name in exported(importlib.import_module(jax_name))]


@pytest.mark.parametrize("jax_package, name", CASES, ids=[f"{p}.{n}" for p, n in CASES])
def test_port_exports_the_counterpart(jax_package, name):
    port = importlib.import_module(PACKAGES[jax_package])
    if (jax_package, name) in NO_COUNTERPART:
        assert not hasattr(port, name), f"{name} has a counterpart now: take it off NO_COUNTERPART"
        return
    assert hasattr(port, name), f"{PACKAGES[jax_package]} lacks {name} (exported by {jax_package})"
    if hasattr(port, "__all__"):
        assert name in port.__all__


def test_every_exemption_names_a_jax_export():
    assert set(NO_COUNTERPART) <= set(CASES)
