"""The JAX package's public definitions that the port added last, each
against its JAX counterpart on the CPU:

* ``LinearResidualLayer``: alone (its widths, the origin layer's width,
  the combine at dropout 0 on converted weights) and in the benchmark
  Graph2Class stack with its two concat residuals replaced
  (``harness.LinearResidualStackCreator``): logits, the loss and every
  gradient of a train step at dropout 0 with params converted through
  ``convert.py``, whose keys for it are checked;
* ``typed_tile_bias_add``: values (float32 and bf16) and the bias
  gradient;
* ``ShardedLazyDataIterable``: the factory's placement before and after
  ``set_rank``;
* ``GnnOutput``'s ``which="input"`` on the unsharded branch (the sharded
  one is a case of ``tests/test_torch_node_sharding.py``).

Tolerances: the stack's logits rtol 1e-5 and 1e-5 of the largest logit,
the loss rtol 1e-5, each gradient rtol 1e-4 and 1e-4 of its tensor's
largest magnitude (``tests/test_torch_layers_stack.py``'s); the rest
exact."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.embedders import StrElementRepresentationModel as JaxStrElementRepresentationModel
from ptgnn_tpu.graph.gnn import GraphNeuralNetworkModel as JaxGraphNeuralNetworkModel
from ptgnn_tpu.graph.messagepassing import LinearResidualLayer as JaxLinearResidualLayer
from ptgnn_tpu.graph.messagepassing import MlpMessagePassingLayer as JaxMlpLayer
from ptgnn_tpu.implementations.typilus.graph2class import Graph2Class as JaxGraph2Class
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu.utils.synthetic import synthetic_typilus_graphs as jax_synthetic_typilus_graphs
from ptgnn_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from ptgnn_tpu_torch.core.trainer import module_loss
from ptgnn_tpu_torch.graph.messagepassing import LinearResidualLayer
from ptgnn_tpu_torch.graph.structs import GnnOutput, tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from tests.test_torch_layers_stack import assert_close_per_tensor
from tests.torch_port_helpers import force_jax_fused_interpret

HIDDEN = 16
KW = dict(hidden_state_size=HIDDEN, num_minibatches=1, minibatch_size=8, seed=1)


def test_linear_residual_layer_alone_matches_jax():
    layer, jlayer = LinearResidualLayer(3, 5, 7), JaxLinearResidualLayer(3, 5, 7)
    for got, want in ((layer, jlayer), (layer.pass_through_dummy_layer(), jlayer.pass_through_dummy_layer())):
        assert (got.input_state_dimension, got.output_state_dimension) == \
            (want.input_state_dimension, want.output_state_dimension)
    assert layer.pass_through_dummy_layer().input_state_dimension == 3  # state_dimension1, not the layer's 5
    assert layer.pass_through_dummy_layer().target_layer is layer
    assert layer.linear.bias is None and tuple(layer.linear.weight.shape) == (7, 8)
    params = jlayer.init(jax.random.PRNGKey(0))
    layer.linear.weight.data.copy_(torch.from_numpy(np.asarray(params["linear"]["weight"])))
    rng = np.random.RandomState(2)
    a, b = rng.randn(9, 3).astype(np.float32), rng.randn(9, 5).astype(np.float32)
    want = jlayer.combine(params, jnp.asarray(a), jnp.asarray(b), train=False)
    got = layer.combine(torch.from_numpy(a), torch.from_numpy(b), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _jax_stack(num_edges, h=HIDDEN):
    """The benchmark stack with its two concat residuals replaced by
    LinearResidualLayers, in the JAX package."""
    r1, r2 = JaxLinearResidualLayer(h, h, 2 * h), JaxLinearResidualLayer(h, h, 2 * h)

    def mlp(d_in, d_msg):
        return JaxMlpLayer(input_state_dimension=d_in, message_dimension=d_msg, output_state_dimension=h,
                           num_edge_types=num_edges, message_aggregation_function="max", dropout_rate=0.0)

    return ([r1.pass_through_dummy_layer(), mlp(h, h), mlp(h, h), mlp(h, h), r1, mlp(2 * h, 2 * h),
             r2.pass_through_dummy_layer(), mlp(h, h), mlp(h, h), mlp(h, h), r2, mlp(2 * h, 2 * h)])


def _jax_build():
    padding = jax_small_padding(max_nodes=256)
    model = JaxGraph2Class(
        gnn_model=JaxGraphNeuralNetworkModel(
            node_representation_model=JaxStrElementRepresentationModel(
                embedding_size=HIDDEN, token_splitting="subtoken", subtoken_combination="mean",
                vocabulary_size=10000, min_freq_threshold=5, dropout_rate=0.0,
            ),
            message_passing_layer_creator=_jax_stack,
            padding=padding, max_nodes_per_graph=100000, max_graph_edges=500000,
            introduce_backwards_edges=True, add_self_edges=True,
            stop_extending_minibatch_after_num_nodes=min(120000, padding.max_nodes),
        ),
        max_num_classes=100,
    )

    def data():
        return jax_synthetic_typilus_graphs(48, seed=KW["seed"], mean_nodes=60, max_nodes=200)

    model.compute_metadata(data(), parallelize=False)
    module = model.build_neural_module()
    params = module.init(jax.random.PRNGKey(KW["seed"]))
    mb, _ = next(iter(model.minibatch_iterator(
        model.tensorize_dataset(data(), parallelize=False), max_minibatch_size=KW["minibatch_size"],
        parallelize=False)))
    return module, params, mb


def test_linear_residual_stack_step_matches_jax(monkeypatch):
    force_jax_fused_interpret(monkeypatch)
    jmodule, params, jmb = _jax_build()
    _, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu",
                                         architecture="linear-residual", dropout_rate=0.0, **KW)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    state = jax_params_to_state_dict(tmodule, np_params)
    residual_keys = sorted(k for k in state if k.endswith(".linear.weight") and ".message_passing_layers." in k)
    assert residual_keys == ["gnn.message_passing_layers.10.linear.weight",
                             "gnn.message_passing_layers.4.linear.weight"]
    assert all(tuple(state[k].shape) == (2 * HIDDEN, 2 * HIDDEN) for k in residual_keys)
    load_jax_params(tmodule, np_params)
    layers = tmodule.gnn.message_passing_layers
    assert [type(layers[i]).__name__ for i in (0, 4, 6, 10)] == ["_ResidualOriginLayer", "LinearResidualLayer"] * 2

    batch = jax.tree_util.tree_map(jnp.asarray, jmb["batch"])
    targets = jnp.asarray(jmb["target_classes"])
    jlogits = np.asarray(jmodule._logits(params, batch, train=False, rng=None)[0])
    mb = tree_to(tmbs[0], torch.device("cpu"))
    with torch.no_grad():
        tlogits = tmodule._logits(mb["batch"], train=False)[0].numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5 * np.abs(jlogits).max())

    def loss_fn(p):
        return jmodule.apply(p, batch, targets, train=True, rng=jax.random.PRNGKey(0))[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    expected = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jgrads))
    loss, _ = module_loss(tmodule, mb, train=True, generator=torch.Generator())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = {name: p.grad.numpy() for name, p in tmodule.named_parameters() if p.grad is not None}
    assert all(k in got and np.abs(got[k]).max() > 0 for k in residual_keys)
    assert_close_per_tensor(got, expected)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_typed_tile_bias_add_matches_jax(dtype):
    from ptgnn_tpu.ops.typed_linear import typed_tile_bias_add as jax_bias_add
    from ptgnn_tpu_torch.ops.typed_linear import typed_tile_bias_add

    rng = np.random.RandomState(3)
    tile, types, m = 8, 3, 6
    tile_types = rng.randint(0, types, 5).astype(np.int32)
    y = rng.randn(5 * tile, m).astype(np.float32)
    bias = rng.randn(types, m).astype(np.float32)
    if dtype == "bfloat16":
        y = y.astype(ml_dtypes.bfloat16)
        ty = torch.from_numpy(y.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        ty = torch.from_numpy(y)
    want = np.asarray(jax_bias_add(jnp.asarray(y), jnp.asarray(bias), jnp.asarray(tile_types), tile))
    tbias = torch.from_numpy(bias).requires_grad_()
    got = typed_tile_bias_add(ty, tbias, torch.from_numpy(tile_types), tile)
    assert got.dtype == ty.dtype
    np.testing.assert_array_equal(got.detach().float().numpy(), want.astype(np.float32))
    if dtype == "float32":
        cot = rng.randn(5 * tile, m).astype(np.float32)
        jgrad = jax.grad(lambda b: jnp.sum(jax_bias_add(jnp.asarray(y), b, jnp.asarray(tile_types), tile) * cot))(
            jnp.asarray(bias))
        (got * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(tbias.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="multiple of the tile"):
        typed_tile_bias_add(ty[:-1], tbias, torch.from_numpy(tile_types), tile)


def test_sharded_lazy_data_iterable_placement():
    from ptgnn_tpu.core.data import ShardedLazyDataIterable as JaxSharded
    from ptgnn_tpu_torch.core.data import ShardedLazyDataIterable

    def shard(rank=None, world_size=None):
        data = range(10)
        return iter(data if rank is None else data[rank::world_size])

    got, want = ShardedLazyDataIterable(shard), JaxSharded(shard)
    assert list(got) == list(want) == list(range(10))
    got.set_rank(1, 3)
    want.set_rank(1, 3)
    assert list(got) == list(want) == [1, 4, 7]
    assert list(got) == [1, 4, 7]  # every iter() is a fresh pass


def test_node_rows_which_input_unsharded_matches_jax():
    from ptgnn_tpu.graph.structs import GnnOutput as JaxGnnOutput

    rng = np.random.RandomState(5)
    tables = {"input": rng.randn(12, 4).astype(np.float32), "output": rng.randn(12, 3).astype(np.float32)}
    ids = np.array([0, 11, 5, 5, -1, 12])  # the last two are out of range
    refs = rng.randint(0, 12, 7)
    common = dict(node_to_graph_idx=None, node_mask=None, node_graph_idx_reference={}, reference_masks={},
                  num_graphs=None, graph_mask=None)
    out = GnnOutput(input_node_representations=torch.from_numpy(tables["input"]),
                    output_node_representations=torch.from_numpy(tables["output"]),
                    node_idx_references={"refs": torch.from_numpy(refs)}, **common)
    jout = JaxGnnOutput(input_node_representations=jnp.asarray(tables["input"]),
                        output_node_representations=jnp.asarray(tables["output"]),
                        node_idx_references={"refs": jnp.asarray(refs)}, **common)
    assert out.reference_nodes_idx is out.node_idx_references
    for which in ("input", "output"):
        rows = out.node_rows(torch.from_numpy(ids), which=which).numpy()
        np.testing.assert_array_equal(rows[:4], np.asarray(jout.node_rows(jnp.asarray(ids[:4]), which=which)))
        assert np.isnan(rows[4:]).all()  # NaN where JAX's take would clamp
        np.testing.assert_array_equal(out.reference_rows("refs", which=which).numpy(),
                                      np.asarray(jout.reference_rows("refs", which=which)))
        np.testing.assert_array_equal(out.node_table(which).numpy(), np.asarray(jout.node_table(which)))
    np.testing.assert_array_equal(out.node_rows(torch.from_numpy(ids[:4])).numpy(), tables["output"][ids[:4]])
    with pytest.raises(ValueError, match="no node table"):
        out.node_rows(torch.from_numpy(ids), which="hidden")
