"""Graph2Class over the seven-position stack of the library's other
message-passing families (``harness.LayersStackCreator``: MLP-MP with PNA,
GraphNorm, EGC, block self-attention, MLP-MP with a hidden layer and mean,
self-attention among the supernodes, MLP-MP with max) at hidden 16 on small
synthetic Typilus graphs, against the JAX package with the same layers and
the JAX params loaded through ``convert.py``; then edge dropout (in this
stack and in the 'mlp' and 'ggnn' stacks, whose layers leave the fused op
under it too; the gated stack against JAX under a mask that empties nodes)
and ``return_all_states``.

The JAX side runs its XLA aggregation, its CPU default: on its Pallas route
PNA's gradients are NaN (see tests/test_torch_mp_families.py). Tolerances:
the loss rtol 1e-5; the logits rtol 1e-5 and 1e-5 of their largest
magnitude (PNA's std is ill-conditioned in float32, as that file says);
every gradient within 1e-4 of its largest magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.embedders import StrElementRepresentationModel as JaxStrElementRepresentationModel
from ptgnn_tpu.graph.gnn import GraphNeuralNetworkModel as JaxGraphNeuralNetworkModel
from ptgnn_tpu.graph.messagepassing import EGCMessagePassingLayer as JaxEGC
from ptgnn_tpu.graph.messagepassing import GraphContext as JaxGraphContext
from ptgnn_tpu.graph.messagepassing import GraphNorm as JaxGraphNorm
from ptgnn_tpu.graph.messagepassing import MlpMessagePassingLayer as JaxMlpLayer
from ptgnn_tpu.graph.messagepassing import MultiHeadSelfAttentionMessagePassing as JaxSelfAtt
from ptgnn_tpu.graph.messagepassing import PnaMessageAggregation as JaxPna
from ptgnn_tpu.implementations.typilus.graph2class import Graph2Class as JaxGraph2Class
from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build_graph2class
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu.utils.synthetic import synthetic_typilus_graphs as jax_synthetic_typilus_graphs
from ptgnn_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from ptgnn_tpu_torch.core.trainer import module_loss
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetwork
from ptgnn_tpu_torch.graph.messagepassing import GraphContext
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.ops import segment_kernels as tsk

HIDDEN = 16
KW = dict(hidden_state_size=HIDDEN, num_minibatches=1, minibatch_size=8, seed=1)


def jax_layers(num_edges, h=HIDDEN):
    """The JAX package's layers at the positions of LayersStackCreator."""
    def attention(**kw):
        return JaxSelfAtt(h, h // 4, h // 4, h, 2 * h, num_heads=4, dropout_rate=0.0, **kw)

    return [
        JaxMlpLayer(h, h, h, num_edges, JaxPna(), mlp_hidden_layers=1),
        JaxGraphNorm(h),
        JaxEGC(h, h, num_edges, "max", num_bases=4, num_heads=8),
        attention(),
        JaxMlpLayer(h, h, h, num_edges, "mean", use_target_state_as_message_input=False, mlp_hidden_layers=[2 * h]),
        attention(target_reference="supernodes"),
        JaxMlpLayer(h, h, h, num_edges, "max"),
    ]


def jax_build():
    """The JAX Graph2Class with the same embedder, batching and stack; its
    module, params and first minibatch."""
    padding = jax_small_padding(max_nodes=256)
    model = JaxGraph2Class(
        gnn_model=JaxGraphNeuralNetworkModel(
            node_representation_model=JaxStrElementRepresentationModel(
                embedding_size=HIDDEN, token_splitting="subtoken", subtoken_combination="mean",
                vocabulary_size=10000, min_freq_threshold=5, dropout_rate=0.0,
            ),
            message_passing_layer_creator=jax_layers,
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


def port_build(architecture="layers"):
    return build_graph2class(padding=small_padding(max_nodes=256), device="cpu", architecture=architecture,
                             dropout_rate=0.0, **KW)


def assert_close_per_tensor(got, expected):
    for name, e in expected.items():
        e = e.numpy()
        g = got.get(name, np.zeros_like(e))  # a parameter the loss does not reach has no gradient
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, e, rtol=1e-4, atol=1e-4 * max(np.abs(e).max(), 1e-30), err_msg=name)


def test_layers_stack_step_matches_jax():
    jmodule, params, jmb = jax_build()
    _, tmodule, tmbs = port_build()
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))
    batch = jax.tree_util.tree_map(jnp.asarray, jmb["batch"])
    targets = jnp.asarray(jmb["target_classes"])
    np.testing.assert_array_equal(tmbs[0]["batch"].att_order, np.asarray(batch.att_order))

    jlogits = np.asarray(jmodule._logits(params, batch, train=False, rng=None)[0])
    mb = tree_to(tmbs[0], torch.device("cpu"))
    with torch.no_grad():
        tlogits = tmodule._logits(mb["batch"], train=False)[0].numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5 * np.abs(jlogits).max())

    def loss_fn(p):
        return jmodule.apply(p, batch, targets, train=True, rng=jax.random.PRNGKey(0))[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    expected = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jgrads))
    tsk.reset_launch_counts()
    loss, _ = module_loss(tmodule, mb, train=True, generator=torch.Generator())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = {name: p.grad.numpy() for name, p in tmodule.named_parameters() if p.grad is not None}
    assert_close_per_tensor(got, expected)
    assert all(v == 0 for v in tsk.launch_counts().values())  # the CPU runs the plain versions
    layers = tmodule.gnn.message_passing_layers
    assert [type(layer).__name__ for layer in layers] == [
        "MlpMessagePassingLayer", "GraphNorm", "EGCMessagePassingLayer", "MultiHeadSelfAttentionMessagePassing",
        "MlpMessagePassingLayer", "MultiHeadSelfAttentionMessagePassing", "MlpMessagePassingLayer"]
    assert tuple(layers[0].message_mlp.weights_0.shape[1:]) == (2 * HIDDEN, HIDDEN)
    assert tuple(layers[4].message_mlp.weights_1.shape[1:]) == (2 * HIDDEN, HIDDEN)
    assert layers[0].layer_norm.dim == 15 * HIDDEN


def fused_calls(monkeypatch):
    """Counts the calls of the fused op from the layers."""
    from ptgnn_tpu_torch.graph.messagepassing import base

    calls = []
    real = base.fused_typed_message_aggregation
    monkeypatch.setattr(base, "fused_typed_message_aggregation", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_edge_dropout_properties(monkeypatch):
    """Training output changes with the dropout draw, eval is deterministic
    and the same as without edge dropout, no layer reaches the fused op
    under edge dropout (two do without), and gradients stay finite."""
    _, module, mbs = port_build()
    _, plain, _ = port_build()
    module.gnn.edge_dropout_rate = 0.3
    batch = tree_to(mbs[0], torch.device("cpu"))["batch"]
    calls = fused_calls(monkeypatch)
    with torch.no_grad():
        e1 = module.gnn(batch, train=False)[0].output_node_representations
        e2 = module.gnn(batch, train=False)[0].output_node_representations
        e0 = plain.gnn(batch, train=False)[0].output_node_representations
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)
    torch.testing.assert_close(e1, e0, rtol=0, atol=0)
    assert len(calls) == 6  # EGC and the last MLP-MP layer, in each forward
    calls.clear()
    outs = []
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        outs.append(module.gnn(batch, train=True, generator=g)[0].output_node_representations)
    assert not torch.allclose(outs[0], outs[1])
    assert not calls
    loss, _ = module_loss(module, tree_to(mbs[0], torch.device("cpu")), train=True,
                          generator=torch.Generator().manual_seed(3))
    loss.backward()
    assert not calls
    assert all(torch.isfinite(p.grad).all() for p in module.parameters() if p.grad is not None)


FUSED_PER_FORWARD = {"mlp": 8, "ggnn": 8}  # the MLP-MP layers; the gated layer's seven positions and the last


@pytest.mark.parametrize("architecture", ["mlp", "ggnn"])
def test_edge_dropout_leaves_the_fused_op_in_every_stack(architecture, monkeypatch):
    """The CLI's stacks under edge dropout: an eval forward keeps the fused
    route, a train step (forward and backward) never reaches the fused op,
    two dropout draws give different outputs, and gradients stay finite."""
    _, module, mbs = port_build(architecture)
    module.gnn.edge_dropout_rate = 0.3
    mb = tree_to(mbs[0], torch.device("cpu"))
    calls = fused_calls(monkeypatch)
    with torch.no_grad():
        module.gnn(mb["batch"], train=False)
    assert len(calls) == FUSED_PER_FORWARD[architecture]
    calls.clear()
    outs = [module.gnn(mb["batch"], train=True, generator=torch.Generator().manual_seed(seed))[0]
            .output_node_representations for seed in (1, 2)]
    assert not torch.allclose(outs[0], outs[1])
    loss, _ = module_loss(module, mb, train=True, generator=torch.Generator().manual_seed(3))
    loss.backward()
    assert not calls
    assert all(torch.isfinite(p.grad).all() for p in module.parameters() if p.grad is not None)


def assert_emptied_nodes_match_jax(jmodule, params, jbatch, tmodule, tbatch):
    """A non-static mask that takes every in-slot of some real nodes, through
    the GNN's stack on both sides: the value, every gradient of the stack's
    parameters and the input states' gradient finite and equal to JAX's."""
    static = np.asarray(jbatch.adjacency.mask)
    receivers = np.asarray(jbatch.adjacency.receivers)
    rng = np.random.RandomState(0)
    emptied = rng.choice(np.unique(receivers[static]), size=5, replace=False)
    mask = static & (rng.rand(static.shape[0]) >= 0.2) & ~np.isin(receivers, emptied)
    n = jbatch.node_graph.shape[0]
    states = rng.randn(n, tmodule.gnn.input_node_state_dim).astype(np.float32)
    cot = rng.randn(n, tmodule.gnn.output_node_state_dim).astype(np.float32) * np.asarray(jbatch.node_mask)[:, None]
    jctx = JaxGraphContext(
        adjacency=jbatch.adjacency._replace(mask=jnp.asarray(mask)), edge_features=None,
        node_graph=jbatch.node_graph, node_mask=jbatch.node_mask, graph_mask=jbatch.graph_mask,
        references=jbatch.references, edge_mask_is_static=False, att_order=jbatch.att_order,
    )
    tctx = GraphContext(
        adjacency=tbatch.adjacency._replace(mask=torch.from_numpy(mask.copy())), node_graph=tbatch.node_graph,
        node_mask=tbatch.node_mask, graph_mask=tbatch.graph_mask, references=tbatch.references,
        edge_mask_is_static=False, att_order=tbatch.att_order,
    )

    def jloss(p, x):
        return jnp.sum(jmodule.gnn.gnn(p["gnn"], x, jctx) * cot)

    jvalue, (jgrads, jgrad_x) = jax.value_and_grad(jloss, argnums=(0, 1))(params, jnp.asarray(states))
    x = torch.from_numpy(states).requires_grad_()
    value = (tmodule.gnn.gnn(x, tctx) * torch.from_numpy(cot)).sum()
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(jvalue), rtol=1e-5)
    expected = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(tmodule.named_parameters())  # a shared layer's under its first position
    expected = {k: v for k, v in expected.items() if k.startswith("gnn.message_passing_layers.") and k in named}
    got = {name: p.grad.numpy() for name, p in named.items() if p.grad is not None}
    assert_close_per_tensor(got, expected)
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad_x), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jgrad_x)).max())


def test_emptied_nodes_in_the_stack_match_jax():
    """A non-static mask that takes every in-slot of some real nodes through
    the whole stack: every gradient is finite and equal to JAX's."""
    jmodule, params, jmb = jax_build()
    _, tmodule, tmbs = port_build()
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))
    assert_emptied_nodes_match_jax(jmodule, params, jax.tree_util.tree_map(jnp.asarray, jmb["batch"]), tmodule,
                                   tree_to(tmbs[0], torch.device("cpu"))["batch"])


def test_gated_stack_under_a_non_static_mask_matches_jax(monkeypatch):
    """The 'ggnn' stack (the gated layer shared at seven positions, then a
    residual and a second gated layer; max aggregation) under a mask that
    empties nodes: the gated layers take the per-slot route, as JAX's do, and
    never the fused op; every gradient finite and equal to JAX's."""
    _, jmodule, params, jmbs = jax_build_graph2class(
        padding=jax_small_padding(max_nodes=256), architecture="ggnn", dropout_rate=0.0, **KW)
    _, tmodule, tmbs = port_build("ggnn")
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))
    calls = fused_calls(monkeypatch)
    assert_emptied_nodes_match_jax(jmodule, params, jax.tree_util.tree_map(jnp.asarray, jmbs[0]["batch"]),
                                   tmodule, tree_to(tmbs[0], torch.device("cpu"))["batch"])
    assert not calls


def test_return_all_states_concatenates_every_entry():
    _, module, mbs = port_build()
    batch = tree_to(mbs[0], torch.device("cpu"))["batch"]
    with torch.no_grad():
        out = module.gnn(batch, train=False, return_all_states=True)[0].output_node_representations
        last = module.gnn(batch, train=False)[0].output_node_representations
    assert out.shape[-1] == HIDDEN * 8  # the embedder's states and the seven entries'
    torch.testing.assert_close(out[:, -HIDDEN:], last, rtol=0, atol=0)


@pytest.mark.parametrize("rate", [-0.1, 1.0])
def test_edge_dropout_rate_must_lie_in_0_1(rate):
    with pytest.raises(ValueError, match="edge_dropout_rate"):
        GraphNeuralNetwork([], node_embedder=torch.nn.Identity(), edge_dropout_rate=rate)
