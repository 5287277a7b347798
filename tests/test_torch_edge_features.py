"""Edge features in the port against the JAX package: the same graphs with
per-edge float features go through both packages' GraphNeuralNetworkModel
(a feature embedder for the nodes and one for the edges).

* The two tests of ``tests/test_edge_features.py`` (slot pairing, and a
  featureless graph that must not shift later graphs' feature rows), each
  held against the JAX package's batch: every layout array and the edge
  embedder's minibatch bitwise.
* A wholly featureless batch under a feature-tracking model still numbers
  its slots (the argmax routing's pair ids), as JAX's does.
* Forward and every gradient (the edge embedder's included) of gated and
  MLP-MP stacks that read the features, on weights converted through
  ``convert.py``: the gated layer with sum and max aggregation, the MLP-MP
  layer with sum, mean, max and a hidden layer. No layer calls the fused op.

Tolerances, float32: the output at rtol 1e-5 and 1e-5 of its largest
magnitude; every gradient within 1e-5 of its largest magnitude (the
segment reductions add in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.embedders import FeatureRepresentationModel as JaxFeatureModel
from ptgnn_tpu.graph.gnn import GraphNeuralNetworkModel as JaxGnnModel
from ptgnn_tpu.graph.messagepassing import GatedMessagePassingLayer as JaxGated
from ptgnn_tpu.graph.messagepassing import MlpMessagePassingLayer as JaxMlp
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.graph.structs import GraphData as JaxGraphData
from ptgnn_tpu_torch.convert import load_jax_params
from ptgnn_tpu_torch.graph.embedders import FeatureRepresentationModel
from ptgnn_tpu_torch.graph.gnn import GraphNeuralNetworkModel
from ptgnn_tpu_torch.graph.messagepassing import GatedMessagePassingLayer, MlpMessagePassingLayer
from ptgnn_tpu_torch.graph.messagepassing import base as mp_base
from ptgnn_tpu_torch.graph.structs import BatchPadding, GraphData

PAD = dict(max_nodes=64, max_edge_slots=2048, max_graphs=4, edge_tile=32, agg_rows=32)
ADJ_FIELDS = ["senders", "receivers", "edge_types", "tile_types", "tile_types_transposed", "mask",
              "tile_row_blocks", "agg_counts", "super_tile_row_blocks", "edge_feature_slot"]


def gated_creator(package, aggregation="sum", state=8, feat=4):
    layer = JaxGated if package == "jax" else GatedMessagePassingLayer
    return lambda n: [layer(state_dimension=state, message_dimension=state, num_edge_types=n,
                            message_aggregation_function=aggregation, edge_feature_dimension=feat)]


def build_pair(creators, *, node_size=8, edge_size=4, pad=PAD):
    """(JAX model, port model) over the same configuration."""
    jmodel = JaxGnnModel(
        node_representation_model=JaxFeatureModel(embedding_size=node_size),
        edge_representation_model=JaxFeatureModel(embedding_size=edge_size),
        message_passing_layer_creator=creators["jax"], padding=JaxBatchPadding(**pad),
        introduce_backwards_edges=True, add_self_edges=True,
    )
    tmodel = GraphNeuralNetworkModel(
        node_representation_model=FeatureRepresentationModel(embedding_size=node_size),
        edge_representation_model=FeatureRepresentationModel(embedding_size=edge_size),
        message_passing_layer_creator=creators["torch"], padding=BatchPadding(**pad),
        introduce_backwards_edges=True, add_self_edges=True,
    )
    return jmodel, tmodel


def make_graph(rng, n=10, e=6, types=("E",), with_features=True):
    """The JAX test's graph, with each edge type's edges and features."""
    node_info = [rng.randn(3).astype(np.float32) for _ in range(n)]
    edges, feats = {}, {}
    for t in types:
        edges[t] = [(int(a), int(b)) for a, b in zip(rng.randint(0, n, e), rng.randint(0, n, e))]
        feats[t] = [rng.randn(2).astype(np.float32) for _ in range(e)]
    return (JaxGraphData(node_info, edges, {}, feats if with_features else None),
            GraphData(node_info, edges, {}, feats if with_features else None))


def batches(jmodel, tmodel, graphs, max_minibatch_size=3, metadata_graphs=None):
    out = []
    for model, side in ((jmodel, 0), (tmodel, 1)):
        data = [g[side] for g in graphs]
        model.compute_metadata(iter([g[side] for g in metadata_graphs or graphs]), parallelize=False)
        out.append([mb["batch"] for mb, _ in model.minibatch_iterator(
            model.tensorize_dataset(iter(data), parallelize=False),
            max_minibatch_size=max_minibatch_size, parallelize=False)])
    return out


def assert_batches_bitwise(jbatch, tbatch):
    for name in ADJ_FIELDS:
        j, t = np.asarray(getattr(jbatch.adjacency, name)), np.asarray(getattr(tbatch.adjacency, name))
        assert j.dtype == t.dtype and j.shape == t.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    np.testing.assert_array_equal(np.asarray(tbatch.adjacency.local_rows),
                                  np.asarray(jbatch.adjacency.local_rows).reshape(-1))
    assert set(tbatch.edge_feature_data) == set(jbatch.edge_feature_data) == {"features"}
    jf, tf = np.asarray(jbatch.edge_feature_data["features"]), tbatch.edge_feature_data["features"]
    assert jf.dtype == tf.dtype and jf.shape == tf.shape == (PAD["max_edge_slots"], 2)
    np.testing.assert_array_equal(tf, jf)


def test_edge_features_flow_and_pairing():
    rng = np.random.RandomState(0)
    graphs = [make_graph(rng) for _ in range(3)]
    jmodel, tmodel = build_pair({"jax": gated_creator("jax"), "torch": gated_creator("torch")})
    (jbatch,), (tbatch,) = batches(jmodel, tmodel, graphs)
    assert_batches_bitwise(jbatch, tbatch)

    adj = tbatch.adjacency
    slot, types, mask = adj.edge_feature_slot, adj.edge_types, adj.mask
    assert (slot[mask & (types == 0)] >= 0).all()  # forward edges have features
    assert (slot[mask & (types == 1)] >= 0).all()  # backward edges share them
    assert (slot[mask & (types == 2)] == -1).all()  # self edges: none
    assert (slot[~mask] == -1).all()
    assert sorted(slot[mask & (types == 0)]) == sorted(slot[mask & (types == 1)])

    jparams = jax.tree_util.tree_map(np.asarray, jmodel.build_neural_module().init(jax.random.PRNGKey(0)))
    module = torch.nn.Module()
    module.gnn = tmodel.build_neural_module()
    load_jax_params(module, {"gnn": jparams})
    batch = tbatch.to("cpu")
    out1 = module.gnn(batch)[0].output_node_representations
    zeroed = batch._replace(edge_feature_data={"features": torch.zeros_like(batch.edge_feature_data["features"])})
    out2 = module.gnn(zeroed)[0].output_node_representations
    assert float((out1 - out2).detach().abs().max()) > 1e-6  # the forward reads the features
    (out1 ** 2).sum().backward()
    assert float(module.gnn.edge_feature_embedder.linear.weight.grad.abs().sum()) > 0


def test_featureless_graph_does_not_shift_later_graphs_slots():
    rng = np.random.RandomState(3)
    g1 = make_graph(rng, n=8, e=5)
    g2 = make_graph(rng, n=6, e=4, with_features=False)
    g3 = make_graph(rng, n=7, e=6)
    jmodel, tmodel = build_pair({"jax": gated_creator("jax"), "torch": gated_creator("torch")})
    (jbatch,), (tbatch,) = batches(jmodel, tmodel, [g1, g2, g3])
    assert_batches_bitwise(jbatch, tbatch)
    adj = tbatch.adjacency
    slot, types, mask, senders = adj.edge_feature_slot, adj.edge_types, adj.mask, adj.senders
    g2_fwd = mask & (types == 0) & (senders >= 8) & (senders < 14)
    assert g2_fwd.sum() == 4 and (slot[g2_fwd] == -1).all()
    assert sorted(slot[mask & (types == 0) & (slot >= 0)]) == list(range(5 + 6))
    assert sorted(slot[mask & (types == 0) & (senders >= 14)]) == list(range(5, 11))
    module = tmodel.build_neural_module()
    for p in module.parameters():
        torch.nn.init.normal_(p)
    out, _ = module(tbatch.to("cpu"))
    assert torch.isfinite(out.output_node_representations).all()


def test_wholly_featureless_batch_numbers_its_slots():
    """A batcher that tracks no features numbers every graph's slots (the
    fwd/bwd pair ids of the argmax routing); one that tracks features gives
    a featureless graph -1 slots. Both bitwise as JAX's batcher."""
    from ptgnn_tpu.graph.batching import GraphBatcher as JaxGraphBatcher
    from ptgnn_tpu.graph.structs import TensorizedGraphData as JaxTensorizedGraphData
    from ptgnn_tpu_torch.graph.batching import GraphBatcher
    from ptgnn_tpu_torch.graph.structs import TensorizedGraphData

    rng = np.random.RandomState(5)
    graphs = []
    for n, e in ((9, 7), (11, 5)):
        adj = [(rng.randint(0, n, e).astype(np.int32), rng.randint(0, n, e).astype(np.int32))]
        graphs.append((n, adj))
    for track in (False, True):
        jb = JaxGraphBatcher(1, JaxBatchPadding(**PAD), True, True, track_edge_features=track)
        tb = GraphBatcher(1, BatchPadding(**PAD), True, True, track_edge_features=track)
        jmb, tmb = jb.initialize(), tb.initialize()
        for n, adj in graphs:
            jb.extend(JaxTensorizedGraphData(n, [0] * n, adj, None, {}), jmb)
            tb.extend(TensorizedGraphData(n, [0] * n, adj, None, {}), tmb)
        jslot = np.asarray(jb.finalize(jmb, node_data={}, reference_names=[]).adjacency.edge_feature_slot)
        tadj = tb.finalize(tmb, node_data={}, reference_names=[]).adjacency
        np.testing.assert_array_equal(tadj.edge_feature_slot, jslot)
        forward = tadj.edge_feature_slot[tadj.mask & (tadj.edge_types == 0)]
        assert sorted(forward) == (list(range(12)) if not track else [-1] * 12)


def mlp_creator(package, aggregation, hidden, state=8, feat=4):
    layer = JaxMlp if package == "jax" else MlpMessagePassingLayer

    def create(n):
        return [layer(state, state, 6, n, aggregation, mlp_hidden_layers=hidden, features_dimension=feat)
                for _ in range(2)]
    return create


STACKS = {
    "gated-sum": lambda p: gated_creator(p, "sum"),
    "gated-max": lambda p: gated_creator(p, "max"),
    "mlp-sum": lambda p: mlp_creator(p, "sum", 0),
    "mlp-mean": lambda p: mlp_creator(p, "mean", 0),
    "mlp-max": lambda p: mlp_creator(p, "max", 0),
    "mlp-hidden": lambda p: mlp_creator(p, "sum", 1),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_stack_with_edge_features_matches_jax(stack, monkeypatch):
    fused = []
    real = mp_base.fused_typed_message_aggregation
    monkeypatch.setattr(mp_base, "fused_typed_message_aggregation",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    rng = np.random.RandomState(11)
    graphs = [make_graph(rng, n=n, e=e, types=("A", "B")) for n, e in ((12, 9), (9, 14), (15, 11))]
    jmodel, tmodel = build_pair({"jax": STACKS[stack]("jax"), "torch": STACKS[stack]("torch")})
    (jbatch,), (tbatch,) = batches(jmodel, tmodel, graphs)
    assert_batches_bitwise(jbatch, tbatch)

    jmodule = jmodel.build_neural_module()
    jparams = jmodule.init(jax.random.PRNGKey(4))
    module = torch.nn.Module()
    module.gnn = tmodel.build_neural_module()
    load_jax_params(module, {"gnn": jax.tree_util.tree_map(np.asarray, jparams)})
    node_mask = np.asarray(jbatch.node_mask)
    cot = np.random.RandomState(2).randn(PAD["max_nodes"], 8).astype(np.float32) * node_mask[:, None]

    def jloss(params):
        out = jmodule.apply(params, jbatch)[0].output_node_representations
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tout = module.gnn(tbatch.to("cpu"))[0].output_node_representations
    (tout * torch.from_numpy(cot)).sum().backward()
    assert not fused, "a layer with edge features called the fused op"

    jout = np.asarray(jout)[node_mask]
    np.testing.assert_allclose(tout.detach().numpy()[node_mask], jout, rtol=1e-5,
                               atol=1e-5 * np.abs(jout).max())
    flat = {}

    def collect(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                collect(f"{prefix}{k}.", v)
        else:
            flat[prefix[:-1]] = np.asarray(tree)

    collect("", jgrads["node_embedder"])
    flat = {f"gnn.node_embedder.{k}": v for k, v in flat.items()}
    edge = {}
    for k, v in jax.tree_util.tree_flatten_with_path(jgrads["edge_embedder"])[0]:
        edge["gnn.edge_feature_embedder." + ".".join(p.key for p in k)] = np.asarray(v)
    flat.update(edge)
    for position, unique in enumerate(module.gnn._layer_param_index):
        for k, v in jax.tree_util.tree_flatten_with_path(jgrads["mp_layers"][unique])[0]:
            flat[f"gnn.message_passing_layers.{position}." + ".".join(p.key for p in k)] = np.asarray(v)
    named = dict(module.named_parameters())
    assert set(flat) == set(named)
    for name, want in flat.items():
        got = named[name].grad.numpy()
        assert np.isfinite(got).all() and np.isfinite(want).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=name)
    assert float(np.abs(named["gnn.edge_feature_embedder.linear.weight"].grad.numpy()).sum()) > 0


def test_layers_reject_a_context_without_their_features():
    rng = np.random.RandomState(7)
    graphs = [make_graph(rng) for _ in range(2)]
    for creator in (gated_creator("torch"), mlp_creator("torch", "sum", 0)):
        _, tmodel = build_pair({"jax": gated_creator("jax"), "torch": creator})
        data = [g[1] for g in graphs]
        tmodel.compute_metadata(iter(data), parallelize=False)
        mb, _ = next(iter(tmodel.minibatch_iterator(tmodel.tensorize_dataset(iter(data), parallelize=False),
                                                    max_minibatch_size=2, parallelize=False)))
        module = tmodel.build_neural_module()
        module.edge_feature_embedder = None  # the context then carries no features
        with pytest.raises(ValueError, match="edge-feature columns"):
            module(mb["batch"].to("cpu"))
