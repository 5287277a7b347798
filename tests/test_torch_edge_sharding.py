"""The port's edge sharding (``parallel/edge_sharding.py``) on 4 gloo ranks
(one spawned world for the module, ``tests/torch_shard_worker.py``) against
the JAX package's on its CPU mesh: the cases of ``tests/test_edge_sharding.py``.

* ``shard_adjacency``: the edge- and tile-indexed arrays of every shard are
  the JAX package's bitwise; each shard's in-degrees sum to the batch's, and
  its row index lists its own slots.
* ``sharded_aggregate`` (sum, mean, max) against JAX's single-device
  ``segment_reduce``, which JAX's own test holds its sharded aggregate to;
  its gradient against the port's single-device aggregation.
* PNA's reductions and degree scalers under edge sharding.
* ``EdgeParallel``'s Graph2Class SGD step, on 4 shards and on 2 (two
  groups of two ranks), against JAX's ``EdgeParallel`` step on a 4-device
  mesh, weights converted through ``convert.py``, dropout 0.

Tolerances: aggregates 1e-5 (rtol and atol, as JAX's test; the all-reduce
adds the partial sums in another order); their gradients 1e-6 of the
largest; the step's loss rtol 1e-5 and each parameter's update within 1e-4
of its largest magnitude (``test_torch_parallel_dp.py``'s)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ptgnn_tpu.graph.batching import GraphBatcher as JaxGraphBatcher
from ptgnn_tpu.graph.messagepassing import GraphContext as JaxGraphContext
from ptgnn_tpu.graph.messagepassing.pna import PnaMessageAggregation as JaxPna
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.graph.structs import TensorizedGraphData as JaxTensorizedGraphData
from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu.ops.segment import segment_reduce as jax_segment_reduce
from ptgnn_tpu.parallel.edge_sharding import EdgeParallel as JaxEdgeParallel
from ptgnn_tpu.parallel.edge_sharding import shard_adjacency as jax_shard_adjacency
from ptgnn_tpu_torch.convert import jax_params_to_state_dict
from ptgnn_tpu_torch.graph.batching import GraphBatcher
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.ops.segment_kernels import adjacency_segment_reduce
from ptgnn_tpu_torch.parallel.edge_sharding import shard_adjacency
from tests.torch_shard_worker import launch

S = 4
N = 96
G2C = dict(num_metadata_graphs=16, mean_nodes=30, max_graph_nodes=80, hidden_state_size=32, num_minibatches=1,
           minibatch_size=8, dropout_rate=0.0)


def build_batches():
    """test_edge_sharding.py's batch, through both packages' batchers."""
    out = []
    for batcher_cls, pad_cls, graph_cls in ((JaxGraphBatcher, JaxBatchPadding, JaxTensorizedGraphData),
                                            (GraphBatcher, BatchPadding, TensorizedGraphData)):
        rng = np.random.RandomState(5)
        pad = pad_cls(max_nodes=N, max_edge_slots=128 * 32, max_graphs=4, edge_tile=32, agg_rows=32)
        b = batcher_cls(2, pad, True, True)
        mb = b.initialize()
        for n in (30, 25):
            adj = [(rng.randint(0, n, 30).astype(np.int32), rng.randint(0, n, 30).astype(np.int32))
                   for _ in range(2)]
            g = graph_cls(num_nodes=n, node_tensorized_data=[0] * n, adjacency_lists=adj, edge_features=None,
                          reference_nodes={})
            assert b.can_add(g, mb)
            b.extend(g, mb)
        out.append(b.finalize(mb, node_data={}, reference_names=[]))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jbatch, tbatch = build_batches()
    rng = np.random.RandomState(0)
    e_pad = tbatch.adjacency.senders.shape[0]
    messages = rng.randn(e_pad, 12).astype(np.float32)
    cot = rng.randn(N, 12).astype(np.float32)
    pna_msgs = rng.randn(e_pad, 6).astype(np.float32)
    tmodel, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8), device="cpu",
                                              **G2C)
    _, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256, max_graphs=8), **G2C)
    state = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, params))
    cases = [
        ("edge_aggregate", {"adj": tbatch.adjacency, "messages": messages, "cot": cot, "num_nodes": N}),
        ("edge_pna", {"adj": tbatch.adjacency, "messages": pna_msgs, "node_graph": tbatch.node_graph,
                      "node_mask": tbatch.node_mask, "graph_mask": tbatch.graph_mask, "num_nodes": N}),
        ("edge_parallel_step", {"model": tmodel, "state": state, "minibatch": tmbs[0], "lr": 0.05}),
    ]
    ranks = launch(cases, tmp_path_factory.mktemp("edge_world"), world=S)
    return {"jbatch": jbatch, "tbatch": tbatch, "messages": messages, "cot": cot, "pna_msgs": pna_msgs,
            "ranks": ranks, "jax_g2c": (jmodule, params, jmbs[0]), "port_g2c": (tmodule, state, tmbs[0])}


def test_shard_adjacency_matches_jax_bitwise():
    jbatch, tbatch = build_batches()
    jsh = jax_shard_adjacency(jbatch.adjacency, S)
    shards = shard_adjacency(tbatch.adjacency, S)
    tile = tbatch.adjacency.edge_tile
    for s, local in enumerate(shards):
        for name in ("senders", "receivers", "edge_types", "tile_types", "mask", "tile_types_transposed",
                     "local_rows", "tile_row_blocks", "edge_feature_slot"):
            # (JAX's local_rows carry a trailing unit axis)
            want = np.asarray(getattr(jsh, name))[s].reshape(getattr(local, name).shape)
            np.testing.assert_array_equal(getattr(local, name), want, err_msg=name)
        # each shard's tiles stay type-pure
        assert all(len(set(row)) == 1 for row in local.edge_types.reshape(-1, tile))
        assert local.super_tile_row_blocks is None
        # the row index lists this shard's real slots, row by row
        real = np.nonzero(local.mask)[0]
        assert local.row_offsets[-1] == len(real)
        np.testing.assert_array_equal(np.sort(local.row_slots[:len(real)]), real)
        np.testing.assert_array_equal(np.diff(local.row_offsets), local.agg_counts.reshape(-1))
    np.testing.assert_array_equal(sum(sh.agg_counts for sh in shards), np.asarray(jsh.agg_counts))


@pytest.mark.parametrize("reduction", ["sum", "mean", "max"])
def test_sharded_aggregate_matches_single_device(world, reduction):
    adj = jax.tree_util.tree_map(jnp.asarray, world["jbatch"].adjacency)
    expected = np.asarray(jax_segment_reduce(jnp.asarray(world["messages"]), adj.receivers, N, reduction,
                                             mask=adj.mask))
    tadj = world["tbatch"].to("cpu").adjacency
    msgs = torch.from_numpy(world["messages"]).requires_grad_(True)
    single = adjacency_segment_reduce(msgs, tadj, N, reduction, mask=tadj.mask, counts_exact=True)
    (single * torch.from_numpy(world["cot"])).sum().backward()
    grads = []
    for rank in world["ranks"]:
        out, grad = rank[0][reduction]
        np.testing.assert_allclose(out.numpy(), expected, rtol=1e-5, atol=1e-5)
        grads.append(grad.numpy())
    # Every rank backpropagates its copy of the replicated output, and the
    # all-reduce's backward sums those cotangents: each rank's slot gradient
    # is S times its share (parallel/collectives.py; DDP divides it out).
    want = msgs.grad.numpy()
    np.testing.assert_allclose(np.concatenate(grads) / S, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_pna_aggregation_matches_single_device_under_edge_sharding(world):
    """PNA's five reductions and its degree scalers are global under edge
    sharding (a collective per reduction), not per-shard partials."""
    jb = world["jbatch"]
    ctx = JaxGraphContext(adjacency=jax.tree_util.tree_map(jnp.asarray, jb.adjacency), edge_features=None,
                          node_graph=jb.node_graph, node_mask=jb.node_mask, graph_mask=jb.graph_mask, references={})
    expected = np.asarray(JaxPna().apply({}, jnp.asarray(world["pna_msgs"]), ctx, N))
    for rank in world["ranks"]:
        np.testing.assert_allclose(rank[1].numpy(), expected, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shards", [4, 2])
def test_edge_parallel_train_step_matches_jax(world, shards):
    jmodule, params, jmb = world["jax_g2c"]
    tmodule, state, _ = world["port_g2c"]
    opt = optax.sgd(0.05)
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("edge",))
    ep = JaxEdgeParallel(jmodule, opt, mesh, axis="edge")
    sharded = ep.shard_batch(jmb)
    p2 = jax.tree_util.tree_map(jnp.copy, params)
    new_params, _, jloss, _ = ep.build_train_step(sharded)(p2, opt.init(p2), sharded, jax.random.PRNGKey(3))
    jmodule.gnn.edge_partition_axis = None
    jflat = {k: v.numpy() for k, v in
             jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, new_params)).items()}
    for rank in world["ranks"]:
        got = rank[2][shards]
        np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
        assert got["metrics"]["num_graphs"] == float(jmb["batch"].num_graphs)
        for name, before in state.items():
            if name not in jflat:
                continue
            update, jupdate = (got["params"][name] - before).numpy(), jflat[name] - before.numpy()
            np.testing.assert_allclose(update, jupdate, rtol=0, atol=1e-4 * max(np.abs(jupdate).max(), 1e-30),
                                       err_msg=name)
    for name, p in world["ranks"][0][2][shards]["params"].items():
        for other in world["ranks"][1:]:
            assert torch.equal(p, other[2][shards]["params"][name]), name
