"""The port's batcher against the JAX package's: for the same tensorized
graphs every layout array is bitwise equal."""
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.batching import GraphBatcher as JaxGraphBatcher
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.graph.structs import TensorizedGraphData as JaxTensorizedGraphData
from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu_torch.graph.batching import GraphBatcher
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding

ADJ_FIELDS = [
    "senders", "receivers", "edge_types", "tile_types", "tile_types_transposed", "mask",
    "local_rows", "tile_row_blocks", "agg_counts", "super_tile_row_blocks",
    "edge_feature_slot",
]


def assert_adjacency_equal(jadj, tadj):
    for name in ADJ_FIELDS:
        j = np.asarray(getattr(jadj, name))
        t = np.asarray(getattr(tadj, name))
        if name == "local_rows":
            j = j.reshape(-1)  # JAX keeps the kernels' [E, 1] column
        assert j.dtype == t.dtype and j.shape == t.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)


def random_graphs(seed, num_graphs, num_types):
    rng = np.random.RandomState(seed)
    graphs = []
    for _ in range(num_graphs):
        n = int(rng.randint(5, 60))
        adj = []
        for _t in range(num_types):
            e = int(rng.randint(0, 3 * n))
            adj.append((rng.randint(0, n, e).astype(np.int32), rng.randint(0, n, e).astype(np.int32)))
        refs = {"supernodes": rng.choice(n, size=3, replace=False).astype(np.int32)}
        graphs.append((n, adj, refs))
    return graphs


@pytest.mark.parametrize(
    "pad",
    [
        dict(max_nodes=256, max_edge_slots=4096, max_graphs=8, edge_tile=32, agg_rows=64, agg_sum_tile=128),
        dict(max_nodes=300, max_edge_slots=3840, max_graphs=6, edge_tile=64, agg_rows=128, agg_sum_tile=0),
    ],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_batcher_arrays_bitwise(pad, seed):
    jb = JaxGraphBatcher(3, JaxBatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    tb = GraphBatcher(3, BatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    jmb, tmb = jb.initialize(), tb.initialize()
    admitted = 0
    for n, adj, refs in random_graphs(seed, 12, 3):
        jg = JaxTensorizedGraphData(n, [0] * n, adj, None, refs)
        tg = TensorizedGraphData(n, [0] * n, adj, None, refs)
        fits = jb.can_add(jg, jmb)
        assert tb.can_add(tg, tmb) == fits
        if fits:
            jb.extend(jg, jmb)
            tb.extend(tg, tmb)
            admitted += 1
    assert admitted >= 2
    jbatch = jb.finalize(jmb, node_data={}, reference_names=["supernodes"])
    tbatch = tb.finalize(tmb, node_data={}, reference_names=["supernodes"])
    assert_adjacency_equal(jbatch.adjacency, tbatch.adjacency)
    for name in ("node_graph", "node_mask", "graph_mask", "num_nodes", "num_edges", "num_graphs"):
        np.testing.assert_array_equal(getattr(tbatch, name), np.asarray(getattr(jbatch, name)), err_msg=name)
    for field in ("node_ids", "graph_ids", "mask"):
        np.testing.assert_array_equal(
            getattr(tbatch.references["supernodes"], field),
            np.asarray(getattr(jbatch.references["supernodes"], field)),
        )


def test_graph2class_minibatches_bitwise():
    """The whole host pipeline (metadata, tensorize, minibatch) gives the
    same arrays, node data and targets included."""
    kw = dict(hidden_state_size=16, num_minibatches=2, minibatch_size=8)
    _, _, _, jmbs = jax_build(padding=jax_small_padding(max_nodes=256), **kw)
    _, _, tmbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", **kw)
    for jmb, tmb in zip(jmbs, tmbs):
        np.testing.assert_array_equal(tmb["target_classes"], jmb["target_classes"])
        jb, tb = jmb["batch"], tmb["batch"]
        assert_adjacency_equal(jb.adjacency, tb.adjacency)
        for key in ("token_idxs", "lengths"):
            np.testing.assert_array_equal(tb.node_data[key], np.asarray(jb.node_data[key]))
        for name in ("node_graph", "node_mask", "graph_mask", "num_nodes", "num_edges"):
            np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)))
        for ref in ("supernodes", "token-sequence"):
            for field in ("node_ids", "graph_ids", "mask"):
                np.testing.assert_array_equal(
                    getattr(tb.references[ref], field), np.asarray(getattr(jb.references[ref], field))
                )


def _admit_both(jb, tb, graphs):
    jmb, tmb = jb.initialize(), tb.initialize()
    sizes = []
    for n, adj, refs in graphs:
        jg = JaxTensorizedGraphData(n, [0] * n, adj, None, refs)
        tg = TensorizedGraphData(n, [0] * n, adj, None, refs)
        fits = jb.can_add(jg, jmb)
        assert tb.can_add(tg, tmb) == fits
        if not fits:
            break
        jb.extend(jg, jmb)
        tb.extend(tg, tmb)
        sizes.append(n)
    return (jb.finalize(jmb, node_data={}, reference_names=[]), tb.finalize(tmb, node_data={}, reference_names=[]),
            sizes)


@pytest.mark.parametrize("att_block", [0, 16, 32, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_att_order_bitwise(att_block, seed):
    """The attention packing equals the JAX batcher's for the same graphs:
    every real node once, each graph of at most one block inside one block,
    padding slots at max_nodes; none when att_block is 0."""
    pad = dict(max_nodes=512, max_edge_slots=16384, max_graphs=12, edge_tile=32, agg_rows=64, att_block=att_block)
    jb = JaxGraphBatcher(3, JaxBatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    tb = GraphBatcher(3, BatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    jbatch, tbatch, sizes = _admit_both(jb, tb, random_graphs(seed, 12, 3))
    assert len(sizes) >= 4
    if not att_block:
        assert tbatch.att_order is None and jbatch.att_order is None
        return
    order = tbatch.att_order
    want = np.asarray(jbatch.att_order)
    assert order.dtype == want.dtype and order.shape == want.shape
    np.testing.assert_array_equal(order, want)
    flat = order.reshape(-1)
    total = sum(sizes)
    assert sorted(flat[flat < total].tolist()) == list(range(total))
    assert (flat[flat >= total] == pad["max_nodes"]).all()
    offset = 0
    for n in sizes:
        if n <= att_block:
            slots = np.nonzero((flat >= offset) & (flat < offset + n))[0]
            assert len(set(slots // att_block)) == 1
        offset += n
    moved = tbatch.to("cpu")
    assert moved.att_order.dtype == torch.int32 and torch.equal(moved.att_order, torch.from_numpy(order))


def test_att_order_worst_case_seal_bitwise():
    """Alternating 1-node and (att_block + 1)-node graphs seal a partial
    block before and after every large graph (about 3x the node budget in
    slots): the packing fits its budget and equals the JAX batcher's."""
    block, max_nodes = 8, 128
    pad = dict(max_nodes=max_nodes, max_edge_slots=4096, max_graphs=32, edge_tile=32, agg_rows=32, att_block=block)
    jb = JaxGraphBatcher(1, JaxBatchPadding(**pad), introduce_backwards_edges=False, add_self_edges=False)
    tb = GraphBatcher(1, BatchPadding(**pad), introduce_backwards_edges=False, add_self_edges=False)
    graphs = []
    for i in range(64):
        n = 1 if i % 2 == 0 else block + 1
        src = np.zeros(max(n - 1, 1), np.int32)
        graphs.append((n, [(src, src)], {}))
    jbatch, tbatch, sizes = _admit_both(jb, tb, graphs)
    assert len(sizes) >= 8
    np.testing.assert_array_equal(tbatch.att_order, np.asarray(jbatch.att_order))
    flat = tbatch.att_order.reshape(-1)
    total = sum(sizes)
    assert sorted(flat[flat < total].tolist()) == list(range(total))
    assert total < max_nodes and (flat < total).sum() > 0 and len(flat) > 2 * max_nodes
