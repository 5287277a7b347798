"""Argmax routing of the fused op on a feature-tracking batch that holds a
featureless graph, against autograd through a single-winner per-slot max.

The JAX package's batcher gives every slot of such a graph the pair id -1,
and its argmax routing (``ptgnn_tpu/ops/fused_mp.py:185-194``) then takes
those slots for self edges, whose winners match one another: its node
gradients are wrong on this batch. So the port is held to the oracle here,
not to the JAX package. The port numbers the fwd/bwd pair ids
(``AdjacencyStruct.edge_pair_id``) apart from the feature slots, which stay
the JAX package's.

The oracle: messages per slot from the sender (and receiver) rows and the
slot's type weights, each receiver's column takes the value of its first
slot attaining the maximum, and autograd differentiates through that one
slot. Tolerance: 1e-5 of each gradient's largest magnitude (float32; the
matmuls and sums add in another order, the routing is exact)."""
import numpy as np
import pytest
import torch

from ptgnn_tpu_torch.graph.batching import GraphBatcher
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation

PAD = BatchPadding(max_nodes=64, max_edge_slots=16 * 64, max_graphs=4, edge_tile=16, agg_rows=16, agg_sum_tile=0)
NUM_FWD = 2
D, M = 8, 6


def mixed_batch(seed=0):
    """Graphs of 25 and 30 nodes in a feature-tracking batch; the second
    carries edge features, the first none."""
    rng = np.random.RandomState(seed)
    batcher = GraphBatcher(NUM_FWD, PAD, introduce_backwards_edges=True, add_self_edges=True,
                           track_edge_features=True)
    mb = batcher.initialize()
    for n, featured in ((25, False), (30, True)):
        adj = [(rng.randint(0, n, 40).astype(np.int32), rng.randint(0, n, 40).astype(np.int32))
               for _ in range(NUM_FWD)]
        graph = TensorizedGraphData(num_nodes=n, node_tensorized_data=[0] * n, adjacency_lists=adj,
                                    edge_features=[0] * 80 if featured else None, reference_nodes={})
        assert batcher.can_add(graph, mb)
        batcher.extend(graph, mb)
    batch = batcher.finalize(mb, node_data={}, reference_names=[])
    return batcher, batch


def oracle_grads(states, weights, adj, use_target_state, cot):
    """Autograd through the single-winner (first slot) per-column max."""
    x = torch.from_numpy(states).requires_grad_(True)
    w = torch.from_numpy(weights).requires_grad_(True)
    senders = torch.from_numpy(adj.senders).long()
    receivers = torch.from_numpy(adj.receivers).long()
    mask = torch.from_numpy(adj.mask)
    n = x.shape[0]
    inp = x[senders.clamp(max=n - 1)]
    if use_target_state:
        inp = torch.cat([inp, x[receivers.clamp(max=n - 1)]], dim=-1)
    msgs = torch.bmm(inp[:, None, :], w[torch.from_numpy(adj.edge_types).long()])[:, 0]
    with torch.no_grad():
        winners = torch.full((n, M), -1, dtype=torch.long)
        for node in range(n):
            slots = torch.nonzero(mask & (receivers == node))[:, 0]
            if len(slots):
                vals = msgs[slots]
                # the first slot (lowest id) of each column's maximum
                winners[node] = slots[(vals == vals.max(0).values).float().argmax(0)]
    picked = msgs.gather(0, winners.clamp_min(0)) * (winners >= 0)
    (picked * torch.from_numpy(cot)).sum().backward()
    return picked.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("use_target_state", [True, False])
def test_argmax_routing_on_a_mixed_feature_batch_matches_the_oracle(use_target_state):
    batcher, batch = mixed_batch()
    adj = batch.adjacency
    # The feature slots are the JAX package's: the featureless graph's are
    # -1; its pair ids are distinct all the same.
    first_graph = adj.mask & (adj.receivers < 25) & (adj.edge_types < 2 * NUM_FWD)
    assert (adj.edge_feature_slot[first_graph] == -1).all()
    assert (adj.edge_pair_id[first_graph] >= 0).all()
    featured = adj.mask & (adj.receivers >= 25) & (adj.edge_types < 2 * NUM_FWD)
    np.testing.assert_array_equal(np.unique(adj.edge_feature_slot[featured]), np.arange(80))
    rng = np.random.RandomState(1)
    num_types = batcher.num_edge_types
    states = rng.randn(PAD.max_nodes, D).astype(np.float32)
    weights = (rng.randn(num_types, (2 if use_target_state else 1) * D, M) * 0.5).astype(np.float32)
    cot = rng.randn(PAD.max_nodes, M).astype(np.float32)
    want_out, want_dx, want_dw = oracle_grads(states, weights, adj, use_target_state, cot)

    x = torch.from_numpy(states).requires_grad_(True)
    w = torch.from_numpy(weights).requires_grad_(True)
    tadj = batch.to("cpu").adjacency
    out = fused_typed_message_aggregation(x, w, tadj, PAD.max_nodes, "max", use_target_state, argmax_routing=True)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=0, atol=1e-5 * np.abs(want_out).max())
    np.testing.assert_allclose(x.grad.numpy(), want_dx, rtol=0, atol=1e-5 * np.abs(want_dx).max())
    np.testing.assert_allclose(w.grad.numpy(), want_dw, rtol=0, atol=1e-5 * np.abs(want_dw).max())
