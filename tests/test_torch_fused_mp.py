"""The port's fused message+aggregation forward and scatter-free backward,
and a whole MLP-MP layer, against the JAX package's fused path (Pallas
kernels interpreted), at f32; the keyed dropout mask bitwise.

Tolerance rtol/atol 1e-5: only the summation order of the matmuls and the
segment sums differs; the gathers, the broadcast, the extremum and the tie
routing are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.batching import GraphBatcher as JaxGraphBatcher
from ptgnn_tpu.graph.messagepassing import GraphContext as JaxGraphContext
from ptgnn_tpu.graph.messagepassing.mlp_mp import MlpMessagePassingLayer as JaxMlpLayer
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.graph.structs import TensorizedGraphData as JaxTensorizedGraphData
from ptgnn_tpu.ops.fused_mp import fused_typed_message_aggregation as jax_fused
from ptgnn_tpu_torch.graph.batching import GraphBatcher
from ptgnn_tpu_torch.graph.messagepassing import GraphContext, MlpMessagePassingLayer
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData, tree_to
from ptgnn_tpu_torch.ops import fused_mp
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation
from tests.torch_port_helpers import force_jax_fused_interpret

PAD = dict(max_nodes=96, max_edge_slots=6144, max_graphs=4, edge_tile=32, agg_rows=32)


@pytest.fixture(autouse=True)
def _fused(monkeypatch):
    force_jax_fused_interpret(monkeypatch)


def build_batches(seed=0):
    rng = np.random.RandomState(seed)
    jb = JaxGraphBatcher(2, JaxBatchPadding(**PAD), introduce_backwards_edges=True, add_self_edges=True)
    tb = GraphBatcher(2, BatchPadding(**PAD), introduce_backwards_edges=True, add_self_edges=True)
    jmb, tmb = jb.initialize(), tb.initialize()
    for n in (25, 30):
        adj = [
            (rng.randint(0, n, 20).astype(np.int32), rng.randint(0, n, 20).astype(np.int32))
            for _ in range(2)
        ]
        jb.extend(JaxTensorizedGraphData(n, [0] * n, adj, None, {}), jmb)
        tb.extend(TensorizedGraphData(n, [0] * n, adj, None, {}), tmb)
    jbatch = jax.tree_util.tree_map(jnp.asarray, jb.finalize(jmb, node_data={}, reference_names=[]))
    tbatch = tb.finalize(tmb, node_data={}, reference_names=[]).to("cpu")
    return jb.num_edge_types, jbatch, tbatch


@pytest.mark.parametrize("use_target_state", [True, False])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_fused_forward_matches_jax(reduction, use_target_state):
    num_types, jbatch, tbatch = build_batches()
    rng = np.random.RandomState(3)
    d, m = 16, 24
    states = rng.randn(PAD["max_nodes"], d).astype(np.float32)
    din = 2 * d if use_target_state else d
    weights = (rng.randn(num_types, din, m) / np.sqrt(din)).astype(np.float32)
    n = PAD["max_nodes"]
    expected = jax_fused(
        jnp.asarray(states), jnp.asarray(weights), (jbatch.adjacency, None), n,
        reduction, use_target_state, 1.0,
    )
    tsk.reset_launch_counts()
    got = fused_typed_message_aggregation(
        torch.from_numpy(states), torch.from_numpy(weights), tbatch.adjacency, n,
        reduction, use_target_state,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    # The CPU ran the plain versions: no kernel was launched.
    assert tsk.launch_counts() == {"segment_extremum": 0, "broadcast_to_edges": 0, "segment_sum": 0, "typed_matmul": 0}


@pytest.mark.parametrize("dtype,tol", [
    (torch.float64, 1e-5), (torch.bfloat16, 5e-2), (torch.float16, 1e-2),
])
def test_target_state_rows_come_from_the_broadcast_at_any_dtype(dtype, tol, monkeypatch):
    """Every dtype takes the broadcast for the target-state rows (the
    kernel copies 16-byte units and ignores the dtype); the result matches
    JAX's f32 fused forward to the dtype's precision."""
    num_types, jbatch, tbatch = build_batches(seed=2)
    rng = np.random.RandomState(6)
    d, m, n = 16, 24, PAD["max_nodes"]
    states = rng.randn(n, d).astype(np.float32)
    weights = (rng.randn(num_types, 2 * d, m) / np.sqrt(2 * d)).astype(np.float32)
    expected = jax_fused(
        jnp.asarray(states), jnp.asarray(weights), (jbatch.adjacency, None), n, "max", True, 1.0,
    )
    seen = []
    real = fused_mp.adjacency_broadcast_to_edges

    def spy(table, adj):
        seen.append(table.dtype)
        return real(table, adj)

    monkeypatch.setattr(fused_mp, "adjacency_broadcast_to_edges", spy)
    got = fused_typed_message_aggregation(
        torch.from_numpy(states).to(dtype), torch.from_numpy(weights).to(dtype),
        tbatch.adjacency, n, "max", True,
    )
    assert seen == [dtype] and got.dtype == dtype
    np.testing.assert_allclose(got.double().numpy(), np.asarray(expected), rtol=tol, atol=tol)


@pytest.mark.parametrize("reduction", ["max", "min"])
def test_mlp_layer_matches_jax(reduction):
    num_types, jbatch, tbatch = build_batches(seed=1)
    d = 16
    jlayer = JaxMlpLayer(
        input_state_dimension=d, output_state_dimension=d, message_dimension=d,
        num_edge_types=num_types, message_aggregation_function=reduction,
    )
    params = jlayer.init(jax.random.PRNGKey(0))
    tlayer = MlpMessagePassingLayer(
        input_state_dimension=d, output_state_dimension=d, message_dimension=d,
        num_edge_types=num_types, message_aggregation_function=reduction,
    )
    flat = {
        "message_mlp.weights_0": params["message_mlp"]["weights_0"],
        "layer_norm.weight": params["layer_norm"]["weight"],
        "layer_norm.bias": params["layer_norm"]["bias"],
        "dense.weight": params["dense"]["weight"],
        "dense.bias": params["dense"]["bias"],
    }
    tlayer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flat.items()})
    states = np.random.RandomState(5).randn(PAD["max_nodes"], d).astype(np.float32)
    jctx = JaxGraphContext(
        adjacency=jbatch.adjacency, edge_features=None, node_graph=jbatch.node_graph,
        node_mask=jbatch.node_mask, graph_mask=jbatch.graph_mask, references={},
    )
    tctx = GraphContext(
        adjacency=tbatch.adjacency, node_graph=tbatch.node_graph,
        node_mask=tbatch.node_mask, graph_mask=tbatch.graph_mask, references={},
    )
    expected = jlayer.apply(params, jnp.asarray(states), jctx)
    with torch.inference_mode():
        got = tlayer(torch.from_numpy(states), tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)


def _fused_grads_jax(states, weights, adj, reduction, use_target_state, cot, keep=1.0, seed=None):
    def f(x, w):
        out = jax_fused(x, w, (adj, seed), x.shape[0], reduction, use_target_state, keep)
        return jnp.sum(out * cot)

    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(states), jnp.asarray(weights))
    return np.asarray(gx), np.asarray(gw)


def _fused_grads_port(states, weights, adj, reduction, use_target_state, cot, keep=1.0, seed=None):
    x = torch.from_numpy(states).requires_grad_()
    w = torch.from_numpy(weights).requires_grad_()
    out = fused_typed_message_aggregation(x, w, adj, x.shape[0], reduction, use_target_state, keep, seed)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), w.grad.numpy()


def _grad_inputs(num_types, use_target_state, seed=7, d=16, m=24, ties=False):
    rng = np.random.RandomState(seed)
    states = rng.randn(PAD["max_nodes"], d).astype(np.float32)
    if ties:  # coarse values: many messages tie for a receiver's extremum
        states = np.round(states).astype(np.float32)
    din = 2 * d if use_target_state else d
    weights = (rng.randn(num_types, din, m) / np.sqrt(din)).astype(np.float32)
    if ties:
        weights = np.round(weights * 4).astype(np.float32) / 4
    cot = rng.randn(PAD["max_nodes"], m).astype(np.float32)
    return states, weights, cot


@pytest.mark.parametrize("use_target_state", [True, False])
@pytest.mark.parametrize("reduction", ["max", "min", "sum", "mean"])
def test_fused_gradients_match_jax(reduction, use_target_state):
    """Gradients of the node states and of the weight stack, f32: rtol/atol
    1e-5 (the sums run in another order; the routing is exact)."""
    num_types, jbatch, tbatch = build_batches(seed=4)
    states, weights, cot = _grad_inputs(num_types, use_target_state)
    gx, gw = _fused_grads_jax(states, weights, jbatch.adjacency, reduction, use_target_state, cot)
    tsk.reset_launch_counts()
    _, tx, tw = _fused_grads_port(states, weights, tbatch.adjacency, reduction, use_target_state, cot)
    np.testing.assert_allclose(tx, gx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw, gw, rtol=1e-5, atol=1e-5)
    assert np.abs(tx).max() > 0 and np.abs(tw).max() > 0
    assert tsk.launch_counts() == {"segment_extremum": 0, "broadcast_to_edges": 0, "segment_sum": 0, "typed_matmul": 0}


@pytest.mark.parametrize("reduction", ["max", "sum"])
def test_tied_extrema_split_the_gradient_as_jax(reduction):
    """Coarse inputs make many messages tie: the cotangent is split evenly
    among the tied slots in both orientations, as JAX splits it (rtol/atol
    1e-5)."""
    num_types, jbatch, tbatch = build_batches(seed=5)
    states, weights, cot = _grad_inputs(num_types, True, seed=8, ties=True)
    gx, gw = _fused_grads_jax(states, weights, jbatch.adjacency, reduction, True, cot)
    _, tx, tw = _fused_grads_port(states, weights, tbatch.adjacency, reduction, True, cot)
    np.testing.assert_allclose(tx, gx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw, gw, rtol=1e-5, atol=1e-5)
    if reduction == "max":
        ties, _ = fused_mp.tie_counts(
            torch.from_numpy(states), torch.from_numpy(weights), tbatch.adjacency, reduction, True
        )
        assert float(ties.max()) > 1  # the case the test is for


@pytest.mark.parametrize("masked_route", [True, False])
def test_both_weight_gradient_routes_match_jax(masked_route, monkeypatch):
    """The per-type masked dots and the per-tile bmm + type sum give JAX's dW
    (rtol/atol 1e-5), whichever route the traffic rule picks."""
    monkeypatch.setattr(fused_mp, "_use_masked_dw_route", lambda *args: masked_route)
    num_types, jbatch, tbatch = build_batches(seed=6)
    states, weights, cot = _grad_inputs(num_types, True, seed=9)
    _, gw = _fused_grads_jax(states, weights, jbatch.adjacency, "max", True, cot)
    _, _, tw = _fused_grads_port(states, weights, tbatch.adjacency, "max", True, cot)
    np.testing.assert_allclose(tw, gw, rtol=1e-5, atol=1e-5)


def test_weight_gradient_route_follows_traffic():
    # the bench's 64-wide layer at 21 types takes the per-tile route; PPI's
    # 512 x 256 layer at 2 types the masked dots
    assert not fused_mp._use_masked_dw_route(384, 49152, 128, 64, 21, 4)
    assert fused_mp._use_masked_dw_route(384, 49152, 512, 256, 2, 2)


@pytest.mark.parametrize("col_offset", [0, 16])
def test_keyed_dropout_mask_equals_jax_bitwise(col_offset):
    from ptgnn_tpu.ops import fused_mp as jfm

    _, jbatch, tbatch = build_batches(seed=3)
    seed = np.uint32(2_975_412_133)
    ja, ta = jbatch.adjacency, tbatch.adjacency
    jkey = jfm._directed_edge_key(ja.senders, ja.receivers, ja.edge_types)
    tkey = fused_mp._directed_edge_key(ta.senders, ta.receivers, ta.edge_types)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey).astype(np.int64))
    jmask = jfm._keyed_dropout_mask(jnp.uint32(seed), jkey, 32, 0.2, col_offset)
    tmask = fused_mp._keyed_dropout_mask(torch.tensor(int(seed)), tkey, 32, 0.2, col_offset)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # padding slots share one key; the real ones drop at about the rate
    assert 0.15 < 1.0 - float(tmask[ta.mask].float().mean()) < 0.25


@pytest.mark.parametrize("reduction", ["max", "mean"])
def test_keyed_message_dropout_matches_jax(reduction):
    """keep 0.8 with one seed: the same slots drop in the forward and in both
    orientations of the backward (rtol/atol 1e-5)."""
    num_types, jbatch, tbatch = build_batches(seed=2)
    states, weights, cot = _grad_inputs(num_types, True, seed=10)
    seed = 1_234_567_891
    expected = jax_fused(
        jnp.asarray(states), jnp.asarray(weights), (jbatch.adjacency, jnp.uint32(seed)),
        PAD["max_nodes"], reduction, True, 0.8,
    )
    gx, gw = _fused_grads_jax(states, weights, jbatch.adjacency, reduction, True, cot, 0.8, jnp.uint32(seed))
    out, tx, tw = _fused_grads_port(
        states, weights, tbatch.adjacency, reduction, True, cot, 0.8, torch.tensor(seed)
    )
    np.testing.assert_allclose(out, np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx, gx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw, gw, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="seed"):
        fused_typed_message_aggregation(
            torch.from_numpy(states), torch.from_numpy(weights), tbatch.adjacency,
            PAD["max_nodes"], reduction, True, 0.8,
        )


@pytest.mark.parametrize("use_target_state", [True, False])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_every_nonempty_extremum_has_a_tie_in_both_orientations(reduction, use_target_state):
    """The backward finds each extremum's slots by recomputing messages and
    comparing with ``==``; a recompute off by one ulp would find none and the
    gradient would vanish silently."""
    num_types, _, tbatch = build_batches(seed=11)
    states, weights, _ = _grad_inputs(num_types, use_target_state, seed=12)
    ties, ties_tr = fused_mp.tie_counts(
        torch.from_numpy(states), torch.from_numpy(weights), tbatch.adjacency, reduction, use_target_state
    )
    nonempty = tbatch.adjacency.agg_counts.reshape(-1)[: PAD["max_nodes"]] > 0
    assert int(nonempty.sum()) > 40
    assert bool((ties[nonempty] >= 1).all()) and bool((ties_tr[nonempty] >= 1).all())
    assert torch.equal(ties, ties_tr)
    assert not ties[~nonempty].any()


def test_tree_to_moves_every_array():
    _, _, tbatch = build_batches()
    moved = tree_to(tbatch, torch.device("cpu"))
    assert isinstance(moved.adjacency.local_rows, torch.Tensor)
    assert moved.adjacency.mask.dtype == torch.bool
    assert moved.num_nodes.dim() == 0
