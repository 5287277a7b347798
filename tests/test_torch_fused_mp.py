"""The port's fused message+aggregation forward, and a whole MLP-MP layer,
against the JAX package's fused path (Pallas kernels interpreted), at f32.

Tolerance rtol/atol 1e-5: only the summation order of the message matmul
differs; the gathers, the broadcast and the extremum are exact."""
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
    assert tsk.launch_counts() == {"segment_extremum": 0, "broadcast_to_edges": 0}


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


def test_backward_and_dropout_raise_until_ported():
    num_types, _, tbatch = build_batches()
    states = torch.randn(PAD["max_nodes"], 8, requires_grad=True)
    weights = torch.randn(num_types, 16, 8, requires_grad=True)
    out = fused_typed_message_aggregation(states, weights, tbatch.adjacency, PAD["max_nodes"], "max", True)
    with pytest.raises(NotImplementedError):
        out.sum().backward()
    with pytest.raises(NotImplementedError):
        fused_typed_message_aggregation(states, weights, tbatch.adjacency, PAD["max_nodes"], "max", True, 0.9)


def test_tree_to_moves_every_array():
    _, _, tbatch = build_batches()
    moved = tree_to(tbatch, torch.device("cpu"))
    assert isinstance(moved.adjacency.local_rows, torch.Tensor)
    assert moved.adjacency.mask.dtype == torch.bool
    assert moved.num_nodes.dim() == 0
