"""The port's message-passing families against the JAX package's: PNA, EGC
on both routes, GraphNorm, self-attention (over ``att_order``, over plain
blocks and on a reference subset), the MLP-MP layer over its options and
aggregations, ``nn.MLP``, and the aggregation dispatch on N-D messages and
under a non-static mask. The same numpy inputs go through both packages,
with the JAX params loaded through ``convert.py``; the JAX side runs its
Pallas kernels interpreted, as its own kernel tests do on the CPU.

Tolerances, float32: forward rtol 1e-5, atol 1e-6; every gradient within
1e-4 of its largest magnitude (the reductions add in another order).

PNA's std is sqrt(sum(relu(m^2 - mean^2)) + ...), a difference of nearly
equal squares wherever a node's messages lie near their mean (a node whose
one in-edge is its self edge: m^2 - (m / (1 + 1e-5))^2 = 2e-5 m^2). Its
float32 rounding error is about eps * sum(m^2) / (2 std), so PNA's std
columns are held within 1e-4 x sqrt(sum of the row's m^2) (the JAX
package's own two routes differ by 2.9e-6 there), its other columns at the
tolerance above, and a layer with PNA inside at rtol 1e-5 and 1e-5 of its
output's largest magnitude. PNA runs against the JAX package's XLA route:
its Pallas route gives NaN gradients where a padding node of a row block
gets a cotangent (the sqrt's infinite derivative at an empty row times the
broadcast's one-hot 0), where the port's are finite and equal the XLA
route's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.batching import GraphBatcher as JaxGraphBatcher
from ptgnn_tpu.graph.messagepassing import EGCMessagePassingLayer as JaxEGC
from ptgnn_tpu.graph.messagepassing import GraphContext as JaxGraphContext
from ptgnn_tpu.graph.messagepassing import GraphNorm as JaxGraphNorm
from ptgnn_tpu.graph.messagepassing import MlpMessagePassingLayer as JaxMlpLayer
from ptgnn_tpu.graph.messagepassing import MultiHeadSelfAttentionMessagePassing as JaxSelfAtt
from ptgnn_tpu.graph.messagepassing import PnaMessageAggregation as JaxPna
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.graph.structs import TensorizedGraphData as JaxTensorizedGraphData
from ptgnn_tpu.nn.layers import MLP as JaxMLP
from ptgnn_tpu.ops.pallas.segment_kernels import adjacency_segment_reduce as jax_adjacency_segment_reduce
from ptgnn_tpu.ops.segment import segment_reduce as jax_segment_reduce
from ptgnn_tpu_torch.graph.batching import GraphBatcher
from ptgnn_tpu_torch.graph.messagepassing import (
    EGCMessagePassingLayer,
    GraphContext,
    GraphNorm,
    MlpMessagePassingLayer,
    MultiHeadSelfAttentionMessagePassing,
    PnaMessageAggregation,
)
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData
from ptgnn_tpu_torch.nn.layers import MLP
from ptgnn_tpu_torch.ops import fused_mp
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from ptgnn_tpu_torch.ops.segment_kernels import adjacency_segment_reduce
from tests.torch_port_helpers import force_jax_fused_interpret

def layer_state_dict(params):
    """One port layer's (or MLP's) state dict for its JAX params: the nested
    keys joined by dots."""
    if not isinstance(params, dict):
        return {"": torch.from_numpy(np.array(params))}
    return {f"{key}.{sub}".rstrip("."): value for key, child in params.items()
            for sub, value in layer_state_dict(child).items()}


PAD = dict(max_nodes=96, max_edge_slots=6144, max_graphs=4, edge_tile=32, agg_rows=32, att_block=32,
           reference_budgets=(("supernodes", 16),))
SIZES = (25, 30, 12)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    force_jax_fused_interpret(monkeypatch)


def build_batches(seed=0, pad=PAD, sizes=SIZES):
    """The same graphs through both batchers: (edge types, JAX batch, port batch)."""
    rng = np.random.RandomState(seed)
    jb = JaxGraphBatcher(2, JaxBatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    tb = GraphBatcher(2, BatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    jmb, tmb = jb.initialize(), tb.initialize()
    for n in sizes:
        adj = [(rng.randint(0, n, n).astype(np.int32), rng.randint(0, n, n).astype(np.int32)) for _ in range(2)]
        refs = {"supernodes": rng.choice(n, size=3, replace=False).astype(np.int32)}
        jb.extend(JaxTensorizedGraphData(n, [0] * n, adj, None, refs), jmb)
        tb.extend(TensorizedGraphData(n, [0] * n, adj, None, refs), tmb)
    jbatch = jax.tree_util.tree_map(jnp.asarray, jb.finalize(jmb, node_data={}, reference_names=["supernodes"]))
    tbatch = tb.finalize(tmb, node_data={}, reference_names=["supernodes"]).to("cpu")
    return jb.num_edge_types, jbatch, tbatch


def contexts(jbatch, tbatch, *, att_order=True, mask=None):
    """The two layers' contexts; ``mask`` (numpy [E_pad] bool) replaces the
    static edge mask, as edge dropout does."""
    jctx = JaxGraphContext(
        adjacency=jbatch.adjacency, edge_features=None, node_graph=jbatch.node_graph,
        node_mask=jbatch.node_mask, graph_mask=jbatch.graph_mask, references=jbatch.references,
        att_order=jbatch.att_order if att_order else None,
    )
    tctx = GraphContext(
        adjacency=tbatch.adjacency, node_graph=tbatch.node_graph, node_mask=tbatch.node_mask,
        graph_mask=tbatch.graph_mask, references=tbatch.references,
        att_order=tbatch.att_order if att_order else None,
    )
    if mask is not None:
        jctx = jctx._replace(adjacency=jctx.adjacency._replace(mask=jnp.asarray(mask)), edge_mask_is_static=False)
        tctx = tctx._replace(adjacency=tctx.adjacency._replace(mask=torch.from_numpy(mask.copy())),
                             edge_mask_is_static=False)
    return jctx, tctx


def assert_grads_close(got, want, err_msg=""):
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all(), err_msg
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-30), err_msg=err_msg)


def use_jax_xla_route(monkeypatch):
    """The JAX package's XLA aggregation (its CPU default) for PNA."""
    monkeypatch.setenv("PTGNN_TPU_FORCE_PALLAS_AGG", "0")


def hold_layer(jlayer, tlayer, jctx, tctx, *, d_in, seed=4, key=0, fwd_atol_scale=None):
    """One layer's forward and gradients (params and input) against JAX for
    the loss sum(out * cot). ``fwd_atol_scale``: the forward's atol as a
    share of the output's largest magnitude, for PNA inside (1e-6 absolute
    otherwise)."""
    params = jlayer.init(jax.random.PRNGKey(key))
    tlayer.load_state_dict(layer_state_dict(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    rng = np.random.RandomState(seed)
    n = PAD["max_nodes"]
    states = rng.randn(n, d_in).astype(np.float32)
    expected = np.asarray(jlayer.apply(params, jnp.asarray(states), jctx))
    cot = rng.randn(*expected.shape).astype(np.float32)
    jgrad_p, jgrad_x = jax.grad(lambda p, x: jnp.sum(jlayer.apply(p, x, jctx) * cot), argnums=(0, 1))(
        params, jnp.asarray(states))
    x = torch.from_numpy(states).requires_grad_()
    out = tlayer(x, tctx)
    (out * torch.from_numpy(cot)).sum().backward()
    atol = 1e-6 if fwd_atol_scale is None else fwd_atol_scale * np.abs(expected).max()
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=1e-5, atol=atol)
    assert_grads_close(x.grad.numpy(), jgrad_x, "input")
    jflat = layer_state_dict(jax.tree_util.tree_map(np.asarray, jgrad_p))
    for name, p in tlayer.named_parameters():
        assert_grads_close(p.grad.numpy(), jflat[name].numpy(), name)
    return out


def test_graphnorm_matches_jax():
    _, jbatch, tbatch = build_batches(seed=11)
    jctx, tctx = contexts(jbatch, tbatch)
    jlayer, tlayer = JaxGraphNorm(16), GraphNorm(16)
    params = jlayer.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32)) for k, v in params.items()}
    jlayer.init = lambda key: params  # random moments' parameters, not the identity ones
    out = hold_layer(jlayer, tlayer, jctx, tctx, d_in=16)
    assert out.shape == (PAD["max_nodes"], 16)


@pytest.mark.parametrize("heads,bases", [(4, 3), (8, 4)])
@pytest.mark.parametrize("reduction", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("route", ["fused", "per_slot"])
def test_egc_matches_jax_on_both_routes(route, reduction, heads, bases, monkeypatch):
    num_types, jbatch, tbatch = build_batches(seed=7)
    jctx, tctx = contexts(jbatch, tbatch)
    calls = []
    real = fused_mp.fused_typed_message_aggregation
    monkeypatch.setattr("ptgnn_tpu_torch.graph.messagepassing.base.fused_typed_message_aggregation",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if route == "per_slot":  # a non-static mask equal to the static one: the per-slot route
        mask = np.asarray(jbatch.adjacency.mask)
        jctx, tctx = contexts(jbatch, tbatch, mask=mask)
    d, out = 12, 16
    hold_layer(JaxEGC(d, out, num_types, reduction, num_bases=bases, num_heads=heads),
               EGCMessagePassingLayer(d, out, num_types, reduction, num_bases=bases, num_heads=heads),
               jctx, tctx, d_in=d)
    assert len(calls) == (1 if route == "fused" else 0)


@pytest.mark.parametrize("static", [True, False])
def test_pna_aggregation_matches_jax(static, monkeypatch):
    """PNA's 15 x M output on the same messages, and the messages' gradient,
    under the static mask and under one with emptied nodes."""
    use_jax_xla_route(monkeypatch)
    _, jbatch, tbatch = build_batches(seed=5)
    mask = None if static else emptying_mask(jbatch)[0]
    jctx, tctx = contexts(jbatch, tbatch, mask=mask)
    n, m = PAD["max_nodes"], 6
    rng = np.random.RandomState(0)
    msgs = rng.randn(tbatch.adjacency.mask.shape[0], m).astype(np.float32)
    cot = rng.randn(n, 15 * m).astype(np.float32)
    expected = np.asarray(JaxPna().apply({}, jnp.asarray(msgs), jctx, n))
    jgrad = jax.grad(lambda x: jnp.sum(JaxPna().apply({}, x, jctx, n) * cot))(jnp.asarray(msgs))
    x = torch.from_numpy(msgs).requires_grad_()
    out = PnaMessageAggregation()(x, tctx, n)
    (out * torch.from_numpy(cot)).sum().backward()
    got = out.detach().numpy()
    assert got.shape == (n, 15 * m)
    std_cols = np.zeros(15 * m, bool)
    for group in range(3):
        std_cols[group * 5 * m + 4 * m:group * 5 * m + 5 * m] = True
    np.testing.assert_allclose(got[:, ~std_cols], expected[:, ~std_cols], rtol=1e-5, atol=1e-6)
    live = np.asarray(tctx.adjacency.mask)
    receivers = np.asarray(tbatch.adjacency.receivers)
    sum_sq = np.zeros(n + 1)
    np.add.at(sum_sq, receivers[live], (msgs[live].astype(np.float64) ** 2).sum(-1))
    scale = 1e-4 * np.sqrt(sum_sq[:n])[:, None] * np.maximum(1.0, np.abs(expected[:, std_cols]).max())
    assert (np.abs(got[:, std_cols] - expected[:, std_cols]) <= scale + 1e-6).all()
    assert_grads_close(x.grad.numpy(), jgrad)


def test_pna_layer_matches_jax(monkeypatch):
    use_jax_xla_route(monkeypatch)
    num_types, jbatch, tbatch = build_batches(seed=5)
    jctx, tctx = contexts(jbatch, tbatch)
    d, m = 12, 6
    kw = dict(message_activation=None, use_layer_norm=False, use_dense_layer=False, dense_activation=None)
    out = hold_layer(JaxMlpLayer(d, m, m, num_types, JaxPna(), **kw),
                     MlpMessagePassingLayer(d, m, m, num_types, PnaMessageAggregation(), **kw),
                     jctx, tctx, d_in=d, fwd_atol_scale=1e-5)
    assert out.shape == (PAD["max_nodes"], 15 * m)


def emptying_mask(jbatch, seed=0):
    """The static mask with a random 30 % of the slots dropped and every
    in-slot of two real nodes (with in-edges) dropped; returns it and the
    emptied nodes."""
    adj = jbatch.adjacency
    static = np.asarray(adj.mask)
    receivers = np.asarray(adj.receivers)
    rng = np.random.RandomState(seed)
    mask = static & (rng.rand(static.shape[0]) >= 0.3)
    emptied = np.unique(receivers[static])[[3, 17]]
    mask &= ~np.isin(receivers, emptied)
    return mask, emptied


@pytest.mark.parametrize("aggregation", ["sum", "mean", "max", "min", "pna"])
def test_emptied_nodes_under_a_non_static_mask_match_jax(aggregation, monkeypatch):
    """Edge dropout can take every in-slot of a real node: its aggregate is
    0 (max/min through the extremum's sentinel) and every gradient stays
    finite and equal to JAX's, PNA's sqrt at 0 included."""
    if aggregation == "pna":
        use_jax_xla_route(monkeypatch)
    num_types, jbatch, tbatch = build_batches(seed=3)
    mask, emptied = emptying_mask(jbatch)
    jctx, tctx = contexts(jbatch, tbatch, mask=mask)
    d, m = 12, 8
    kw = dict(message_activation=None, use_layer_norm=False, use_dense_layer=False, mlp_hidden_layers=1)
    jagg = JaxPna() if aggregation == "pna" else aggregation
    tagg = PnaMessageAggregation() if aggregation == "pna" else aggregation
    out = hold_layer(JaxMlpLayer(d, m, m, num_types, jagg, **kw), MlpMessagePassingLayer(d, m, m, num_types, tagg, **kw),
                     jctx, tctx, d_in=d, fwd_atol_scale=1e-5 if aggregation == "pna" else None)
    np.testing.assert_array_equal(out.detach().numpy()[emptied], 0.0)


MLP_OPTIONS = {
    "one_hidden": dict(mlp_hidden_layers=1),
    "hidden_list_no_target": dict(mlp_hidden_layers=[8, 6], use_target_state_as_message_input=False,
                                  message_activation=None, use_layer_norm=False, dense_activation=None),
    "single_linear_relu_no_dense": dict(message_activation="relu", use_dense_layer=False),
}


@pytest.mark.parametrize("options", sorted(MLP_OPTIONS))
@pytest.mark.parametrize("aggregation", ["sum", "mean", "max", "pna"])
def test_mlp_mp_layer_matches_jax(aggregation, options, monkeypatch):
    if aggregation == "pna":
        use_jax_xla_route(monkeypatch)
    num_types, jbatch, tbatch = build_batches(seed=2)
    jctx, tctx = contexts(jbatch, tbatch)
    d, m, o = 12, 10, 8
    kw = MLP_OPTIONS[options]
    jagg = JaxPna() if aggregation == "pna" else aggregation
    tagg = PnaMessageAggregation() if aggregation == "pna" else aggregation
    tlayer = MlpMessagePassingLayer(d, o, m, num_types, tagg, **kw)
    hold_layer(JaxMlpLayer(d, o, m, num_types, jagg, **kw), tlayer, jctx, tctx, d_in=d,
               fwd_atol_scale=1e-5 if aggregation == "pna" else None)
    hidden = kw.get("mlp_hidden_layers", 0)
    assert len(tlayer.message_mlp.dims) == 2 + (hidden if isinstance(hidden, int) else len(hidden))


def test_mlp_mp_layer_rejects_edge_features():
    """``features_dimension`` builds and reads the context's edge features,
    concatenated after the source and target states, as the JAX layer does
    (forward and gradients at the tolerances above, no fused-op call); the
    layer rejects a context whose edge features are missing or of another
    width, where the JAX layer would fail in its matmul."""
    num_types, jbatch, tbatch = build_batches(seed=5)
    jctx, tctx = contexts(jbatch, tbatch)
    feats = np.random.RandomState(3).randn(PAD["max_edge_slots"], 4).astype(np.float32)
    jctx = jctx._replace(edge_features=jnp.asarray(feats))
    tctx = tctx._replace(edge_features=torch.from_numpy(feats.copy()))
    d, m, o = 12, 10, 8
    tlayer = MlpMessagePassingLayer(d, o, m, num_types, "sum", features_dimension=4)
    assert tlayer.message_mlp.weights_0.shape == (num_types, 2 * d + 4, m)
    calls = []
    real = fused_mp.fused_typed_message_aggregation
    import ptgnn_tpu_torch.graph.messagepassing.base as mp_base
    mp_base.fused_typed_message_aggregation = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        hold_layer(JaxMlpLayer(d, o, m, num_types, "sum", features_dimension=4), tlayer, jctx, tctx, d_in=d)
    finally:
        mp_base.fused_typed_message_aggregation = real
    assert not calls
    x = torch.zeros(PAD["max_nodes"], d)
    with pytest.raises(ValueError, match="edge-feature columns"):
        tlayer(x, tctx._replace(edge_features=None))
    with pytest.raises(ValueError, match="edge-feature columns"):
        tlayer(x, tctx._replace(edge_features=torch.zeros(PAD["max_edge_slots"], 3)))


@pytest.mark.parametrize("case", ["att_order", "plain_blocks", "att_width_differs", "reference"])
def test_self_attention_matches_jax(case, caplog):
    _, jbatch, tbatch = build_batches(seed=9)
    jctx, tctx = contexts(jbatch, tbatch, att_order=case != "plain_blocks")
    d = 16
    kw = dict(input_state_dimension=d, key_query_dimension=4, value_dimension=5, output_dimension=d,
              intermediate_dimension=24, num_heads=3)
    kw["max_num_nodes"] = {"plain_blocks": 24, "att_width_differs": 64}.get(case, PAD["att_block"])
    if case == "reference":
        kw["target_reference"] = "supernodes"
    tlayer = MultiHeadSelfAttentionMessagePassing(**kw)
    out = hold_layer(JaxSelfAtt(**kw), tlayer, jctx, tctx, d_in=d, seed=6)
    def warnings():
        return [r for r in caplog.records
                if r.name.startswith("ptgnn_tpu_torch.") and "using the batch's block width" in r.getMessage()]

    assert len(warnings()) == (1 if case == "att_width_differs" else 0)
    if case == "att_width_differs":  # a second call does not warn again
        tlayer(torch.zeros(PAD["max_nodes"], d), tctx)
        assert len(warnings()) == 1
    if case == "reference":
        ref = tbatch.references["supernodes"]
        touched = set(ref.node_ids[ref.mask].tolist())
        states = np.random.RandomState(6).randn(PAD["max_nodes"], d).astype(np.float32)
        untouched = [i for i in range(PAD["max_nodes"]) if i not in touched]
        np.testing.assert_array_equal(out.detach().numpy()[untouched], states[untouched])
    elif case == "att_order":  # padding nodes sit in no block: zero rows
        n = int(tbatch.num_nodes)
        np.testing.assert_array_equal(out.detach().numpy()[n:], 0.0)


@pytest.mark.parametrize(
    "hidden,output,use_biases,activation",
    [(1, 7, False, "relu"), ([9, 5], 4, True, "tanh"), (2, 1, False, "gelu"), (1, 6, False, None)],
)
def test_mlp_matches_jax(hidden, output, use_biases, activation):
    jmlp = JaxMLP(10, output, hidden_layers=hidden, use_biases=use_biases, activation=activation)
    tmlp = MLP(10, output, hidden_layers=hidden, use_biases=use_biases, activation=activation)
    params = jmlp.init(jax.random.PRNGKey(1))
    tmlp.load_state_dict(layer_state_dict(jax.tree_util.tree_map(np.asarray, params)), strict=True)
    rng = np.random.RandomState(0)
    x = rng.randn(20, 10).astype(np.float32)
    expected = np.asarray(jmlp.apply(params, jnp.asarray(x)))
    cot = rng.randn(*expected.shape).astype(np.float32)
    jgrad = jax.grad(lambda p: jnp.sum(jmlp.apply(p, jnp.asarray(x)) * cot))(params)
    out = tmlp(torch.from_numpy(x))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=1e-5, atol=1e-6)
    jflat = layer_state_dict(jax.tree_util.tree_map(np.asarray, jgrad))
    for name, p in tmlp.named_parameters():
        assert_grads_close(p.grad.numpy(), jflat[name].numpy(), name)
    if output == 1:  # a size-1 output widens the hidden layers to 32
        assert tmlp.layer_0.out_features == 32


def test_mlp_refuses_stacked_linears_without_activation():
    with pytest.raises(ValueError, match="without an activation"):
        MLP(4, 4, hidden_layers=2, activation=None)


@pytest.mark.parametrize("reduction", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("static", [True, False])
def test_aggregation_dispatch_on_nd_messages_matches_jax(reduction, static):
    """[E, 2, 3, 4] messages through the dispatch: the kernels' 2-D view and
    back, under the static mask (mean from the plan's counts) and under a
    mask with emptied rows (mean counts the live slots)."""
    _, jbatch, tbatch = build_batches(seed=13)
    adj_j, adj_t = jbatch.adjacency, tbatch.adjacency
    mask = np.asarray(adj_j.mask) if static else emptying_mask(jbatch, seed=2)[0]
    rng = np.random.RandomState(0)
    data = rng.randn(mask.shape[0], 2, 3, 4).astype(np.float32)
    n = PAD["max_nodes"]
    expected = np.asarray(jax_adjacency_segment_reduce(
        jnp.asarray(data), adj_j, n, reduction, mask=jnp.asarray(mask), counts_exact=static))
    xla = np.asarray(jax_segment_reduce(jnp.asarray(data), adj_j.receivers, n, reduction, mask=jnp.asarray(mask)))
    x = torch.from_numpy(data).requires_grad_()
    tsk.reset_launch_counts()
    got = adjacency_segment_reduce(x, adj_t, n, reduction, mask=torch.from_numpy(mask.copy()), counts_exact=static)
    assert got.shape == (n, 2, 3, 4)
    np.testing.assert_allclose(got.detach().numpy(), expected, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), xla, rtol=1e-5, atol=1e-6)
    cot = rng.randn(*got.shape).astype(np.float32)
    (got * torch.from_numpy(cot)).sum().backward()
    jgrad = jax.grad(lambda d: jnp.sum(jax_segment_reduce(d, adj_j.receivers, n, reduction,
                                                          mask=jnp.asarray(mask)) * cot))(jnp.asarray(data))
    assert_grads_close(x.grad.numpy(), jgrad)
    assert all(v == 0 for v in tsk.launch_counts().values())  # the CPU runs the plain versions


def test_mean_under_a_non_static_mask_counts_the_live_slots():
    """The count of a mean under a non-static mask is the sum at width 1 over
    the live slots: rows whose slots are all dropped read 0, others divide
    by their live count, not the plan's static count."""
    _, jbatch, tbatch = build_batches(seed=1)
    mask, emptied = emptying_mask(jbatch)
    adj = tbatch.adjacency
    n = PAD["max_nodes"]
    ones = torch.ones(adj.mask.shape[0], 3)
    got = adjacency_segment_reduce(ones, adj, n, "mean", mask=torch.from_numpy(mask.copy()), counts_exact=False)
    live = np.bincount(np.asarray(adj.receivers)[mask], minlength=n + 1)[:n]
    np.testing.assert_array_equal(got[:, 0].numpy(), (live > 0).astype(np.float32))
    assert (got[torch.from_numpy(emptied)] == 0).all()
    stale = adjacency_segment_reduce(ones, adj, n, "mean", mask=torch.from_numpy(mask.copy()), counts_exact=True)
    static = adj.agg_counts.reshape(-1)[:n].numpy()
    partial = (live > 0) & (live < static)
    assert partial.any() and (stale[:, 0].numpy()[partial] < 1).all()
