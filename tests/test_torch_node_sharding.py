"""The port's node sharding (``parallel/node_sharding.py``) against the JAX
package's: the cases of ``tests/test_node_sharding.py``, and of
``tests/test_node_sharding_at_scale.py`` on the host side.

Host side, in one process: ``shard_batch_by_nodes`` (without, with and by
choice of the BFS reorder), ``suggest_budgets`` and ``BoundaryBudgetError``'s
fields give the JAX package's arrays and numbers bitwise; the resharded
edges are the batch's, each once; the reorder recovers scrambled locality;
a 250k-node graph's per-shard payload is a fraction of the batch's.

Device side, on 4 gloo ranks (one spawned world for the module,
``tests/torch_shard_worker.py``), weights converted through ``convert.py``,
dropout 0:
* Graph2Class SGD steps of the ``mlp`` and ``ggnn`` stacks, on 4 shards and
  on 2 (two node groups of two ranks), against JAX's ``NodeParallel`` step on
  a 4-device mesh, and at the JAX test's size against the port's own
  single-device step (see ``G2C``);
* a heterogeneous stack (GGNN, GraphNorm, two global exchanges, the
  self-attention layer whole and on the supernodes) and an edge-feature
  model, against JAX's single-device step, which JAX's own test holds its
  node-sharded loss to;
* GraphNorm's per-graph moments across ranks;
* PPI with the BFS reorder against the port's own unsharded step: the JAX
  package does not permute PPI's node-aligned targets under a reorder
  (``ptgnn_tpu/implementations/ppi/ppi.py:67``), so it is no oracle there;
* a single graph larger than a shard trains; the interior aggregation does
  not read the exchange.

Tolerances: the loss rtol 1e-5; each parameter's update within 1e-4 of its
largest magnitude (``test_torch_parallel_dp.py``'s), or within 1e-6 of the
step's largest update where a parameter's update is rounding noise
(``assert_updates_match``); GraphNorm 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from ptgnn_tpu.graph.batching import GraphBatcher as JaxGraphBatcher
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.graph.structs import TensorizedGraphData as JaxTensorizedGraphData
from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu.parallel import node_sharding as jns
from ptgnn_tpu_torch.convert import jax_params_to_state_dict
from ptgnn_tpu_torch.core.trainer import module_loss
from ptgnn_tpu_torch.graph.batching import GraphBatcher
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData, tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.parallel import node_sharding as tns
from tests.torch_shard_worker import SumOfSquaresHead, launch

S = 4
# test_node_sharding.py's Graph2Class size. At it the two packages' single-
# device steps already differ by up to 6e-3 of a parameter's largest update
# (max aggregation routes a gradient to its winning slot, and float32 drift
# between the packages flips near-ties), so there the port's node-sharded
# step is held to its own single-device step; the JAX parity cases take the
# size of test_torch_parallel_dp.py, where the packages agree to 1e-4.
G2C = dict(num_metadata_graphs=16, mean_nodes=60, max_graph_nodes=120, hidden_state_size=32, num_minibatches=1,
           minibatch_size=8, dropout_rate=0.0)
G2C_PARITY = {**G2C, "num_metadata_graphs": 32, "mean_nodes": 30, "max_graph_nodes": 80}
LR = 0.05


# ---------------------------------------------------------------------------
# batches through both packages' batchers
# ---------------------------------------------------------------------------
def build_batch(pkg, seed=5, nodes_per_graph=(40, 35, 30), edges_per_type=60):
    """test_node_sharding.py's batch of graphs that straddle the shard rows."""
    batcher_cls, pad_cls, graph_cls = pkg
    rng = np.random.RandomState(seed)
    pad = pad_cls(max_nodes=128, max_edge_slots=16 * 256, max_graphs=4, edge_tile=16, agg_rows=16, agg_sum_tile=0)
    b = batcher_cls(2, pad, introduce_backwards_edges=True, add_self_edges=True)
    mb = b.initialize()
    for n in nodes_per_graph:
        adj = [(rng.randint(0, n, edges_per_type).astype(np.int32),
                rng.randint(0, n, edges_per_type).astype(np.int32)) for _ in range(2)]
        g = graph_cls(num_nodes=n, node_tensorized_data=[0] * n, adjacency_lists=adj, edge_features=None,
                      reference_nodes={})
        assert b.can_add(g, mb)
        b.extend(g, mb)
    return b.finalize(mb, node_data={"x": np.arange(128, dtype=np.float32)}, reference_names=[])


def build_scrambled_chains(pkg, seed=7):
    """Chains whose numbering is a random permutation: local topology that
    the batch order hides."""
    batcher_cls, pad_cls, graph_cls = pkg
    rng = np.random.RandomState(seed)
    pad = pad_cls(max_nodes=128, max_edge_slots=16 * 256, max_graphs=4, edge_tile=16, agg_rows=16, agg_sum_tile=0)
    b = batcher_cls(1, pad, introduce_backwards_edges=True, add_self_edges=False)
    mb = b.initialize()
    for n in (40, 35, 30):
        p = rng.permutation(n).astype(np.int32)
        g = graph_cls(num_nodes=n, node_tensorized_data=[0] * n, adjacency_lists=[(p[:-1], p[1:])],
                      edge_features=None, reference_nodes={})
        assert b.can_add(g, mb)
        b.extend(g, mb)
    return b.finalize(mb, node_data={}, reference_names=[])


JAX = (JaxGraphBatcher, JaxBatchPadding, JaxTensorizedGraphData)
PORT = (GraphBatcher, BatchPadding, TensorizedGraphData)
BUDGETS = dict(boundary_budget=64, interior_slots=16 * 64, boundary_slots=16 * 64)
ADJ_FIELDS = ("senders", "receivers", "edge_types", "tile_types", "mask", "tile_types_transposed", "local_rows",
              "tile_row_blocks", "agg_counts", "super_tile_row_blocks", "edge_feature_slot")


def assert_adjacency_equal(ours, theirs):
    for name in ADJ_FIELDS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None), name
        if a is not None:  # (JAX's local_rows carry a trailing unit axis)
            np.testing.assert_array_equal(a, np.asarray(b).reshape(a.shape), err_msg=name)


@pytest.mark.parametrize("builder", [build_batch, build_scrambled_chains])
@pytest.mark.parametrize("reorder", [None, "bfs", "auto"])
def test_reshard_matches_jax_bitwise(builder, reorder):
    (jmb, jstats), (tmb, tstats) = (
        jns.shard_batch_by_nodes({"batch": builder(JAX)}, S, reorder=reorder, **BUDGETS),
        tns.shard_batch_by_nodes({"batch": builder(PORT)}, S, reorder=reorder, **BUDGETS),
    )
    perm = tstats.pop("permutation")  # the port's own
    assert tstats == jstats
    jb, tb = jmb["batch"], tmb["batch"]
    if perm is None:
        assert reorder != "bfs"
    else:  # the renumbering that the sharded arrays follow
        np.testing.assert_array_equal(tb.node_sharding.node_graph_global, builder(PORT).node_graph[perm])
    assert_adjacency_equal(tb.adjacency, jb.adjacency)
    assert_adjacency_equal(tb.node_sharding.adjacency_bnd, jb.node_sharding.adjacency_bnd)
    for name in ("send_idx", "node_graph_global", "node_mask_global", "boundary_counts"):
        np.testing.assert_array_equal(getattr(tb.node_sharding, name), getattr(jb.node_sharding, name))
    np.testing.assert_array_equal(tb.node_graph, jb.node_graph)
    np.testing.assert_array_equal(tb.node_mask, jb.node_mask)
    for k in jb.node_data:
        np.testing.assert_array_equal(tb.node_data[k], jb.node_data[k])
    # each sub-layout's row index lists its own slots (the kernels walk it)
    for adj in (tb.adjacency, tb.node_sharding.adjacency_bnd):
        for s in range(S):
            np.testing.assert_array_equal(np.diff(adj.row_offsets[s]), adj.agg_counts[s].reshape(-1))
            real = np.nonzero(adj.mask[s])[0]
            np.testing.assert_array_equal(np.sort(adj.row_slots[s][:len(real)]), real)


def test_reshard_preserves_every_edge_once():
    batch = build_batch(PORT)
    sharded, stats = tns.shard_batch_by_nodes({"batch": batch}, S, reorder=None, **BUDGETS)
    rows_per = 128 // S
    adj = batch.adjacency
    expected = sorted((int(s), int(r), int(t)) for s, r, t, m in
                      zip(adj.senders, adj.receivers, adj.edge_types, adj.mask) if m)
    got = []
    for s in range(S):
        local = tns.local_shard(sharded, s)["batch"]
        ai, ab = local.adjacency, local.node_sharding.adjacency_bnd
        send_idx = sharded["batch"].node_sharding.send_idx
        b = send_idx.shape[-1]
        got.extend((int(x) + s * rows_per, int(r) + s * rows_per, int(t))
                   for x, r, t, m in zip(ai.senders, ai.receivers, ai.edge_types, ai.mask) if m)
        for x, r, t, m in zip(ab.senders, ab.receivers, ab.edge_types, ab.mask):
            if m:
                owner, slot = divmod(int(x), b)
                got.append((int(send_idx[owner, s, slot]) + owner * rows_per, int(r) + s * rows_per, int(t)))
    assert sorted(got) == expected
    assert stats["boundary_nodes_total"] > 0


def test_bfs_reorder_recovers_locality():
    batch = build_scrambled_chains(PORT)
    _, stats_id = tns.shard_batch_by_nodes({"batch": batch}, S, reorder=None, **BUDGETS)
    _, stats_bfs = tns.shard_batch_by_nodes({"batch": batch}, S, **BUDGETS)
    assert 0 < stats_bfs["boundary_nodes_total"] <= stats_id["boundary_nodes_total"] // 4
    assert stats_bfs["boundary_nodes_total"] <= 8 * 3


def test_ast_topology_generator_schema():
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    offs = []
    for g in synthetic_typilus_graphs(4, seed=0, mean_nodes=120, topology="ast"):
        n = len(g["nodes"])
        assert g["supernodes"]
        for adj in g["edges"].values():
            for src, dsts in adj.items():
                assert 0 <= int(src) < n and all(0 <= d < n for d in dsts)
                offs.extend(abs(d - int(src)) for d in dsts)
    assert (np.asarray(offs) <= 32).mean() > 0.8


def test_reshard_budget_error_reports_requirements():
    fields = ("required_boundary_budget", "required_interior_slots", "required_boundary_slots")
    errors = []
    for pkg, mod in ((JAX, jns), (PORT, tns)):
        with pytest.raises(ValueError) as ei:
            mod.shard_batch_by_nodes({"batch": build_batch(pkg)}, S, **{**BUDGETS, "boundary_budget": 1})
        assert isinstance(ei.value, mod.BoundaryBudgetError) and "boundary_budget>=" in str(ei.value)
        errors.append(tuple(getattr(ei.value, f) for f in fields))
    assert errors[0] == errors[1]
    for reorder in (None, "auto"):
        budgets = tns.suggest_budgets([{"batch": build_batch(PORT)}], S, reorder=reorder)
        assert budgets == jns.suggest_budgets([{"batch": build_batch(JAX)}], S, reorder=reorder)
        _, stats = tns.shard_batch_by_nodes({"batch": build_batch(PORT)}, S, reorder=reorder, **budgets)
        assert stats["boundary_budget_used"] <= budgets["boundary_budget"]


def test_exchanged_rows_scale_with_boundary_not_nodes():
    batch = build_batch(PORT, nodes_per_graph=(32, 32, 32), edges_per_type=40)
    _, stats = tns.shard_batch_by_nodes({"batch": batch}, S, **BUDGETS)
    assert stats["boundary_nodes_total"] == 0
    _, stats2 = tns.shard_batch_by_nodes({"batch": build_batch(PORT)}, S, **BUDGETS)
    assert stats2["boundary_nodes_total"] > 0 and stats2["exchanged_rows_real"] == stats2["boundary_nodes_total"]


def test_node_parallel_per_shard_arrays_scale_down():
    _, _, mbs = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8), device="cpu", **G2C)
    sharded, stats = tns.shard_batch_by_nodes(mbs[0], S, **tns.suggest_budgets(mbs, S))
    for leaf in sharded["batch"].node_data.values():
        assert leaf.shape[:2] == (S, 256 // S)
    local = tns.local_shard(sharded, 1)["batch"]
    for leaf in local.node_data.values():
        assert leaf.shape[0] == 256 // S
    assert stats["rows_per_shard"] == 256 // S


def test_layers_without_exchange_declare_it():
    """The layers that read no sender rows skip the exchange: the
    self-attention layer (gather-based), GraphNorm and the global exchange."""
    from ptgnn_tpu_torch.graph.messagepassing.gated import GatedMessagePassingLayer
    from ptgnn_tpu_torch.graph.messagepassing.global_exchange import GruGlobalStateUpdate
    from ptgnn_tpu_torch.graph.messagepassing.graphnorm import GraphNorm
    from ptgnn_tpu_torch.graph.messagepassing.selfatt import MultiHeadSelfAttentionMessagePassing

    for cls in (MultiHeadSelfAttentionMessagePassing, GraphNorm, GruGlobalStateUpdate):
        assert cls.needs_boundary_exchange is False
    assert GatedMessagePassingLayer.needs_boundary_exchange is True


def test_per_shard_payload_at_reference_dropping_scale():
    """One ~250k-node graph (past both of the reference's graph-size drop
    caps) in a 2**18-row batch: a shard's payload is under 1/(S/2) of the
    batch's, its rows a quarter, and after the reorder the boundary is a
    sliver of the graph (the JAX package's host-side case)."""
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    max_nodes = 262_144
    padding = BatchPadding(max_nodes=max_nodes, max_edge_slots=max_nodes * 14, max_graphs=4, edge_tile=128,
                           reference_budgets=(("supernodes", 16384), ("token-sequence", 131072)))
    model = create_graph2class_gnn_model(hidden_state_size=64, padding=padding)
    model.gnn_model.max_nodes_per_graph = max_nodes
    model.gnn_model.max_graph_edges = 4_000_000
    graphs = list(synthetic_typilus_graphs(1, seed=42, mean_nodes=250_000, max_nodes=262_000, edges_per_node=2.5,
                                           topology="ast"))
    model.compute_metadata(iter(graphs), parallelize=False)
    (mb, _), = list(model.minibatch_iterator(model.tensorize_dataset(iter(graphs), parallelize=False),
                                             max_minibatch_size=1, parallelize=False))
    batch = mb["batch"]
    assert int(batch.num_nodes) > 200_000 and int(batch.num_edges) > 1_000_000
    budgets = tns.suggest_budgets([mb], S)
    smb, stats = tns.shard_batch_by_nodes(mb, S, **budgets)

    def nbytes(tree):
        leaves = []
        stack = [tree]
        while stack:
            x = stack.pop()
            if isinstance(x, np.ndarray):
                leaves.append(x)
            elif isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
        return sum(a.nbytes for a in leaves)

    assert nbytes(tns.local_shard(smb, 0)) < nbytes(mb) / (S / 2)
    assert stats["rows_per_shard"] == max_nodes // S
    assert stats["boundary_nodes_total"] < 0.05 * int(batch.num_nodes)


# ---------------------------------------------------------------------------
# the device side on 4 gloo ranks
# ---------------------------------------------------------------------------
def hetero_model(pkg: str):
    """test_node_sharding.py's heterogeneous stack, in either package."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    H = 32
    mp, ge, gn, sa = (mod("graph.messagepassing"), mod("graph.messagepassing.global_exchange"),
                      mod("graph.messagepassing.graphnorm"), mod("graph.messagepassing.selfatt"))
    rd = mod("reduceops.varsizedsummary")

    def creator(num_edges):
        gated = mp.GatedMessagePassingLayer(state_dimension=H, message_dimension=H, num_edge_types=num_edges,
                                            message_aggregation_function="max", dropout_rate=0.0)
        att = dict(input_state_dimension=H, key_query_dimension=8, value_dimension=8, output_dimension=H,
                   intermediate_dimension=2 * H, num_heads=2, dropout_rate=0.0)
        return [
            gated,
            gn.GraphNorm(H),
            ge.GruGlobalStateUpdate(rd.SimpleVarSizedElementReduce("mean"), input_state_size=H,
                                    summarized_state_size=H),
            ge.GruGlobalStateUpdate(rd.MultiheadSelfAttentionVarSizedElementReduce(
                input_representation_size=H, hidden_size=16, output_representation_size=H, num_heads=2,
                query_representation_summarizer=rd.NormalizedWeightsVarSizedElementReduce(H, 16)),
                input_state_size=H, summarized_state_size=H),
            sa.MultiHeadSelfAttentionMessagePassing(**att),
            sa.MultiHeadSelfAttentionMessagePassing(**att, target_reference="supernodes"),
            mp.GatedMessagePassingLayer(state_dimension=H, message_dimension=H, num_edge_types=num_edges,
                                        message_aggregation_function="max", dropout_rate=0.0),
        ]

    harness = mod("implementations.typilus.harness")
    return mod("implementations.typilus.graph2class").Graph2Class(
        gnn_model=mod("graph.gnn").GraphNeuralNetworkModel(
            node_representation_model=mod("graph.embedders").StrElementRepresentationModel(
                embedding_size=H, token_splitting="subtoken", subtoken_combination="mean", vocabulary_size=10000,
                min_freq_threshold=2, dropout_rate=0.0),
            message_passing_layer_creator=creator, padding=harness.small_padding(max_nodes=256, max_graphs=8),
            introduce_backwards_edges=True, add_self_edges=True, edge_dropout_rate=0.0),
        max_num_classes=100,
    )


def first_minibatch(model, data):
    return next(model.minibatch_iterator(model.tensorize_dataset(iter(data), parallelize=False),
                                         max_minibatch_size=8, parallelize=False))[0]


def edge_feature_models(pkg: str):
    """test_node_sharding.py's edge-feature model and its 3 graphs."""
    import importlib

    emb = importlib.import_module(f"{pkg}.graph.embedders")
    gnn = importlib.import_module(f"{pkg}.graph.gnn")
    mp = importlib.import_module(f"{pkg}.graph.messagepassing")
    structs = importlib.import_module(f"{pkg}.graph.structs")
    rng = np.random.RandomState(0)

    def graph(n=40, e=50):
        edges = [(int(a), int(b)) for a, b in zip(rng.randint(0, n, e), rng.randint(0, n, e))]
        return structs.GraphData(node_information=[rng.randn(3).astype(np.float32) for _ in range(n)],
                                 edges={"E": edges}, reference_nodes={},
                                 edge_features={"E": [rng.randn(2).astype(np.float32) for _ in range(e)]})

    pad = structs.BatchPadding(max_nodes=128, max_edge_slots=4096, max_graphs=4, edge_tile=32, agg_rows=32)
    model = gnn.GraphNeuralNetworkModel(
        node_representation_model=emb.FeatureRepresentationModel(embedding_size=8),
        edge_representation_model=emb.FeatureRepresentationModel(embedding_size=4),
        message_passing_layer_creator=lambda n: [mp.GatedMessagePassingLayer(
            state_dimension=8, message_dimension=8, num_edge_types=n, message_aggregation_function="sum",
            edge_feature_dimension=4)] * 2,
        padding=pad, introduce_backwards_edges=True, add_self_edges=True,
    )
    graphs = [graph() for _ in range(3)]
    model.compute_metadata(iter(graphs), parallelize=False)
    mb = next(model.minibatch_iterator(model.tensorize_dataset(iter(graphs), parallelize=False),
                                       max_minibatch_size=3, parallelize=False))[0]
    return model, {"batch": mb["batch"]}


def jax_sgd_step(jmodule_apply, params, mb, lr=LR):
    """JAX's single-device loss and SGD step."""
    loss, grads = jax.value_and_grad(lambda p: jmodule_apply(p, mb))(params)
    return float(loss), jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)


def port_update(tmodule_like, state, params_after, jparams_after):
    """(port update, JAX update) per parameter."""
    jflat = {k: v.numpy() for k, v in
             jax_params_to_state_dict(tmodule_like, jax.tree_util.tree_map(np.asarray, jparams_after)).items()}
    for name, after in params_after.items():  # (a shared layer's parameters once)
        before = state[name]
        yield name, (after - before).numpy(), jflat[name] - before.numpy()


def assert_updates_match(tmodule_like, state, params_after, jparams_after):
    """Each parameter's update within 1e-4 of its largest magnitude, or
    within 1e-6 of the step's largest update, the float32 rounding of the
    step: a parameter whose update is noise is held to that. (In the
    heterogeneous stack GraphNorm centres the states that the next global
    exchange averages, so that layer's input weights get a gradient of about
    1e-7, where the two packages' own single-device steps differ by 70 %.)"""
    updates = list(port_update(tmodule_like, state, params_after, jparams_after))
    floor = 1e-6 * max(np.abs(j).max() for _, _, j in updates)
    for name, update, jupdate in updates:
        np.testing.assert_allclose(update, jupdate, rtol=0, atol=max(1e-4 * np.abs(jupdate).max(), floor),
                                   err_msg=name)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    refs, cases = {}, []
    # Graph2Class, mlp and ggnn: the port on 4 and 2 shards against its own
    # single-device step at the JAX test's size
    for arch in ("mlp", "ggnn"):
        tmodel, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8),
                                                  architecture=arch, device="cpu", **G2C)
        state = {k: v.clone() for k, v in tmodule.state_dict().items()}
        loss, _ = module_loss(tmodule, tree_to(tmbs[0], torch.device("cpu")), train=True,
                              generator=torch.Generator())
        loss.backward()
        refs[f"{arch}-single"] = (float(loss), {n: (p - LR * p.grad).detach() for n, p in tmodule.named_parameters()},
                                  state)
        budgets = {k: tns.suggest_budgets(tmbs, k) for k in (S, 2)}
        cases.append(("node_step", {"model": tmodel, "state": state, "minibatch": tmbs[0], "budgets": budgets,
                                    "lr": LR}))
    # and against JAX's NodeParallel step on a 4-device mesh
    for arch in ("mlp", "ggnn"):
        _, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256, max_graphs=8),
                                             architecture=arch, **G2C_PARITY)
        tmodel, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8),
                                                  architecture=arch, device="cpu", **G2C_PARITY)
        state = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, params))
        mesh = Mesh(np.asarray(jax.devices()[:S]), ("node",))
        npar = jns.NodeParallel(jmodule, optax.sgd(LR), mesh, axis="node", **jns.suggest_budgets([jmbs[0]], S))
        smb = npar.shard_batch(jmbs[0])
        p2 = jax.tree_util.tree_map(jnp.copy, params)
        jparams, _, jloss, _ = npar.build_train_step(smb)(p2, optax.sgd(LR).init(p2), smb, jax.random.PRNGKey(3))
        jmodule.gnn.node_partition_axis = None
        refs[arch] = (tmodule, state, float(jloss), jparams)
        budgets = {k: tns.suggest_budgets(tmbs, k) for k in (S, 2)}
        cases.append(("node_step", {"model": tmodel, "state": state, "minibatch": tmbs[0], "budgets": budgets,
                                    "lr": LR}))

    # the heterogeneous stack against JAX's single-device step
    from ptgnn_tpu.utils.synthetic import synthetic_typilus_graphs as jax_graphs
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    jmodel = hetero_model("ptgnn_tpu")
    jmodel.compute_metadata(jax_graphs(16, seed=2, mean_nodes=60, max_nodes=120), parallelize=False)
    jmod = jmodel.build_neural_module()
    jparams0 = jmod.init(jax.random.PRNGKey(0))
    jmb = first_minibatch(jmodel, jax_graphs(16, seed=2, mean_nodes=60, max_nodes=120))
    tmodel = hetero_model("ptgnn_tpu_torch")
    tmodel.compute_metadata(synthetic_typilus_graphs(16, seed=2, mean_nodes=60, max_nodes=120), parallelize=False)
    tmod = tmodel.build_neural_module(device="cpu")
    tmod.load_state_dict(jax_params_to_state_dict(tmod, jax.tree_util.tree_map(np.asarray, jparams0)))
    state = {k: v.clone() for k, v in tmod.state_dict().items()}
    tmb = first_minibatch(tmodel, synthetic_typilus_graphs(16, seed=2, mean_nodes=60, max_nodes=120))
    jloss, jparams = jax_sgd_step(lambda p, mb: jmod.apply(p, **mb, train=True, rng=jax.random.PRNGKey(3))[0],
                                  jparams0, jmb)
    refs["hetero"] = (tmod, state, jloss, jparams)
    cases.append(("node_loss", {"module": tmod, "minibatch": tmb, "budgets": tns.suggest_budgets([tmb], S),
                                "lr": LR}))

    # edge features: the gated stack over an embedded edge-feature table
    jgnn_model, jfmb = edge_feature_models("ptgnn_tpu")
    tgnn_model, tfmb = edge_feature_models("ptgnn_tpu_torch")
    jgnn = jgnn_model.build_neural_module()
    jfp0 = jgnn.init(jax.random.PRNGKey(0))

    def jax_sq_loss(p, mb):
        out, _ = jgnn.apply(p, mb["batch"], train=True, rng=jax.random.PRNGKey(3))
        h, mask = out.node_table("output"), out.node_mask
        return jnp.sum(jnp.where(mask[:, None], h, 0.0) ** 2) / jnp.maximum(jnp.sum(mask), 1)

    jfloss, jfparams = jax_sgd_step(jax_sq_loss, jfp0, jfmb)
    thead = SumOfSquaresHead(tgnn_model.build_neural_module())
    thead.load_state_dict(jax_params_to_state_dict(thead, {"gnn": jax.tree_util.tree_map(np.asarray, jfp0)}))
    refs["edge_features"] = (thead, {k: v.clone() for k, v in thead.state_dict().items()}, jfloss,
                             {"gnn": jfparams})
    cases.append(("node_loss", {"module": thead, "minibatch": tfmb, "budgets": tns.suggest_budgets([tfmb], S),
                                "lr": LR}))

    # GraphNorm: the layer over each rank's rows
    from ptgnn_tpu.graph.messagepassing import GraphContext as JaxGraphContext
    from ptgnn_tpu.graph.messagepassing.graphnorm import GraphNorm as JaxGraphNorm
    from ptgnn_tpu_torch.graph.messagepassing.graphnorm import GraphNorm

    batch = build_batch(PORT)
    rng = np.random.RandomState(1)
    x = rng.randn(128, 8).astype(np.float32)
    cot = rng.randn(128, 8).astype(np.float32)
    jgn = JaxGraphNorm(8)
    jgp = jax.tree_util.tree_map(lambda a: a * 1.5 + 0.25, jgn.init(jax.random.PRNGKey(0)))
    jctx = JaxGraphContext(adjacency=None, edge_features=None, node_graph=jnp.asarray(batch.node_graph),
                           node_mask=jnp.asarray(batch.node_mask), graph_mask=jnp.asarray(batch.graph_mask),
                           references={})
    gout, gvjp = jax.vjp(lambda p, h: jgn.apply(p, h, jctx), jgp, jnp.asarray(x))
    refs["graphnorm"] = (np.asarray(gout),) + tuple(gvjp(jnp.asarray(cot)))
    layer = GraphNorm(8)
    layer.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in jgp.items()})
    cases.append(("node_graphnorm", {"layer": layer, "x": x, "cot": cot, "node_graph": batch.node_graph,
                                     "node_mask": batch.node_mask, "graph_mask": batch.graph_mask}))

    # PPI under the BFS reorder, against the port's unsharded step
    from ptgnn_tpu_torch.implementations.ppi.harness import build_ppi, synthetic_ppi_samples

    pad = BatchPadding(max_nodes=512, max_edge_slots=128 * 96, max_graphs=4, edge_tile=128, agg_rows=128)
    pmodel, pmodule, pmbs = build_ppi(padding=pad, samples=synthetic_ppi_samples(
        2, 3, mean_nodes=200, edges_per_node=6, num_features=12, num_labels=5), hidden_state_size=32,
        minibatch_size=2, device="cpu")
    for m in pmodule.modules():  # PPI's stack drops out 0.2: off, as in every step compared here
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    pstate = {k: v.clone() for k, v in pmodule.state_dict().items()}
    loss, _ = module_loss(pmodule, tree_to(pmbs[0], torch.device("cpu")), train=True, generator=torch.Generator())
    loss.backward()
    refs["ppi"] = (float(loss), {n: (p - LR * p.grad).detach() for n, p in pmodule.named_parameters()}, pstate)
    pmodule.zero_grad(set_to_none=True)
    pmodule.load_state_dict(pstate)
    cases.append(("node_loss", {"module": pmodule, "minibatch": pmbs[0], "reorder": "bfs",
                                "node_aligned": pmodel.node_aligned_minibatch_keys,
                                "budgets": tns.suggest_budgets(pmbs[:1], S, reorder="bfs"), "lr": LR}))

    # one graph larger than a shard's rows
    lmodel, lmodule, lmbs = build_graph2class(padding=small_padding(max_nodes=512, max_graphs=4), device="cpu",
                                              **{**G2C, "num_metadata_graphs": 6, "mean_nodes": 400,
                                                 "max_graph_nodes": 460, "num_minibatches": 2,
                                                 "minibatch_size": 1})
    assert all(int(mb["batch"].num_graphs) == 1 and int(mb["batch"].num_nodes) > 512 // S for mb in lmbs)
    cases.append(("node_large_graph", {"model": lmodel, "state": lmodule.state_dict(), "minibatches": lmbs,
                                       "budgets": tns.suggest_budgets(lmbs, S)}))

    # the interior pass reads nothing of the exchange
    imodel, imodule, imbs = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8), device="cpu",
                                              **G2C)
    cases.append(("node_interior_independent", {"model": imodel, "state": imodule.state_dict(),
                                                "minibatch": imbs[0], "budgets": tns.suggest_budgets(imbs[:1], S)}))
    cases.append(("node_edge_dropout", {"model": imodel, "state": imodule.state_dict(), "minibatch": imbs[0],
                                        "budgets": tns.suggest_budgets(imbs[:1], S), "lr": LR}))
    ranks = launch(cases, tmp_path_factory.mktemp("node_world"), world=S)
    return refs, ranks


CASE = {"mlp-single": 0, "ggnn-single": 1, "mlp": 2, "ggnn": 3, "hetero": 4, "edge_features": 5, "graphnorm": 6,
        "ppi": 7, "large": 8, "interior": 9, "edge_dropout": 10}


def assert_matches_port_step(got, loss, want, state):
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    for name, w in want.items():
        update, wupdate = (got["params"][name] - state[name]).numpy(), (w - state[name]).numpy()
        np.testing.assert_allclose(update, wupdate, rtol=0, atol=1e-4 * max(np.abs(wupdate).max(), 1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("shards", [4, 2])
@pytest.mark.parametrize("architecture", ["mlp", "ggnn"])
def test_node_parallel_train_step_matches_single_device(world, architecture, shards):
    """At the JAX test's size: the port's node-sharded step against its own
    single-device step."""
    refs, ranks = world
    loss, want, state = refs[f"{architecture}-single"]
    for rank in ranks:
        got = rank[CASE[f"{architecture}-single"]][shards]
        assert got["stats"]["boundary_nodes_total"] > 0, "the step must exercise the exchange"
        assert_matches_port_step(got, loss, want, state)


@pytest.mark.parametrize("shards", [4, 2])
@pytest.mark.parametrize("architecture", ["mlp", "ggnn"])
def test_node_parallel_train_step_matches_jax(world, architecture, shards):
    refs, ranks = world
    tmodule, state, jloss, jparams = refs[architecture]
    for rank in ranks:
        got = rank[CASE[architecture]][shards]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        assert got["stats"]["boundary_nodes_total"] > 0, "the step must exercise the exchange"
        assert_updates_match(tmodule, state, got["params"], jparams)
    for name, p in ranks[0][CASE[architecture]][shards]["params"].items():
        assert all(torch.equal(p, r[CASE[architecture]][shards]["params"][name]) for r in ranks[1:]), name


@pytest.mark.parametrize("case", ["hetero", "edge_features"])
def test_node_parallel_stack_matches_single_device_jax(world, case):
    """The heterogeneous stack (exchange-free layers, the gather-based
    self-attention, the sharded summaries) and the edge-feature table
    route, against JAX's single-device step."""
    refs, ranks = world
    tmodule, state, jloss, jparams = refs[case]
    for rank in ranks:
        got = rank[CASE[case]]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
        assert got["stats"]["boundary_nodes_total"] > 0
        assert_updates_match(tmodule, state, got["params"], jparams)


def test_graphnorm_matches_under_node_sharding(world):
    """GraphNorm's per-graph moments are global (summed over the node
    group), and so are their gradients."""
    refs, ranks = world
    out, gparams, gx = refs["graphnorm"]
    np.testing.assert_allclose(np.concatenate([r[CASE["graphnorm"]]["out"].numpy() for r in ranks]), out,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r[CASE["graphnorm"]]["grad"].numpy() for r in ranks]),
                               np.asarray(gx), rtol=1e-5, atol=1e-5)
    for name, g in gparams.items():  # the parameter gradients summed over the ranks
        total = sum(r[CASE["graphnorm"]]["params"][name].numpy() for r in ranks)
        np.testing.assert_allclose(total, np.asarray(g), rtol=1e-5, atol=1e-5)


def test_ppi_targets_follow_the_reorder(world):
    """PPI node-sharded under the BFS reorder against the port's unsharded
    step (the JAX package leaves PPI's targets in the old order,
    ``ptgnn_tpu/implementations/ppi/ppi.py:67``)."""
    refs, ranks = world
    loss, want, state = refs["ppi"]
    for rank in ranks:
        assert_matches_port_step(rank[CASE["ppi"]], loss, want, state)


def test_single_graph_larger_than_one_shard_trains(world):
    _, ranks = world
    for rank in ranks:
        got = rank[CASE["large"]]
        assert got["stats"]["boundary_nodes_total"] > 0
        assert all(rows[0] == 512 // S for rows in got["rows"].values())
        assert got["losses"][-1] < got["losses"][0] * 0.9, got["losses"]


def test_interior_compute_independent_of_exchange(world):
    _, ranks = world
    for rank in ranks:
        got = rank[CASE["interior"]]
        assert not np.isfinite(got["control"]), "the poisoned exchange must reach the loss through live slots"
        assert np.isfinite(got["poisoned"])
        np.testing.assert_allclose(got["poisoned"], got["clean"], rtol=1e-6)


def test_edge_dropout_under_node_sharding_keeps_one_step(world):
    """Edge dropout 0.3 on 4 shards: each shard keeps about 70 % of its
    slots, the shards' masks are not one pattern, and every rank ends the
    step with the same parameters (the replicated work drew alike)."""
    _, ranks = world
    got = [r[CASE["edge_dropout"]] for r in ranks]
    assert all(np.isfinite(g["loss"]) for g in got) and len({g["loss"] for g in got}) == 1
    assert all(0.55 < g["kept"] < 0.85 for g in got), [g["kept"] for g in got]
    assert not all(torch.equal(got[0]["mask"], g["mask"]) for g in got[1:])
    for name, p in got[0]["params"].items():
        assert all(torch.equal(p, g["params"][name]) for g in got[1:]), name
