"""The GGNN architecture of the port against the JAX package's: the GRU
cell, the gated message-passing layer in both routing modes, and one
Graph2Class training step of the 'ggnn' stack (tie-split) and of the 'mlp'
stack with argmax routing, with the JAX parameters loaded through
``convert.py``; the shared GGNN layer through save and restore; the new
initializers.

Tolerances. The GRU cell and one gated layer at f32: rtol/atol 1e-5 (the
matmuls add in another order). A whole training step: the loss to rtol
1e-5, every gradient to rtol 1e-4 and 1e-4 of its tensor's largest
magnitude, as tests/test_torch_trainer.py holds the 'mlp' step and for the
reason it gives. Dropout is 0: torch cannot reproduce JAX's random bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.messagepassing import GraphContext as JaxGraphContext
from ptgnn_tpu.graph.messagepassing.gated import GatedMessagePassingLayer as JaxGatedLayer
from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu.nn.layers import GRUCell as JaxGRUCell
from ptgnn_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from ptgnn_tpu_torch.core.trainer import module_loss
from ptgnn_tpu_torch.graph.messagepassing import GatedMessagePassingLayer, GraphContext
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import GRUCell
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from tests.test_torch_fused_mp import PAD, build_batches
from tests.torch_port_helpers import force_jax_fused_interpret, to_dtype_pair

HIDDEN = 16
KW = dict(hidden_state_size=HIDDEN, num_minibatches=1, minibatch_size=8, dropout_rate=0.0, seed=1)


def _torch_params(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_gru_cell_matches_jax():
    jcell = JaxGRUCell(12, 20)
    params = jcell.init(jax.random.PRNGKey(3))
    cell = GRUCell(12, 20)
    cell.load_state_dict(_torch_params(params))
    rng = np.random.RandomState(0)
    x, h = rng.randn(30, 12).astype(np.float32), rng.randn(30, 20).astype(np.float32)
    cot = rng.randn(30, 20).astype(np.float32)

    def f(p, x, h):
        return jnp.sum(jcell.apply(p, x, h) * cot)

    expected = jcell.apply(params, jnp.asarray(x), jnp.asarray(h))
    jgrads = jax.grad(f, argnums=(0, 1, 2))(params, jnp.asarray(x), jnp.asarray(h))
    tx, th = torch.from_numpy(x).requires_grad_(), torch.from_numpy(h).requires_grad_()
    out = cell(tx, th)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[2]), rtol=1e-5, atol=1e-5)
    for name, p in cell.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[0][name]), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_gru_cell_keeps_bf16_as_jax():
    """Under AMP every tensor is bf16: each gate product rounds to bf16 before
    its bias, as in JAX; the output stays bf16 (within 2 bf16 ulps of JAX's:
    the transcendentals may round differently)."""
    jcell = JaxGRUCell(8, 16)
    params = jcell.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    jx, tx = to_dtype_pair(rng.randn(40, 8), "bfloat16")
    jh, th = to_dtype_pair(rng.randn(40, 16), "bfloat16")
    jparams = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    cell = GRUCell(8, 16)
    cell.load_state_dict(_torch_params(params))
    with torch.no_grad():
        got = torch.func.functional_call(
            cell, {k: v.to(torch.bfloat16) for k, v in cell.named_parameters()}, (tx, th))
    expected = np.asarray(jcell.apply(jparams, jx, jh)).astype(np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), expected, rtol=2 ** -7, atol=2 ** -7)


def _contexts(jbatch, tbatch):
    jctx = JaxGraphContext(adjacency=jbatch.adjacency, edge_features=None, node_graph=jbatch.node_graph,
                           node_mask=jbatch.node_mask, graph_mask=jbatch.graph_mask, references={})
    tctx = GraphContext(adjacency=tbatch.adjacency, node_graph=tbatch.node_graph,
                        node_mask=tbatch.node_mask, graph_mask=tbatch.graph_mask, references={})
    return jctx, tctx


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("argmax_routing", [False, True])
def test_gated_layer_forward_and_gradients_match_jax(argmax_routing, ties, monkeypatch):
    force_jax_fused_interpret(monkeypatch)
    if argmax_routing:
        monkeypatch.setenv("PTGNN_TPU_ARGMAX_ROUTING", "1")
    num_types, jbatch, tbatch = build_batches(seed=7)
    d, m = 16, 12
    jlayer = JaxGatedLayer(state_dimension=d, message_dimension=m, num_edge_types=num_types,
                           message_aggregation_function="max")
    params = jlayer.init(jax.random.PRNGKey(2))
    if ties:  # coarse weights and states: many messages tie
        params["message_weights"] = jnp.round(params["message_weights"] * 8) / 8
    tlayer = GatedMessagePassingLayer(d, m, num_types, "max", argmax_routing=argmax_routing)
    tlayer.load_state_dict({"message_weights": torch.from_numpy(np.array(params["message_weights"])),
                            **{f"state_update.{k}": v for k, v in _torch_params(params["state_update"]).items()}})
    rng = np.random.RandomState(4)
    states = rng.randn(PAD["max_nodes"], d).astype(np.float32)
    if ties:
        states = np.round(states).astype(np.float32)
    cot = rng.randn(PAD["max_nodes"], d).astype(np.float32)
    jctx, tctx = _contexts(jbatch, tbatch)

    def f(p, x):
        return jnp.sum(jlayer.apply(p, x, jctx) * cot)

    expected = jlayer.apply(params, jnp.asarray(states), jctx)
    jgrad_p, jgrad_x = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(states))
    x = torch.from_numpy(states).requires_grad_()
    tsk.reset_launch_counts()
    out = tlayer(x, tctx)
    (out * torch.from_numpy(cot)).sum().backward()
    assert all(v == 0 for v in tsk.launch_counts().values())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlayer.message_weights.grad.numpy(), np.asarray(jgrad_p["message_weights"]),
                               rtol=1e-5, atol=1e-5)
    for name, p in tlayer.state_update.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad_p["state_update"][name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _assert_close_per_tensor(got, expected, rtol=1e-4, scale=1e-4):
    for name, g in got.items():
        e = expected[name].numpy()
        np.testing.assert_allclose(g, e, rtol=rtol, atol=scale * max(np.abs(e).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("architecture,argmax_routing", [("ggnn", False), ("mlp", True)])
def test_train_step_matches_jax(architecture, argmax_routing, monkeypatch):
    force_jax_fused_interpret(monkeypatch)
    if argmax_routing:
        monkeypatch.setenv("PTGNN_TPU_ARGMAX_ROUTING", "1")
    _, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256), architecture=architecture, **KW)
    _, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu",
                                         architecture=architecture, argmax_routing=argmax_routing, **KW)
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))
    batch = jax.tree_util.tree_map(jnp.asarray, jmbs[0]["batch"])
    targets = jnp.asarray(jmbs[0]["target_classes"])

    def loss_fn(p):
        return jmodule.apply(p, batch, targets, train=True, rng=jax.random.PRNGKey(0))[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    expected = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jgrads))
    loss, _ = module_loss(tmodule, tree_to(tmbs[0], torch.device("cpu")), train=True, generator=torch.Generator())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = {name: p.grad.numpy() for name, p in tmodule.named_parameters()}
    _assert_close_per_tensor(got, expected)
    assert all(np.abs(g).max() > 0 for name, g in got.items() if "embeddings" not in name)
    layers = tmodule.gnn.message_passing_layers
    if architecture == "ggnn":  # one shared layer object at 7 positions
        assert all(layers[i] is layers[1] for i in range(1, 8)) and len(layers) == 10
        assert layers[9].state_dimension == 2 * HIDDEN and tmodule.node_to_class.in_features == 2 * HIDDEN
    assert all(getattr(l, "argmax_routing", argmax_routing) == argmax_routing for l in layers)


def test_shared_ggnn_weights_survive_save_and_restore(tmp_path):
    model, module, _ = build_graph2class(padding=small_padding(max_nodes=256), hidden_state_size=8,
                                         architecture="ggnn", device="cpu")
    path = tmp_path / "ggnn.pkl.gz"
    model.save(path, module)
    restored, state = Graph2Class.restore_model(path)
    again = restored.build_neural_module(device="cpu", seed=5)
    again.load_state_dict(state)
    layers = again.gnn.message_passing_layers
    assert all(layers[i] is layers[1] for i in range(1, 8))
    assert len(list(again.parameters())) == len(list(module.parameters()))
    for (name, a), b in zip(module.named_parameters(), again.parameters()):
        assert torch.equal(a, b), name
    assert again.gnn._layer_param_index == [0, 1, 1, 1, 1, 1, 1, 1, 2, 3]


def test_convert_raises_on_unknown_or_missing_gated_keys(monkeypatch):
    _, _, params, _ = jax_build(padding=jax_small_padding(max_nodes=256), architecture="ggnn", **KW)
    _, tmodule, _ = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", architecture="ggnn", **KW)
    params = jax.tree_util.tree_map(np.asarray, params)
    shared = params["gnn"]["mp_layers"][1]
    assert set(shared) == {"message_weights", "state_update"}
    extra = dict(params, gnn=dict(params["gnn"], mp_layers=list(params["gnn"]["mp_layers"])))
    extra["gnn"]["mp_layers"][1] = dict(shared, bogus=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="bogus"):
        load_jax_params(tmodule, extra)
    missing = dict(params, gnn=dict(params["gnn"], mp_layers=list(params["gnn"]["mp_layers"])))
    missing["gnn"]["mp_layers"][1] = {"message_weights": shared["message_weights"]}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(tmodule, missing)


def test_initializers_follow_torch_semantics():
    g = torch.Generator().manual_seed(0)
    w = torch.empty(96, 48)
    init.orthogonal(gain=2.0)(w, g)
    np.testing.assert_allclose((w.T @ w).numpy(), 4.0 * np.eye(48), atol=1e-4)
    wide = torch.empty(16, 64)
    init.orthogonal()(wide, g)
    np.testing.assert_allclose((wide @ wide.T).numpy(), np.eye(16), atol=1e-5)
    big = torch.empty(400, 600)
    init.xavier_normal(gain=0.5)(big, g)
    assert abs(float(big.std()) - 0.5 * (2.0 / 1000) ** 0.5) < 2e-3 * 0.5 and abs(float(big.mean())) < 1e-3
    b = torch.empty(100000)
    init.normal(mean=1.0, std=1e-5)(b, g)
    assert abs(float(b.mean()) - 1.0) < 1e-6 and abs(float(b.std()) - 1e-5) < 1e-7
    first = torch.empty(8, 8)
    init.orthogonal()(first, torch.Generator().manual_seed(3))
    second = torch.empty(8, 8)
    init.orthogonal()(second, torch.Generator().manual_seed(3))
    assert torch.equal(first, second)


def test_amp_step_keeps_the_shared_layer_float32_and_trains_it():
    """Under AMP the shared gated layer runs with bf16 copies and keeps its
    float32 leaf parameters after the step, with gradients from all seven
    positions (as the float32 step's, to bf16 precision)."""
    _, module, mbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", architecture="ggnn", **KW)
    mb = tree_to(mbs[0], torch.device("cpu"))
    grads = {}
    for amp in (False, True):
        module.zero_grad(set_to_none=True)
        loss, _ = module_loss(module, mb, train=True, generator=torch.Generator(), amp=amp)
        loss.backward()
        assert all(p.is_leaf and p.dtype == torch.float32 for p in module.parameters())
        grads[amp] = {name: p.grad.clone() for name, p in module.named_parameters()}
    shared = "gnn.message_passing_layers.1.message_weights"
    for name, g in grads[True].items():
        assert g.dtype == torch.float32
        assert float((g - grads[False][name]).norm()) <= 5e-2 * float(grads[False][name].norm()), name
    assert float(grads[True][shared].abs().max()) > 0
