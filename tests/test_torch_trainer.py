"""The Graph2Class training step and the trainer of the port against the JAX
package, at hidden 16 with dropout 0 (JAX's RNG cannot be reproduced), with
the JAX parameters loaded through ``convert.py``.

Tolerances. Float32: the loss to rtol 1e-5; every parameter gradient, and
every parameter after one clip(1.0) + Adam(2.5e-4) step, to rtol 1e-4 and
an absolute 1e-4 of that tensor's largest magnitude. The eight layers
differ by a few float32 ulps per operation between the packages (see
test_torch_graph2class.py), which the backward carries into the gradients;
the routing of the max gradients is exact. bf16 AMP is held loosely, for the reason
stated in its test.

The batch is seed 1's. Max aggregation routes each (node, column)'s gradient
to the slots that attain the maximum, so the float32 comparison holds only
where the two frameworks agree on which slots tie. They need not on every
batch: where JAX's float32 messages split an exact tie between identical
inputs into two values, which the port (as JAX in float64) keeps whole, a
gradient moves wholesale. On this batch they route every gradient alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from ptgnn_tpu_torch.core import schedulers
from ptgnn_tpu_torch.core.data import MemorizedDataIterable
from ptgnn_tpu_torch.core.metrics import MetricsAccumulator
from ptgnn_tpu_torch.core.trainer import ModelTrainer, clip_by_global_norm_, module_loss, optimizer_step
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.implementations.typilus.graph2class import Graph2Class
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding, train_steps
from ptgnn_tpu_torch.nn import initializers as init
from ptgnn_tpu_torch.nn.layers import Embedding, _EmbeddingLookup, dropout
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs
from tests.torch_port_helpers import force_jax_fused_interpret

HIDDEN = 16
KW = dict(hidden_state_size=HIDDEN, num_minibatches=1, minibatch_size=8, dropout_rate=0.0, seed=1)


@pytest.fixture(params=["jax_default", "jax_fused_interpret"])
def both(request, monkeypatch):
    if request.param == "jax_fused_interpret":
        force_jax_fused_interpret(monkeypatch)
    jmodel, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256), **KW)
    _, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", **KW)
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))
    return jmodule, params, jmbs[0], tmodule, tmbs[0]


def _jax_loss_fn(jmodule, mb, amp=False):
    batch = jax.tree_util.tree_map(jnp.asarray, mb["batch"])
    targets = jnp.asarray(mb["target_classes"])

    def loss_fn(params):
        if amp:
            params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
        loss, _ = jmodule.apply(params, batch, targets, train=True, rng=jax.random.PRNGKey(0))
        return loss.astype(jnp.float32)

    return loss_fn


def _port_loss(tmodule, mb, amp=False):
    tmodule.zero_grad(set_to_none=True)
    loss, _ = module_loss(tmodule, tree_to(mb, torch.device("cpu")), train=True,
                          generator=torch.Generator(), amp=amp)
    loss.backward()
    return loss


def _assert_close_per_tensor(got, expected, rtol=1e-4, scale=1e-4):
    for name, e in expected.items():
        e = e.numpy()
        np.testing.assert_allclose(
            got[name], e, rtol=rtol, atol=scale * max(np.abs(e).max(), 1e-30), err_msg=name
        )


def test_train_step_loss_and_every_gradient_match_jax(both):
    jmodule, params, jmb, tmodule, tmb = both
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jmodule, jmb))(params)
    expected = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jgrads))
    loss = _port_loss(tmodule, tmb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = {name: p.grad.numpy() for name, p in tmodule.named_parameters()}
    assert sorted(got) == sorted(expected)
    _assert_close_per_tensor(got, expected)
    assert all(np.abs(g).max() > 0 for name, g in got.items() if "embeddings" not in name)


def test_parameters_after_one_clip_adam_step_match_optax(both):
    """The step is held on the same (JAX's) gradients: Adam divides each
    gradient by its own magnitude, so an entry near zero, whose value is all
    float32 noise of the backward (allowed above), moves its parameter by up
    to a whole learning rate either way. On equal gradients the clip formula
    and the Adam rule must agree to rtol 1e-4, atol 1e-4 of each tensor's
    largest magnitude."""
    jmodule, params, jmb, tmodule, tmb = both
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(2.5e-4))
    jgrads = jax.grad(_jax_loss_fn(jmodule, jmb))(params)
    updates, _ = optimizer.update(jgrads, optimizer.init(params), params)
    jnew = optax.apply_updates(params, updates)
    expected = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jnew))
    grads = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in tmodule.named_parameters():
        p.grad = grads[name].clone()
    torch_opt = torch.optim.Adam(tmodule.parameters(), lr=2.5e-4)
    optimizer_step(tmodule, torch_opt, [2.5e-4], clip_gradient_norm=1.0)
    got = {name: p.detach().numpy() for name, p in tmodule.named_parameters()}
    _assert_close_per_tensor(got, expected)
    assert all(p.grad is None for p in tmodule.parameters())  # cleared for the next step


def _flat(grads):
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in sorted(grads)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_one_bf16_amp_step_matches_jax_loosely():
    _, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256), **KW)
    _, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", **KW)
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))

    def jax_grads(amp):
        loss, grads = jax.value_and_grad(_jax_loss_fn(jmodule, jmbs[0], amp=amp))(params)
        grads = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads))
        return float(loss), {k: v.numpy() for k, v in grads.items()}

    jloss16, j16 = jax_grads(True)
    _, j32 = jax_grads(False)
    loss = _port_loss(tmodule, tmbs[0], amp=True)
    t16 = {name: p.grad.numpy() for name, p in tmodule.named_parameters()}
    assert all(p.grad.dtype == torch.float32 for p in tmodule.parameters())  # float32 masters
    np.testing.assert_allclose(float(loss), jloss16, rtol=2e-2)
    # Max aggregation over bf16 messages meets many ties and near-ties, which
    # each framework breaks its own way, so an AMP step's gradient lies tens of
    # percent from the float32 one in both (JAX: 74 % of the norm here). The
    # port's must lie no farther than 1.5 times JAX's distance; the
    # classifier's, which sees no aggregation of its own, within 20 % of JAX's.
    assert _rel(_flat(t16), _flat(j32)) <= 1.5 * _rel(_flat(j16), _flat(j32))
    for name in ("node_to_class.weight", "node_to_class.bias"):
        assert _rel(t16[name], j16[name]) <= 0.2, name


@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_clip_is_optax_clip_by_global_norm(max_norm):
    rng = np.random.RandomState(0)
    grads = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    expected, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_gradient_is_the_per_id_sum(dtype):
    """The embedding's fixed-order backward against the exact (float64) sum
    of each id's rows: float32 sums in another order to rtol/atol 1e-5; bf16
    rows summed in float32 and rounded once to bf16, to rtol 2**-8."""
    table = Embedding(50, 8, weight_init=init.uniform())
    table.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(0, 40, (300, 5), generator=torch.Generator().manual_seed(1))  # ids >= 40 unused
    ids[:200, 3:] = 0  # id 0 takes more rows than one chunk
    cot = torch.randn(300, 5, 8, generator=torch.Generator().manual_seed(2)).to(dtype)
    exact = torch.zeros(50, 8, dtype=torch.float64).index_add_(0, ids.reshape(-1), cot.double().reshape(-1, 8))
    weight = table.weight.detach().to(dtype).requires_grad_()
    _EmbeddingLookup.apply(ids, weight).backward(cot)
    assert weight.grad.dtype == dtype
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0**-8, 1e-6)
    np.testing.assert_allclose(weight.grad.double().numpy(), exact.numpy(), rtol=rtol, atol=atol)
    assert not weight.grad[40:].any()


def test_dropout_keeps_its_rate_and_scale_and_needs_a_generator():
    x = torch.ones(200_000)
    out = dropout(x, 0.1, True, torch.Generator().manual_seed(3))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    assert torch.allclose(out[kept], torch.full((), 1 / 0.9))
    again = dropout(x, 0.1, True, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    assert dropout(x, 0.1, False) is x and dropout(x, 0.0, True) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, True)


def _graphs(n, seed):
    return list(synthetic_typilus_graphs(n, seed=seed, mean_nodes=60, max_nodes=200))


def _trainer(model, path, **kw):
    return ModelTrainer(model, path, max_num_epochs=2, minibatch_size=8, clip_gradient_norm=1.0,
                        device="cpu", seed=5, **kw)


def _eval_loss(model, module, graphs):
    with torch.no_grad():
        losses = [
            float(module_loss(module, tree_to(mb, torch.device("cpu")), train=False)[0])
            for mb, _ in model.minibatch_iterator(
                model.tensorize_dataset(iter(graphs), parallelize=False), 8, parallelize=False
            )
        ]
    return float(np.mean(losses))


def test_model_trainer_trains_saves_and_restores(tmp_path):
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model

    model = create_graph2class_gnn_model(hidden_state_size=HIDDEN, padding=small_padding(max_nodes=256))
    train, valid = _graphs(24, 1), _graphs(8, 2)
    trainer = _trainer(model, tmp_path / "model.pkl.gz")
    seen = {"train": [], "valid": [], "improved": []}
    trainer.register_train_epoch_end_hook(lambda m, mod, e, metrics: seen["train"].append(metrics))
    trainer.register_validation_epoch_end_hook(lambda m, mod, e, metrics: seen["valid"].append(metrics))
    trainer.register_epoch_improved_end_hook(lambda m, mod, e, metrics: seen["improved"].append(e))
    trainer.train(train, valid, parallelize=False)
    assert len(seen["train"]) == 2 and len(seen["valid"]) == 3  # validation on start
    assert 0.0 <= seen["train"][0]["Accuracy"] <= 1.0
    assert seen["train"][0]["_throughput"]["num_edges_per_sec"] > 0
    assert (tmp_path / "model.pkl.gz").exists() and (tmp_path / "model.pkl.optimizerstate").exists()

    loss = _eval_loss(model, trainer.neural_module, valid)
    restored_model, state = Graph2Class.restore_model(tmp_path / "model.pkl.gz")
    module = restored_model.build_neural_module(device="cpu", seed=99)
    module.load_state_dict(state)
    assert _eval_loss(restored_model, module, valid) == loss

    # Resume: the optimizer state and the next epoch come back too.
    resumed = _trainer(model, tmp_path / "model.pkl.gz")
    resumed.restore_parameters(restore_optimizer=True)
    assert _eval_loss(model, resumed.neural_module, valid) == loss
    assert resumed._start_epoch_override == 2


def test_training_is_reproducible_from_its_seed(tmp_path):
    """Dropout on (rate 0.1): the same seed gives the same run."""
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model

    states = []
    for run in range(2):
        model = create_graph2class_gnn_model(hidden_state_size=HIDDEN, padding=small_padding(max_nodes=256))
        trainer = _trainer(model, tmp_path / f"run{run}.pkl.gz", gradient_accumulation_steps=2)
        trainer.train(_graphs(16, 3), _graphs(8, 4), parallelize=False, patience=0)
        states.append(trainer.neural_module.state_dict())
    for name in states[0]:
        assert torch.equal(states[0][name], states[1][name]), name

    losses = []
    for _ in range(2):
        _, module, mbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu",
                                           hidden_state_size=HIDDEN, num_minibatches=2, minibatch_size=8)
        batches = [(mb["batch"].to("cpu"), torch.from_numpy(mb["target_classes"])) for mb in mbs]
        losses.append(train_steps(module, batches, steps=3, seed=11)["loss"])
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_gradient_accumulation_applies_the_mean_gradient():
    """Two microbatches accumulated equal one step on their mean gradient."""
    _, module, mbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu",
                                       hidden_state_size=HIDDEN, num_minibatches=2, minibatch_size=8,
                                       dropout_rate=0.0)
    _, reference, _ = build_graph2class(padding=small_padding(max_nodes=256), device="cpu",
                                        hidden_state_size=HIDDEN, num_minibatches=1, minibatch_size=8,
                                        dropout_rate=0.0)
    cpu_mbs = [tree_to(mb, torch.device("cpu")) for mb in mbs]
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    for mb in cpu_mbs:
        module_loss(module, mb, train=True)[0].backward()
    optimizer_step(module, opt, [1e-3], clip_gradient_norm=1.0, grad_divisor=2)
    ref_opt = torch.optim.Adam(reference.parameters(), lr=1e-3)
    total = sum(module_loss(reference, mb, train=True)[0] for mb in cpu_mbs) / 2
    total.backward()
    optimizer_step(reference, ref_opt, [1e-3], clip_gradient_norm=1.0)
    for (name, a), b in zip(module.named_parameters(), reference.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def test_nan_loss_aborts_training(tmp_path):
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model

    model = create_graph2class_gnn_model(hidden_state_size=HIDDEN, padding=small_padding(max_nodes=256))
    trainer = _trainer(model, tmp_path / "nan.pkl.gz")

    def poison(_model):
        with torch.no_grad():
            trainer.neural_module.node_to_class.bias.fill_(float("nan"))

    trainer.register_model_metadata_finalized_hook(poison)
    with pytest.raises(RuntimeError, match="NaN"):
        trainer.train(_graphs(16, 1), _graphs(8, 2), parallelize=False, validate_on_start=False)


@pytest.mark.parametrize("name,args,kwargs", [
    ("ConstantScheduler", (0.5,), {}),
    ("LinearWarmupScheduler", (4, 3), {}),
    ("WarmupCosineScheduler", (2, 10, 3), {"final_factor": 0.1}),
    ("StepDecayScheduler", (0.5, 2), {}),
])
def test_schedulers_match_jax(name, args, kwargs):
    from ptgnn_tpu.core import schedulers as jax_schedulers

    ours = getattr(schedulers, name)(*args, **kwargs)
    theirs = getattr(jax_schedulers, name)(*args, **kwargs)
    for epoch in range(4):
        for step in range(3):
            assert ours.step(epoch, step) == theirs.step(epoch, step)


def test_metrics_accumulator_and_memorized_data():
    acc = MetricsAccumulator()
    acc.update({"num_samples": torch.tensor(3), "sum_accuracy": 2})
    acc.update({"num_samples": torch.tensor(4), "sum_accuracy": torch.tensor(1.5)})
    assert acc.totals() == {"num_samples": 7.0, "sum_accuracy": 3.5} and len(acc) == 2
    calls = []

    def source():
        calls.append(1)
        return iter(range(5))

    data = MemorizedDataIterable(source, shuffle=True)
    assert list(data) == list(range(5))
    assert sorted(data) == list(range(5)) and len(calls) == 1
