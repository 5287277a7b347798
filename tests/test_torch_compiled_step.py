"""The compiled steps (``ptgnn_tpu_torch/core/compiled_step.py``) and the
train step written once for them (``core/trainer.py::TrainStep``), on the
CPU, against the JAX package.

* The signature cache's key: the same shapes give the same key; a new
  padding, dtype or train/eval flag gives another, as ``jax.jit``'s cache.
* ``ModelTrainer``'s step (static gradient buffers, the learning rate set
  from a schedule's factor before each step, accumulation over 2) against
  the JAX trainer's steps (``_build_step_functions``): the same converted
  parameters, the same minibatches, dropout 0, three optimizer steps. The
  JAX steps run under ``jax.disable_jit()``: XLA's fused float32 arithmetic
  splits near-ties of the max aggregation otherwise than its op-by-op
  arithmetic, which the port's step matches (``test_torch_trainer.py``),
  and moves the early layers' updates by up to 1 %. Tolerances are ``test_torch_trainer.py``'s: the loss to rtol 1e-5;
  every parameter to rtol 1e-4 and 1e-4 of that tensor's largest magnitude.
  Adam's eps is 1 on both sides. The packages' gradients agree to 1e-4 of
  each tensor's largest entry (``test_torch_trainer.py``), and Adam divides
  each entry by its own magnitude plus eps: at a small eps an entry small
  beside its tensor's largest turns that agreement into a difference of up
  to a learning rate (``test_torch_trainer.py`` holds one step on JAX's
  gradients for that reason). At eps 1 the update is near-linear in the
  gradient, so the agreement carries over to the parameters, while the
  moments, the bias corrections, the schedule's factors, the clip and the
  accumulated mean are all in play.
  On the CPU torch refuses a ``capturable`` Adam and no graph exists, so the
  rate there is a Python float; the device-scalar rate and the capturable
  state run on the card (``test_torch_compiled_step_cuda.py``).
* Metrics aliasing: a compiled step returns the same buffers on every
  replay, so two steps that return one buffer accumulate to the sum of both.
* The optimizer state of a compiled step round-trips through both
  checkpointers bitwise; an optimizer that cannot be captured raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ptgnn_tpu.core.trainer import ModelTrainer as JaxModelTrainer
from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from ptgnn_tpu_torch.core import checkpoint as ckpt
from ptgnn_tpu_torch.core.compiled_step import CompiledStep, signature
from ptgnn_tpu_torch.core.dcp_checkpoint import DistributedCheckpointer
from ptgnn_tpu_torch.core.metrics import MetricsAccumulator
from ptgnn_tpu_torch.core.schedulers import LinearWarmupScheduler
from ptgnn_tpu_torch.core.trainer import ModelTrainer, TrainStep, make_capturable
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding

CPU = torch.device("cpu")
HIDDEN = 16
LR, EPS = 1e-3, 1.0


def _minibatch(max_nodes=256, num_minibatches=1, **kw):
    _, module, mbs = build_graph2class(padding=small_padding(max_nodes=max_nodes), device="cpu",
                                       hidden_state_size=HIDDEN, num_minibatches=num_minibatches,
                                       minibatch_size=8, **kw)
    return module, [tree_to(mb, CPU) for mb in mbs]


# ---------------------------------------------------------------------------
# the signature cache
# ---------------------------------------------------------------------------
def test_the_signature_keys_shapes_dtypes_and_static_flags():
    _, (mb, other) = _minibatch(num_minibatches=2)
    key, leaves = signature((mb,), {"train": True})
    assert len(leaves) == len([t for t in leaves if isinstance(t, torch.Tensor)]) > 10
    assert signature((other,), {"train": True})[0] == key  # same padding, other data
    assert signature((mb,), {"train": False})[0] != key
    _, (wide,) = _minibatch(max_nodes=512)
    assert signature((wide,), {"train": True})[0] != key
    bf16 = dict(mb, batch=mb["batch"]._replace(node_mask=mb["batch"].node_mask.to(torch.bfloat16)))
    assert signature((bf16,), {"train": True})[0] != key
    with torch.no_grad():
        assert signature((mb,), {"train": True})[0] != key


def test_a_compiled_step_on_the_cpu_is_a_plain_call():
    calls = []
    step = CompiledStep(lambda x, scale: calls.append(scale) or x * scale, CPU)
    x = torch.arange(3.0)
    assert torch.equal(step(x, 2.0), x * 2.0) and torch.equal(step(x, scale=3.0), x * 3.0)
    assert calls == [2.0, 3.0] and len(step) == 0 and step.stats() == []


# ---------------------------------------------------------------------------
# the trainer's step against the JAX trainer's
# ---------------------------------------------------------------------------
def _jax_steps(jmodel, jmodule, params, jmbs, factors, k, path):
    trainer = JaxModelTrainer(jmodel, path, clip_gradient_norm=1.0, gradient_accumulation_steps=k)
    trainer.neural_module, trainer.params = jmodule, params
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR, eps=EPS))
    trainer._build_step_functions(optimizer)
    opt_state = trainer._init_opt_state(optimizer)
    losses = []
    with jax.disable_jit():
        for mb, factor in zip(jmbs, factors):
            params, opt_state, loss, _ = trainer._train_step_fn(
                params, opt_state, jax.tree_util.tree_map(jnp.asarray, mb), jax.random.PRNGKey(0), factor)
            losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("k", [1, 2])
def test_the_trainer_step_matches_the_jax_trainer(tmp_path, k):
    """Three optimizer steps (3 k microbatches) at a warm-up schedule's
    factors, counted as each trainer counts them, on ``test_torch_trainer.py``'s
    batch (seed 1), where the two packages route every max gradient alike."""
    kw = dict(hidden_state_size=HIDDEN, num_minibatches=1, minibatch_size=8, dropout_rate=0.0, seed=1)
    jmodel, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256), **kw)
    tmodel, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", **kw)
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))
    jmbs, tmbs = jmbs * 3 * k, tmbs * 3 * k  # the batch on which both route every max gradient alike

    schedule = LinearWarmupScheduler(warmup_steps=4, steps_per_epoch=10)
    trainer = ModelTrainer(tmodel, tmp_path / "m.pkl.gz", clip_gradient_norm=1.0, gradient_accumulation_steps=k,
                           optimizer_creator=lambda p: torch.optim.Adam(p, lr=LR, eps=EPS), device="cpu")
    trainer._neural_module = tmodule
    optimizer, _ = trainer._create_optimizer()
    step = trainer._train_step_for(optimizer)
    losses, factors = [], []
    for i, mb in enumerate(tmbs):
        factors.append(schedule.step(0, trainer._opt_steps_this_epoch if k > 1 else i))
        losses.append(trainer._train_step(tree_to(mb, CPU), step.generator, factors[-1])[0])
    assert trainer._opt_steps_this_epoch == 3 and trainer._accumulated == 0
    assert factors == [0.25, 0.5, 0.75] if k == 1 else [0.25, 0.25, 0.5, 0.5, 0.75, 0.75]
    assert all(bool((p.grad == 0).all()) for p in tmodule.parameters())  # static buffers, zero between steps

    jlosses, jparams = _jax_steps(jmodel, jmodule, params, jmbs, factors, k, tmp_path / "jax.pkl.gz")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    expected = jax_params_to_state_dict(tmodule, jparams)
    moved = 0
    for name, p in tmodule.named_parameters():
        want = np.asarray(expected[name])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4, atol=1e-4 * max(np.abs(want).max(), 1e-30),
                                   err_msg=name)
        moved += int(not np.array_equal(want, np.asarray(jax_params_to_state_dict(tmodule, params)[name])))
    assert moved > 0


def test_a_train_step_is_the_trainers_step():
    """``TrainStep.step`` as harness.train_steps and the autotuner call it
    and ``ModelTrainer``'s step leave the same bits, dropout on."""
    results = []
    for via_trainer in (False, True):
        module, mbs = _minibatch(num_minibatches=2, dropout_rate=0.1)
        optimizer = torch.optim.Adam(module.parameters(), lr=LR)
        if via_trainer:
            trainer = ModelTrainer(None, "unused.pkl.gz", clip_gradient_norm=1.0, device="cpu")
            trainer._neural_module = module
            step = trainer._train_step_for(optimizer)
        else:
            step = TrainStep(module, optimizer, clip_gradient_norm=1.0)
        for i, mb in enumerate(mbs):
            step.generator.manual_seed(7 + i)
            if via_trainer:
                trainer._train_step(mb, step.generator, 0.5)
            else:
                step.step(mb, 0.5)
        results.append({k: v.clone() for k, v in module.state_dict().items()})
    for name in results[0]:
        assert torch.equal(results[0][name], results[1][name]), name


def test_an_optimizer_that_cannot_be_captured_raises():
    module, _ = _minibatch()
    with pytest.raises(TypeError, match="SGD"):
        TrainStep(module, torch.optim.SGD(module.parameters(), lr=0.1))


# ---------------------------------------------------------------------------
# metrics aliasing
# ---------------------------------------------------------------------------
def test_metrics_of_a_reused_buffer_accumulate_each_step():
    buffer = torch.tensor(3.0, dtype=torch.float64)
    acc = MetricsAccumulator()
    acc.update({"sum_loss": buffer, "num_samples": torch.tensor(2)})
    buffer.fill_(5.0)  # the next replay writes the same output buffer
    acc.update({"sum_loss": buffer, "num_samples": torch.tensor(4)})
    assert acc.totals() == {"sum_loss": 8.0, "num_samples": 6.0}


# ---------------------------------------------------------------------------
# checkpoints of a compiled step's optimizer state
# ---------------------------------------------------------------------------
def _stepped(seed=3):
    module, mbs = _minibatch(dropout_rate=0.1)
    step = TrainStep(module, torch.optim.Adam(module.parameters(), lr=LR, betas=(0.8, 0.95)), clip_gradient_norm=1.0)
    for i in range(2):
        step.generator.manual_seed(seed + i)
        step.step(mbs[0], 0.5)
    return module, step


def _optimizer_tensors(optimizer):
    state = optimizer.state_dict()["state"]
    return {(i, k): v for i, s in state.items() for k, v in s.items()}


def _assert_same_state(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def test_the_pickle_checkpoint_round_trips_a_compiled_steps_state(tmp_path):
    module, step = _stepped()
    path = ckpt.optimizer_state_path(tmp_path / "m.pkl.gz")
    ckpt.save_optimizer_state(path, step.optimizer.state_dict(), 4)
    fresh, _ = _minibatch(dropout_rate=0.1)
    optimizer = torch.optim.Adam(fresh.parameters(), lr=LR, betas=(0.8, 0.95))
    state, epoch = ckpt.load_optimizer_state(path)
    optimizer.load_state_dict(state)
    assert make_capturable(optimizer, CPU) == [LR] and epoch == 4
    _assert_same_state(_optimizer_tensors(optimizer), _optimizer_tensors(step.optimizer))
    assert {int(s["step"]) for s in optimizer.state.values()} == {2}


def test_the_distributed_checkpoint_round_trips_a_compiled_steps_state(tmp_path):
    module, step = _stepped()
    checkpointer = DistributedCheckpointer(tmp_path / "dcp")
    checkpointer.save(2, module, step.optimizer, wait=True)
    fresh, _ = _minibatch(dropout_rate=0.1)
    optimizer = torch.optim.Adam(fresh.parameters(), lr=0.5)
    assert checkpointer.restore(module=fresh, optimizer=optimizer) == 2
    restored = TrainStep(fresh, optimizer, clip_gradient_norm=1.0)
    _assert_same_state(_optimizer_tensors(optimizer), _optimizer_tensors(step.optimizer))
    for (name, a), b in zip(module.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name
    # the restored step goes on as the original does
    for s, m in ((step, module), (restored, fresh)):
        s.generator.manual_seed(11)
        s.step(_minibatch(dropout_rate=0.1)[1][0], 0.5)
    for (name, a), b in zip(module.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name
    checkpointer.close()
