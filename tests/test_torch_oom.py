"""Device-OOM handling (``ptgnn_tpu_torch/utils/oom.py`` and the trainer),
the counterpart of the JAX package's ``utils/oom.py`` and of the OOM cases
of ``tests/test_trainer_lifecycle.py``.

* ``is_oom_error`` knows the three forms (the allocator's
  ``torch.OutOfMemoryError``, CUDA's ``out of memory`` runtime error, also
  as a hand kernel's wrapper raises it, and cuBLAS's
  ``CUBLAS_STATUS_ALLOC_FAILED``) and nothing else; the JAX package's agrees
  on the forms both know. ``catch_device_oom`` swallows only those.
* ``ModelTrainer`` with ``catch_device_ooms``: an OOM in a step skips the
  minibatch (also the first step, and in every epoch), the optimizer applies
  only the steps that ran; an OOM in a backward after a partial gradient
  accumulation drops that accumulation group, bitwise as if its minibatches
  never came; an OOM raised by the prefetch copy skips that minibatch,
  bitwise as if it never came. Without ``catch_device_ooms`` each
  propagates."""
import itertools

import pytest
import torch

from ptgnn_tpu.utils.oom import is_oom_error as jax_is_oom_error
from ptgnn_tpu_torch.core import trainer as trainer_module
from ptgnn_tpu_torch.core.trainer import ModelTrainer, module_loss
from ptgnn_tpu_torch.implementations.typilus.harness import small_padding
from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
from ptgnn_tpu_torch.ops import cuda_build
from ptgnn_tpu_torch.utils.oom import catch_cuda_oom, catch_device_oom, is_oom_error
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

ALLOCATOR = "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of 79.19 GiB"
RUNTIME = "CUDA error: out of memory\nCUDA kernel errors might be asynchronously reported"
CUBLAS = "CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`"


class _FakeKernelLibrary:
    @staticmethod
    def ptgnn_error_string(err):
        return {2: b"out of memory", 700: b"an illegal memory access was encountered"}[err]


def _kernel_error(monkeypatch, err):
    monkeypatch.setitem(cuda_build._LIBS, "sum", _FakeKernelLibrary())
    with pytest.raises(RuntimeError) as info:
        cuda_build.check("sum", err)
    return info.value


@pytest.mark.parametrize("error,expected,jax_knows", [
    (torch.cuda.OutOfMemoryError(ALLOCATOR), True, True),
    (RuntimeError(RUNTIME), True, True),
    (RuntimeError(CUBLAS), True, False),
    (RuntimeError("The size of tensor a (3) must match the size of tensor b (4)"), False, True),
    (ValueError("out of memory"), False, False),
    (KeyError("CUDA out of memory"), False, False),
])
def test_is_oom_error_forms(error, expected, jax_knows):
    assert is_oom_error(error) is expected
    if jax_knows:
        assert jax_is_oom_error(error) is expected


def test_a_kernel_wrapper_allocation_failure_is_an_oom(monkeypatch):
    assert is_oom_error(_kernel_error(monkeypatch, 2))
    assert not is_oom_error(_kernel_error(monkeypatch, 700))


def test_catch_device_oom_swallows_only_ooms():
    assert catch_cuda_oom is catch_device_oom
    with catch_device_oom():
        raise torch.cuda.OutOfMemoryError(ALLOCATOR)
    with catch_device_oom():
        raise RuntimeError(CUBLAS)
    with pytest.raises(RuntimeError):
        with catch_device_oom():
            raise RuntimeError("shape mismatch")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with catch_device_oom(enabled=False):
            raise torch.cuda.OutOfMemoryError(ALLOCATOR)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
DATA = list(synthetic_typilus_graphs(48, seed=1, mean_nodes=60, max_nodes=120))


def _model():
    return create_graph2class_gnn_model(hidden_state_size=32, padding=small_padding(max_nodes=256, max_graphs=8),
                                        dropout_rate=0.0)


class _OomInjectingTrainer(ModelTrainer):
    """Raises a device OOM at the given attempted steps: before the step
    (``where="step"``) or after its backward left gradients in ``.grad``
    (``where="backward"``)."""

    def __init__(self, *args, fail_steps=(), where="step", **kwargs):
        super().__init__(*args, **kwargs)
        self.fail_steps, self.where = set(fail_steps), where
        self.attempted = self.failed = self.succeeded = 0

    def _train_step(self, minibatch, generator, *args):
        idx, self.attempted = self.attempted, self.attempted + 1
        if idx in self.fail_steps:
            self.failed += 1
            if self.where == "backward":
                loss, _ = module_loss(self.neural_module, minibatch, train=True, generator=generator)
                loss.backward()
            raise torch.cuda.OutOfMemoryError(ALLOCATOR)
        self.succeeded += 1
        return super()._train_step(minibatch, generator, *args)


class _DroppingTrainer(ModelTrainer):
    """Leaves out the minibatches at positions ``drop`` of each training
    pass, as if they never came."""

    def __init__(self, *args, drop=(), **kwargs):
        super().__init__(*args, **kwargs)
        self.drop = set(drop)

    def _device_minibatches(self, items):
        return super()._device_minibatches(item for i, item in enumerate(items) if i not in self.drop)


def _train(trainer):
    trainer.train(DATA, DATA[:8], parallelize=False, validate_on_start=False, patience=10)
    return {k: v.detach().clone() for k, v in trainer.neural_module.named_parameters()}


def _optimizers(trainer):
    """The optimizers ``trainer`` creates, as it creates them."""
    created = []
    original = trainer._create_optimizer

    def create():
        optimizer, lrs = original()
        created.append(optimizer)
        return optimizer, lrs

    trainer._create_optimizer = create
    return created


def test_oom_steps_are_skipped(tmp_path):
    """The first-ever step and a mid-epoch step of each epoch fail; the
    optimizer applies only the steps that ran."""
    trainer = _OomInjectingTrainer(_model(), tmp_path / "m.pkl.gz", max_num_epochs=2, minibatch_size=4,
                                   catch_device_ooms=True, fail_steps=(0, 5, 13), device="cpu")
    optimizers = _optimizers(trainer)
    params = _train(trainer)
    assert trainer.failed == 3 and trainer.succeeded == trainer.attempted - 3 > 0
    state = optimizers[0].state_dict()["state"]
    assert {int(s["step"]) for s in state.values()} == {trainer.succeeded}
    assert all(torch.isfinite(p).all() for p in params.values())


def test_oom_in_a_backward_drops_the_partial_accumulation_group(tmp_path):
    """Accumulation over 2: the OOM in microbatch 3's backward drops
    microbatches 2 and 3 (whose gradients sat in .grad); the run ends on the
    parameters of a run without them."""
    kw = dict(max_num_epochs=1, minibatch_size=4, gradient_accumulation_steps=2, device="cpu", seed=5)
    oom = _OomInjectingTrainer(_model(), tmp_path / "a.pkl.gz", catch_device_ooms=True, fail_steps=(3,),
                               where="backward", **kw)
    got = _train(oom)
    assert oom.failed == 1
    want = _train(_DroppingTrainer(_model(), tmp_path / "b.pkl.gz", drop={2, 3}, **kw))
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("where", ["step", "backward"])
def test_an_uncaught_oom_propagates(tmp_path, where):
    trainer = _OomInjectingTrainer(_model(), tmp_path / "m.pkl.gz", max_num_epochs=1, minibatch_size=4,
                                   fail_steps=(2,), where=where, device="cpu")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _train(trainer)


def _failing_copy(monkeypatch, fail_at):
    """``tree_to`` in the trainer raising a device OOM on its ``fail_at``-th
    minibatch copy."""
    inner, calls = trainer_module.tree_to, itertools.count()

    def tree_to(tree, device, *args, **kwargs):
        if next(calls) == fail_at:
            raise torch.cuda.OutOfMemoryError(ALLOCATOR)
        return inner(tree, device, *args, **kwargs)

    monkeypatch.setattr(trainer_module, "tree_to", tree_to)


@pytest.mark.parametrize("prefetch", [1, 2])
def test_an_oom_in_the_prefetch_copy_skips_that_minibatch(monkeypatch, tmp_path, prefetch):
    kw = dict(max_num_epochs=1, minibatch_size=4, prefetch_to_device=prefetch, device="cpu", seed=5)
    want = _train(_DroppingTrainer(_model(), tmp_path / "b.pkl.gz", drop={2}, **kw))
    _failing_copy(monkeypatch, 2)
    got = _train(ModelTrainer(_model(), tmp_path / "a.pkl.gz", catch_device_ooms=True, **kw))
    for k in want:
        assert torch.equal(got[k], want[k]), k

    _failing_copy(monkeypatch, 2)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _train(ModelTrainer(_model(), tmp_path / "c.pkl.gz", **kw))
