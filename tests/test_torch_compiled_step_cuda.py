"""Compiled steps on the card (``ptgnn_tpu_torch/core/compiled_step.py``):
a small Graph2Class's train step (float32 and bf16 AMP, dropout on), its
accumulation pair, and its serving function, captured and replayed, against
the same step functions called eagerly, bit for bit; a generator reseeded
between replays; the launch counters after N replays; the signature cache;
a capture that fails (a device OOM inside it, a step that waits for the
device) leaves nothing behind.

These tests need a card and skip elsewhere. This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_compiled_step_cuda.py
"""
import pytest
import torch

from ptgnn_tpu_torch.core import compiled_step as cs
from ptgnn_tpu_torch.core.compiled_step import CompiledStep
from ptgnn_tpu_torch.core.trainer import TrainStep
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.ops import segment_kernels as sk

pytestmark = pytest.mark.cuda

STEPS = 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a compiled step captures a CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph2class(dev, max_nodes=512, num_minibatches=2, dropout_rate=0.1):
    _, module, mbs = build_graph2class(padding=small_padding(max_nodes=max_nodes), device=dev, hidden_state_size=32,
                                       num_minibatches=num_minibatches, minibatch_size=8, dropout_rate=dropout_rate)
    return module, [tree_to(mb, dev) for mb in mbs]


def _eager(step: TrainStep) -> TrainStep:
    """``step`` with its compiled steps replaced by the functions they
    compile: the same step, called directly."""
    for name in ("train_step", "grad_step", "apply_step"):
        setattr(step, name, getattr(step, name).fn)
    return step


def _state(module, optimizer):
    out = {f"param {k}": v.detach().clone() for k, v in module.named_parameters()}
    for i, state in enumerate(optimizer.state.values()):
        out.update({f"state {i} {k}": v.clone() for k, v in state.items()})
    return out


def _run(compiled: bool, dev, amp: bool, accumulate: int = 1):
    module, mbs = _graph2class(dev)
    step = TrainStep(module, torch.optim.Adam(module.parameters(), lr=1e-3), clip_gradient_norm=1.0, amp=amp)
    if not compiled:
        _eager(step)
    losses = []
    for i in range(STEPS):
        step.generator.manual_seed(1000 + i)
        mb = mbs[i % len(mbs)]
        if accumulate == 1:
            loss, metrics = step.step(mb, lr_factor=0.5 + 0.1 * i)
        else:
            loss, metrics = step.accumulate(mb)
            if (i + 1) % accumulate == 0:
                step.apply(accumulate, lr_factor=0.5 + 0.1 * i)
        losses.append(loss.clone())
    return torch.stack(losses), _state(module, step.optimizer), step


@pytest.mark.parametrize("amp", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_compiled_train_steps_equal_eager_steps_bitwise(cuda_device, amp, accumulate):
    eager_losses, eager_state, _ = _run(False, cuda_device, amp, accumulate)
    losses, state, step = _run(True, cuda_device, amp, accumulate)
    assert torch.isfinite(losses).all()
    assert torch.equal(losses, eager_losses), (losses, eager_losses)
    assert state.keys() == eager_state.keys()
    for name, value in state.items():
        assert torch.equal(value, eager_state[name]), name
    compiled = step.train_step if accumulate == 1 else step.grad_step
    assert len(compiled) == 1 and compiled.stats()[0].pool_bytes > 0


def test_compiled_predict_probs_equal_eager(cuda_device):
    module, mbs = _graph2class(cuda_device)
    module.eval()
    predict = CompiledStep(module.predict_probs, cuda_device)
    with torch.inference_mode():
        for mb in mbs + mbs:
            want = module.predict_probs(mb["batch"])
            got = predict(mb["batch"])
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    assert len(predict) == 1


def test_a_reseeded_generator_draws_in_a_replay_what_it_draws_eagerly(cuda_device):
    generator = torch.Generator(device=cuda_device)
    x = torch.zeros(1000, device=cuda_device)

    def draw(x):
        return x + torch.rand(x.shape, generator=generator, device=x.device)

    compiled = CompiledStep(draw, cuda_device, generators=[generator])
    for seed in (3, 4, 3):
        generator.manual_seed(seed)
        want = draw(x)
        generator.manual_seed(seed)
        assert torch.equal(compiled(x), want), seed


def test_launch_counters_count_warm_ups_and_replays(cuda_device):
    module, mbs = _graph2class(cuda_device, num_minibatches=1)
    step = TrainStep(module, torch.optim.Adam(module.parameters(), lr=1e-3), clip_gradient_norm=1.0)
    _eager(step)
    sk.reset_launch_counts()
    step.generator.manual_seed(0)
    step.step(mbs[0])
    per_step = sk.launch_counts()
    assert sum(per_step.values()) > 0

    module, mbs = _graph2class(cuda_device, num_minibatches=1)
    step = TrainStep(module, torch.optim.Adam(module.parameters(), lr=1e-3), clip_gradient_norm=1.0)
    sk.reset_launch_counts()
    n = 5
    for i in range(n):
        step.generator.manual_seed(i)
        step.step(mbs[0])
    torch.cuda.synchronize()
    assert sk.launch_counts() == {k: v * (cs.WARMUP_CALLS + n) for k, v in per_step.items()}


def test_the_cache_reuses_a_signature_and_adds_one_per_padding(cuda_device):
    module, mbs = _graph2class(cuda_device)
    _, wide = _graph2class(cuda_device, max_nodes=1024, num_minibatches=1)
    module.eval()
    forward = CompiledStep(module, cuda_device)
    with torch.no_grad():
        for mb in mbs:
            forward(**mb)
        assert len(forward) == 1
        forward(**wide[0])
        forward(**mbs[0], train=False)  # a static flag given anew
        assert len(forward) == 3
    forward.clear()
    assert len(forward) == 0


def test_an_oom_inside_a_capture_propagates_and_leaves_nothing_behind(cuda_device):
    generator = torch.Generator(device=cuda_device)
    weight = torch.ones(8, device=cuda_device)
    fail = [True]

    def step(x):
        weight.add_(torch.rand(x.shape, generator=generator, device=x.device))
        if fail[0] and torch.cuda.is_current_stream_capturing():
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return weight * x

    compiled = CompiledStep(step, cuda_device, state=lambda: [weight], generators=[generator])
    x = torch.ones(8, device=cuda_device)
    with pytest.raises(torch.OutOfMemoryError):
        compiled(x)
    assert not torch.cuda.is_current_stream_capturing() and len(compiled) == 0
    assert torch.equal(weight, torch.ones(8, device=cuda_device))  # the warm-up's update was undone
    # the generator and the default generator still draw eagerly, and a later capture works
    torch.rand(4, generator=generator, device=cuda_device)
    torch.rand(4, device=cuda_device)
    fail[0] = False
    generator.manual_seed(9)
    got = compiled(x).clone()
    generator.manual_seed(9)
    weight.copy_(torch.ones(8, device=cuda_device))
    assert torch.equal(got, step(x))


def test_a_step_that_waits_for_the_device_raises_at_its_warm_up(cuda_device):
    weight = torch.ones(4, device=cuda_device)

    def step(x):
        weight.add_(x)
        return x * float(x.sum())  # a host read of a device value

    compiled = CompiledStep(step, cuda_device, state=lambda: [weight])
    with pytest.raises(RuntimeError, match="synchroniz"):
        compiled(torch.ones(4, device=cuda_device))
    assert torch.equal(weight, torch.ones(4, device=cuda_device)) and len(compiled) == 0
    assert torch.cuda.get_sync_debug_mode() == 0
