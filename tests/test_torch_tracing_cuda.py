"""Phase marks in the compiled train step on the card
(``ptgnn_tpu_torch/utils/tracing.py``, ``csrc/trace_mark.cu``,
``core/compiled_step.py``): a profiled replay shows marks 0-3 once each, in
order; an unprofiled replay leaves the graph's marks disabled, and they are
switched only when the profiler starts or stops; the accumulation pair's
graphs hold their two marks each; loss, parameters and optimizer state are
bitwise the same with marks on and off, compiled and eager.

These tests need a card and skip elsewhere. This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing_cuda.py
"""
import re

import pytest
import torch

from ptgnn_tpu_torch.core.trainer import TrainStep
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

MARK = re.compile(r"trace_mark_kernel<(\d)>")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase marks are kernels in a CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tracing.set_marking(False)
    yield torch.device("cuda")
    tracing.set_marking(False)


def _setup(dev):
    _, module, mbs = build_graph2class(padding=small_padding(max_nodes=512), device=dev, hidden_state_size=32,
                                       num_minibatches=2, minibatch_size=8, dropout_rate=0.1)
    step = TrainStep(module, torch.optim.Adam(module.parameters(), lr=1e-3), clip_gradient_norm=1.0)
    return step, [tree_to(mb, dev) for mb in mbs]


def _marks_run(prof):
    """The ids of the marks the card ran under ``prof``, in order."""
    events = [(e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us(), int(m.group(1)))
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and (m := MARK.search(e.name()))]
    return [i for _, i in sorted(events)]


def test_a_profiled_replay_shows_the_four_marks_in_order(cuda_device):
    step, mbs = _setup(cuda_device)
    step.step(mbs[0])  # the capture, unprofiled
    entry = next(iter(step.train_step._entries.values()))
    assert len(entry.marks) == 4 and not entry.marks_on
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            step.step(mbs[i % 2])
        torch.cuda.synchronize()
    assert entry.marks_on
    assert _marks_run(prof) == [0, 1, 2, 3] * 3
    host = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("ptgnn.")]
    assert host.count("ptgnn.train_step") == 3 and host.count("ptgnn.compiled_step.replay") == 3


def test_an_unprofiled_replay_leaves_the_marks_disabled(cuda_device, monkeypatch):
    step, mbs = _setup(cuda_device)
    switched = []
    real = tracing.set_graph_marks

    def counting(graph, nodes, enabled):
        switched.append(enabled)
        return real(graph, nodes, enabled)

    monkeypatch.setattr(tracing, "set_graph_marks", counting)
    step.step(mbs[0])
    entry = next(iter(step.train_step._entries.values()))
    for i in range(3):
        step.step(mbs[i % 2])
    assert switched == [False] and not entry.marks_on  # disabled at the capture, then left alone
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        step.step(mbs[1])
        step.step(mbs[0])
        torch.cuda.synchronize()
    step.step(mbs[1])
    assert switched == [False, True, False] and not entry.marks_on
    # and on again for a later profile, for its own replay alone
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step.step(mbs[0])
        torch.cuda.synchronize()
    assert _marks_run(prof) == [0, 1, 2, 3]


def test_the_accumulation_pair_holds_its_marks(cuda_device):
    step, mbs = _setup(cuda_device)
    step.accumulate(mbs[0])
    step.accumulate(mbs[1])
    step.apply(2)
    grad = next(iter(step.grad_step._entries.values()))
    apply = next(iter(step.apply_step._entries.values()))
    assert (len(grad.marks), len(apply.marks)) == (2, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step.accumulate(mbs[0])
        step.accumulate(mbs[1])
        step.apply(2)
        torch.cuda.synchronize()
    assert _marks_run(prof) == [0, 1, 0, 1, 2, 3]


def _three_steps(dev, marks: bool, compiled: bool = True):
    torch.manual_seed(0)
    tracing.set_marking(marks)
    step, mbs = _setup(dev)
    if not compiled:
        step.train_step = step.train_step.fn
    losses = []
    for i in range(3):
        step.generator.manual_seed(500 + i)
        losses.append(step.step(mbs[i % 2], lr_factor=0.5 + 0.25 * i)[0].clone())
    state = [p.detach().clone() for p in step.module.parameters()]
    state += [v.clone() for s in step.optimizer.state.values() for v in s.values()]
    tracing.set_marking(False)
    return torch.stack(losses), state


@pytest.mark.parametrize("compiled", [True, False], ids=["compiled", "eager"])
def test_marks_on_and_off_give_the_same_bits(cuda_device, compiled):
    on_loss, on_state = _three_steps(cuda_device, True, compiled)
    off_loss, off_state = _three_steps(cuda_device, False, compiled)
    assert torch.equal(on_loss, off_loss)
    assert len(on_state) == len(off_state)
    assert all(torch.equal(a, b) for a, b in zip(on_state, off_state))
