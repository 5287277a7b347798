"""Compiled steps on the card (``ptgnn_tpu_torch/core/compiled_step.py``):
a small Graph2Class's train step (float32 and bf16 AMP, dropout on), its
accumulation pair, and its serving function, captured and replayed, against
the same step functions called eagerly, bit for bit; a generator reseeded
between replays; the launch counters after N replays; the signature cache;
a capture that fails (a device OOM inside it, a step that waits for the
device) leaves nothing behind. Then the later compiled steps: a small
Graph2Seq's greedy, sampled and beam decode loops, alone and through the
model, and the data-parallel steps at world 1 over NCCL (DataParallel's
train step and accumulation pair with and without ZeRO-1, its eval step,
EdgeParallel and NodeParallel), each against its eager function bit for
bit, with weights and learning-rate factors that change between calls.

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


def test_the_collector_frees_nothing_while_a_step_captures(cuda_device):
    """Garbage freed during a capture may hold another graph, whose release
    the CUDA runtime does not permit while a stream captures (the capture is
    invalidated): the collector runs before a capture and is off during it.
    The step makes cyclic garbage and allocates, with a collection due at
    nearly every allocation; each finalizer records whether it ran while
    the stream captured."""
    import gc
    import weakref

    class Node:
        pass

    freed = []

    def step(x):
        for _ in range(20):
            node = Node()
            node.me = node
            weakref.finalize(node, lambda: freed.append(torch.cuda.is_current_stream_capturing()))
            del node
            [[] for _ in range(50)]
        return x * 2

    compiled = CompiledStep(step, cuda_device)
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        out = compiled(torch.ones(4, device=cuda_device))
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full((4,), 2.0, device=cuda_device))
    assert len(freed) == 20 * (cs.WARMUP_CALLS + 1) and not any(freed), freed.count(True)


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


# ---------------------------------------------------------------------------
# The Graph2Seq decode loops
# ---------------------------------------------------------------------------
G2S_PAD = dict(max_nodes=512, max_edge_slots=512 * 8, max_graphs=16, edge_tile=64,
               reference_budgets=(("backbone_nodes", 256),))


def _graph2seq(dev):
    from ptgnn_tpu_torch.graph.structs import BatchPadding
    from ptgnn_tpu_torch.implementations.graph2seq.harness import build_graph2seq
    from ptgnn_tpu_torch.utils.synthetic import synthetic_graph2seq_samples

    samples = list(synthetic_graph2seq_samples(48, seed=2, mean_nodes=30, max_nodes=60))
    model, module, _ = build_graph2seq(padding=BatchPadding(**G2S_PAD), samples=samples, embedding_size=32,
                                       max_seq_len=6, device=dev, minibatch_size=8, seed=3)
    return model, module.eval(), samples


def _decode_inputs(model, module, samples, dev, batch):
    """The decoder's inputs of the ``batch``-th minibatch of ``samples``."""
    mbs = list(model.minibatch_iterator(model.tensorize_dataset(iter(samples), parallelize=False,
                                                                return_input_data=True),
                                        max_minibatch_size=8, parallelize=False))
    mb, raw = mbs[batch]
    values = [s["node_labels"][k].lower() for s in raw for k in s["backbone_sequence"]]
    memories, origin, mask, states, _ = module.encode(tree_to(mb["batch"], dev))
    return values, memories, origin, mask, states, len(raw)


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam"])
def test_compiled_decode_loops_equal_eager_loops_bitwise(cuda_device, kind):
    model, module, samples = _graph2seq(cuda_device)
    decoder = model.decoder_model
    generator = torch.Generator(device=cuda_device)
    loop = decoder.decode_loop("beam" if kind == "beam" else "greedy", module.decoder, cuda_device,
                               generator if kind == "sampled" else None)
    g_pads = set()
    with torch.inference_mode():
        for batch in (0, 1, 0):
            values, memories, origin, mask, states, n = _decode_inputs(model, module, samples, cuda_device, batch)
            k = 3 if kind == "beam" else 1
            groups, _ = decoder._copy_groups(k, values, memories, origin, mask, n, states.shape[0],
                                             module.decoder.vocabulary_size, module.decoder.unk_id)
            g_pads.add(groups.g_pad)
            extra = (k,) if kind == "beam" else (torch.tensor(0.7, device=cuda_device) if kind == "sampled" else None,)
            for seed in (5, 6):
                generator.manual_seed(seed)
                want = [t.clone() for t in loop.fn(groups, states, *extra)]
                generator.manual_seed(seed)
                got = loop(groups, states, *extra)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (kind, batch, seed)
    assert len(loop) == len(g_pads)


@pytest.mark.parametrize("beam_size", [1, 5])
def test_compiled_decode_through_the_model_equals_eager(cuda_device, beam_size):
    """``greedy_decode`` (beam 1) and ``beam_decode`` through the model:
    the compiled loops give the eager loops' tokens and scores exactly, and
    one graph per signature is kept on the decoder model."""
    model, module, samples = _graph2seq(cuda_device)
    decoder = model.decoder_model

    def decode():
        if beam_size == 1:
            return model.greedy_decode(samples[:24], module, max_minibatch_size=8, device=cuda_device)
        return model.beam_decode(samples[:24], module, beam_size=beam_size, max_minibatch_size=8, device=cuda_device)

    compiled = decode()
    again = decode()
    loops = decoder.__dict__["_decode_loops_compiled_cache"]
    assert len(loops) == 1
    signatures = len(next(iter(loops.values()))[2])
    compiled_loop = decoder.decode_loop
    decoder.decode_loop = lambda *args, **kwargs: compiled_loop(*args, **kwargs).fn
    try:
        eager = decode()
    finally:
        del decoder.decode_loop
    assert compiled == eager == again
    assert 1 <= signatures <= 3


# ---------------------------------------------------------------------------
# The data-parallel steps at world 1 over NCCL
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl_world(cuda_device, tmp_path):
    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel import initialize_multi_host

    initialize_multi_host("nccl", f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        yield cuda_device
    finally:
        dist.destroy_process_group()


def _eager_dp(dp):
    """``dp`` with its compiled steps replaced by the functions they compile."""
    for name in ("train_step_compiled", "grad_step_compiled", "apply_step_compiled", "eval_step_compiled"):
        setattr(dp, name, getattr(dp, name).fn)
    return dp


def _dp_run(dev, compiled: bool, zero1: bool, accumulate: int):
    from ptgnn_tpu_torch.parallel import DataParallel, zero1_optimizer

    module, mbs = _graph2class(dev)

    def adam(params):
        return torch.optim.Adam(params, lr=1e-3)

    optimizer = zero1_optimizer(module.parameters(), adam) if zero1 else adam(module.parameters())
    dp = DataParallel(module)
    if not compiled:
        _eager_dp(dp)
    losses, last_grad_calls = [], 0
    weights = [8.0, 5.0, 3.0, 0.0, 8.0, 7.0]
    for i in range(STEPS):
        before = dp.allreduce_calls
        dp.generator.manual_seed(2000 + i)
        mb, weight, factor = mbs[i % len(mbs)], weights[i], 1.0 - 0.1 * i
        if accumulate == 1:
            loss, metrics = dp.train_step(mb, weight, None, optimizer, [1e-3], clip_gradient_norm=1.0,
                                          lr_factor=factor)
        else:
            loss, metrics, _ = dp.grad_step(mb, weight)
            last_grad_calls = dp.allreduce_calls - before
            if (i + 1) % accumulate == 0:
                dp.apply_gradients(optimizer, [1e-3], clip_gradient_norm=1.0, lr_factor=factor)
        if accumulate == 1:
            last_grad_calls = dp.allreduce_calls - before
        losses.append(loss.clone())
        evaluated = dp.eval_step(mb, weight + 1.0)
        losses.append(evaluated[0].clone())
    torch.cuda.synchronize()
    dp.last_grad_calls = last_grad_calls  # the all-reduces of one steady grad or train step
    return torch.stack(losses), _state(module, getattr(optimizer, "optim", optimizer)), dp


@pytest.mark.parametrize("zero1", [False, True], ids=["adam", "zero1"])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_compiled_data_parallel_steps_equal_eager_bitwise(nccl_world, zero1, accumulate):
    """DataParallel's train step (or its accumulation pair) and eval step,
    compiled against eager from the same weights and seeds: the losses,
    every parameter and both Adam moments bit for bit, with the weight and
    the learning-rate factor changing at every call (a graph that baked the
    first call's would be off from the second). The all-reduce counters
    count what ran: warm-ups and replays."""
    from ptgnn_tpu_torch.parallel.dp import DDP_WARMUP_CALLS

    eager_losses, eager_state, eager_dp = _dp_run(nccl_world, False, zero1, accumulate)
    losses, state, dp = _dp_run(nccl_world, True, zero1, accumulate)
    assert torch.isfinite(losses).all()
    assert torch.equal(losses, eager_losses), (losses, eager_losses)
    for name, value in state.items():
        assert torch.equal(value, eager_state[name]), name
    compiled = dp.train_step_compiled if accumulate == 1 else dp.grad_step_compiled
    assert len(compiled) == (1 if accumulate == 1 else 2) and len(dp.eval_step_compiled) == 1
    # eager: one execution per call; compiled: each signature's warm-ups on
    # top (a steady grad step all-reduces the weight, DDP's buckets, and the
    # loss with the metrics; an eval step twice; DDP's first iteration, in
    # both runs, its first buckets)
    per_grad_step = eager_dp.last_grad_calls
    assert per_grad_step >= 3 and dp.last_grad_calls == per_grad_step
    warm = DDP_WARMUP_CALLS * len(compiled) * per_grad_step + cs.WARMUP_CALLS * len(dp.eval_step_compiled) * 2
    assert dp.allreduce_calls == eager_dp.allreduce_calls + warm


def test_compiled_edge_and_node_parallel_steps_equal_eager_bitwise(nccl_world):
    """EdgeParallel's and NodeParallel's train steps at world 1 (one shard),
    compiled against eager, SGD and Adam: the losses and every parameter
    bit for bit, the rate changing between calls (a new graph for each of
    SGD's Python rates, one graph for Adam's device-scalar rate)."""
    from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
    from ptgnn_tpu_torch.parallel import EdgeParallel, NodeParallel, suggest_budgets

    def run(kind, compiled, opt_name):
        model, module, mbs = build_graph2class(padding=small_padding(max_nodes=512), device=nccl_world,
                                               hidden_state_size=32, num_minibatches=2, minibatch_size=8,
                                               dropout_rate=0.0)
        sharder = EdgeParallel(module) if kind == "edge" else NodeParallel(module, **suggest_budgets(mbs, 1))
        if not compiled:
            _eager_dp(sharder.data_parallel)
        local = [tree_to(sharder.shard_batch(mb), nccl_world) for mb in mbs]
        optimizer = (torch.optim.SGD(module.parameters(), lr=0.05) if opt_name == "sgd"
                     else torch.optim.Adam(module.parameters(), lr=1e-3))
        losses = []
        for i in range(4):
            optimizer.param_groups[0]["lr" if opt_name == "sgd" else "initial_lr"] = 0.05 / (1 + i % 2) \
                if opt_name == "sgd" else 1e-3 / (1 + i % 2)
            losses.append(sharder.train_step(local[i % 2], optimizer)[0].clone())
        if compiled:  # SGD's rate is static: a graph per rate; Adam's a device scalar
            assert len(sharder.data_parallel.train_step_compiled) == (2 if opt_name == "sgd" else 1)
        gnn = module.gnn
        gnn.edge_group = gnn.node_group = None
        return torch.stack(losses), {k: v.detach().clone() for k, v in module.named_parameters()}

    for kind in ("edge", "node"):
        for opt_name in ("sgd", "adam"):
            want = run(kind, False, opt_name)
            got = run(kind, True, opt_name)
            assert torch.equal(got[0], want[0]), (kind, opt_name)
            for name, value in got[1].items():
                assert torch.equal(value, want[1][name]), (kind, opt_name, name)
