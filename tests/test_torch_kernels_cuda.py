"""The port's CUDA kernels against their plain PyTorch versions (bitwise for
the broadcast and the extremum; for the sum within 1e-5 of each row's sum of
|x|, bitwise on 0/1 data and from run to run; for the typed matmul within
2^-8 of each element plus 1e-5 of its sum of |x||w|, against float64, and
bitwise from run to run and under tile and row permutations), and the small
Graph2Class and PPI forward and train steps on the card against the CPU.

These tests need a card and skip elsewhere. This file imports neither JAX
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from ptgnn_tpu_torch.core.trainer import module_loss
from ptgnn_tpu_torch.graph.batching import GraphBatcher, _assemble_layout_python
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData, tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.implementations.ppi.harness import build_ppi, synthetic_ppi_samples
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from ptgnn_tpu_torch.ops import typed_linear as ttl
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation

pytestmark = pytest.mark.cuda

N_PAD, R = 512, 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_plan(seed, tile, align):
    """A unified layout: nodes >= 400 have no edges, node 7 has enough edges
    to span several tiles, receivers 3 and 11 have all their edges masked."""
    rng = np.random.RandomState(seed)
    recv = np.concatenate([rng.randint(0, 400, 3000), np.full(300, 7)]).astype(np.int32)
    types = rng.randint(0, 5, len(recv)).astype(np.int32)
    layout = _assemble_layout_python(
        np.zeros_like(recv), recv, types, np.full(len(recv), -1, np.int32),
        max_nodes=N_PAD, e_pad=16384, tile=tile, agg_rows=R, num_types=5, align=align,
    )
    _, receivers, _, local_rows, mask, _, trb, counts, _ = layout
    mask = mask & ~np.isin(receivers, [3, 11])
    plan = tsk.AggregationPlan(*(torch.from_numpy(a) for a in (local_rows, trb, counts)))
    return plan, torch.from_numpy(mask)


def _bits(t):
    return t.cpu().view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_extremum_kernel_matches_plain_bitwise(cuda_device, reduction, dtype, m, tile):
    plan, mask = make_plan(m + tile, tile, 4 * tile)
    g = torch.Generator().manual_seed(m)
    data = torch.randn(plan.local_rows.shape[0], m, generator=g).to(dtype)
    plain = tsk.planned_segment_reduce(data, plan, 450, reduction, mask)
    cplan = tsk.AggregationPlan(*(t.to(cuda_device) for t in plan))
    before = tsk.planned_segment_extremum.launches
    got = tsk.planned_segment_reduce(data.to(cuda_device), cplan, 450, reduction, mask.to(cuda_device))
    torch.cuda.synchronize()
    assert tsk.planned_segment_extremum.launches == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    assert not got[400:].float().any() and not got[[3, 11]].float().any()


@pytest.mark.parametrize("tile", [32, 128, 512])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_broadcast_kernel_matches_plain_bitwise(cuda_device, dtype, d, tile):
    plan, _ = make_plan(d + tile, tile, tile)
    table = torch.randn(500, d, generator=torch.Generator().manual_seed(d)).to(dtype)
    plain = tsk.planned_broadcast_to_edges(table, plan)
    cplan = tsk.AggregationPlan(*(t.to(cuda_device) for t in plan))
    before = tsk.planned_broadcast_to_edges.launches
    got = tsk.planned_broadcast_to_edges(table.to(cuda_device), cplan)
    torch.cuda.synchronize()
    assert tsk.planned_broadcast_to_edges.launches == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(plain))


def supertile_plan(plan, tile, align):
    """The same slots viewed at supertile granularity (as the sum runs)."""
    trb = plan.tile_row_blocks.reshape(-1, align // tile)[:, 0].contiguous()
    return tsk.AggregationPlan(plan.local_rows, trb, plan.counts)


@pytest.mark.parametrize("tile,align", [(32, 128), (128, 512)])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_kernel_matches_plain_and_is_deterministic(cuda_device, dtype, d, tile, align):
    plan, mask = make_plan(d + tile, tile, align)
    plan = supertile_plan(plan, tile, align)
    cplan = tsk.AggregationPlan(*(t.to(cuda_device) for t in plan))
    g = torch.Generator().manual_seed(d)
    data = torch.randn(plan.local_rows.shape[0], d, generator=g).to(dtype)
    data = torch.where(mask[:, None], data, torch.zeros((), dtype=dtype))
    plain = tsk.planned_segment_sum(data, plan, 450)
    before = tsk.planned_segment_sum.launches
    got = tsk.planned_segment_sum(data.to(cuda_device), cplan, 450)
    again = tsk.planned_segment_sum(data.to(cuda_device), cplan, 450)
    torch.cuda.synchronize()
    assert tsk.planned_segment_sum.launches == before + 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (450, d)
    # A float32 sum in another order: within 1e-5 of each row's sum of |x|.
    bound = 1e-5 * tsk.planned_segment_sum(data.abs(), plan, 450)
    assert bool(((got.cpu() - plain).abs() <= bound).all())
    np.testing.assert_array_equal(_bits(got), _bits(again))  # the same bits on every run
    assert not got[400:].any() and not got[[3, 11]].any()
    # 0/1 data (tie indicators) sums small integers: exact.
    ones = (torch.rand(data.shape, generator=g) < 0.3).to(dtype) * mask[:, None].to(dtype)
    np.testing.assert_array_equal(
        _bits(tsk.planned_segment_sum(ones.to(cuda_device), cplan, 450)),
        _bits(tsk.planned_segment_sum(ones, plan, 450)),
    )


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_sum_and_mean_reduce_run_the_kernel_on_cuda(cuda_device, reduction):
    plan, mask = make_plan(5, 128, 512)
    plan = supertile_plan(plan, 128, 512)
    data = torch.randn(plan.local_rows.shape[0], 64, generator=torch.Generator().manual_seed(1))
    plain = tsk.planned_segment_reduce(data, plan, 450, reduction, mask)
    cplan = tsk.AggregationPlan(*(t.to(cuda_device) for t in plan))
    got = tsk.planned_segment_reduce(data.to(cuda_device), cplan, 450, reduction, mask.to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


def test_graph2class_forward_on_card_matches_cpu(cuda_device):
    kw = dict(padding=small_padding(max_nodes=256), hidden_state_size=64, num_minibatches=1)
    _, gpu_module, mbs = build_graph2class(device=cuda_device, **kw)
    _, cpu_module, _ = build_graph2class(device="cpu", **kw)
    batch = mbs[0]["batch"]
    tsk.reset_launch_counts()
    with torch.inference_mode():
        gpu = gpu_module._logits(batch.to(cuda_device), train=False)[0].cpu().numpy()
        counts = tsk.launch_counts()
        cpu = cpu_module._logits(batch.to("cpu"), train=False)[0].numpy()
    assert counts == {"segment_extremum": 8, "broadcast_to_edges": 8, "segment_sum": 0, "typed_matmul": 0}
    # rtol 1e-4 and 1e-4 of the logit scale: float32 rounding differs
    # between the card's and the CPU's matmuls and transcendentals.
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=1e-4 * np.abs(cpu).max())


@pytest.mark.parametrize("amp", [False, True])
def test_graph2class_train_step_on_card_matches_cpu(cuda_device, amp):
    """float32: the loss to rtol 1e-5, every gradient to rtol 1e-4 and 1e-4 of
    its tensor's largest magnitude. bf16 AMP: the step runs through the same
    kernels and gives a finite loss and float32 gradients."""
    kw = dict(padding=small_padding(max_nodes=256), hidden_state_size=64, num_minibatches=1, dropout_rate=0.0)
    _, gpu_module, mbs = build_graph2class(device=cuda_device, **kw)
    _, cpu_module, _ = build_graph2class(device="cpu", **kw)
    tsk.reset_launch_counts()
    loss, _ = module_loss(gpu_module, tree_to(mbs[0], cuda_device), train=True,
                          generator=torch.Generator(device=cuda_device), amp=amp)
    loss.backward()
    torch.cuda.synchronize()
    assert tsk.launch_counts() == {"segment_extremum": 8, "broadcast_to_edges": 24, "segment_sum": 16, "typed_matmul": 0}
    assert all(p.grad.dtype == torch.float32 for p in gpu_module.parameters())
    if amp:
        assert np.isfinite(float(loss.detach()))
        return
    cpu_loss, _ = module_loss(cpu_module, tree_to(mbs[0], torch.device("cpu")), train=True,
                              generator=torch.Generator())
    cpu_loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(cpu_loss.detach()), rtol=1e-5)
    for (name, g), c in zip(gpu_module.named_parameters(), cpu_module.parameters()):
        c = c.grad.numpy()
        np.testing.assert_allclose(g.grad.cpu().numpy(), c, rtol=1e-4, atol=1e-4 * np.abs(c).max(), err_msg=name)


@pytest.mark.parametrize("use_target_state", [True, False])
@pytest.mark.parametrize("reduction", ["max", "min", "sum", "mean"])
def test_fused_backward_on_card_matches_cpu(cuda_device, reduction, use_target_state):
    """The fused op's gradients through the kernels against the plain
    versions, every reduction (mean's widened table has an odd width, which
    the broadcast pads): rtol/atol 1e-5, float32 sums in another order."""
    pad = dict(max_nodes=256, max_edge_slots=8192, max_graphs=4, edge_tile=32, agg_rows=64, agg_sum_tile=128)
    batcher = GraphBatcher(2, BatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    mb = batcher.initialize()
    rng = np.random.RandomState(3)
    for n in (90, 120):
        adj = [(rng.randint(0, n, 150).astype(np.int32), rng.randint(0, n, 150).astype(np.int32)) for _ in range(2)]
        batcher.extend(TensorizedGraphData(n, [0] * n, adj, None, {}), mb)
    batch = batcher.finalize(mb, node_data={}, reference_names=[])
    d, m = 32, 48
    din = 2 * d if use_target_state else d
    states = torch.from_numpy(rng.randn(pad["max_nodes"], d).astype(np.float32))
    weights = torch.from_numpy((rng.randn(batcher.num_edge_types, din, m) / np.sqrt(din)).astype(np.float32))
    cot = torch.from_numpy(rng.randn(pad["max_nodes"], m).astype(np.float32))
    grads = []
    for device in (torch.device("cpu"), cuda_device):
        x = states.clone().to(device).requires_grad_()
        w = weights.clone().to(device).requires_grad_()
        out = fused_typed_message_aggregation(x, w, batch.to(device).adjacency, pad["max_nodes"], reduction,
                                              use_target_state)
        (out * cot.to(device)).sum().backward()
        grads.append((out.detach().cpu(), x.grad.cpu(), w.grad.cpu()))
    torch.cuda.synchronize()
    for cpu, card in zip(*grads):
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=1e-5, atol=1e-5)


# (tiles, tile, D, M, types): PPI's widths; rows and columns that fill no
# whole CTA block, with a depth that ends mid-chunk.
TYPED_SHAPES = [(40, 128, 512, 256, 3), (30, 48, 72, 40, 4)]


def _typed_inputs(shape, dtype, device, seed=0):
    nt, tile, d, m, num_types = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(nt * tile, d, generator=g).to(dtype)
    w = (torch.randn(num_types, d, m, generator=g) / d ** 0.5).to(dtype)
    tt = torch.sort(torch.randint(0, num_types, (nt,), generator=g)).values.int()
    tt[-1] = num_types  # a type out of range reads zeros
    return x.to(device), w.to(device), tt.to(device)


def _typed_reference(x, w, tt, tile):
    """float64 product and the sum of |x||w| of each element; 0 for a type
    out of range."""
    num_types, d, m = w.shape
    valid = (tt >= 0) & (tt < num_types)
    wt = w.double()[torch.where(valid, tt, 0).long()] * valid[:, None, None]
    xt = x.double().reshape(-1, tile, d)
    return torch.bmm(xt, wt).reshape(-1, m), torch.bmm(xt.abs(), wt.abs()).reshape(-1, m)


@pytest.mark.parametrize("shape", TYPED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_typed_matmul_kernel_matches_plain_and_float64(cuda_device, dtype, shape):
    x, w, tt = _typed_inputs(shape, dtype, cuda_device)
    tile = shape[1]
    before = ttl.typed_matmul_kernel.launches
    got = ttl.typed_matmul_kernel(x, w, tt, tile)
    torch.cuda.synchronize()
    assert ttl.typed_matmul_kernel.launches == before + 1 and got.dtype == dtype
    ref, scale = _typed_reference(x, w, tt, tile)
    for out in (got, ttl.typed_matmul_plain(x, w, tt, tile)):
        assert bool(((out.double() - ref).abs() <= 2.0 ** -8 * ref.abs() + 1e-5 * scale).all())
    assert not got.reshape(-1, tile, shape[3])[-1].any()
    if dtype == torch.float32:  # the CPU's float32 product, the same tolerance
        cpu = ttl.typed_matmul_plain(x.cpu(), w.cpu(), tt.cpu(), tile)
        assert bool(((got.cpu().double() - cpu.double()).abs() <= 2.0 ** -8 * ref.abs().cpu()
                     + 1e-5 * scale.cpu()).all())


@pytest.mark.parametrize("shape", TYPED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_typed_matmul_kernel_bits_repeat_and_ignore_row_positions(cuda_device, dtype, shape):
    """The same bits on a second run, and under a permutation of the tiles of
    one type and of the rows inside each tile (the tie routing of the fused
    backward compares messages recomputed in other slots)."""
    x, w, tt = _typed_inputs(shape, dtype, cuda_device, seed=1)
    nt, tile = shape[0], shape[1]
    first = ttl.typed_matmul_kernel(x, w, tt, tile)
    assert torch.equal(_bits_t(first), _bits_t(ttl.typed_matmul_kernel(x, w, tt, tile)))
    g = torch.Generator().manual_seed(2)
    tile_perm = torch.arange(nt)
    for t in torch.unique(tt.cpu()):
        idx = torch.nonzero(tt.cpu() == t)[:, 0]
        tile_perm[idx] = idx[torch.randperm(len(idx), generator=g)]
    rows = torch.cat([tile_perm[i] * tile + torch.randperm(tile, generator=g) for i in range(nt)]).to(cuda_device)
    permuted = ttl.typed_matmul_kernel(x[rows], w, tt, tile)
    torch.cuda.synchronize()
    assert torch.equal(_bits_t(permuted), _bits_t(first[rows]))


def _bits_t(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def test_typed_matmul_gradient_on_card_matches_cpu(cuda_device):
    """The custom VJP through the kernel against the plain version: the
    output and dx, bf16 roundings of float32 sums taken in other orders,
    within one bf16 ulp (at most 2^-7 of the value) plus 1e-5 of the
    element's sum of |a||b|, where cancellation leaves a tiny result; dW (float32
    products of bf16 values) to rtol 1e-5 and 1e-5 of its largest
    magnitude."""
    x, w, tt = _typed_inputs(TYPED_SHAPES[0], torch.bfloat16, "cpu", seed=3)
    w = w.float()
    dy = torch.randn(x.shape[0], w.shape[2], generator=torch.Generator().manual_seed(4)).bfloat16()
    results = []
    for device in ("cpu", cuda_device):
        xd = x.to(device).clone().requires_grad_()
        wd = w.to(device).clone().requires_grad_()
        y = ttl._TypedMatmul.apply(xd, wd, tt.to(device), 128)
        y.backward(dy.to(device))
        results.append([t.detach().float().cpu() for t in (y, xd.grad, wd.grad)])
    _, scale_y = _typed_reference(x, w.bfloat16(), tt, 128)
    _, scale_dx = _typed_reference(dy, w.bfloat16().transpose(1, 2), tt, 128)
    for name, cpu, card, scale in zip(("y", "dx"), results[0][:2], results[1][:2], (scale_y, scale_dx)):
        assert bool(((card - cpu).abs() <= 2.0 ** -7 * cpu.abs() + 1e-5 * scale.float()).all()), name
    dw_cpu, dw_card = results[0][2], results[1][2]
    np.testing.assert_allclose(dw_card.numpy(), dw_cpu.numpy(), rtol=1e-5, atol=1e-5 * float(dw_cpu.abs().max()))


def _ppi_small(device, hidden=64):
    pad = BatchPadding(max_nodes=512, max_edge_slots=512 * 30, max_graphs=4, edge_tile=64)
    samples = synthetic_ppi_samples(3, seed=5, mean_nodes=150, num_labels=24, edges_per_node=8)
    return build_ppi(padding=pad, samples=samples, hidden_state_size=hidden, minibatch_size=2, device=device)


@pytest.mark.parametrize("amp", [False, True])
def test_ppi_train_step_on_card_matches_cpu(cuda_device, amp, monkeypatch):
    """float32 (dropout 0): the loss to rtol 1e-5, every gradient to rtol 1e-4
    and 1e-4 of its largest magnitude. bf16 AMP with the typed matmul route
    forced open at these small widths: 15 kernel launches a step (5 forward,
    10 backward), the loss within 2e-2 and each gradient within 2e-2 of its
    norm of the CPU's plain route."""
    if amp:
        monkeypatch.setattr(ttl, "use_typed_matmul_kernel", lambda x, *a: x.dtype == torch.bfloat16)
    _, gpu_module, mbs = _ppi_small(cuda_device)
    _, cpu_module, _ = _ppi_small("cpu")
    for m in (gpu_module, cpu_module):
        for sub in m.modules():
            if hasattr(sub, "dropout_rate"):
                sub.dropout_rate = 0.0
    tsk.reset_launch_counts()
    loss, _ = module_loss(gpu_module, tree_to(mbs[0], cuda_device), train=True,
                          generator=torch.Generator(device=cuda_device), amp=amp)
    loss.backward()
    torch.cuda.synchronize()
    assert tsk.launch_counts() == {"segment_extremum": 0, "broadcast_to_edges": 10, "segment_sum": 10,
                                   "typed_matmul": 15 if amp else 0}
    cpu_loss, _ = module_loss(cpu_module, tree_to(mbs[0], torch.device("cpu")), train=True,
                              generator=torch.Generator(), amp=amp)
    cpu_loss.backward()
    if amp:
        np.testing.assert_allclose(float(loss.detach()), float(cpu_loss.detach()), rtol=2e-2)
        for (name, g), c in zip(gpu_module.named_parameters(), cpu_module.parameters()):
            assert float((g.grad.cpu() - c.grad).norm()) <= 2e-2 * float(c.grad.norm()), name
        return
    np.testing.assert_allclose(float(loss.detach()), float(cpu_loss.detach()), rtol=1e-5)
    for (name, g), c in zip(gpu_module.named_parameters(), cpu_module.parameters()):
        c = c.grad.numpy()
        np.testing.assert_allclose(g.grad.cpu().numpy(), c, rtol=1e-4, atol=1e-4 * np.abs(c).max(), err_msg=name)
