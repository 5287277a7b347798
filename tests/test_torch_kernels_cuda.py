"""The port's CUDA kernels against their plain PyTorch versions, bitwise, and
the small Graph2Class forward on the card against the CPU.

These tests need a card and skip elsewhere. This file imports neither JAX
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from ptgnn_tpu_torch.graph.batching import _assemble_layout_python
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.ops import segment_kernels as tsk

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
    assert counts == {"segment_extremum": 8, "broadcast_to_edges": 8}
    # rtol 1e-4 and 1e-4 of the logit scale: float32 rounding differs
    # between the card's and the CPU's matmuls and transcendentals.
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=1e-4 * np.abs(cpu).max())
