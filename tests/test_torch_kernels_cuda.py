"""The port's CUDA kernels against their plain PyTorch versions (bitwise for
the broadcast and the extremum, a hub row of thousands of slots included; the
argmax extremum's slots exactly and its values bitwise apart from the sign of
zero, and on a hub row split into pieces bitwise with slots exactly; the sum
bitwise from run to run and on 0/1 data, bitwise equal to the
CPU's at rows of at most ROW_CHUNK slots and within 1e-5 of each row's sum
of |x| on longer ones; for the typed matmul within
2^-8 of each element plus 1e-5 of its sum of |x||w|, against float64, and
bitwise from run to run and under tile and row permutations; the argmax
extremum and the typed matmul replayed from a CUDA graph as run eagerly),
the small Graph2Class, PPI and Graph2Seq forward and train steps on the card
against the CPU, K1 and K3 on a Graph2Seq batch's layout at width 128, and
K1-K3 through the aggregation dispatch on N-D messages, at width 1 and
under a mask with emptied rows, alone and in a PNA layer, and each
Graph2Class stack under edge dropout, off the fused op.

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
from ptgnn_tpu_torch.implementations.graph2seq.harness import build_graph2seq
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.implementations.ppi.harness import build_ppi, synthetic_ppi_samples
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from ptgnn_tpu_torch.ops import typed_linear as ttl
from ptgnn_tpu_torch.ops import fused_mp
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation
from ptgnn_tpu_torch.utils import tracing
from ptgnn_tpu_torch.utils.synthetic import synthetic_graph2seq_samples

pytestmark = pytest.mark.cuda

N_PAD, R = 512, 128


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_plan(seed, tile, align, hub=0):
    """A unified layout: nodes >= 400 have no edges, node 7 has enough edges
    to span several tiles (300 + ``hub``, more than ROW_CHUNK: a split row),
    receivers 3 and 11 have all their edges masked. The plan carries no row
    index: the wrappers compute it (``with_row_index``)."""
    rng = np.random.RandomState(seed)
    recv = np.concatenate([rng.randint(0, 400, 3000), np.full(300 + hub, 7)]).astype(np.int32)
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


def _signed_zeros(data, plan, is_max):
    """Node 9's column 0 ties at zero: -0.0 on its first slot, +0.0 on the
    others, every other value of the row on the losing side."""
    rows = tsk.plan_rows(plan, plan.counts.numel())
    nine = torch.nonzero(rows == 9)[:, 0]
    data[nine, 0] = -5.0 if is_max else 5.0
    data[nine[0], 0], data[nine[1:], 0] = -0.0, 0.0
    return data


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("m", [1, 40, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_extremum_kernel_matches_plain_bitwise(cuda_device, reduction, dtype, m, tile):
    """M = 1 and 40 take the scalar and the partial-group paths; empty and
    all-masked rows, a last row block that 450 rows fill in part, the split
    row 7, and -0.0 tied with +0.0 (read +0.0)."""
    plan, mask = make_plan(m + tile, tile, 4 * tile)
    g = torch.Generator().manual_seed(m)
    data = _signed_zeros(torch.randn(plan.local_rows.shape[0], m, generator=g), plan, reduction == "max").to(dtype)
    plain = tsk.planned_segment_reduce(data, plan, 450, reduction, mask)
    cplan = tree_to(plan, cuda_device)
    before = tracing.counter("segment_extremum")
    got = tsk.planned_segment_reduce(data.to(cuda_device), cplan, 450, reduction, mask.to(cuda_device))
    torch.cuda.synchronize()
    assert tracing.counter("segment_extremum") == before + 1
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    assert not got[400:].float().any() and not got[[3, 11]].float().any()
    assert _bits(got)[9, 0] == 0  # +0.0


@pytest.mark.parametrize("m", [1, 40, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_extremum_kernel_splits_a_hub_row_bitwise(cuda_device, reduction, dtype, m):
    """Node 7 with 4,396 slots over many tiles of five types: its pieces are
    combined by the last to finish, bitwise equal to the plain version, the
    same bits on a second run; the batcher's index (from the host) gives the
    same result as the one the wrapper computes."""
    from ptgnn_tpu_torch.graph.batching import row_index

    plan, mask = make_plan(m + 3, 128, 512, hub=4096)
    assert int((tsk.plan_rows(plan, plan.counts.numel()) == 7).sum()) > 32 * tsk.ROW_CHUNK
    g = torch.Generator().manual_seed(m + 3)
    data = torch.randn(plan.local_rows.shape[0], m, generator=g).to(dtype)
    plain = tsk.planned_segment_reduce(data, plan, 450, reduction, mask)
    offsets, slots = row_index(plan.local_rows.numpy(), plan.tile_row_blocks.numpy(), plan.counts.numpy())
    indexed = plan._replace(row_offsets=torch.from_numpy(offsets), row_slots=torch.from_numpy(slots))
    cdata, cmask = data.to(cuda_device), mask.to(cuda_device)
    before = tracing.counter("segment_extremum")
    runs = [tsk.planned_segment_reduce(cdata, tree_to(p, cuda_device), 450, reduction, cmask)
            for p in (plan, indexed, plan)]
    torch.cuda.synchronize()
    assert tracing.counter("segment_extremum") == before + 3
    for got in runs:
        np.testing.assert_array_equal(_bits(got), _bits(plain))
    assert bool((runs[0][7] != 0).all())


def _tied(plan, mask, m, dtype, is_max, seed):
    """Coarse values (ties inside tiles), node 7's column 0 equal on all its
    slots (ties across its tiles and types), -0.0 before +0.0 on node 9's
    column 1, masked slots at the neutral value, as the fused op gives."""
    g = torch.Generator().manual_seed(seed)
    data = torch.round(torch.randn(plan.local_rows.shape[0], m, generator=g) * 2) / 2
    rows = tsk.plan_rows(plan, plan.counts.numel())
    data[rows == 7, 0] = 3.0 if is_max else -3.0
    nine = torch.nonzero(rows == 9)[:, 0]
    data[nine, 1] = -100.0 if is_max else 100.0
    data[nine[0], 1], data[nine[1:], 1] = -0.0, 0.0
    data = data.to(dtype)
    info = torch.finfo(dtype)
    neutral = {torch.float32: 3.0e38, torch.bfloat16: info.max}[dtype] * (-1 if is_max else 1)
    return torch.where(mask[:, None], data, torch.full((), neutral, dtype=dtype))


@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("m", [64, 128, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_argmax_extremum_kernel_matches_plain(cuda_device, reduction, dtype, m, tile):
    """M = 128 splits the columns over 8 CTAs of each row block, M = 40 ends
    mid-chunk; values bitwise apart from the sign of zero, slots exactly, the
    same bits on a second run."""
    plan, mask = make_plan(m + tile + 1, tile, 4 * tile)
    is_max = reduction == "max"
    data = _tied(plan, mask, m, dtype, is_max, seed=m)
    vals, args = tsk.planned_segment_extremum_with_argmax(data, plan, 450, is_max)
    cplan = tree_to(plan, cuda_device)
    before = tracing.counter("segment_extremum_argmax")
    cdata = data.to(cuda_device)
    got_vals, got_args = tsk.planned_segment_extremum_with_argmax(cdata, cplan, 450, is_max)
    again_vals, again_args = tsk.planned_segment_extremum_with_argmax(cdata, cplan, 450, is_max)
    torch.cuda.synchronize()
    assert tracing.counter("segment_extremum_argmax") == before + 2
    assert got_vals.dtype == torch.float32 and got_args.dtype == torch.int32
    np.testing.assert_array_equal(got_args.cpu().numpy(), args.numpy())
    np.testing.assert_array_equal(_bits(got_vals + 0.0), _bits(vals + 0.0))
    np.testing.assert_array_equal(_bits(got_vals), _bits(again_vals))
    assert torch.equal(got_args, again_args)
    # The planted cases: empty and all-masked rows, ties across tiles, zeros.
    assert (got_args[400:] == -1).all() and (got_args[[3, 11]] == -1).all()
    rows = tsk.plan_rows(plan, plan.counts.numel())
    assert int(got_args[7, 0]) == int(torch.nonzero((rows == 7) & mask)[0, 0])
    assert int(got_args[9, 1]) == int(torch.nonzero((rows == 9) & mask)[0, 0])


def _hub_ties(plan, mask, m, dtype, is_max, seed):
    """Node 7's 4,396 slots, split into pieces at the multiples of ROW_CHUNK of
    the slot list: column 0 takes its extremum on the last slot of one piece
    and the first of the next, column 1 on one slot of each of three pieces,
    column 2 ties at zero (-0.0 on its first slot, +0.0 on two later pieces'
    first slots, every other value on the losing side), and column 3 holds
    a NaN on the first slot of a piece and its extremum three pieces on.
    Returns the data (masked slots at the neutral value) and the data with
    the NaN at the neutral value, whose plain version the kernel must give
    (NaN never wins)."""
    g = torch.Generator().manual_seed(seed)
    data = torch.round(torch.randn(plan.local_rows.shape[0], m, generator=g) * 2) / 2
    indexed = tsk.with_row_index(plan)
    start, end = int(indexed.row_offsets[7]), int(indexed.row_offsets[8])
    cut = [p for p in range(start + 1, end) if p % tsk.ROW_CHUNK == 0]
    assert len(cut) >= 8
    slot = lambda p: int(indexed.row_slots[p])  # noqa: E731
    sign = 1.0 if is_max else -1.0
    seven = torch.nonzero(tsk.plan_rows(plan, plan.counts.numel()) == 7)[:, 0]
    data[seven, :4] = -sign * torch.rand(len(seven), 4, generator=g) - sign  # the losing side of 0
    data[[slot(cut[1] - 1), slot(cut[1])], 0] = 9.0 * sign
    data[[slot(cut[2] + 5), slot(cut[4]), slot(cut[6] + 1)], 1] = 9.0 * sign
    data[slot(start), 2] = -0.0
    data[[slot(cut[3]), slot(cut[5])], 2] = 0.0
    data[slot(cut[4]), 3] = 9.0 * sign
    data = data.to(dtype)
    neutral = {torch.float32: 3.0e38, torch.bfloat16: torch.finfo(torch.bfloat16).max}[dtype] * -sign
    data = torch.where(mask[:, None], data, torch.full((), neutral, dtype=dtype))
    without_nan = data.clone()
    data[slot(cut[1]), 3] = float("nan")
    without_nan[slot(cut[1]), 3] = neutral
    winners = {0: slot(cut[1] - 1), 1: slot(cut[2] + 5), 2: slot(start), 3: slot(cut[4])}
    return data, without_nan, winners


@pytest.mark.parametrize("m", [40, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_argmax_extremum_kernel_splits_a_hub_row(cuda_device, reduction, dtype, m):
    """Node 7 with 4,396 slots over many tiles: its pieces' (value, slot)
    partials folded in piece order with a strict compare. Ties across the
    piece boundaries go to the first slot, -0.0 keeps its earlier slot and
    reads +0.0, a NaN never wins; values bitwise and slots exactly equal to
    the plain version, the same bits on a second run."""
    plan, mask = make_plan(m + 11, 128, 512, hub=4096)
    is_max = reduction == "max"
    data, without_nan, winners = _hub_ties(plan, mask, m, dtype, is_max, seed=m + 11)
    vals, args = tsk.planned_segment_extremum_with_argmax(without_nan, plan, 450, is_max)
    cplan = tree_to(plan, cuda_device)
    cdata = data.to(cuda_device)
    before = tracing.counter("segment_extremum_argmax")
    runs = [tsk.planned_segment_extremum_with_argmax(cdata, cplan, 450, is_max) for _ in range(2)]
    torch.cuda.synchronize()
    assert tracing.counter("segment_extremum_argmax") == before + 2
    for got_vals, got_args in runs:
        np.testing.assert_array_equal(got_args.cpu().numpy(), args.numpy())
        np.testing.assert_array_equal(_bits(got_vals), _bits(vals))
    for column, slot in winners.items():
        assert int(runs[0][1][7, column]) == slot, column
    assert _bits(runs[0][0])[7, 2] == 0  # +0.0


def _broadcast_width(d, dtype):
    """The main path's widths (64, 128 and the widened backward tables 192
    and 256) and an odd one: 67 columns of 4 bytes, 65 of 2 (rows that are
    not whole 16-byte vectors: the kernel's narrow route)."""
    if d != "odd":
        return d
    return 67 if dtype.itemsize == 4 else 65


def _launch_broadcast(table, cplan, times=1):
    """The kernel on ``table`` (on the card), with its launch count and its
    tally by (row bytes, dtype) checked."""
    key = (table.shape[1] * table.element_size(), str(table.dtype).removeprefix("torch."))
    before = tracing.counter("broadcast_to_edges")
    before_width = tracing.tally("broadcast_to_edges").get(key, 0)
    got = tsk.planned_broadcast_to_edges(table, cplan)
    torch.cuda.synchronize()
    assert tracing.counter("broadcast_to_edges") == before + 1
    assert tracing.tally("broadcast_to_edges")[key] == before_width + 1
    return got


@pytest.mark.parametrize("tile", [32, 128, 512])
@pytest.mark.parametrize("d", [64, 128, 192, 256, "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_broadcast_kernel_matches_plain_bitwise(cuda_device, dtype, d, tile):
    """A table of 500 rows, shorter than the plan's 512: 0 at sentinel
    slots and at rows past the table."""
    d = _broadcast_width(d, dtype)
    plan, _ = make_plan(d + tile, tile, tile)
    table = torch.randn(500, d, generator=torch.Generator().manual_seed(d)).to(dtype)
    plain = tsk.planned_broadcast_to_edges(table, plan)
    got = _launch_broadcast(table.to(cuda_device), tree_to(plan, cuda_device))
    np.testing.assert_array_equal(_bits(got), _bits(plain))


@pytest.mark.parametrize("d", [64, 256, "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_broadcast_kernel_zeroes_sentinel_tiles_and_rows_past_a_short_table(cuda_device, dtype, d):
    """A table of 100 rows under a plan of 512 (most slots' rows lie past
    it), one tile all sentinels and one whose row block lies wholly past the
    table: bitwise the plain version, those tiles 0."""
    d = _broadcast_width(d, dtype)
    tile = 128
    plan, _ = make_plan(d + 1, tile, tile)
    local_rows, trb = plan.local_rows.clone(), plan.tile_row_blocks.clone()
    local_rows[:tile] = R  # tile 0: every slot a sentinel
    trb[1] = plan.counts.shape[0] - 1  # tile 1: rows 384-511
    plan = plan._replace(local_rows=local_rows, tile_row_blocks=trb)
    table = torch.randn(100, d, generator=torch.Generator().manual_seed(d)).to(dtype)
    plain = tsk.planned_broadcast_to_edges(table, plan)
    got = _launch_broadcast(table.to(cuda_device), tree_to(plan, cuda_device))
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    assert not got[:2 * tile].float().any()
    assert got[2 * tile:].float().any()


@pytest.mark.parametrize("d", [64, 192, "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_broadcast_kernel_takes_misaligned_and_strided_tables(cuda_device, dtype, d):
    """A contiguous table view one element past a 16-byte boundary (the
    narrow route, no padded copy) and a view with a row stride wider than
    its rows (made contiguous): bitwise the plain version."""
    d = _broadcast_width(d, dtype)
    plan, _ = make_plan(d + 2, 128, 512)
    cplan = tree_to(plan, cuda_device)
    g = torch.Generator().manual_seed(d + 2)
    flat = torch.randn(500 * d + 1, generator=g).to(dtype).to(cuda_device)
    shifted = flat[1:].view(500, d)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    wide = torch.randn(500, d + 3, generator=g).to(dtype).to(cuda_device)
    strided = wide[:, 1:d + 1]
    assert not strided.is_contiguous()
    for table in (shifted, strided):
        got = _launch_broadcast(table, cplan)
        np.testing.assert_array_equal(_bits(got), _bits(tsk.planned_broadcast_to_edges(table.cpu(), plan)))


@pytest.mark.parametrize("d", [64, 256, "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_broadcast_kernel_replays_in_a_cuda_graph_bitwise(cuda_device, dtype, d):
    """Captured on one table and replayed on another: the bits of the plain
    version on the second, and of an eager call."""
    d = _broadcast_width(d, dtype)
    plan, _ = make_plan(d + 3, 128, 512)
    cplan = tree_to(plan, cuda_device)
    g = torch.Generator().manual_seed(d + 3)
    first, second = (torch.randn(500, d, generator=g).to(dtype) for _ in range(2))
    captured, eager = _graph_replays(lambda t: tsk.planned_broadcast_to_edges(t, cplan), first.to(cuda_device),
                                     second.to(cuda_device))
    np.testing.assert_array_equal(_bits(captured), _bits(tsk.planned_broadcast_to_edges(second, plan)))
    np.testing.assert_array_equal(_bits(captured), _bits(eager))


def supertile_plan(plan, tile, align):
    """The same slots viewed at supertile granularity (as the sum runs)."""
    trb = plan.tile_row_blocks.reshape(-1, align // tile)[:, 0].contiguous()
    return tsk.AggregationPlan(plan.local_rows, trb, plan.counts)


def _short_rows(plan, num_nodes):
    """Rows of at most ROW_CHUNK slots: the kernel adds them in slot order,
    as index_add_ does on the CPU."""
    counts = torch.bincount(tsk.plan_rows(plan, plan.counts.numel()), minlength=plan.counts.numel() + 1)
    return counts[:num_nodes] <= tsk.ROW_CHUNK


@pytest.mark.parametrize("tile,align", [(32, 128), (128, 512)])
@pytest.mark.parametrize("d", [1, 40, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_kernel_matches_plain_and_is_deterministic(cuda_device, dtype, d, tile, align):
    """Bitwise equal to the CPU's plain version on every row of at most
    ROW_CHUNK slots; on the split row 7 a float32 sum in another order,
    within 1e-5 of its sum of |x|; the same bits on every run."""
    plan, mask = make_plan(d + tile, tile, align)
    plan = supertile_plan(plan, tile, align)
    cplan = tree_to(plan, cuda_device)
    g = torch.Generator().manual_seed(d)
    data = torch.randn(plan.local_rows.shape[0], d, generator=g).to(dtype)
    data = torch.where(mask[:, None], data, torch.zeros((), dtype=dtype))
    plain = tsk.planned_segment_sum(data, plan, 450)
    before = tracing.counter("segment_sum")
    got = tsk.planned_segment_sum(data.to(cuda_device), cplan, 450)
    again = tsk.planned_segment_sum(data.to(cuda_device), cplan, 450)
    torch.cuda.synchronize()
    assert tracing.counter("segment_sum") == before + 2
    assert got.dtype == torch.float32 and tuple(got.shape) == (450, d)
    short = _short_rows(plan, 450)
    assert not bool(short[7])
    np.testing.assert_array_equal(_bits(got[short.to(cuda_device)]), _bits(plain[short]))
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


@pytest.mark.parametrize("d", [1, 40, 64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_kernel_splits_a_hub_row(cuda_device, dtype, d):
    """Node 7 with 4,396 slots: its pieces added in piece order, within 1e-5
    of its sum of |x| and the same bits on every run; every other row
    bitwise equal to the CPU's; exact on 0/1 data."""
    plan, mask = make_plan(d + 5, 128, 512, hub=4096)
    plan = supertile_plan(plan, 128, 512)
    cplan = tree_to(plan, cuda_device)
    g = torch.Generator().manual_seed(d + 5)
    data = torch.where(mask[:, None], torch.randn(plan.local_rows.shape[0], d, generator=g), 0.0).to(dtype)
    plain = tsk.planned_segment_sum(data, plan, 450)
    before = tracing.counter("segment_sum")
    runs = [tsk.planned_segment_sum(data.to(cuda_device), cplan, 450) for _ in range(2)]
    torch.cuda.synchronize()
    assert tracing.counter("segment_sum") == before + 2
    short = _short_rows(plan, 450)
    assert int(short.logical_not().sum()) == 1
    np.testing.assert_array_equal(_bits(runs[0][short.to(cuda_device)]), _bits(plain[short]))
    bound = 1e-5 * tsk.planned_segment_sum(data.abs(), plan, 450)
    assert bool(((runs[0].cpu() - plain).abs() <= bound).all())
    np.testing.assert_array_equal(_bits(runs[0]), _bits(runs[1]))
    ones = (torch.rand(data.shape, generator=g) < 0.5).to(dtype) * mask[:, None].to(dtype)
    np.testing.assert_array_equal(_bits(tsk.planned_segment_sum(ones.to(cuda_device), cplan, 450)),
                                  _bits(tsk.planned_segment_sum(ones, plan, 450)))


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_sum_and_mean_reduce_run_the_kernel_on_cuda(cuda_device, reduction):
    plan, mask = make_plan(5, 128, 512)
    plan = supertile_plan(plan, 128, 512)
    data = torch.randn(plan.local_rows.shape[0], 64, generator=torch.Generator().manual_seed(1))
    plain = tsk.planned_segment_reduce(data, plan, 450, reduction, mask)
    cplan = tree_to(plan, cuda_device)
    got = tsk.planned_segment_reduce(data.to(cuda_device), cplan, 450, reduction, mask.to(cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


def _layers_batch(max_nodes=512):
    """A small Graph2Class batch: its adjacency on the CPU, the live mask
    with two real nodes emptied, and those nodes."""
    _, _, mbs = build_graph2class(padding=small_padding(max_nodes=max_nodes), hidden_state_size=16,
                                  num_minibatches=1, device="cpu")
    adj = tree_to(mbs[0]["batch"].adjacency, torch.device("cpu"))
    live = adj.receivers[adj.mask]
    emptied = torch.unique(live)[[2, 40]]
    g = torch.Generator().manual_seed(0)
    mask = adj.mask & (torch.rand(adj.mask.shape, generator=g) >= 0.2) & ~torch.isin(adj.receivers, emptied)
    return adj, mask, emptied


@pytest.mark.parametrize("shape", [(4, 2, 8), (1,), (64,)])
@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("reduction", ["sum", "mean", "max", "min"])
def test_reduce_on_nd_messages_and_a_non_static_mask_matches_plain(cuda_device, reduction, static, shape):
    """adjacency_segment_reduce on [E, 4, 2, 8] (EGC's N-D messages), [E, 1]
    and [E, 64] slot data, under the static mask and under one with emptied
    rows (a mean then counts its live slots with the sum kernel at width 1):
    the card's forward bitwise equal to the plain version's on the CPU, its
    gradient (the broadcast, the sum) within 1e-6, emptied rows 0, and the
    launches the code gives."""
    adj, live, emptied = _layers_batch()
    mask = adj.mask if static else live
    n = adj.agg_counts.numel()
    g = torch.Generator().manual_seed(len(shape))
    data = torch.randn((adj.mask.shape[0],) + shape, generator=g)
    cot = torch.randn((n,) + shape, generator=g)
    x = data.clone().requires_grad_()
    plain = tsk.adjacency_segment_reduce(x, adj, n, reduction, mask=mask, counts_exact=static)
    (plain * cot).sum().backward()
    cadj = tree_to(adj, cuda_device)
    cx = data.to(cuda_device).requires_grad_()
    tsk.reset_launch_counts()
    got = tsk.adjacency_segment_reduce(cx, cadj, n, reduction, mask=mask.to(cuda_device), counts_exact=static)
    forward = tsk.launch_counts()
    (got * cot.to(cuda_device)).sum().backward()
    torch.cuda.synchronize()
    backward = {k: v - forward[k] for k, v in tsk.launch_counts().items()}
    assert got.shape == (n,) + shape
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    torch.testing.assert_close(cx.grad.cpu(), x.grad, rtol=1e-6, atol=1e-6)
    if not static:
        assert not got[emptied.to(cuda_device)].any()
    is_sum = reduction in ("sum", "mean")
    counting = reduction == "mean" and not static
    assert forward["segment_sum"] == int(is_sum) + int(counting)
    assert forward["segment_extremum"] == int(not is_sum)
    assert backward["broadcast_to_edges"] == (1 if is_sum else 2)
    assert backward["segment_sum"] == (0 if is_sum else 1)


def test_pna_layer_on_card_matches_cpu_with_emptied_nodes(cuda_device):
    """An MLP-MP layer with a hidden layer and PNA aggregation at width 64
    under a mask that empties two real nodes: the forward runs K1 twice and
    K2 twice (K1 at width 1 once more for the live in-degrees), the backward
    K3 and K1 (K1 also for the backward of the gathers: the senders, the
    receivers, the two weight stacks, PNA's means); outputs and gradients finite and within rtol 1e-4 and 1e-4 of
    each tensor's largest magnitude of the CPU's."""
    from ptgnn_tpu_torch.graph.messagepassing import GraphContext, MlpMessagePassingLayer, PnaMessageAggregation
    from ptgnn_tpu_torch.nn.module import init_parameters

    adj, live, emptied = _layers_batch()
    n = adj.agg_counts.numel()
    num_types = int(adj.tile_types.max()) + 1
    outs, grads = [], []
    for device in (torch.device("cpu"), cuda_device):
        layer = MlpMessagePassingLayer(64, 64, 64, num_types, PnaMessageAggregation(), mlp_hidden_layers=1)
        init_parameters(layer, 0)
        layer.to(device)
        ctx = GraphContext(adjacency=tree_to(adj._replace(mask=live), device), node_graph=None, node_mask=None,
                           graph_mask=None, references={}, edge_mask_is_static=False)
        x = torch.randn(n, 64, generator=torch.Generator().manual_seed(1)).to(device).requires_grad_()
        tsk.reset_launch_counts()
        out = layer(x, ctx)
        forward = tsk.launch_counts()
        out.square().sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert forward["segment_sum"] == 3 and forward["segment_extremum"] == 2
            assert tsk.launch_counts()["broadcast_to_edges"] == 6 and tsk.launch_counts()["segment_sum"] == 10
        outs.append(out.detach().cpu())
        grads.append([x.grad.cpu()] + [p.grad.cpu() for p in layer.parameters()])
    assert torch.isfinite(outs[1]).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4 * float(outs[0].abs().max()))
    for got, want in zip(grads[1], grads[0]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


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
    assert counts == {"segment_extremum": 8, "segment_extremum_argmax": 0, "broadcast_to_edges": 8,
                      "segment_sum": 0, "typed_matmul": 0, "typed_dw": 0, "keyed_dropout": 0,
                      "keyed_dropout_elements": 0}
    # rtol 1e-4 and 1e-4 of the logit scale: float32 rounding differs
    # between the card's and the CPU's matmuls and transcendentals.
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=1e-4 * np.abs(cpu).max())


@pytest.mark.parametrize("amp", [False, True])
def test_graph2class_train_step_on_card_matches_cpu(cuda_device, amp):
    """float32: the loss to rtol 1e-5, every gradient to rtol 1e-4 and 1e-4 of
    its tensor's largest magnitude. bf16 AMP: the step runs through the same
    kernels, the 8 MP layers' dW through the typed dW (K6), and gives a
    finite loss and float32 gradients."""
    kw = dict(padding=small_padding(max_nodes=256), hidden_state_size=64, num_minibatches=1, dropout_rate=0.0)
    _, gpu_module, mbs = build_graph2class(device=cuda_device, **kw)
    _, cpu_module, _ = build_graph2class(device="cpu", **kw)
    tsk.reset_launch_counts()
    loss, _ = module_loss(gpu_module, tree_to(mbs[0], cuda_device), train=True,
                          generator=torch.Generator(device=cuda_device), amp=amp)
    loss.backward()
    torch.cuda.synchronize()
    assert tsk.launch_counts() == {"segment_extremum": 8, "segment_extremum_argmax": 0, "broadcast_to_edges": 24,
                                   "segment_sum": 17, "typed_matmul": 0, "typed_dw": 8 if amp else 0,
                                   "keyed_dropout": 0, "keyed_dropout_elements": 0}
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


@pytest.mark.parametrize("architecture,argmax_routing,per_step", [
    ("mlp", True, {"segment_extremum": 0, "segment_extremum_argmax": 8, "broadcast_to_edges": 16,
                   "segment_sum": 9, "typed_matmul": 0, "typed_dw": 0, "keyed_dropout": 0,
                   "keyed_dropout_elements": 0}),
    ("ggnn", False, {"segment_extremum": 8, "segment_extremum_argmax": 0, "broadcast_to_edges": 16,
                     "segment_sum": 17, "typed_matmul": 0, "typed_dw": 0, "keyed_dropout": 0,
                     "keyed_dropout_elements": 0}),
    ("ggnn", True, {"segment_extremum": 0, "segment_extremum_argmax": 8, "broadcast_to_edges": 8,
                    "segment_sum": 9, "typed_matmul": 0, "typed_dw": 0, "keyed_dropout": 0,
                    "keyed_dropout_elements": 0}),
])
def test_graph2class_paths_train_on_card_as_on_cpu(cuda_device, architecture, argmax_routing, per_step):
    """A train step of the argmax-routed and the GGNN paths: the launches the
    code gives, the loss to rtol 1e-5 and every gradient within 1e-2 of its
    norm (a near-tie that the devices' few-ulp differences order differently
    moves a single winner's gradient wholesale)."""
    kw = dict(padding=small_padding(max_nodes=256), hidden_state_size=64, num_minibatches=1, dropout_rate=0.0,
              architecture=architecture, argmax_routing=argmax_routing)
    _, gpu_module, mbs = build_graph2class(device=cuda_device, **kw)
    _, cpu_module, _ = build_graph2class(device="cpu", **kw)
    tsk.reset_launch_counts()
    loss, _ = module_loss(gpu_module, tree_to(mbs[0], cuda_device), train=True,
                          generator=torch.Generator(device=cuda_device))
    loss.backward()
    torch.cuda.synchronize()
    assert tsk.launch_counts() == per_step
    cpu_loss, _ = module_loss(cpu_module, tree_to(mbs[0], torch.device("cpu")), train=True,
                              generator=torch.Generator())
    cpu_loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(cpu_loss.detach()), rtol=1e-5)
    for (name, g), c in zip(gpu_module.named_parameters(), cpu_module.parameters()):
        assert float((g.grad.cpu() - c.grad).norm()) <= 1e-2 * float(c.grad.norm()), name


@pytest.mark.parametrize("architecture", ["mlp", "ggnn", "layers"])
def test_edge_dropout_on_card_leaves_the_fused_op(cuda_device, architecture, monkeypatch):
    """Each Graph2Class stack with edge dropout 0.3 on the card: a train step
    reaches the fused op no time and launches the per-slot route's kernels
    (the extremum, the sum, the broadcast), with a finite loss and finite
    gradients. Then the stack under one mask that empties two real nodes on
    the card and on the CPU: the value to rtol 1e-5 and every gradient within
    1e-2 of its norm (a near-tie that the devices order differently moves a
    max's gradient wholesale, as in the paths' steps above)."""
    from ptgnn_tpu_torch.graph.messagepassing import GraphContext
    from ptgnn_tpu_torch.graph.messagepassing import base

    calls = []
    real = base.fused_typed_message_aggregation
    monkeypatch.setattr(base, "fused_typed_message_aggregation", lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(padding=small_padding(max_nodes=512), hidden_state_size=64, num_minibatches=1, dropout_rate=0.0,
              architecture=architecture)
    _, gpu_module, mbs = build_graph2class(device=cuda_device, **kw)
    gpu_module.gnn.edge_dropout_rate = 0.3
    tsk.reset_launch_counts()
    loss, _ = module_loss(gpu_module, tree_to(mbs[0], cuda_device), train=True,
                          generator=torch.Generator(device=cuda_device).manual_seed(0))
    loss.backward()
    torch.cuda.synchronize()
    counts = tsk.launch_counts()
    assert not calls
    assert min(counts[k] for k in ("segment_extremum", "segment_sum", "broadcast_to_edges")) > 0, counts
    assert np.isfinite(float(loss.detach()))
    assert all(bool(torch.isfinite(p.grad).all()) for p in gpu_module.parameters() if p.grad is not None)

    adj, live, _ = _layers_batch()
    batch = mbs[0]["batch"]
    assert torch.equal(adj.receivers, torch.as_tensor(batch.adjacency.receivers).cpu())
    n = batch.node_graph.shape[0]
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn(n, gpu_module.gnn.input_node_state_dim, generator=g)
    cot = torch.randn(n, gpu_module.gnn.output_node_state_dim, generator=g)
    _, cpu_module, _ = build_graph2class(device="cpu", **kw)
    results = []
    for module, device in ((gpu_module, cuda_device), (cpu_module, torch.device("cpu"))):
        module.load_state_dict(cpu_module.state_dict())
        module.zero_grad(set_to_none=True)
        b = tree_to(batch, device)
        ctx = GraphContext(adjacency=b.adjacency._replace(mask=live.to(device)), node_graph=b.node_graph,
                           node_mask=b.node_mask, graph_mask=b.graph_mask, references=b.references,
                           edge_mask_is_static=False, att_order=b.att_order)
        x = x0.to(device).requires_grad_()
        value = (module.gnn.gnn(x, ctx) * cot.to(device)).sum()
        value.backward()
        results.append((float(value.detach()), [x.grad.cpu()] + [p.grad.cpu() for p in module.parameters()
                                                                   if p.grad is not None]))
    assert not calls
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-5)
    assert len(results[0][1]) == len(results[1][1])
    for got, want in zip(results[0][1], results[1][1]):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).norm()) <= 1e-2 * float(want.norm())


@pytest.mark.parametrize("use_target_state", [True, False])
@pytest.mark.parametrize("reduction,argmax_routing", [
    ("max", False), ("min", False), ("sum", False), ("mean", False), ("max", True), ("min", True),
])
def test_fused_backward_on_card_matches_cpu(cuda_device, reduction, argmax_routing, use_target_state):
    """The fused op's gradients through the kernels against the plain
    versions, every reduction (mean's widened table has an odd width, which
    the broadcast pads), both routings of max/min: rtol/atol 1e-5, float32
    sums in another order."""
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
                                              use_target_state, argmax_routing=argmax_routing)
        (out * cot.to(device)).sum().backward()
        grads.append((out.detach().cpu(), x.grad.cpu(), w.grad.cpu()))
    torch.cuda.synchronize()
    for cpu, card in zip(*grads):
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), rtol=1e-5, atol=1e-5)
    # bf16: the card's dW is the typed dW (K6), launched once, on the
    # backward's own operands; held to the float64 product of those
    # operands within its float32 bound (the two devices' bf16 messages may
    # pick other extrema, so the CPU's dW is no yardstick here).
    seen = []
    real = fused_mp.typed_weight_gradient
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_mp, "typed_weight_gradient", lambda *a: seen.append(a) or real(*a))
        before = tracing.counter("typed_dw")
        x = states.clone().to(cuda_device).bfloat16().requires_grad_()
        w = weights.clone().to(cuda_device).requires_grad_()
        out = fused_typed_message_aggregation(x, w, batch.to(cuda_device).adjacency, pad["max_nodes"], reduction,
                                              use_target_state, argmax_routing=argmax_routing)
        (out.float() * cot.to(cuda_device)).sum().backward()
        torch.cuda.synchronize()
    assert tracing.counter("typed_dw") == before + 1 and len(seen) == 1
    inp, d_msgs, tile_types, tile, num_types = seen[0]
    ref, bound = _typed_dw_reference(inp, d_msgs, tile_types, tile, num_types)
    assert bool(((w.grad.double() - ref).abs() <= bound).all())


# (tiles, tile, D, M, types): PPI's widths, and a whole PPI batch's 960
# tiles; rows and columns that fill no whole CTA block, with a depth that
# ends mid-chunk; a tile of 32; M = 384, two column passes of the bf16
# kernel. _typed_inputs gives the last tile a type out of range.
TYPED_SHAPES = [(40, 128, 512, 256, 3), (30, 48, 72, 40, 4), (960, 128, 512, 256, 3), (50, 32, 128, 64, 3),
                (20, 128, 256, 384, 3)]


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
    before = tracing.counter("typed_matmul")
    got = ttl.typed_matmul_kernel(x, w, tt, tile)
    torch.cuda.synchronize()
    assert tracing.counter("typed_matmul") == before + 1 and got.dtype == dtype
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


def _graph_replays(fn, static_input, new_input):
    """fn on new_input replayed from a CUDA graph captured on static_input,
    and fn run eagerly on new_input."""
    fn(static_input)  # warm-up: builds, opts in, grows scratch before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn(static_input)
    static_input.copy_(new_input)
    graph.replay()
    torch.cuda.synchronize()
    return captured, fn(new_input)


def test_kernels_replay_in_a_cuda_graph(cuda_device):
    """The argmax extremum (a split hub row) and the typed matmul (bf16
    and float32; its tensor maps are built on the host at every call, so the
    capture bakes valid ones) replayed from a CUDA graph on new inputs give
    the bits they give eagerly."""
    plan, mask = make_plan(17, 128, 512, hub=4096)
    cplan = tree_to(tsk.with_row_index(plan), cuda_device)  # the index is computed before the capture
    first, _, _ = _hub_ties(plan, mask, 64, torch.float32, True, seed=1)
    second, _, _ = _hub_ties(plan, mask, 64, torch.float32, True, seed=2)
    (cv, ca), (ev, ea) = _graph_replays(
        lambda d: tsk.planned_segment_extremum_with_argmax(d, cplan, 450, True),
        first.to(cuda_device), second.to(cuda_device))
    np.testing.assert_array_equal(_bits(cv), _bits(ev))
    assert torch.equal(ca, ea)
    for dtype in (torch.bfloat16, torch.float32):
        x, w, tt = _typed_inputs(TYPED_SHAPES[0], dtype, cuda_device, seed=5)
        x2, _, _ = _typed_inputs(TYPED_SHAPES[0], dtype, cuda_device, seed=6)
        captured, eager = _graph_replays(lambda a: ttl.typed_matmul_kernel(a, w, tt, 128), x.clone(), x2)
        assert torch.equal(_bits_t(captured), _bits_t(eager)), dtype


def test_typed_matmul_gradient_on_card_matches_cpu(cuda_device):
    """The custom VJP through the kernel against the plain version: the
    output and dx, bf16 roundings of float32 sums taken in other orders,
    within one bf16 ulp (at most 2^-7 of the value) plus 1e-5 of the
    element's sum of |a||b|, where cancellation leaves a tiny result; dW (float32
    products of bf16 values) to rtol 1e-5 and 1e-5 of its largest
    magnitude. The card's dW runs the typed dW (K6)."""
    x, w, tt = _typed_inputs(TYPED_SHAPES[0], torch.bfloat16, "cpu", seed=3)
    w = w.float()
    dy = torch.randn(x.shape[0], w.shape[2], generator=torch.Generator().manual_seed(4)).bfloat16()
    results = []
    before = tracing.counter("typed_dw")
    for device in ("cpu", cuda_device):
        xd = x.to(device).clone().requires_grad_()
        wd = w.to(device).clone().requires_grad_()
        y = ttl._TypedMatmul.apply(xd, wd, tt.to(device), 128)
        y.backward(dy.to(device))
        results.append([t.detach().float().cpu() for t in (y, xd.grad, wd.grad)])
        if device == cuda_device:
            assert tracing.counter("typed_dw") == before + 1  # the card's dW is the typed dW (K6)
        before = tracing.counter("typed_dw")
    _, scale_y = _typed_reference(x, w.bfloat16(), tt, 128)
    _, scale_dx = _typed_reference(dy, w.bfloat16().transpose(1, 2), tt, 128)
    for name, cpu, card, scale in zip(("y", "dx"), results[0][:2], results[1][:2], (scale_y, scale_dx)):
        assert bool(((card - cpu).abs() <= 2.0 ** -7 * cpu.abs() + 1e-5 * scale.float()).all()), name
    dw_cpu, dw_card = results[0][2], results[1][2]
    np.testing.assert_allclose(dw_card.numpy(), dw_cpu.numpy(), rtol=1e-5, atol=1e-5 * float(dw_cpu.abs().max()))


# (tiles, tile, Din, M, types) of the typed dW (K6): PPI's whole batch;
# Din and M of 128, 256 and 512 on tiles of 128 and of 48 (not a multiple
# of the kernel's 64-row box); M = 384 (two column blocks); Graph2Class's 17
# types. _typed_dw_inputs draws ragged type shares (type t with weight
# 2^-t, so the rarest may draw no tile), leaves type 1 without a tile where
# there are 4 types or more, gives the last tile a type out of range, and
# reads g as a row-strided view.
TYPED_DW_SHAPES = [(960, 128, 512, 256, 3), (30, 128, 128, 128, 3), (30, 128, 256, 512, 4), (30, 128, 512, 128, 4),
                   (40, 48, 128, 256, 5), (40, 48, 512, 512, 3), (20, 128, 256, 384, 5), (384, 128, 128, 64, 17)]


def _typed_dw_inputs(shape, device, seed=0):
    nt, tile, din, m, num_types = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(nt * tile, din, generator=g).bfloat16()
    dy = torch.randn(nt * tile, m + 8, generator=g).bfloat16()
    weights = torch.tensor([2.0 ** -t for t in range(num_types)])
    if num_types >= 4:
        weights[1] = 0.0
    tt = torch.multinomial(weights, nt, replacement=True, generator=g).int()
    tt[-1] = num_types
    return x.to(device), dy.to(device)[:, :m], tt.to(device)


def _typed_dw_reference(x, g, tt, tile, num_types):
    """The float64 dW of each type and each element's bound: a float32 sum of
    n terms in any order lies within (n - 1) 2^-24 of the sum of their
    magnitudes; the kernel chains at most n / 16 accumulator adds (a wgmma
    step adds 16 rows, up to 16 more inside one), then its chunks'
    partials (at most n / tile), so (n / 16 + n / tile + 64) 2^-24 sum|x||g|
    bounds it, with n the type's slots (up to 122,880 at PPI's shape)."""
    rows = tt.long().repeat_interleave(tile)
    refs, bounds = [], []
    for t in range(num_types):
        sel = torch.nonzero(rows == t)[:, 0]
        xs, gs = x.index_select(0, sel).double(), g.index_select(0, sel).double()
        n = sel.numel()
        refs.append(xs.T @ gs)
        bounds.append((n / 16 + n / tile + 64) * 2.0 ** -24 * (xs.abs().T @ gs.abs()))
    return torch.stack(refs), torch.stack(bounds)


@pytest.mark.parametrize("shape", TYPED_DW_SHAPES)
def test_typed_dw_kernel_matches_float64(cuda_device, shape):
    """K6 against the float64 product of the same bf16 operands, within the
    float32 bound of ``_typed_dw_reference`` (its plain version, float32
    products that chain up to n adds, within 16 times that bound); zeros
    for a type with no tile."""
    x, dy, tt = _typed_dw_inputs(shape, cuda_device)
    tile, num_types = shape[1], shape[4]
    before = tracing.counter("typed_dw")
    got = ttl.typed_dw_kernel(x, dy, tt, tile, num_types)
    torch.cuda.synchronize()
    assert tracing.counter("typed_dw") == before + 1
    assert got.dtype == torch.float32 and got.shape == (num_types, shape[2], shape[3])
    ref, bound = _typed_dw_reference(x, dy, tt, tile, num_types)
    assert bool(((got.double() - ref).abs() <= bound).all())
    assert bool(((ttl.typed_weight_gradient_plain(x, dy, tt, tile, num_types).double() - ref).abs()
                 <= 16 * bound).all())
    empty = [t for t in range(num_types) if not bool((tt == t).any())]
    assert (1 in empty) == (num_types >= 4) and not any(bool(got[t].any()) for t in empty)


@pytest.mark.parametrize("shape", TYPED_DW_SHAPES[:2])
def test_typed_dw_kernel_bits_repeat_and_replay(cuda_device, shape):
    """The same bits on a second call, from the row-strided g and from its
    contiguous copy, and replayed from a CUDA graph on new inputs as run
    eagerly."""
    x, dy, tt = _typed_dw_inputs(shape, cuda_device, seed=1)
    tile, num_types = shape[1], shape[4]
    first = ttl.typed_dw_kernel(x, dy, tt, tile, num_types)
    assert torch.equal(_bits_t(first), _bits_t(ttl.typed_dw_kernel(x, dy, tt, tile, num_types)))
    assert torch.equal(_bits_t(first), _bits_t(ttl.typed_dw_kernel(x, dy.contiguous(), tt, tile, num_types)))
    x2, dy2, _ = _typed_dw_inputs(shape, cuda_device, seed=2)
    both, both2 = torch.cat([x, dy], dim=1), torch.cat([x2, dy2], dim=1)
    d = shape[2]
    captured, eager = _graph_replays(lambda a: ttl.typed_dw_kernel(a[:, :d], a[:, d:], tt, tile, num_types),
                                     both.clone(), both2)
    assert torch.equal(_bits_t(captured), _bits_t(eager))


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
    norm of the CPU's plain route. The five dW products go through the typed
    dW (K6) under AMP."""
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
    assert tsk.launch_counts() == {"segment_extremum": 0, "segment_extremum_argmax": 0, "broadcast_to_edges": 10,
                                   "segment_sum": 10, "typed_matmul": 15 if amp else 0,
                                   "typed_dw": 5 if amp else 0,
                                   "keyed_dropout": 0, "keyed_dropout_elements": 0}
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


def _graph2seq_small(device):
    pad = BatchPadding(max_nodes=1024, max_edge_slots=1024 * 8, max_graphs=8, edge_tile=64,
                       reference_budgets=(("backbone_nodes", 1024),))
    samples = list(synthetic_graph2seq_samples(8, seed=3, mean_nodes=100, max_nodes=250))
    return build_graph2seq(padding=pad, samples=samples, embedding_size=128, device=device, minibatch_size=8)


@pytest.mark.parametrize("kernel", ["segment_sum", "broadcast_to_edges"])
def test_kernels_on_a_graph2seq_layout_match_plain(cuda_device, kernel):
    """K1 and K3 at Graph2Seq's width 128 on one of its batch layouts (8
    materialized edge types, a tile of 64): the sum bitwise equal to its
    plain version on the CPU (no row here exceeds ROW_CHUNK), the broadcast
    bitwise equal to its plain version."""
    _, _, mbs = _graph2seq_small("cpu")
    adj = mbs[0]["batch"].adjacency
    plan = tsk.sum_plan_from_adjacency(tree_to(adj, torch.device("cpu")))
    num_nodes = adj.agg_counts.shape[0] * adj.agg_counts.shape[1]
    g = torch.Generator().manual_seed(11)
    if kernel == "segment_sum":
        mask = torch.from_numpy(adj.mask)
        data = torch.where(mask[:, None], torch.randn(mask.shape[0], 128, generator=g), 0.0)
        want = tsk.planned_segment_sum(data, plan, num_nodes)
        got = tsk.planned_segment_sum(data.to(cuda_device), tree_to(plan, cuda_device), num_nodes)
    else:
        table = torch.randn(num_nodes, 128, generator=g)
        want = tsk.planned_broadcast_to_edges(table, plan)
        got = tsk.planned_broadcast_to_edges(table.to(cuda_device), tree_to(plan, cuda_device))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_graph2seq_train_step_on_card_matches_cpu(cuda_device):
    """A Graph2Seq train step (dropout 0) at width 128: 16 sum and 8
    broadcast launches of the 8 gated positions and 18 sum launches of
    ops/segment.py's sums (the summariser's and the decoder's, over sorted
    ids, and the backward of its gathers), the loss to rtol 1e-5, every gradient to rtol 1e-4 and 1e-4 of its
    tensor's largest magnitude."""
    _, gpu_module, mbs = _graph2seq_small(cuda_device)
    _, cpu_module, _ = _graph2seq_small("cpu")
    for m in (gpu_module, cpu_module):
        for sub in m.modules():
            if hasattr(sub, "dropout_rate"):
                sub.dropout_rate = 0.0
    tsk.reset_launch_counts()
    loss, _ = module_loss(gpu_module, tree_to(mbs[0], cuda_device), train=True,
                          generator=torch.Generator(device=cuda_device))
    loss.backward()
    torch.cuda.synchronize()
    assert tsk.launch_counts() == {"segment_extremum": 0, "segment_extremum_argmax": 0, "broadcast_to_edges": 8,
                                   "segment_sum": 16 + 18, "typed_matmul": 0, "typed_dw": 0,
                                   "keyed_dropout": 0, "keyed_dropout_elements": 0}
    cpu_loss, _ = module_loss(cpu_module, tree_to(mbs[0], torch.device("cpu")), train=True,
                              generator=torch.Generator())
    cpu_loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(cpu_loss.detach()), rtol=1e-5)
    for (name, g), c in zip(gpu_module.named_parameters(), cpu_module.parameters()):
        c = c.grad.numpy()
        np.testing.assert_allclose(g.grad.cpu().numpy(), c, rtol=1e-4, atol=1e-4 * np.abs(c).max(), err_msg=name)


def _edge_feature_small(device, gated):
    from ptgnn_tpu_torch.implementations.ppi.harness import build_edge_feature_gnn, synthetic_edge_feature_graphs

    pad = BatchPadding(max_nodes=512, max_edge_slots=512 * 30, max_graphs=4, edge_tile=128)
    graphs = synthetic_edge_feature_graphs(2, seed=3, mean_nodes=200, edges_per_node=10.0)
    return build_edge_feature_gnn(padding=pad, graphs=graphs, hidden_state_size=128, edge_embedding_size=128,
                                  gated=gated, device=device)


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("gated", [False, True])
def test_edge_feature_stack_on_card_matches_cpu(cuda_device, gated, amp, monkeypatch):
    """The edge-feature stack (5 sum MLP-MP layers reading 128 feature
    columns, or 4 and a gated layer) on the card against its plain route on
    the CPU, dropout 0: per step 5 sums forward and 5 broadcasts backward,
    the sums of the gathers' backward (the feature rows, each layer's
    senders, the MLP-MP layers' receivers and, while K5's gate is closed,
    the weight stacks), no fused-op call, and in bf16 AMP 10 typed matmul
    launches (its gate opens at D = 384, M = 128 once forced at this small
    stack) and 5 of the typed dW (K6, the dW of each typed matmul). float32: the
    loss to rtol 1e-5 and every gradient to rtol 1e-4 and 1e-4 of its largest
    magnitude. bf16 AMP: the loss within 2e-2; the two devices round at
    other places (the card's bf16 GEMMs and K5, the CPU's plain route), so
    each bf16 gradient is held to its own device's float32 gradient of the
    same step, as chip_smoke.py's PPI gate holds it: the card's no farther
    from it than 1.5 times the CPU's distance, or 1e-2 of its norm."""
    import ptgnn_tpu_torch.graph.messagepassing.base as mp_base

    if amp:
        monkeypatch.setattr(ttl, "use_typed_matmul_kernel", lambda x, *a: x.dtype == torch.bfloat16)
    fused = []
    real = mp_base.fused_typed_message_aggregation
    monkeypatch.setattr(mp_base, "fused_typed_message_aggregation", lambda *a, **k: fused.append(1) or real(*a, **k))
    _, gpu_module, mbs = _edge_feature_small(cuda_device, gated)
    _, cpu_module, _ = _edge_feature_small("cpu", gated)
    for m in (gpu_module, cpu_module):
        for sub in m.modules():
            if hasattr(sub, "dropout_rate"):
                sub.dropout_rate = 0.0

    def step(module, device, with_amp):
        module.zero_grad(set_to_none=True)
        loss, _ = module_loss(module, tree_to(mbs[0], device), train=True,
                              generator=torch.Generator(device=device), amp=with_amp)
        loss.backward()
        return float(loss.detach()), [p.grad.detach().cpu().clone() for p in module.parameters()]

    g32_loss, g32 = step(gpu_module, cuda_device, False)
    c32_loss, c32 = step(cpu_module, torch.device("cpu"), False)
    tsk.reset_launch_counts()
    g_loss, g = step(gpu_module, cuda_device, amp)
    torch.cuda.synchronize()
    sums = {(False, False): 21, (False, True): 16, (True, False): 20, (True, True): 15}[gated, amp]
    assert tsk.launch_counts() == {"segment_extremum": 0, "segment_extremum_argmax": 0, "broadcast_to_edges": 5,
                                   "segment_sum": sums, "typed_matmul": 10 if amp else 0,
                                   "typed_dw": 5 if amp else 0,
                                   "keyed_dropout": 0, "keyed_dropout_elements": 0}
    assert not fused
    names = [name for name, _ in gpu_module.named_parameters()]
    if amp:
        c_loss, c = step(cpu_module, torch.device("cpu"), True)
        np.testing.assert_allclose(g_loss, c_loss, rtol=2e-2)
        for name, gb, cb, gf, cf in zip(names, g, c, g32, c32):
            card, cpu = float((gb - gf).norm()), float((cb - cf).norm())
            assert card <= max(1.5 * cpu, 1e-2 * float(gf.norm())), (name, card, cpu)
        return
    np.testing.assert_allclose(g32_loss, c32_loss, rtol=1e-5)
    for name, gf, cf in zip(names, g32, c32):
        cf = cf.numpy()
        np.testing.assert_allclose(gf.numpy(), cf, rtol=1e-4, atol=1e-4 * np.abs(cf).max(), err_msg=name)


def test_data_parallel_world_one_over_nccl_matches_the_single_device_step(cuda_device, tmp_path):
    """One rank over NCCL (a ``file://`` rendezvous), ZeRO-1 Adam with the
    clip: three steps equal the single-device trainer's step function on the
    same minibatches and dropout seeds (both Adams capturable, as
    ``ModelTrainer``'s and the compiled step's are) within 1e-6 of each
    parameter's largest magnitude (a rank's share of the weight is exactly 1, so the
    steps should agree bit for bit); each step all-reduces the weight, the
    gradients (DDP's buckets), the loss and the metrics, and the counters
    count every execution of the compiled step: its DDP warm-ups and its
    replays."""
    import torch.distributed as dist

    from ptgnn_tpu_torch.core.trainer import make_capturable, optimizer_step, step_seed
    from ptgnn_tpu_torch.parallel import DataParallel, initialize_multi_host, zero1_optimizer
    from ptgnn_tpu_torch.parallel.dp import DDP_WARMUP_CALLS

    model, single, mbs = build_graph2class(padding=small_padding(max_nodes=512), hidden_state_size=64,
                                           num_minibatches=3, minibatch_size=8, device=cuda_device)
    initialize_multi_host("nccl", f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        ranked = model.build_neural_module(device=cuda_device, seed=0)

        def adam(params):
            return torch.optim.Adam(params, lr=2.5e-4)

        single_opt, zero_opt = adam(single.parameters()), zero1_optimizer(ranked.parameters(), adam)
        # the single-device trainer's Adam is capturable, as the data-parallel
        # step makes its own: both update with the same arithmetic
        make_capturable(single_opt, cuda_device)
        dp = DataParallel(ranked)
        generator = torch.Generator(device=cuda_device)
        for step, mb in enumerate(mbs):
            batch = tree_to(mb, cuda_device)
            generator.manual_seed(step_seed(0, 0, step))
            loss, _ = module_loss(single, batch, train=True, generator=generator)
            loss.backward()
            optimizer_step(single, single_opt, [2.5e-4], clip_gradient_norm=1.0)
            generator.manual_seed(step_seed(0, 0, step, rank=0))
            _, metrics = dp.train_step(batch, float(mb["batch"].num_graphs), generator, zero_opt, [2.5e-4],
                                       clip_gradient_norm=1.0)
        torch.cuda.synchronize()
        params = sum(p.numel() for p in ranked.parameters())
        executions = len(mbs) + DDP_WARMUP_CALLS * len(dp.train_step_compiled)
        assert dp.allreduce_calls >= 3 * executions
        assert dp.allreduce_bytes == executions * 4 * (1 + params + 1 + len(metrics))
    finally:
        dist.destroy_process_group()
    for (name, a), b in zip(single.named_parameters(), ranked.parameters()):
        torch.testing.assert_close(b.detach(), a.detach(), rtol=0, atol=1e-6 * float(a.detach().abs().max()), msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_on_card_repeats_bit_for_bit(cuda_device, dtype):
    """``ops/segment.py::segment_sum`` on a CUDA tensor (K1 over the stably
    sorted ids): 10^5 unsorted ids, some out of range, into 10^3 segments.
    Two calls give the same bits, the result is within 1e-5 of each row's
    sum of |x| of the plain version, and its gradient is the cotangent's
    row of each element."""
    from ptgnn_tpu_torch.ops.segment import segment_sum

    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 1010, (100_000,), generator=gen)  # 1000..1009 are dropped
    x = torch.randn(100_000, 24, generator=gen).to(dtype)
    mask = torch.rand(100_000, generator=gen) < 0.9
    want = segment_sum(x, ids, 1000, mask).float()
    scale = segment_sum(x.float().abs(), ids, 1000, mask)
    xc = x.to(cuda_device).requires_grad_(True)
    tsk.reset_launch_counts()
    got = segment_sum(xc, ids.to(cuda_device), 1000, mask.to(cuda_device))
    again = segment_sum(xc, ids.to(cuda_device), 1000, mask.to(cuda_device))
    assert tsk.launch_counts()["segment_sum"] == 2
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.detach().float().cpu().numpy(), again.detach().float().cpu().numpy())
    err = (got.detach().float().cpu() - want).abs()
    # bf16 outputs round once more: half a bf16 ulp of the sum on top.
    tol = 1e-5 * scale + (want.abs() * 2.0**-8 if dtype == torch.bfloat16 else 0.0)
    assert bool((err <= tol + 1e-30).all()), float((err - tol).max())
    cot = torch.randn(1000, 24, generator=gen).to(dtype)
    (g,) = torch.autograd.grad(got, xc, cot.to(cuda_device))
    want_g = torch.where((mask & (ids < 1000))[:, None], cot[ids.clamp(max=999)], torch.zeros((), dtype=dtype))
    np.testing.assert_array_equal(g.float().cpu().numpy(), want_g.float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_rows_backward_on_card_repeats_bit_for_bit(cuda_device, dtype):
    """``ops/segment.py::take_rows`` on a CUDA tensor: 10^5 unsorted ids
    gather from 10^3 rows; the backward sums each row's cotangents with one
    K1 launch. Two backward passes give the same bits, within 1e-5 of each
    row's sum of |cotangent| of the float32 sums of ``index_add_`` on the
    CPU (half a bf16 ulp more in bf16)."""
    from ptgnn_tpu_torch.ops.segment import take_rows

    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 1000, (100_000,), generator=gen)
    values = torch.randn(1000, 24, generator=gen).to(dtype)
    cot = torch.randn(100_000, 24, generator=gen).to(dtype)
    want = torch.zeros(1000, 24).index_add_(0, ids, cot.float())
    scale = torch.zeros(1000, 24).index_add_(0, ids, cot.float().abs())
    grads = []
    for _ in range(2):
        xc = values.to(cuda_device).requires_grad_(True)
        out = take_rows(xc, ids.to(cuda_device))
        np.testing.assert_array_equal(out.detach().float().cpu().numpy(), values[ids].float().numpy())
        tsk.reset_launch_counts()
        (g,) = torch.autograd.grad(out, xc, cot.to(cuda_device))
        assert tsk.launch_counts()["segment_sum"] == 1
        assert g.dtype == dtype
        grads.append(g.float().cpu())
    np.testing.assert_array_equal(grads[0].numpy(), grads[1].numpy())
    tol = 1e-5 * scale + (want.abs() * 2.0**-8 if dtype == torch.bfloat16 else 0.0)
    err = (grads[0] - want).abs()
    assert bool((err <= tol + 1e-30).all()), float((err - tol).max())


# ---------------------------------------------------------------------------
# Every kernel launches on its tensors' card, whatever the current device
# ---------------------------------------------------------------------------
def _card(cuda_device, card):
    """``cuda:card`` with the current device set to cuda:0; skips below two
    cards (the wrappers' device guard needs another card to show)."""
    if torch.cuda.device_count() < max(2, card + 1):
        pytest.skip(f"needs {max(2, card + 1)} CUDA devices: a launch on another card than the current one")
    torch.cuda.set_device(0)
    return torch.device("cuda", card)


def _integer_typed_inputs(device, seed=0):
    """K5 at PPI's bf16 shape on integers in [-2, 2]: every product and sum is
    exact in float32, so the kernel and its plain version round the same
    values to bf16."""
    g = torch.Generator().manual_seed(seed)
    tt = torch.randint(0, 3, (960,), generator=g, dtype=torch.int32)
    x = torch.randint(-2, 3, (960 * 128, 256), generator=g).to(torch.bfloat16)
    w = torch.randint(-2, 3, (3, 256, 256), generator=g).to(torch.bfloat16)
    return x.to(device), w.to(device), tt.to(device)


def _on_other_card(kernel, dev):
    """(the kernel's result on ``dev`` called from cuda:0, its plain version
    on the CPU or, for K5, on the card), moved to the CPU; the launch
    counted."""
    plan, mask = make_plan(71, 128, 512)
    g = torch.Generator().manual_seed(3)
    if kernel == "typed_dw":  # integer operands: every sum exact, in any order
        x, _, tt = _integer_typed_inputs(dev)
        dy = torch.randint(-2, 3, (x.shape[0], 128), generator=g).to(torch.bfloat16).to(dev)
        before = tracing.counter("typed_dw")
        got = ttl.typed_dw_kernel(x, dy, tt, 128, 3)
        assert tracing.counter("typed_dw") == before + 1
        return (got.cpu(),), (ttl.typed_weight_gradient_plain(x.cpu(), dy.cpu(), tt.cpu(), 128, 3),)
    if kernel == "typed_matmul":
        x, w, tt = _integer_typed_inputs(dev)
        before = tracing.counter("typed_matmul")
        got = ttl.typed_matmul_kernel(x, w, tt, 128)
        assert tracing.counter("typed_matmul") == before + 1
        return (got.cpu(),), (ttl.typed_matmul_plain(x, w, tt, 128).cpu(),)
    cplan = tree_to(plan, dev)
    if kernel == "broadcast_to_edges":
        table = torch.randn(500, 64, generator=g)
        return (_launch_broadcast(table.to(dev), cplan).cpu(),), (tsk.planned_broadcast_to_edges(table, plan),)
    wrapper = {"segment_sum": tsk.planned_segment_sum, "segment_extremum": tsk.planned_segment_extremum,
               "segment_extremum_argmax": tsk.planned_segment_extremum_with_argmax}[kernel]
    before = tracing.counter(kernel)
    if kernel == "segment_sum":  # 0/1 data: small integer sums, exact in any order
        data = (torch.rand(plan.local_rows.shape[0], 64, generator=g) < 0.3).float() * mask[:, None].float()
        got, plain = wrapper(data.to(dev), cplan, 450), wrapper(data, plan, 450)
    else:
        data = torch.where(mask[:, None], torch.randn(plan.local_rows.shape[0], 64, generator=g),
                           torch.full((), -3.0e38))
        got, plain = wrapper(data.to(dev), cplan, 450, True), wrapper(data, plan, 450, True)
    assert tracing.counter(kernel) == before + 1
    got, plain = (got if isinstance(got, tuple) else (got,)), (plain if isinstance(plain, tuple) else (plain,))
    if kernel == "segment_extremum_argmax":  # values apart from the sign of zero, slots exactly
        got, plain = (got[0] + 0.0, got[1]), (plain[0] + 0.0, plain[1])
    return tuple(t.cpu() for t in got), plain


@pytest.mark.parametrize("kernel", ["segment_sum", "segment_extremum", "segment_extremum_argmax",
                                    "broadcast_to_edges", "typed_matmul", "typed_dw"])
def test_kernel_launches_on_its_tensors_card(cuda_device, kernel):
    """K1-K6 on cuda:1 called while the current device is cuda:0: the
    wrapper launches on the tensors' card (its stream, its SM count, K5's
    shared-memory opt-in for that card), bitwise equal to its plain
    version (K6 on integers, whose sums are exact), and leaves the current
    device at cuda:0."""
    dev = _card(cuda_device, 1)
    got, plain = _on_other_card(kernel, dev)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    for a, b in zip(got, plain, strict=True):
        np.testing.assert_array_equal(_bits(a) if a.is_floating_point() else a.numpy(),
                                      _bits(b) if b.is_floating_point() else b.numpy())


@pytest.mark.parametrize("card", [0, 1, 2, 3])
def test_typed_matmul_bf16_runs_on_each_card_in_turn(cuda_device, card):
    """K5 (bf16, the TMA + wgmma route and its dynamic shared memory) on each
    card in turn from cuda:0: bitwise its plain version, and card 0's bits
    for the same inputs."""
    dev = _card(cuda_device, card)
    x, w, tt = _integer_typed_inputs(dev, seed=card)
    got = ttl.typed_matmul_kernel(x, w, tt, 128)
    random_x, random_w, random_tt = _typed_inputs((960, 128, 256, 256, 3), torch.bfloat16, dev, seed=9)
    other = ttl.typed_matmul_kernel(random_x, random_w, random_tt, 128)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert torch.equal(_bits_t(got), _bits_t(ttl.typed_matmul_plain(x, w, tt, 128)))
    zero = torch.device("cuda", 0)
    on_zero = ttl.typed_matmul_kernel(random_x.to(zero), random_w.to(zero), random_tt.to(zero), 128)
    assert torch.equal(_bits_t(other.cpu()), _bits_t(on_zero.cpu()))
