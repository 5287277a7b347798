"""The port's row index (``row_offsets``, ``row_slots``) against a numpy
construction from the JAX package's batch arrays: the batcher's, and the one
:func:`with_row_index` computes with torch ops for a plan built by hand, are
bitwise equal to it; the in-degrees count each row's slots; the offsets end
at the number of real slots; each row's slots increase; the tail is -1; and
the sum plan and the extremum plan carry the same index."""
import functools

import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.batching import GraphBatcher as JaxGraphBatcher
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.graph.structs import TensorizedGraphData as JaxTensorizedGraphData
from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu_torch.graph.batching import GraphBatcher
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData, tree_to
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from tests.test_torch_batching import random_graphs

PADDINGS = [  # the two paddings of tests/test_torch_batching.py
    dict(max_nodes=256, max_edge_slots=4096, max_graphs=8, edge_tile=32, agg_rows=64, agg_sum_tile=128),
    dict(max_nodes=300, max_edge_slots=3840, max_graphs=6, edge_tile=64, agg_rows=128, agg_sum_tile=0),
]


def expected_index(local_rows, tile_row_blocks, counts):
    """Slot by slot: each real slot (local row in [0, R)) appended to its
    row's list; the lists' lengths, the offsets and the flat slots."""
    r = counts.shape[1]
    tile = len(local_rows) // len(tile_row_blocks)
    per_row = [[] for _ in range(counts.size)]
    for e, lr in enumerate(local_rows.tolist()):
        if 0 <= lr < r:
            per_row[int(tile_row_blocks[e // tile]) * r + lr].append(e)
    lengths = np.array([len(s) for s in per_row], np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    slots = np.full(len(local_rows), -1, np.int32)
    flat = [e for s in per_row for e in s]
    slots[: len(flat)] = flat
    return lengths, offsets, slots


# Both paddings with seeds 0 and 1, and a Graph2Class minibatch; the
# supertile view exists where agg_sum_tile is set.
CASES = ["pad0-seed0", "pad0-seed1", "pad1-seed0", "pad1-seed1", "graph2class"]
SUPERTILE_CASES = ["pad0-seed0", "pad0-seed1", "graph2class"]


@functools.lru_cache(maxsize=None)
def adjacencies(case):
    """(JAX adjacency, port adjacency) of one case's batch."""
    if case == "graph2class":
        kw = dict(hidden_state_size=16, num_minibatches=1, minibatch_size=8)
        _, _, _, jmbs = jax_build(padding=jax_small_padding(max_nodes=256), **kw)
        _, _, tmbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", **kw)
        return jmbs[0]["batch"].adjacency, tmbs[0]["batch"].adjacency
    pad = PADDINGS[int(case[3])]
    jb = JaxGraphBatcher(3, JaxBatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    tb = GraphBatcher(3, BatchPadding(**pad), introduce_backwards_edges=True, add_self_edges=True)
    jmb, tmb = jb.initialize(), tb.initialize()
    for n, adj, refs in random_graphs(int(case[-1]), 12, 3):
        jg = JaxTensorizedGraphData(n, [0] * n, adj, None, refs)
        if jb.can_add(jg, jmb):
            jb.extend(jg, jmb)
            tb.extend(TensorizedGraphData(n, [0] * n, adj, None, refs), tmb)
    return (jb.finalize(jmb, node_data={}, reference_names=["supernodes"]).adjacency,
            tb.finalize(tmb, node_data={}, reference_names=["supernodes"]).adjacency)


def jax_arrays(jadj):
    return (np.asarray(jadj.local_rows).reshape(-1), np.asarray(jadj.tile_row_blocks),
            np.asarray(jadj.agg_counts))


@pytest.mark.parametrize("case", CASES)
def test_batcher_row_index_matches_numpy_from_jax_batch(case):
    jadj, tadj = adjacencies(case)
    local_rows, trb, counts = jax_arrays(jadj)
    lengths, offsets, slots = expected_index(local_rows, trb, counts)
    np.testing.assert_array_equal(counts.reshape(-1), lengths)  # the in-degrees count the slots
    for name, want in (("row_offsets", offsets), ("row_slots", slots)):
        got = getattr(tadj, name)
        assert got.dtype == np.int32 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_row_index_invariants(case):
    jadj, tadj = adjacencies(case)
    local_rows, _, counts = jax_arrays(jadj)
    offsets, slots = tadj.row_offsets, tadj.row_slots
    real = int(((local_rows >= 0) & (local_rows < counts.shape[1])).sum())
    assert offsets[0] == 0 and offsets[-1] == real == int(np.asarray(jadj.mask).sum())
    assert (np.diff(offsets) >= 0).all()
    for g in range(counts.size):
        assert (np.diff(slots[offsets[g]:offsets[g + 1]]) > 0).all()
    assert (slots[real:] == -1).all() and (slots[:real] >= 0).all()
    assert sorted(slots[:real].tolist()) == np.nonzero(local_rows < counts.shape[1])[0].tolist()


@pytest.mark.parametrize(
    "case,granularity", [(c, "edge_tile") for c in CASES] + [(c, "supertile") for c in SUPERTILE_CASES]
)
def test_hand_built_plan_index_matches_numpy(case, granularity):
    """with_row_index from the JAX batch's arrays, at edge-tile and (where
    the batcher aligned row-block runs) supertile granularity."""
    jadj, _ = adjacencies(case)
    local_rows, trb, counts = jax_arrays(jadj)
    if granularity == "supertile":
        trb = np.asarray(jadj.super_tile_row_blocks)
    _, offsets, slots = expected_index(local_rows, trb, counts)
    plan = tsk.AggregationPlan(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (local_rows, trb, counts)))
    indexed = tsk.with_row_index(plan)
    assert indexed.row_offsets.dtype == torch.int32 and indexed.row_slots.dtype == torch.int32
    np.testing.assert_array_equal(indexed.row_offsets.numpy(), offsets)
    np.testing.assert_array_equal(indexed.row_slots.numpy(), slots)
    assert tsk.with_row_index(indexed) is indexed  # an index it has is kept


@pytest.mark.parametrize("case", CASES)
def test_sum_and_extremum_plans_carry_one_index(case):
    adj = tree_to(adjacencies(case)[1], torch.device("cpu"))
    ext, summ = tsk.plan_from_adjacency(adj), tsk.sum_plan_from_adjacency(adj)
    assert ext.row_offsets is summ.row_offsets is adj.row_offsets
    assert ext.row_slots is summ.row_slots is adj.row_slots
    tsk._check_plan(ext, torch.device("cpu"))
    tsk._check_plan(summ, torch.device("cpu"))


def test_check_plan_refuses_a_mismatched_index():
    _, tadj = adjacencies(CASES[0])
    plan = tsk.AggregationPlan(*(torch.from_numpy(getattr(tadj, k)) for k in (
        "local_rows", "tile_row_blocks", "agg_counts", "row_offsets", "row_slots")))
    tsk._check_plan(plan, torch.device("cpu"))
    tsk._check_plan(plan._replace(row_offsets=None, row_slots=None), torch.device("cpu"))
    with pytest.raises(ValueError, match="row index"):
        tsk._check_plan(plan._replace(row_offsets=plan.row_offsets[:-1].contiguous()), torch.device("cpu"))
    with pytest.raises(ValueError, match="row index"):
        tsk._check_plan(plan._replace(row_slots=None), torch.device("cpu"))
