"""Single-winner (argmax) routing of max/min aggregation against the JAX
package's, which selects it with ``PTGNN_TPU_ARGMAX_ROUTING``: the plain
version of the argmax extremum kernel against the Pallas kernel
(interpreted), on a row split into pieces too; the row index that the
kernel walks against the slots of the tile walk it replaced; and the
argmax-routed fused op's forward and gradients.

Tolerances. The argmax extremum: slot ids exactly equal, values bitwise
apart from the sign of zero (-0.0 and +0.0 tie; the kernels write +0.0).
The fused op: rtol/atol 1e-5 on the forward, dx and dW at f32 (the matmuls
and segment sums add in another order; the routing is exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.ops.fused_mp import fused_typed_message_aggregation as jax_fused
from ptgnn_tpu.ops.pallas import segment_kernels as jsk
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from ptgnn_tpu_torch.ops.fused_mp import fused_typed_message_aggregation
from tests.test_torch_fused_mp import PAD, _fused_grads_jax, _grad_inputs, build_batches
from ptgnn_tpu_torch.graph.batching import _assemble_layout_python
from tests.test_torch_segment_kernels import R, make_layout, plans
from tests.torch_port_helpers import bits, force_jax_fused_interpret, to_dtype_pair

TILE = 32
NO_LAUNCHES = {k: 0 for k in tsk.launch_counts()}


@pytest.fixture(autouse=True)
def _argmax_routing(monkeypatch):
    force_jax_fused_interpret(monkeypatch)
    monkeypatch.setenv("PTGNN_TPU_ARGMAX_ROUTING", "1")


def _tied_data(receivers, local_rows, mask, m, is_max, dtype, seed):
    """Coarse values (many ties inside a tile), node 7's column 0 equal on
    every slot (ties across its tiles and types), -0.0 against +0.0 on node
    9's column 1, masked slots at the neutral value."""
    rng = np.random.RandomState(seed)
    data = np.round(rng.randn(len(receivers), m) * 2) / 2
    data[receivers == 7, 0] = 3.0 if is_max else -3.0
    nine = np.nonzero(receivers == 9)[0]
    data[nine, 1] = -100.0 if is_max else 100.0
    data[nine[0], 1], data[nine[1:], 1] = -0.0, 0.0
    jdata, tdata = to_dtype_pair(data, dtype)
    neutral = {("float32", True): -3.0e38, ("float32", False): 3.0e38,
               ("bfloat16", True): float(torch.finfo(torch.bfloat16).min),
               ("bfloat16", False): float(torch.finfo(torch.bfloat16).max)}[(dtype, is_max)]
    jmask, tmask = jnp.asarray(mask)[:, None], torch.from_numpy(mask)[:, None]
    jdata = jnp.where(jmask, jdata, jnp.asarray(neutral, jdata.dtype))
    tdata = torch.where(tmask, tdata, torch.full((), neutral, dtype=tdata.dtype))
    return jdata, tdata


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_argmax_extremum_plain_matches_jax_kernel(reduction, dtype, m):
    receivers, local_rows, mask, trb, counts = make_layout(seed=m + 40)
    jplan, tplan = plans(local_rows, trb, counts, TILE)
    is_max = reduction == "max"
    jdata, tdata = _tied_data(receivers, local_rows, mask, m, is_max, dtype, seed=m)
    n = 230
    jvals, jargs = jsk.planned_segment_extremum_with_argmax(jdata, jnp.asarray(receivers), jplan, n, is_max)
    tsk.reset_launch_counts()
    vals, args = tsk.planned_segment_extremum_with_argmax(tdata, tplan, n, is_max)
    assert tsk.launch_counts() == NO_LAUNCHES
    assert vals.dtype == torch.float32 and args.dtype == torch.int32 and tuple(args.shape) == (n, m)
    np.testing.assert_array_equal(args.numpy(), np.asarray(jargs))
    np.testing.assert_array_equal(bits(vals + 0.0), bits(jvals + 0.0))
    # The values are the extremum's, bitwise.
    np.testing.assert_array_equal(bits(vals), bits(tsk.segment_extremum_plain(tdata, tplan, n, is_max)))
    # The cases the test is for: empty and all-masked rows give -1; node 7's
    # tie spans tiles and types and goes to its first slot; node 9's zeros
    # tie, and the first (-0.0) wins.
    assert (args[200:] == -1).all() and (args[[3, 11]] == -1).all() and not vals[200:].any()
    slots7 = np.nonzero((receivers == 7) & mask)[0]
    assert len(np.unique(slots7 // TILE)) > 2  # type-pure tiles of one row block
    assert int(args[7, 0]) == slots7[0]
    assert int(args[9, 1]) == np.nonzero((receivers == 9) & mask)[0][0]
    assert bits(vals[9:10, 1:2])[0, 0] == 0  # +0.0
    assert int((args >= 0).sum()) > 150 * m


def split_row_layout(seed, hub=300):
    """make_layout's unified layout with node 7 receiving ``hub`` more edges:
    a row of more than ROW_CHUNK slots, which the argmax extremum kernel
    splits into pieces at the multiples of ROW_CHUNK of the row index."""
    rng = np.random.RandomState(seed)
    recv = np.concatenate([rng.randint(0, 200, 900), np.full(hub, 7)]).astype(np.int32)
    types = rng.randint(0, 3, len(recv)).astype(np.int32)
    layout = _assemble_layout_python(
        rng.randint(0, 200, len(recv)).astype(np.int32), recv, types, np.full(len(recv), -1, np.int32),
        max_nodes=256, e_pad=4096, tile=TILE, agg_rows=R, num_types=3, align=128,
    )
    _, receivers, _, local_rows, mask, _, trb, counts, _ = layout
    return receivers, local_rows, mask & ~np.isin(receivers, [3, 11]), trb, counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_argmax_extremum_plain_matches_jax_kernel_on_a_split_row(reduction, dtype):
    """Node 7 spread over more than ROW_CHUNK slots and many tiles, with ties
    planted where the kernel cuts its slot list into pieces: column 2 on the
    last slot of one piece and the first of the next, column 3 on one slot
    of each of three pieces. The plain version gives the interpreted Pallas
    kernel's slots exactly and its values bitwise apart from the sign of
    zero; both give the first slot of each tie."""
    receivers, local_rows, mask, trb, counts = split_row_layout(seed=21)
    jplan, tplan = plans(local_rows, trb, counts, TILE)
    is_max = reduction == "max"
    rng = np.random.RandomState(22)
    data = np.round(rng.randn(len(receivers), 64) * 2) / 2
    indexed = tsk.with_row_index(tplan)
    start, end = int(indexed.row_offsets[7]), int(indexed.row_offsets[8])
    cut = [q for q in range(start + 1, end) if q % tsk.ROW_CHUNK == 0]
    assert end - start > tsk.ROW_CHUNK and len(cut) >= 2
    slot = indexed.row_slots.numpy()
    sign = 1.0 if is_max else -1.0
    data[slot[[cut[0] - 1, cut[0]]], 2] = 9.0 * sign
    data[slot[[start + 3, cut[0] + 2, cut[-1]]], 3] = 9.0 * sign
    jdata, tdata = to_dtype_pair(data, dtype)
    neutral = -3.0e38 if is_max else 3.0e38
    if dtype == "bfloat16":
        neutral = float(torch.finfo(torch.bfloat16).min if is_max else torch.finfo(torch.bfloat16).max)
    jdata = jnp.where(jnp.asarray(mask)[:, None], jdata, jnp.asarray(neutral, jdata.dtype))
    tdata = torch.where(torch.from_numpy(mask)[:, None], tdata, torch.full((), neutral, dtype=tdata.dtype))
    n = 230
    jvals, jargs = jsk.planned_segment_extremum_with_argmax(jdata, jnp.asarray(receivers), jplan, n, is_max)
    vals, args = tsk.planned_segment_extremum_with_argmax(tdata, tplan, n, is_max)
    np.testing.assert_array_equal(args.numpy(), np.asarray(jargs))
    np.testing.assert_array_equal(bits(vals + 0.0), bits(jvals + 0.0))
    assert int(args[7, 2]) == slot[cut[0] - 1] and int(args[7, 3]) == slot[start + 3]
    assert len(np.unique(slot[start:end] // TILE)) > 4


def tile_walk_lists(local_rows, trb, counts):
    """The slots the first argmax extremum kernel folded, row by row: it
    found each row block's tiles with a searchsorted over the non-decreasing
    tile row blocks and walked them in order, folding every slot whose local
    row lies in [0, R) into row block * R + local row."""
    num_blocks, r = counts.shape
    tile = len(local_rows) // len(trb)
    start = np.searchsorted(trb, np.arange(num_blocks + 1), side="left")
    lists = [[] for _ in range(counts.size)]
    for b in range(num_blocks):
        for t in range(start[b], start[b + 1]):
            for e in range(t * tile, (t + 1) * tile):
                if 0 <= local_rows[e] < r:
                    lists[b * r + local_rows[e]].append(e)
    return lists


@pytest.mark.parametrize("layout", ["split-row", "bench-like"])
def test_row_index_lists_the_slots_the_tile_walk_folded(layout):
    """The row index that the argmax extremum kernel now walks (the
    batcher's, and the one with_row_index computes for a hand-built plan)
    lists, row by row and in the same order, exactly the slots that the
    tile-walking kernel it replaces folded."""
    from ptgnn_tpu_torch.graph.batching import row_index

    if layout == "split-row":
        _, local_rows, _, trb, counts = split_row_layout(seed=23)
    else:
        _, local_rows, _, trb, counts = make_layout(seed=24)
    want = tile_walk_lists(local_rows, trb, counts)
    offsets, slots = row_index(local_rows, trb, counts)
    indexed = tsk.with_row_index(tsk.AggregationPlan(*(torch.from_numpy(a) for a in (local_rows, trb, counts))))
    for got_offsets, got_slots in ((offsets, slots), (indexed.row_offsets.numpy(), indexed.row_slots.numpy())):
        got = [got_slots[got_offsets[g]:got_offsets[g + 1]].tolist() for g in range(counts.size)]
        assert got == want
        assert (got_slots[got_offsets[-1]:] == -1).all()
    assert max(len(x) for x in want) > (tsk.ROW_CHUNK if layout == "split-row" else 0)


def _port_grads(states, weights, adj, reduction, use_target_state, cot, keep=1.0, seed=None,
                argmax_routing=True):
    x = torch.from_numpy(states).requires_grad_()
    w = torch.from_numpy(weights).requires_grad_()
    out = fused_typed_message_aggregation(x, w, adj, x.shape[0], reduction, use_target_state, keep, seed,
                                          argmax_routing=argmax_routing)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("use_target_state", [True, False])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_argmax_routed_fused_op_matches_jax(reduction, use_target_state, dropout):
    num_types, jbatch, tbatch = build_batches(seed=4)
    states, weights, cot = _grad_inputs(num_types, use_target_state, seed=13)
    keep, jseed, tseed = 1.0, None, None
    if dropout:
        keep, jseed, tseed = 0.8, jnp.uint32(987_654_321), torch.tensor(987_654_321)
    n = PAD["max_nodes"]
    expected = jax_fused(jnp.asarray(states), jnp.asarray(weights), (jbatch.adjacency, jseed), n,
                         reduction, use_target_state, keep)
    gx, gw = _fused_grads_jax(states, weights, jbatch.adjacency, reduction, use_target_state, cot, keep, jseed)
    tsk.reset_launch_counts()
    out, tx, tw = _port_grads(states, weights, tbatch.adjacency, reduction, use_target_state, cot, keep, tseed)
    launched = tsk.launch_counts()
    assert (launched.pop("keyed_dropout_elements") > 0) == dropout  # the hash runs on every device
    assert launched == {k: 0 for k in launched}  # the CPU runs the plain versions
    np.testing.assert_allclose(out, np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx, gx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw, gw, rtol=1e-5, atol=1e-5)
    assert np.abs(tx).max() > 0 and np.abs(tw).max() > 0


@pytest.mark.parametrize("use_target_state", [True, False])
def test_argmax_routing_on_ties_matches_jax_and_differs_from_tie_split(use_target_state):
    """Coarse inputs make many messages tie: single-winner routing gives
    JAX's gradients, and they differ from the tie split's (the same
    forward)."""
    num_types, jbatch, tbatch = build_batches(seed=5)
    states, weights, cot = _grad_inputs(num_types, use_target_state, seed=8, ties=True)
    gx, gw = _fused_grads_jax(states, weights, jbatch.adjacency, "max", use_target_state, cot)
    out, tx, tw = _port_grads(states, weights, tbatch.adjacency, "max", use_target_state, cot)
    np.testing.assert_allclose(tx, gx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw, gw, rtol=1e-5, atol=1e-5)
    split_out, sx, sw = _port_grads(states, weights, tbatch.adjacency, "max", use_target_state, cot,
                                    argmax_routing=False)
    np.testing.assert_array_equal(out, split_out)
    assert np.abs(tx - sx).max() > 0.1 and np.abs(tw - sw).max() > 0.1


def test_argmax_routing_needs_pair_ids():
    num_types, _, tbatch = build_batches(seed=2)
    states, weights, _ = _grad_inputs(num_types, True, seed=3)
    adj = tbatch.adjacency._replace(edge_pair_id=None)
    with pytest.raises(ValueError, match="edge_pair_id"):
        fused_typed_message_aggregation(torch.from_numpy(states), torch.from_numpy(weights), adj,
                                        PAD["max_nodes"], "max", True, argmax_routing=True)
    # Sum and mean have no winners to route: the flag changes nothing there.
    got = fused_typed_message_aggregation(torch.from_numpy(states), torch.from_numpy(weights), adj,
                                          PAD["max_nodes"], "sum", True, argmax_routing=True)
    assert got.shape == (PAD["max_nodes"], weights.shape[2])
