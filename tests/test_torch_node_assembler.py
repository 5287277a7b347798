"""The node's assembler (``parallel/distributed_trainer.py``,
``parallel/handoff.py``) on 4 gloo ranks on the CPU, in ONE spawned world
(``tests/torch_shard_worker.py``): local rank 0 of each node alone
tensorizes, assembles, finalizes and (node-sharded) reshards the node's
minibatches, and hands every other rank of the node its slot or shard.

Each rank's slots are held bitwise against an oracle that this process
computes with ``model.minibatch_iterator`` over the same graphs (and
``shard_batch_by_nodes`` at the budgets the ranks froze): the groups of
``slots_per_group`` minibatches in order, a short last group padded with
the empty minibatch at weight 0, and, over several nodes, the empty
minibatch at weight 0 for a node that has run out while another has data."""
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch

from ptgnn_tpu_torch.implementations.typilus.harness import small_padding
from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model
from ptgnn_tpu_torch.parallel.handoff import pack, unpack
from ptgnn_tpu_torch.parallel.node_sharding import local_shard, shard_batch_by_nodes
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs
from tests.torch_shard_worker import launch

WORLD, SIZE = 4, 3
NODE_GRAPHS = (21, 9)  # two nodes' graphs: uneven, so node 1 runs out first
LAYOUTS = [("one node", False), ("one node", True), ("two nodes", False), ("two nodes", True)]
IDLE = {"tensorize_dataset": 0, "children": 0, "tensorize": 0, "finalize": 0, "reshard": 0}


def same_tree(a: Any, b: Any, path: str = "") -> None:
    """``a`` and ``b`` are the same tree with bitwise equal arrays."""
    if isinstance(b, (np.ndarray, np.generic)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes(), path
    elif isinstance(b, tuple) and hasattr(b, "_fields"):
        assert type(a) is type(b), path
        for name, x, y in zip(b._fields, a, b):
            same_tree(x, y, f"{path}.{name}")
    elif isinstance(b, dict):
        assert type(a) is dict and a.keys() == b.keys(), path
        for k in b:
            same_tree(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def minibatches(model, graphs):
    """(finalized minibatch, raw count) of ``graphs`` in order, full
    minibatches only, in this process."""
    return [(mb, len(raw)) for mb, raw in model.minibatch_iterator(
        model.tensorize_dataset(iter(graphs), parallelize=False, return_input_data=True),
        max_minibatch_size=SIZE, yield_partial_minibatches=False, parallelize=False)]


def oracle_groups(mbs, slots, empty):
    """Every group of ``slots`` of ``mbs``: (each slot's minibatch, weight),
    and the group's raw count; the short last group padded."""
    groups = []
    for start in range(0, len(mbs), slots):
        chunk = mbs[start:start + slots]
        padded = [(mb, float(n)) for mb, n in chunk] + [(empty, 0.0)] * (slots - len(chunk))
        groups.append((padded, sum(n for _, n in chunk)))
    return groups


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    model = create_graph2class_gnn_model(hidden_state_size=8, padding=small_padding(max_nodes=256, max_graphs=8))
    node_graphs = [list(synthetic_typilus_graphs(n, seed=31 + i, mean_nodes=30, max_nodes=80))
                   for i, n in enumerate(NODE_GRAPHS)]
    every = node_graphs[0] + node_graphs[1]
    valid = list(synthetic_typilus_graphs(6, seed=40, mean_nodes=30, max_nodes=80))
    model.compute_metadata(iter(every), parallelize=False)
    payload = {"model": model, "graphs": node_graphs, "all": every, "valid": valid, "minibatch_size": SIZE}
    ranks = launch([("assembler_groups", payload), ("assembler_train", payload), ("assembler_failure", payload)],
                   tmp_path_factory.mktemp("assembler_world"), world=WORLD)
    empty = model.finalize_minibatch(model.initialize_minibatch())
    return {"ranks": ranks, "empty": empty, "all": minibatches(model, every),
            "nodes": [minibatches(model, g) for g in node_graphs]}


def expected_slots(world, layout, rank):
    """(host minibatch, raw count, weight) of each group, for ``rank``."""
    if layout == "one node":
        return [(slots[rank][0], raw, slots[rank][1])
                for slots, raw in oracle_groups(world["all"], WORLD, world["empty"])]
    per_node = [oracle_groups(mbs, 2, world["empty"]) for mbs in world["nodes"]]
    mine = per_node[rank // 2]
    steps = max(len(g) for g in per_node)
    return [(mine[g][0][rank % 2][0], mine[g][1], mine[g][0][rank % 2][1]) if g < len(mine)
            else (world["empty"], 0, 0.0) for g in range(steps)]


class Leaf(NamedTuple):
    a: Any
    b: Any


@pytest.mark.parametrize("tree", [
    {"x": np.arange(7, dtype=np.int32), "y": Leaf(np.ones((3, 5), np.float32)[:, 1:4], None), "n": 3},
    [np.asfortranarray(np.arange(12.0).reshape(3, 4)), np.zeros(0, np.int64), np.float32(2.5), np.array(True),
     (np.arange(5, dtype=np.uint8), "text")],
])
def test_a_packed_tree_unpacks_bitwise_with_aligned_arrays(tree):
    head_bytes, num_buffers, blob = pack(tree)
    received = torch.from_numpy(blob.copy()).numpy()  # a fresh buffer, as the receiver's
    got = unpack(received, head_bytes, num_buffers)
    same_tree(got, tree)
    for leaf in (got["x"], got["y"].a) if isinstance(got, dict) else (got[0], got[4][0]):
        assert leaf.ctypes.data % leaf.dtype.alignment == 0


@pytest.mark.parametrize("layout,parallelize", LAYOUTS)
def test_every_slot_on_every_rank_is_the_oracles(world, layout, parallelize):
    """One node of 4, and 2 nodes of 2 whose data are uneven: node 1 runs
    out first and feeds the empty minibatch at weight 0 while node 0 has
    groups left (the "anyone left" flag)."""
    for rank, r in enumerate(world["ranks"]):
        got = r[0][(layout, parallelize)]["slots"]
        want = expected_slots(world, layout, rank)
        assert len(got) == len(want)
        for g, ((mb, raw, weight), (want_mb, want_raw, want_weight)) in enumerate(zip(got, want)):
            assert (raw, weight) == (want_raw, want_weight), (rank, g)
            same_tree(mb, want_mb, f"rank {rank} group {g}")
    if layout == "two nodes":
        weights = [[w for _, _, w in r[0][(layout, parallelize)]["slots"]] for r in world["ranks"]]
        assert weights[2][-1] == weights[3][-1] == 0.0 and weights[0][-1] > 0, weights


@pytest.mark.parametrize("layout,parallelize", LAYOUTS)
def test_only_the_assembler_tensorizes_and_finalizes(world, layout, parallelize):
    """The assembler (local rank 0) makes its node's stream once and sends
    each peer a slot a group; the peers receive and do no host work."""
    local_world = WORLD if layout == "one node" else 2
    for rank, r in enumerate(world["ranks"]):
        got = r[0][(layout, parallelize)]
        groups = len(got["slots"]) if layout == "one node" else len(world["nodes"][rank // 2][::2])
        if rank % local_world == 0:
            assert got["host"]["calls"]["tensorize_dataset"] == 1 and got["host"]["calls"]["finalize"] >= groups
            assert got["handoff"]["slots"] == (local_world - 1) * groups
        else:
            assert got["host"]["calls"] == IDLE
            assert got["handoff"]["slots"] == groups and got["handoff"]["bytes"] > 0


def test_hybrid_shards_are_the_present_reshardings(world):
    """2 data x 2 node: rank r's shard of each group is shard r % 2 of
    ``shard_batch_by_nodes`` of the group's slot r // 2, at the budgets
    every rank froze; only the assembler reshards."""
    budgets = world["ranks"][0][0]["hybrid"]["budgets"]
    groups = oracle_groups(world["all"], 2, world["empty"])
    for rank, r in enumerate(world["ranks"]):
        got = r[0]["hybrid"]
        assert got["budgets"] == budgets and got["shard_index"] == rank % 2
        assert len(got["slots"]) == len(groups)
        for g, ((shard, raw, weight), (slots, want_raw)) in enumerate(zip(got["slots"], groups)):
            mb, want_weight = slots[rank // 2]
            sharded, _ = shard_batch_by_nodes(mb, 2, **budgets)
            assert (raw, weight) == (want_raw, want_weight)
            same_tree(shard, local_shard(sharded, rank % 2), f"rank {rank} group {g}")
        if rank == 0:
            assert got["host"]["calls"]["reshard"] > len(groups) and got["handoff"]["slots"] == 3 * len(groups)
        else:
            assert got["host"]["calls"] == IDLE and got["handoff"]["slots"] == len(groups)


@pytest.mark.parametrize("kind", ["data-parallel", "node-sharded"])
def test_trainers_tensorize_only_on_the_assembler(world, kind):
    """train(): the tensorize child is forked on the assembler alone (the
    data-parallel trainer memorizes its data there, so its second epoch
    forks nothing), the peers never call the tensorize closures, and every
    rank ends with the same parameters."""
    runs = [r[1][kind] for r in world["ranks"]]
    calls = runs[0]["host"]["calls"]
    # one training and one validation pass tensorize (the data-parallel trainer's second epoch is memorized)
    assert calls["tensorize_dataset"] == calls["children"] == 2 and calls["finalize"] > 0
    if kind == "node-sharded":
        assert calls["reshard"] > 0
    for run in runs[1:]:
        assert run["host"]["calls"] == IDLE and run["handoff"]["slots"] > 0
        for name, value in runs[0]["params"].items():
            assert torch.equal(run["params"][name], value), name


@pytest.mark.parametrize("layout", ["one node", "two nodes"])
def test_an_assembler_error_raises_on_every_rank(world, layout):
    """rank 0's tensorize raises: its peers get the error as a message and
    raise it; over two nodes the other node's ranks raise after the
    "anyone left" all-reduce; none hangs."""
    for rank, r in enumerate(world["ranks"]):
        got = r[2][layout]
        assert got["error"] is not None and got["seconds"] < 60, (rank, got)
        if rank == 0:
            assert "planted failure" in got["error"]
        elif layout == "one node" or rank == 1:
            assert "assembler (rank 0) failed" in got["error"] and "planted failure" in got["error"], got
        else:
            assert "another node" in got["error"], got
