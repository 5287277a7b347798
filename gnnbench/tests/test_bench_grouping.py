"""The harness's grouping against the budgets and against the program's own
minibatching, and its edge count."""
import itertools

import numpy as np
import pytest
import torch

from gnnbench.harness import pool, spec


@pytest.mark.parametrize("name", ["g2c_mlp.train", "ppi.train_bf16"])
def test_groups_fit_and_the_program_takes_them(small, name):
    cell = small(name)
    task = spec.task(cell.config["task"])
    meta = pool.metadata_graphs(cell.traffic, 5)
    types = task.edge_types(meta)
    groups = pool.pool(cell.config, cell.traffic, task, 5, 0, types, 4)
    model, _ = task.build(cell.config, meta, torch.device("cpu"))
    p = cell.config["padding"]
    for g in groups:
        assert 1 <= len(g.graphs) <= p["max_graphs"] and g.nodes <= p["max_nodes"]
        mb = task.minibatch(model, g.graphs)  # raises where the program refuses a graph
        assert int(mb["batch"].num_edges) == g.edges
        assert int(mb["batch"].num_nodes) == g.nodes


def test_grouping_matches_the_programs_iterator(small):
    cell = small("g2c_mlp.train")
    task = spec.task("graph2class")
    meta = pool.metadata_graphs(cell.traffic, 9)
    model, _ = task.build(cell.config, meta, torch.device("cpu"))
    graphs = list(itertools.islice(pool.graph_stream(cell.traffic, 9, 0), 16))
    theirs = [len(raw) for _, raw in model.minibatch_iterator(
        model.tensorize_dataset(iter(graphs), parallelize=False, return_input_data=True),
        max_minibatch_size=10**6, parallelize=False)]
    ours = pool.Packer(cell.config, task.num_edge_types(cell.config, len(task.edge_types(meta)))).groups(
        iter(graphs + graphs), lambda g: task.layout(cell.config, g, {t: i for i, t in enumerate(
            task.edge_types(meta))}), len(theirs) - 1)
    assert [len(g.graphs) for g in ours] == theirs[:-1]


def test_edge_count_is_forward_backward_and_self():
    config = spec.load_config("g2c_typilus_mlp")
    graph = {"nodes": ["a", "b", "c"], "edges": {"NEXT": {"0": [1], "1": [2]}, "CHILD": {"0": [2]}},
             "supernodes": {"1": {"annotation": "int"}, "2": {"annotation": "Any"}}, "token-sequence": [0, 1]}
    task = spec.task("graph2class")
    n, recv, types, refs = task.layout(config, graph, {"CHILD": 0, "NEXT": 1})
    assert n == 3 and len(recv) == 2 * 3 + 3
    assert refs == {"supernodes": 1, "token-sequence": 2}
    assert sorted(types.tolist()) == [0, 1, 1, 2, 3, 3, 4, 4, 4]


def test_same_sizes_for_every_seed(small):
    cell = small("ppi.train_bf16")
    task = spec.task("ppi")
    a = pool.pool(cell.config, cell.traffic, task, 1, 0, ["e0"], 4)
    b = pool.pool(cell.config, cell.traffic, task, 2**33 + 5, 0, ["e0"], 4)
    assert [g.edges for g in a] == [g.edges for g in b]
    assert not np.array_equal(a[0].graphs[0]["features"], b[0].graphs[0]["features"])


def test_seeds_beyond_32_bits():
    assert pool.sub_seed(2**31 + 10, 1) != pool.sub_seed(2**31 + 11, 1)
    assert 0 <= pool.sub_seed(2**40, 3, 2) < 2**32


def test_traffic_fills_the_published_vocabularies():
    """At the cell's own traffic, the program's metadata pass and the
    reference both give the published widths: a 10,000-row subtoken
    embedding table and a head over 100 classes and UNK."""
    cell = spec.cell("g2c_mlp.train")
    meta = pool.metadata_graphs(cell.traffic, 2**31 + 9)
    _, module = spec.task("graph2class").build(cell.config, meta, torch.device("cpu"))
    params = dict(module.named_parameters())
    rows = cell.config["embedder"]["vocabulary_size"]
    classes = cell.config["head"]["max_num_classes"] + 1
    assert params["gnn.node_embedder.embeddings.weight"].shape[0] == rows == 10000
    assert params["node_to_class.weight"].shape[0] == classes == 101
    ctx = spec.reference("g2c_typilus_mlp").Context(cell.config, meta)
    assert len(ctx.vocab) == rows and len(ctx.classes) == classes
    assert len(ctx.edge_types) == len(cell.traffic["params"]["edge_kinds"]) == 8
