"""The fused op's keyed message dropout (``ops/keyed_dropout.py``) against
the benchmark's plain Graph2Seq reference (``gnnbench/reference/
g2s_ggnn_copy.py``), which keeps its own copy of the hash: the keep masks
equal bit for bit on random keys, seeds, rates and column offsets. The
dispatch from the edges' ids computes the plain composition on the CPU in
both orientations and launches nothing; the kernel's launch counter is a
replayed one. And a
Graph2Seq train step with tracing on: the layer marks in a step's order
(``ENCODED`` between the forward's keyed pairs and the backward's,
``DECODER_GRAD`` after the backward starts) and the elements the hash
covered (``utils/tracing.keyed_dropout_elements``), one [E, columns] block a
mask."""
import numpy as np
import pytest
import torch

from gnnbench.reference import g2s_ggnn_copy as reference
from ptgnn_tpu_torch.core.trainer import TrainStep
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.implementations.graph2seq.harness import build_graph2seq
from ptgnn_tpu_torch.implementations.graph2seq.train import g2s_padding
from ptgnn_tpu_torch.ops import keyed_dropout
from ptgnn_tpu_torch.ops import segment_kernels as sk
from ptgnn_tpu_torch.utils import tracing
from ptgnn_tpu_torch.utils.synthetic import synthetic_graph2seq_samples


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
@pytest.mark.parametrize("col_offset", [0, 3, 128])
def test_the_reference_mask_is_the_programs_bit_for_bit(rate, col_offset):
    rng = np.random.RandomState(int(rate * 10) + col_offset)
    e = 2000
    src, dst = (torch.from_numpy(rng.randint(0, 2**31 - 1, e)) for _ in range(2))
    etype = torch.from_numpy(rng.randint(0, 17, e))
    key = keyed_dropout._directed_edge_key(src.int(), dst.int(), etype.int())
    assert torch.equal(key, reference.edge_key(src, dst, etype))
    for seed in (0, 1, 2**31 + 5, 2**32 - 1, int(rng.randint(0, 2**31))):
        seed_t = torch.tensor(seed, dtype=torch.int64)
        want = keyed_dropout._keyed_dropout_mask(seed_t, key, 40, rate, col_offset)
        got = reference.keep_mask(seed_t, key, 40, rate, col_offset)
        assert torch.equal(got, want), (seed, rate, col_offset)
        assert 0.5 * rate < 1.0 - float(want.float().mean()) < 1.5 * rate


def test_the_reference_products_wrap_as_uint32():
    x = torch.tensor([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x9E3779B9], dtype=torch.int64)
    for c in (2654435761, 0x7FEB352D, 0xFFFFFFFF):
        assert reference.mul_u32(x, c).tolist() == [(int(v) * c) % 2**32 for v in x]


def _ids(orientation, e, rng):
    """Ids of ``e`` slots with padding ids among them (0, max_nodes and a
    negative one): a type a slot, or a type a tile of 32 or 128."""
    max_nodes = 4096
    src, dst = (rng.randint(0, max_nodes, e).astype(np.int32) for _ in range(2))
    src[:3], dst[:3] = [0, max_nodes, -1], [max_nodes, -7, 0]
    tile = {"forward": 1, "transpose32": 32, "transpose128": 128}[orientation]
    types = rng.randint(0, 16, e // tile).astype(np.int32)
    types[-1] = -1
    return keyed_dropout.EdgeIds(*(torch.from_numpy(a) for a in (src, dst, types)), tile)


@pytest.mark.parametrize("col_offset", [0, 3, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("orientation", ["forward", "transpose32", "transpose128"])
def test_the_ids_in_dispatch_is_the_plain_composition(orientation, dtype, col_offset):
    rng = np.random.RandomState(col_offset + len(orientation))
    e, c = 512, 40
    ids = _ids(orientation, e, rng)
    x = torch.from_numpy(rng.randn(e, c)).to(dtype)
    types = ids.types.repeat_interleave(ids.tile)
    key = keyed_dropout._directed_edge_key(ids.src, ids.dst, types)
    sk.reset_launch_counts()
    for seed in (0, 2**31 + 5, 2**32 - 1):
        seed_t = torch.tensor(seed, dtype=torch.int64)
        for keep in (0.9, 0.8, 0.5):
            got = keyed_dropout.keyed_dropout(x, seed_t, ids, keep, col_offset)
            mask = keyed_dropout._keyed_dropout_mask(seed_t, key, c, 1.0 - keep, col_offset)
            want = torch.where(mask, x / torch.full((), keep, dtype=dtype), torch.zeros((), dtype=dtype))
            assert got.dtype == dtype and torch.equal(got, want), (seed, keep)
            assert 0.5 * (1 - keep) < 1.0 - float(mask.float().mean()) < 1.5 * (1 - keep)
    assert sk.launch_counts()["keyed_dropout"] == 0  # the CPU runs the plain version


def test_the_keyed_dropout_kernel_counts_its_launches_as_a_replayed_counter():
    from ptgnn_tpu_torch.core import compiled_step

    assert (keyed_dropout.keyed_dropout_kernel, "launches") in compiled_step.REPLAYED_COUNTERS
    keyed_dropout.keyed_dropout_kernel.launches = 5
    assert sk.launch_counts()["keyed_dropout"] == 5
    sk.reset_launch_counts()
    assert keyed_dropout.keyed_dropout_kernel.launches == 0 and sk.launch_counts()["keyed_dropout"] == 0


def test_the_keyed_dropout_kernel_tallies_its_launches_by_shape_as_a_replayed_counter():
    from ptgnn_tpu_torch.core import compiled_step

    assert (keyed_dropout.keyed_dropout_kernel, "launches_by_shape") in compiled_step.REPLAYED_COUNTERS
    keyed_dropout.keyed_dropout_kernel.launches_by_shape[(131072, 128, 0, 128, "float32")] = 3
    sk.reset_launch_counts()
    assert keyed_dropout.keyed_dropout_kernel.launches_by_shape == {}


def test_the_keyed_dropout_gate_stays_shut_on_the_cpu():
    """Off the card the dispatch takes the plain version; the kernel
    itself refuses a CPU tensor."""
    ids = _ids("forward", 64, np.random.RandomState(0))
    x = torch.ones(64, 8)
    sk.reset_launch_counts()
    seed = torch.tensor(1)
    got = keyed_dropout.keyed_dropout(x, seed, ids, 0.9)
    assert torch.equal(got, keyed_dropout.keyed_dropout_plain(x, seed, ids, 0.9))
    assert sk.launch_counts()["keyed_dropout"] == 0
    with pytest.raises(ValueError, match="no kernel"):
        keyed_dropout.keyed_dropout_kernel(x, seed, ids, 0.9)


@pytest.mark.parametrize("refused", ["float16", "float64", "3-d", "column-strided", "int64 ids"])
def test_the_keyed_dropout_kernel_raises_on_what_it_does_not_take(refused):
    """On the card the dispatch has no fallback: a dtype, layout or ids
    dtype the kernel does not take is an error, not a silent plain route."""
    ids = _ids("forward", 64, np.random.RandomState(0))
    x = torch.ones(64, 8)
    if refused in ("float16", "float64"):
        x = x.to(getattr(torch, refused))
    elif refused == "3-d":
        x = x.reshape(64, 2, 4)
    elif refused == "column-strided":
        x = torch.ones(64, 16)[:, ::2]
    else:
        ids = ids._replace(src=ids.src.long())
    match = "int32" if refused == "int64 ids" else "contiguous rows"
    with pytest.raises(ValueError, match=match):
        keyed_dropout.keyed_dropout_kernel(x, torch.tensor(1), ids, 0.9)


@pytest.fixture(autouse=True)
def no_marking():
    tracing.set_marking(False)
    yield
    tracing.set_marking(False)


def test_a_graph2seq_step_marks_its_layers_in_order_and_counts_the_hash(monkeypatch):
    padding = g2s_padding(max_nodes=512, max_graphs=8)
    samples = list(synthetic_graph2seq_samples(24, seed=3, mean_nodes=30, max_nodes=60))
    _, module, mbs = build_graph2seq(padding=padding, samples=samples, embedding_size=16, device="cpu")
    step = TrainStep(module, torch.optim.Adam(module.parameters(), lr=1e-3))
    marks = []
    monkeypatch.setattr(tracing, "mark", lambda mark_id, device: marks.append(mark_id))
    tracing.set_marking(True)
    sk.reset_launch_counts()
    step.generator.manual_seed(7)
    loss, _ = step.step(tree_to(mbs[0], "cpu"))
    assert np.isfinite(float(loss))
    layers = 8  # 7 positions of the shared gated layer and the fresh one
    keyed = [tracing.KEYED_BEGIN, tracing.KEYED_END] * layers
    assert marks == ([tracing.FORWARD] + keyed + [tracing.ENCODED, tracing.BACKWARD, tracing.DECODER_GRAD]
                     + keyed + [tracing.OPTIMIZER, tracing.UPDATED])
    # each layer's forward mask and its backward's transposed one: [E, 16]
    counts = sk.launch_counts()
    assert counts["keyed_dropout_elements"] == 2 * layers * padding.max_edge_slots * 16
    assert sum(v for k, v in counts.items() if k != "keyed_dropout_elements") == 0  # the CPU launches no kernel
