"""The fused op's keyed message dropout (``ops/fused_mp.py``) against the
benchmark's plain Graph2Seq reference (``gnnbench/reference/
g2s_ggnn_copy.py``), which keeps its own copy of the hash: the keep masks
equal bit for bit on random keys, seeds, rates and column offsets. And a
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
from ptgnn_tpu_torch.ops import fused_mp
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
    key = fused_mp._directed_edge_key(src.int(), dst.int(), etype.int())
    assert torch.equal(key, reference.edge_key(src, dst, etype))
    for seed in (0, 1, 2**31 + 5, 2**32 - 1, int(rng.randint(0, 2**31))):
        seed_t = torch.tensor(seed, dtype=torch.int64)
        want = fused_mp._keyed_dropout_mask(seed_t, key, 40, rate, col_offset)
        got = reference.keep_mask(seed_t, key, 40, rate, col_offset)
        assert torch.equal(got, want), (seed, rate, col_offset)
        assert 0.5 * rate < 1.0 - float(want.float().mean()) < 1.5 * rate


def test_the_reference_products_wrap_as_uint32():
    x = torch.tensor([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x9E3779B9], dtype=torch.int64)
    for c in (2654435761, 0x7FEB352D, 0xFFFFFFFF):
        assert reference.mul_u32(x, c).tolist() == [(int(v) * c) % 2**32 for v in x]


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
