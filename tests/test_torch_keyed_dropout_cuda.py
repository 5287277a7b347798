"""The keyed dropout kernel (``csrc/keyed_dropout.cu``) against the plain
PyTorch composition it replaces (``ops/keyed_dropout.py::
keyed_dropout_plain``), bit for bit: float32 and bf16, widths 1 to 256,
column offsets, rates and seeds up to 2**32 - 1, a type a slot (the forward
orientation) and a type a tile (the transpose one), padding ids and a
negative id; rows with a row stride and misaligned rows; a replay of a CUDA
graph whose seed is rewritten between replays; and a Graph2Seq train step
that launches it 16 times and hashes the elements it hashed before.

These tests need a card and skip elsewhere. This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_keyed_dropout_cuda.py
"""
import numpy as np
import pytest
import torch

from ptgnn_tpu_torch.core.trainer import module_loss
from ptgnn_tpu_torch.graph.structs import tree_to
from ptgnn_tpu_torch.ops import fused_mp
from ptgnn_tpu_torch.ops import keyed_dropout as kd
from ptgnn_tpu_torch.ops import segment_kernels as sk
from ptgnn_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

MAX_NODES = 4096
SEEDS = (0, 2**31 + 5, 2**32 - 1)
KEEPS = (0.9, 0.8, 0.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the keyed dropout kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ids(orientation, e, rng, device):
    """Ids of ``e`` slots with padding ids among them (0, max_nodes and a
    negative one): a type a slot, or a type a tile of 32 or 128."""
    src, dst = (rng.randint(0, MAX_NODES, e).astype(np.int32) for _ in range(2))
    src[:3], dst[:3] = [0, MAX_NODES, -1], [MAX_NODES, -7, 0]
    tile = {"forward": 1, "transpose32": 32, "transpose128": 128}[orientation]
    types = rng.randint(0, 16, e // tile).astype(np.int32)
    types[-1] = -1
    return kd.EdgeIds(*(torch.from_numpy(a).to(device) for a in (src, dst, types)), tile)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _seed(value, device):
    return torch.tensor(value, dtype=torch.int64, device=device)


@pytest.mark.parametrize("orientation", ["forward", "transpose32", "transpose128"])
@pytest.mark.parametrize("col_offset", [0, 3, 128])
@pytest.mark.parametrize("width", [1, 40, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keyed_dropout_kernel_matches_plain_bitwise(cuda_device, dtype, width, col_offset, orientation):
    rng = np.random.RandomState(width + col_offset)
    e = 4096
    ids = _ids(orientation, e, rng, cuda_device)
    x = torch.from_numpy(rng.randn(e, width).astype(np.float32)).to(cuda_device, dtype)
    for seed in SEEDS:
        for keep in KEEPS:
            before = tracing.counter("keyed_dropout")
            shape = (e, width, col_offset, ids.tile, str(dtype).removeprefix("torch."))
            before_shape = tracing.tally("keyed_dropout").get(shape, 0)
            got = kd.keyed_dropout(x, _seed(seed, cuda_device), ids, keep, col_offset)
            assert tracing.counter("keyed_dropout") == before + 1
            assert tracing.tally("keyed_dropout")[shape] == before_shape + 1
            want = kd.keyed_dropout_plain(x, _seed(seed, cuda_device), ids, keep, col_offset)
            assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
            assert torch.equal(_bits(got), _bits(want)), (seed, keep)
            dropped = float((want == 0).float().mean())
            assert 0.5 * (1 - keep) < dropped < 1.5 * (1 - keep) + 0.01


@pytest.mark.parametrize("layout", ["row-strided", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keyed_dropout_kernel_takes_strided_and_misaligned_rows(cuda_device, dtype, layout):
    """A column slice of a wider block: whole 16-byte rows a row stride
    apart (the vector route), or rows that start off 16 bytes (element by
    element)."""
    rng = np.random.RandomState(1)
    e, c = 2048, 128
    wide = torch.from_numpy(rng.randn(e, 2 * c + 8).astype(np.float32)).to(cuda_device, dtype)
    x = wide[:, :c] if layout == "row-strided" else wide[:, 1:1 + c]
    ids = _ids("transpose32", e, rng, cuda_device)
    seed = _seed(2**32 - 3, cuda_device)
    got = kd.keyed_dropout_kernel(x, seed, ids, 0.8, 5)
    assert torch.equal(_bits(got), _bits(kd.keyed_dropout_plain(x, seed, ids, 0.8, 5)))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_keyed_dropout_on_the_card_raises_for_a_dtype_the_kernel_does_not_take(cuda_device, dtype):
    """No silent plain route on the card: the dispatch launches or raises."""
    ids = _ids("forward", 64, np.random.RandomState(3), cuda_device)
    x = torch.ones(64, 8, dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError, match="no kernel"):
        kd.keyed_dropout(x, _seed(1, cuda_device), ids, 0.9)


def test_keyed_dropout_kernel_replays_a_rewritten_seed(cuda_device):
    rng = np.random.RandomState(2)
    e, c = 8192, 128
    ids = _ids("forward", e, rng, cuda_device)
    x = torch.from_numpy(rng.randn(e, c).astype(np.float32)).to(cuda_device)
    seed = _seed(11, cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kd.keyed_dropout_kernel(x, seed, ids, 0.9)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kd.keyed_dropout_kernel(x, seed, ids, 0.9)
    outs = []
    for value in (11, 2**32 - 1):
        seed.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(kd.keyed_dropout_plain(x, _seed(value, cuda_device), ids, 0.9)))
        outs.append(out.clone())
    assert not torch.equal(outs[0], outs[1])


def test_a_graph2seq_train_step_launches_the_kernel_16_times(cuda_device, monkeypatch):
    """8 gated positions, a forward and a transposed mask each: 16 launches,
    the elements hashed as before; the loss and gradients as the plain
    masks give them (float32 rounding aside: the step's other sums run in
    atomic order)."""
    from ptgnn_tpu_torch.implementations.graph2seq.harness import build_graph2seq
    from ptgnn_tpu_torch.implementations.graph2seq.train import g2s_padding
    from ptgnn_tpu_torch.utils.synthetic import synthetic_graph2seq_samples

    padding = g2s_padding(max_nodes=1024, max_graphs=8)
    samples = list(synthetic_graph2seq_samples(24, seed=3, mean_nodes=60, max_nodes=150))
    _, module, mbs = build_graph2seq(padding=padding, samples=samples, embedding_size=32, device=cuda_device)
    mb = tree_to(mbs[0], cuda_device)

    def step():
        module.zero_grad(set_to_none=True)
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(7)
        loss, _ = module_loss(module, mb, train=True, generator=gen)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), [p.grad.clone() for p in module.parameters() if p.grad is not None]

    sk.reset_launch_counts()
    loss, grads = step()
    counts = sk.launch_counts()
    assert counts["keyed_dropout"] == 16
    assert counts["keyed_dropout_elements"] == 2 * 8 * padding.max_edge_slots * 32
    monkeypatch.setattr(fused_mp, "keyed_dropout", kd.keyed_dropout_plain)
    plain_loss, plain_grads = step()
    assert sk.launch_counts()["keyed_dropout"] == 16  # the plain masks launch nothing
    np.testing.assert_allclose(loss, plain_loss, rtol=1e-5)
    assert len(grads) == len(plain_grads)
    for g, p in zip(grads, plain_grads):
        scale = float(p.abs().max())
        np.testing.assert_allclose(g.cpu().numpy(), p.cpu().numpy(), rtol=1e-4, atol=1e-4 * scale)
