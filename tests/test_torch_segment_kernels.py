"""The port's segment extremum and receiver broadcast against the JAX
package's Pallas kernels (interpreted), bitwise, and the port's plain
planned sum/mean against the interpreted sum kernel. The CUDA kernels
against their plain versions: tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.ops.pallas import segment_kernels as jsk
from ptgnn_tpu_torch.graph.batching import _assemble_layout_python
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from tests.torch_port_helpers import bits, force_jax_fused_interpret, to_dtype_pair

N_PAD, R, TILE, ALIGN = 256, 64, 32, 128


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    force_jax_fused_interpret(monkeypatch)


def make_layout(seed=0, num_edges=900, num_types=3):
    """A unified layout over N_PAD slots: nodes >= 200 have no edges, node 7
    has enough edges to span several tiles."""
    rng = np.random.RandomState(seed)
    recv = np.concatenate([rng.randint(0, 200, num_edges), np.full(70, 7)]).astype(np.int32)
    send = rng.randint(0, 200, len(recv)).astype(np.int32)
    types = rng.randint(0, num_types, len(recv)).astype(np.int32)
    layout = _assemble_layout_python(
        send, recv, types, np.full(len(recv), -1, np.int32),
        max_nodes=N_PAD, e_pad=4096, tile=TILE, agg_rows=R, num_types=num_types, align=ALIGN,
    )
    (senders, receivers, _, local_rows, mask, _, tile_row_blocks, counts, _) = layout
    # All-masked rows: every edge into receivers 3 and 11 is masked out.
    mask = mask & ~np.isin(receivers, [3, 11])
    return receivers, local_rows, mask, tile_row_blocks, counts


def plans(local_rows, tile_row_blocks, counts, tile):
    jplan = jsk.AggregationPlan(
        perm=None,
        local_rows=jnp.asarray(local_rows.reshape(-1, 1)),
        local_rows_row=jnp.asarray(jsk.replicate_rows_sublanes(local_rows, tile)),
        tile_row_blocks=jnp.asarray(tile_row_blocks),
        counts=jnp.asarray(counts),
    )
    tplan = tsk.AggregationPlan(
        torch.from_numpy(local_rows), torch.from_numpy(tile_row_blocks), torch.from_numpy(counts)
    )
    return jplan, tplan


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduction", ["max", "min"])
def test_extremum_plain_matches_jax_kernel_bitwise(reduction, dtype, m):
    receivers, local_rows, mask, trb, counts = make_layout(seed=m)
    jplan, tplan = plans(local_rows, trb, counts, TILE)
    data = np.random.RandomState(1).randn(len(receivers), m)
    jdata, tdata = to_dtype_pair(data, dtype)
    n = 230
    expected = jsk.planned_segment_reduce(
        jdata, jnp.asarray(receivers), jplan, n, reduction, jnp.asarray(mask)
    )
    got = tsk.planned_segment_reduce(tdata, tplan, n, reduction, torch.from_numpy(mask))
    assert got.dtype == tdata.dtype and tuple(got.shape) == (n, m)
    np.testing.assert_array_equal(bits(got), bits(expected))
    # The cases the test is for: empty rows and all-masked rows read 0.
    assert not got[200:].float().any() and not got[[3, 11]].float().any()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("granularity", ["edge_tile", "supertile"])
def test_broadcast_plain_matches_jax_kernel_bitwise(granularity, dtype, d):
    receivers, local_rows, _, trb, counts = make_layout(seed=d + 1)
    tile = TILE
    if granularity == "supertile":
        tile = ALIGN
        trb = np.ascontiguousarray(trb.reshape(-1, ALIGN // TILE)[:, 0])
    jplan, tplan = plans(local_rows, trb, counts, tile)
    n = 250  # shorter than the plan's 256 rows: JAX pads, the port masks
    jtab, ttab = to_dtype_pair(np.random.RandomState(2).randn(n, d), dtype)
    expected = jsk.planned_broadcast_to_edges(jtab, jnp.asarray(receivers), jplan)
    got = tsk.planned_broadcast_to_edges(ttab, tplan)
    np.testing.assert_array_equal(bits(got), bits(expected))
    assert not got[local_rows == R].float().any()  # sentinel slots read 0


@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("granularity", ["edge_tile", "supertile"])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_plain_sum_and_mean_match_jax_kernel(reduction, granularity, m):
    """f32; only the summation order differs, hence rtol/atol 1e-5."""
    receivers, local_rows, mask, trb, counts = make_layout(seed=m + 2)
    tile = TILE
    if granularity == "supertile":
        tile = ALIGN
        trb = np.ascontiguousarray(trb.reshape(-1, ALIGN // TILE)[:, 0])
    jplan, tplan = plans(local_rows, trb, counts, tile)
    data = np.random.RandomState(4).randn(len(receivers), m).astype(np.float32)
    n = 230
    expected = jsk.planned_segment_reduce(
        jnp.asarray(data), jnp.asarray(receivers), jplan, n, reduction, jnp.asarray(mask)
    )
    got = tsk.planned_segment_reduce(torch.from_numpy(data), tplan, n, reduction, torch.from_numpy(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    assert not got[200:].any() and not got[[3, 11]].any()


def test_sum_on_cuda_tensor_raises_until_ported():
    receivers, local_rows, _, trb, counts = make_layout()
    _, tplan = plans(local_rows, trb, counts, TILE)
    meta = torch.zeros((len(receivers), 4), device="meta")
    with pytest.raises(NotImplementedError):
        tsk.planned_segment_sum(meta, tplan, 10)
