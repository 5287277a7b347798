"""The typed matmul route of the port (``ops/typed_linear.py``) against the
JAX package's Pallas typed matmul, interpreted on the CPU.

Tolerances. The output and dx are bf16 results of float32 sums taken in
another order: within 2 bf16 ulps. dW is a float32 sum of exact bf16
products: rtol 1e-5 and 1e-5 of its largest magnitude.
"""
import jax
import jax.experimental.pallas as pl_mod
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ptgnn_tpu.ops import typed_linear as jtl
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from ptgnn_tpu_torch.ops import typed_linear as tl
from tests.torch_port_helpers import bits, to_dtype_pair

NT, TILE, D, M, T = 12, 16, 256, 128, 3


@pytest.fixture
def interpret_pallas(monkeypatch):
    if jax.default_backend() != "tpu":
        real_call = pl_mod.pallas_call

        def patched(*args, **kwargs):
            kwargs["interpret"] = True
            kwargs.pop("cost_estimate", None)
            return real_call(*args, **kwargs)

        monkeypatch.setattr(pl_mod, "pallas_call", patched)


def _inputs(seed=1, nt=NT, tile=TILE, d=D, m=M, num_types=T):
    rng = np.random.RandomState(seed)
    x = rng.randn(nt * tile, d).astype(np.float32)
    w = (rng.randn(num_types, d, m) * 0.05).astype(np.float32)
    tt = np.sort(rng.randint(0, num_types, nt)).astype(np.int32)
    dy = rng.randn(nt * tile, m).astype(np.float32)
    return x, w, tt, dy


def assert_within_bf16_ulps(got, want, ulps=2):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulps * ulp), float(np.max(np.abs(got - want) / ulp))


def test_plain_version_and_its_backward_match_the_pallas_kernel(interpret_pallas):
    x, w, tt, dy = _inputs()
    jx, tx = to_dtype_pair(x, "bfloat16")
    jdy, tdy = to_dtype_pair(dy, "bfloat16")
    jy, vjp = jax.vjp(lambda a, b: jtl._pallas_typed_matmul(a, b, jnp.asarray(tt), TILE), jx, jnp.asarray(w))
    jdx, jdw = vjp(jdy)

    tx.requires_grad_(True)
    tw = torch.from_numpy(w.copy()).requires_grad_(True)
    tsk.reset_launch_counts()
    ty = tl._TypedMatmul.apply(tx, tw, torch.from_numpy(tt), TILE)
    ty.backward(tdy)
    assert ty.dtype == torch.bfloat16 and tx.grad.dtype == torch.bfloat16 and tw.grad.dtype == torch.float32
    assert tsk.launch_counts()["typed_matmul"] == 0  # the CPU ran the plain version
    assert_within_bf16_ulps(ty.detach().float().numpy(), np.asarray(jy, np.float32))
    assert_within_bf16_ulps(tx.grad.float().numpy(), np.asarray(jdx, np.float32))
    jdw = np.asarray(jdw)
    np.testing.assert_allclose(tw.grad.numpy(), jdw, rtol=1e-5, atol=1e-5 * np.abs(jdw).max())


def test_plain_version_is_the_float64_product_rounded_once():
    x, w, tt, _ = _inputs(seed=2)
    for dtype in (torch.float32, torch.bfloat16):
        tx = torch.from_numpy(x).to(dtype)
        tw = torch.from_numpy(w).to(dtype)
        got = tl.typed_matmul_plain(tx, tw, torch.from_numpy(tt), TILE)
        ref = torch.bmm(tx.double().reshape(NT, TILE, D), tw.double()[torch.from_numpy(tt).long()]).reshape(-1, M)
        scale = torch.bmm(tx.double().abs().reshape(NT, TILE, D),
                          tw.double().abs()[torch.from_numpy(tt).long()]).reshape(-1, M)
        assert got.dtype == dtype
        assert bool(((got.double() - ref).abs() <= 2.0 ** -8 * ref.abs() + 1e-5 * scale).all())


def test_plain_version_reads_zeros_for_a_type_out_of_range():
    x, w, tt, _ = _inputs(seed=3)
    tt = tt.copy()
    tt[[0, 5]] = [T, -1]
    got = tl.typed_matmul_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tt), TILE)
    rows = got.reshape(NT, TILE, M)
    assert not rows[0].any() and not rows[5].any() and rows[1].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_invariant_under_tile_and_row_permutations(dtype):
    """Each output row depends only on its input row and its tile's type:
    permuting tiles of one type and rows inside a tile permutes the output,
    bit for bit."""
    x, w, tt, _ = _inputs(seed=4)
    rng = np.random.RandomState(5)
    tile_perm = np.arange(NT)
    for t in range(T):  # shuffle the tiles of each type among themselves
        idx = np.nonzero(tt == t)[0]
        tile_perm[idx] = rng.permutation(idx)
    row_perm = np.concatenate([tile_perm[i] * TILE + rng.permutation(TILE) for i in range(NT)])
    tx = torch.from_numpy(x).to(dtype)
    tw = torch.from_numpy(w).to(dtype)
    ttt = torch.from_numpy(tt)
    base = tl.typed_matmul_plain(tx, tw, ttt, TILE)
    permuted = tl.typed_matmul_plain(tx[torch.from_numpy(row_perm)], tw, ttt, TILE)
    np.testing.assert_array_equal(bits(permuted), bits(base[torch.from_numpy(row_perm)]))


# (x shape, W shape, gate open in bf16): PPI's forward messages, its
# backward cotangents, and Graph2Class's 64- and 128-wide layers.
GATE_CASES = {
    "ppi_forward": ((122880, 512), (3, 512, 256), True),
    "ppi_backward": ((122880, 256), (3, 256, 256), True),
    "graph2class_64": ((49152, 128), (11, 128, 64), False),
    "graph2class_128": ((49152, 256), (11, 256, 128), False),
    "small_stack": ((12800, 512), (3, 512, 256), False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gate_matches_jax_without_its_tpu_clauses(case, dtype, monkeypatch):
    x_shape, w_shape, opens_in_bf16 = GATE_CASES[case]
    x = torch.empty(x_shape, dtype=getattr(torch, dtype), device="meta")
    w = torch.empty(w_shape, dtype=x.dtype, device="meta")
    port = tl.use_typed_matmul_kernel(x, w, 128)
    assert port == (opens_in_bf16 and dtype == "bfloat16")
    # JAX's gate on a TPU, without its environment override.
    monkeypatch.delenv("PTGNN_TPU_TYPED_MM_PALLAS", raising=False)
    monkeypatch.setattr(jtl.jax, "default_backend", lambda: "tpu")
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jax_gate = jtl._use_pallas_typed_matmul(
        jax.ShapeDtypeStruct(x_shape, jdtype), jax.ShapeDtypeStruct(w_shape, jdtype), 128
    )
    assert port == jax_gate


def test_typed_tile_matmul_routes_by_the_gate(monkeypatch):
    x, w, tt, _ = _inputs(seed=6)
    tx = torch.from_numpy(x.astype(ml_dtypes.bfloat16).astype(np.float32)).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    ttt = torch.from_numpy(tt)
    calls = []
    real = tl.typed_matmul_plain
    monkeypatch.setattr(tl, "typed_matmul_plain", lambda *a: calls.append(1) or real(*a))
    bmm = tl.typed_tile_matmul(tx, tw, ttt, TILE)  # a small stack: the gate stays closed
    assert not calls
    monkeypatch.setattr(tl, "use_typed_matmul_kernel", lambda *a: True)
    routed = tl.typed_tile_matmul(tx, tw, ttt, TILE)
    assert calls == [1]
    assert torch.equal(routed, real(tx, tw, ttt, TILE))
    # CPU bf16 bmm rounds partial sums its own way: a few bf16 ulps apart.
    np.testing.assert_allclose(routed.float().numpy(), bmm.float().numpy(), rtol=2 ** -5,
                               atol=2 ** -7 * float(bmm.float().abs().max()))


def test_kernel_wrapper_refuses_a_cpu_tensor():
    x, w, tt, _ = _inputs(seed=7)
    with pytest.raises(ValueError, match="no kernel for a tensor on cpu"):
        tl.typed_matmul_kernel(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(tt), TILE)
