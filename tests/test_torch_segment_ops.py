"""The port's stock-op segment reductions (``ptgnn_tpu_torch/ops/segment.py``)
against the JAX package's (``ptgnn_tpu/ops/segment.py``) on the CPU: values
and gradients of every function on the same numpy-seeded inputs, in five
cases: plain; masked with out-of-range (padding) ids; empty and fully masked
segments; exact ties (coarse values, and one segment all equal); bf16 inputs
accumulated in float32.

Tolerances. float32: rtol 1e-5, atol 1e-6 (the two packages may add in
another order). bf16 outputs and gradients: rtol and atol 2^-7, one bf16
rounding step. Counts, argmax indices and the infinities are compared
exactly. The gradient is that of sum(out * cotangent) over the finite
outputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.ops import segment as jseg
from ptgnn_tpu_torch.ops import segment as tseg
from tests.torch_port_helpers import to_dtype_pair

E, S, D = 48, 7, 3
CASES = ("plain", "masked_oob", "empty", "ties", "bf16")
DIFFERENTIABLE = ("sum", "mean", "max", "min", "logsumexp", "log_softmax", "softmax",
                  "reduce_sum", "reduce_mean", "reduce_max", "reduce_min")


def _case(case: str, seed: int = 0):
    """(data [E, D] float64, ids [E] int32, mask [E] bool or None, dtype)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, S, E).astype(np.int32)
    data = rng.randn(E, D)
    mask = None
    if case == "masked_oob":
        mask = rng.rand(E) < 0.7
        ids[rng.rand(E) < 0.2] = S  # padding points past the last segment
    elif case == "empty":
        ids = rng.randint(0, S - 2, E).astype(np.int32)  # segments S-2 and S-1 receive nothing
        mask = ids != 0  # segment 0 is fully masked
    elif case == "ties":
        data = np.round(data)  # many exact ties
        data[ids == 1] = 2.0  # one segment all equal
        data[ids == 2, 0] = -3.0
    return data, ids, mask, ("bfloat16" if case == "bf16" else "float32")


def _call(mod, name, data, ids, mask):
    if name.startswith("reduce_"):
        return mod.segment_reduce(data, ids, S, name[len("reduce_"):], mask)
    return getattr(mod, f"segment_{name}")(data, ids, S, mask)


def _assert_close(got: torch.Tensor, want, dtype: str, what: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want), err_msg=what)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=what)
    tol = 2.0 ** -7 if dtype == "bfloat16" else None
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=tol or 1e-5, atol=tol or 1e-6, err_msg=what)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", DIFFERENTIABLE)
def test_values_and_gradients_match_jax(name, case):
    data, ids, mask, dtype = _case(case)
    jdata, tdata = to_dtype_pair(data, dtype)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    cot = np.random.RandomState(1).randn(S if name not in ("log_softmax", "softmax") else E, D).astype(np.float32)

    def jloss(x):
        out = _call(jseg, name, x, jids, jmask).astype(jnp.float32)
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * cot)

    expected = _call(jseg, name, jdata, jids, jmask)
    jgrad = jax.grad(jloss)(jdata)
    x = tdata.clone().requires_grad_()
    out = _call(tseg, name, x, tids, tmask)
    assert out.dtype == tdata.dtype and tuple(out.shape) == tuple(expected.shape)
    torch.where(torch.isfinite(out.float()), out.float(), 0.0).mul(torch.from_numpy(cot)).sum().backward()
    _assert_close(out, expected, dtype, f"{name} value")
    assert x.grad.dtype == tdata.dtype and torch.isfinite(x.grad.float()).all()
    _assert_close(x.grad, jgrad, dtype, f"{name} gradient")
    if case == "empty" and name not in ("log_softmax", "softmax"):
        # segment 0 fully masked, S-2 and S-1 empty: logsumexp -inf, the rest 0
        empty = out.detach().float().numpy()[[0, S - 2, S - 1]]
        assert np.all(np.isneginf(empty)) if name == "logsumexp" else np.all(empty == 0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ("count", "argmax", "max_no_fill", "min_no_fill"))
def test_counts_argmax_and_unfilled_extrema_match_jax(name, case):
    data, ids, mask, dtype = _case(case)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    if name == "count":
        expected = jseg.segment_count(jids, S, jmask)
        got = tseg.segment_count(tids, S, tmask)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
        return
    jdata, tdata = to_dtype_pair(data[:, 0] if name == "argmax" else data, dtype)
    if name == "argmax":
        expected = jseg.segment_argmax(jdata, jids, S, jmask)
        got = tseg.segment_argmax(tdata, tids, S, tmask)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
        return
    fn = name[:3]
    expected = getattr(jseg, f"segment_{fn}")(jdata, jids, S, jmask, empty_fill=None)
    got = getattr(tseg, f"segment_{fn}")(tdata, tids, S, tmask, empty_fill=None)
    _assert_close(got, expected, dtype, name)


def test_argmax_takes_the_first_occurrence_and_len_for_empty_segments():
    data = torch.tensor([1.0, 5.0, 5.0, 2.0, 7.0, 7.0, 0.0])
    ids = torch.tensor([0, 0, 0, 1, 1, 1, 3], dtype=torch.int32)
    mask = torch.tensor([True, True, True, True, False, True, False])
    # segment 1: slot 4 is masked, so its 7.0 at slot 5 wins; segments 2 and 3 are empty
    np.testing.assert_array_equal(tseg.segment_argmax(data, ids, 4, mask).numpy(), [1, 5, 7, 7])
    np.testing.assert_array_equal(tseg.segment_argmax(data, ids, 4).numpy(), [1, 4, 7, 6])


def test_max_splits_its_gradient_evenly_among_exact_ties():
    x = torch.tensor([3.0, 3.0, 1.0, 3.0, -1.0, -1.0], requires_grad=True)
    ids = torch.tensor([0, 0, 0, 0, 1, 1])
    tseg.segment_max(x, ids, 2).backward(torch.tensor([1.0, 2.0]))
    np.testing.assert_allclose(x.grad.numpy(), [1 / 3, 1 / 3, 0.0, 1 / 3, 1.0, 1.0], rtol=1e-7)


def test_masked_take_fills_out_of_range_rows():
    values = torch.arange(6.0).reshape(3, 2)
    got = tseg.masked_take(values, torch.tensor([2, 3, -1, 0]), -5.0)
    np.testing.assert_array_equal(got.numpy(), [[4, 5], [-5, -5], [-5, -5], [0, 1]])
    expected = jnp.take(jnp.asarray(values.numpy()), jnp.array([2, 3, 0]), axis=0, mode="fill", fill_value=-5.0)
    np.testing.assert_array_equal(got[[0, 1, 3]].numpy(), np.asarray(expected))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_and_its_summing_backward_match_jax(dtype):
    """``take_rows`` with repeated ids (on the CPU, ``index_select``) and the
    route it takes on the card (``_TakeRows``: the backward sums each row's
    cotangents with ``segment_sum``), both run here: the rows and the
    gradient of sum(rows * cotangent) against JAX's ``take`` and its grad."""
    rng = np.random.RandomState(2)
    idx = rng.randint(0, S, E).astype(np.int32)
    jvalues, tvalues = to_dtype_pair(rng.randn(S, D), dtype)
    cot = rng.randn(E, D).astype(np.float32)
    expected = jnp.take(jvalues, jnp.asarray(idx), axis=0)
    jgrad = jax.grad(lambda v: jnp.sum(jnp.take(v, jnp.asarray(idx), axis=0).astype(jnp.float32) * cot))(jvalues)
    for route in (tseg.take_rows, tseg._TakeRows.apply):
        x = tvalues.clone().requires_grad_()
        out = route(x, torch.from_numpy(idx).long())
        out.float().mul(torch.from_numpy(cot)).sum().backward()
        assert out.dtype == x.grad.dtype == tvalues.dtype
        _assert_close(out, expected, dtype, f"{route} value")
        _assert_close(x.grad, jgrad, dtype, f"{route} gradient")
