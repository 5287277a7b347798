"""The whole serving slice: the port's Graph2Class against the JAX
package's, with the JAX parameters loaded through ``convert.py``.

The eval loss agrees to rtol 1e-4 / atol 1e-5. Logits agree to rtol 1e-4
and an absolute 1e-4 of the largest logit: each operation of a layer differs
by a few float32 ulps between the packages (erf, LayerNorm, matmul order;
one layer from identical inputs agrees to 1e-5, see test_torch_fused_mp.py),
and the eight layers and the classifier's
uniform(0, 1) weights carry that to about 1e-5 of the logit scale, so a
near-zero logit cannot meet an absolute 1e-5. Predictions agree wherever the
top-2 logit margin exceeds 1e-4. The JAX side runs both its CPU default path
(XLA segment ops) and its fused path with the Pallas kernels interpreted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
from ptgnn_tpu.utils.synthetic import synthetic_typilus_graphs as jax_graphs
from ptgnn_tpu_torch.convert import load_jax_params
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs
from tests.torch_port_helpers import force_jax_fused_interpret

HIDDEN = 16
KW = dict(hidden_state_size=HIDDEN, num_minibatches=2, minibatch_size=8)


@pytest.fixture(params=["jax_default", "jax_fused_interpret"])
def both(request, monkeypatch):
    if request.param == "jax_fused_interpret":
        force_jax_fused_interpret(monkeypatch)
    jmodel, jmodule, params, jmbs = jax_build(padding=jax_small_padding(max_nodes=256), **KW)
    tmodel, tmodule, tmbs = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", **KW)
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))
    return jmodel, jmodule, params, jmbs, tmodel, tmodule, tmbs


def test_stack_is_the_benchmark_architecture(both):
    tmodule = both[5]
    layers = tmodule.gnn.message_passing_layers
    assert len(layers) == 12
    mlp = [l for l in layers if type(l).__name__ == "MlpMessagePassingLayer"]
    assert len(mlp) == 8 and all(l.aggregation_fn == "max" for l in mlp)
    assert [l.input_state_dimension for l in mlp] == [HIDDEN] * 3 + [2 * HIDDEN] + [HIDDEN] * 3 + [2 * HIDDEN]


def test_eval_loss_and_logits_match_jax(both):
    _, jmodule, params, jmbs, _, tmodule, tmbs = both
    for jmb, tmb in zip(jmbs, tmbs):
        jbatch = jax.tree_util.tree_map(jnp.asarray, jmb["batch"])
        jloss, _ = jmodule.apply(params, jbatch, jnp.asarray(jmb["target_classes"]), train=False)
        jlogits = np.asarray(jmodule._logits(params, jbatch, train=False, rng=None)[0])
        batch = tmb["batch"].to("cpu")
        tsk.reset_launch_counts()
        with torch.inference_mode():
            tloss, metrics = tmodule(batch, torch.from_numpy(tmb["target_classes"]))
            tlogits = tmodule._logits(batch, train=False)[0].numpy()
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4 * np.abs(jlogits).max())
        top2 = np.sort(jlogits, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 1e-4
        assert decided.mean() > 0.9
        np.testing.assert_array_equal(tlogits.argmax(-1)[decided], jlogits.argmax(-1)[decided])
        assert int(metrics["num_samples"]) > 0


def test_predict_and_report_accuracy_match_jax(both):
    jmodel, jmodule, params, _, tmodel, tmodule, _ = both
    data = dict(seed=3, mean_nodes=60, max_nodes=200)
    jpreds = list(jmodel.predict(jax_graphs(6, **data), params, jmodule))
    tpreds = list(tmodel.predict(synthetic_typilus_graphs(6, **data), tmodule, device="cpu"))
    assert len(tpreds) == len(jpreds) == 6
    for (jg, jp), (tg, tp) in zip(jpreds, tpreds):
        assert jg["filename"] == tg["filename"] and sorted(jp) == sorted(tp)
        for idx in jp:
            assert tp[idx][0] == jp[idx][0]
            np.testing.assert_allclose(tp[idx][1], jp[idx][1], rtol=1e-4, atol=1e-6)
    jacc = jmodel.report_accuracy(jax_graphs(6, **data), params, jmodule)
    tacc = tmodel.report_accuracy(synthetic_typilus_graphs(6, **data), tmodule, device="cpu")
    assert tacc == pytest.approx(jacc)


def test_each_built_module_owns_its_layers():
    model, first, _ = build_graph2class(padding=small_padding(max_nodes=256), hidden_state_size=8, device="cpu")
    second = model.build_neural_module(device="cpu", seed=0)
    for a, b in zip(first.parameters(), second.parameters()):
        assert a is not b and torch.equal(a, b)
