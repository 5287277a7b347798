"""The port's VarMisuse against the JAX package's on the CPU, at a small size
(hidden 32, the 1,024-node padding of tests/test_varmisuse.py): the char
tensorizer's ids, the SubtokenOf derivation and the finalized minibatches
bitwise; the char-CNN embedder, the var-sized reduces and the GRU global
state update with converted params (values and gradients); the whole model
in both factories ('mlp' and 'ggnn', eval mode) with the JAX side's fused
path interpreted; the CLI for one epoch and a restored run; and
``convert.py``'s refusal of unknown and missing VarMisuse keys.

Tolerances. A module alone: rtol 1e-5 and atol 1e-5 (float32 products add
in another order). The whole model: the loss to rtol 1e-5, the accuracy
sums exactly, and every parameter gradient to rtol 1e-4 and 1e-4 of its
tensor's largest magnitude, as tests/test_torch_ggnn.py holds a training
step. Dropout is off: torch cannot reproduce JAX's random bits.

Why hidden 32: the 'ggnn' stack's last global update has the worst
conditioned gradient, its gate weight's (a sum of products of small node
states). At hidden 16 the port's own float32 gradient of it lies 3.6e-4 of
its largest magnitude from the port's float64 one, and JAX's 1.05e-3: both
beyond the 1e-4 asked of them, by float32 rounding alone. At hidden 32 both
sides' rounding sits inside it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.embedders import CharUnitEmbedder as JaxCharUnitEmbedder
from ptgnn_tpu.graph.embedders import CnnConfig as JaxCnnConfig
from ptgnn_tpu.graph.messagepassing import GraphContext as JaxGraphContext
from ptgnn_tpu.graph.messagepassing import GruGlobalStateUpdate as JaxGruGlobalStateUpdate
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.graph.structs import GraphData as JaxGraphData
from ptgnn_tpu.implementations.varmisuse.train import create_var_misuse_gnn_model as jax_create
from ptgnn_tpu.implementations.varmisuse.varmisuse import VarMisuseModel as JaxVarMisuseModel
from ptgnn_tpu import reduceops as jreduce
from ptgnn_tpu.utils.text import CharTensorizer as JaxCharTensorizer
from ptgnn_tpu_torch import reduceops as treduce
from ptgnn_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from ptgnn_tpu_torch.core.trainer import _cast_parameters, module_loss
from ptgnn_tpu_torch.graph.embedders import CharUnitEmbedder, CnnConfig
from ptgnn_tpu_torch.graph.messagepassing import GraphContext, GruGlobalStateUpdate
from ptgnn_tpu_torch.graph.structs import BatchPadding, GraphData, tree_to
from ptgnn_tpu_torch.implementations.varmisuse import train as vm_train
from ptgnn_tpu_torch.implementations.varmisuse.harness import build_varmisuse
from ptgnn_tpu_torch.implementations.varmisuse.varmisuse import VarMisuseModel
from ptgnn_tpu_torch.utils import io
from ptgnn_tpu_torch.utils.synthetic import synthetic_varmisuse_samples
from ptgnn_tpu_torch.utils.text import CharTensorizer
from tests.test_torch_batching import assert_adjacency_equal
from tests.test_torch_ggnn import _assert_close_per_tensor
from tests.torch_port_helpers import force_jax_fused_interpret

HIDDEN = 32
PAD = dict(max_nodes=1024, max_edge_slots=1024 * 10, max_graphs=8, edge_tile=64,
           reference_budgets=(("candidate_nodes", 64), ("slot_node_idx", 8)))


def _samples(n=16, seed=1):
    return list(synthetic_varmisuse_samples(n, seed=seed))


def _jax_build(architecture, samples, seed=1):
    """(JAX module, params, host minibatches) on the same samples."""
    model = jax_create(hidden_state_size=HIDDEN, padding=JaxBatchPadding(**PAD), architecture=architecture)
    model.compute_metadata(iter(samples), parallelize=False)
    module = model.build_neural_module()
    params = module.init(jax.random.PRNGKey(seed))
    mbs = [mb for mb, _ in model.minibatch_iterator(
        model.tensorize_dataset(iter(samples), parallelize=False), max_minibatch_size=8, parallelize=False)]
    return module, params, mbs


def _torch_build(architecture, samples):
    return build_varmisuse(padding=BatchPadding(**PAD), samples=samples, hidden_state_size=HIDDEN,
                           architecture=architecture, device="cpu", minibatch_size=8, seed=3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("lower_case_all,include_space", [(False, False), (True, False), (False, True)])
def test_char_tensorizer_ids_bitwise(lower_case_all, include_space):
    words = ["getValue", "x", "Ünïcode ok", "a_b-c.d[0]", "", "averyveryverylongidentifier99", "{}<>|\\\"'"]
    j = JaxCharTensorizer(15, lower_case_all=lower_case_all, include_space=include_space)
    t = CharTensorizer(15, lower_case_all=lower_case_all, include_space=include_space)
    assert t.num_chars_in_vocabulary() == j.num_chars_in_vocabulary()
    for w in words:
        got, want = t.tensorize_str(w), j.tensorize_str(w)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=w)


def test_subtoken_vocab_derivation_matches_jax():
    for sample in _samples(6, seed=4):
        graph = sample["ContextGraph"]
        nodes = [(graph["NodeLabels"][str(i)], False) for i in range(len(graph["NodeLabels"]))]
        edges = {t: list(e) for t, e in graph["Edges"].items()}
        jg = JaxGraphData(node_information=list(nodes), edges=dict(edges), reference_nodes={})
        tg = GraphData(node_information=list(nodes), edges=dict(edges), reference_nodes={})
        JaxVarMisuseModel._VarMisuseModel__add_subtoken_vocab_nodes(jg)
        VarMisuseModel._VarMisuseModel__add_subtoken_vocab_nodes(tg)
        assert tg.node_information == jg.node_information and len(tg.node_information) > len(nodes)
        assert tg.edges == jg.edges and len(tg.edges["SubtokenOf"]) > 0


def test_minibatches_bitwise():
    samples = _samples()
    _, _, jmbs = _jax_build("mlp", samples)
    _, _, tmbs = _torch_build("mlp", samples)
    assert len(tmbs) == len(jmbs) == 2
    for jmb, tmb in zip(jmbs, tmbs):
        np.testing.assert_array_equal(tmb["correct_candidate_idxs"], jmb["correct_candidate_idxs"])
        jb, tb = jmb["batch"], tmb["batch"]
        assert_adjacency_equal(jb.adjacency, tb.adjacency)
        np.testing.assert_array_equal(tb.node_data["node_data"]["chars"], np.asarray(jb.node_data["node_data"]["chars"]))
        np.testing.assert_array_equal(tb.node_data["is_candidate"], np.asarray(jb.node_data["is_candidate"]))
        for name in ("node_graph", "node_mask", "graph_mask", "num_nodes", "num_edges", "num_graphs"):
            np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)), err_msg=name)
        for ref in ("candidate_nodes", "slot_node_idx"):
            for field in ("node_ids", "graph_ids", "mask"):
                np.testing.assert_array_equal(getattr(tb.references[ref], field),
                                              np.asarray(getattr(jb.references[ref], field)))


def _load(module, params):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})


@pytest.mark.parametrize("amp", [False, True])
def test_char_unit_embedder_matches_jax(amp):
    """Under bf16 AMP (bf16 weights) the CNN still convolves a float32
    one-hot in float32, as JAX's, and returns float32."""
    config = CnnConfig(32, 3, 16, 3, 3)
    jemb = JaxCharUnitEmbedder(96, 12, JaxCnnConfig(*config))
    params = _np(jemb.init(jax.random.PRNGKey(5)))
    temb = CharUnitEmbedder(96, 12, config)
    temb.load_state_dict({f"{c}.{k}": torch.from_numpy(np.array(v)) for c, p in params.items() for k, v in p.items()})
    chars = np.random.RandomState(0).randint(0, 96, (40, 15)).astype(np.int32)
    cot = np.random.RandomState(1).randn(40, 12).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16 if amp else jnp.float32), params)

    def f(p):
        return jnp.sum(jemb.apply(p, jnp.asarray(chars)) * cot)

    expected = jemb.apply(jparams, jnp.asarray(chars))
    jgrads = jax.grad(f)(jparams)
    with _cast_parameters(temb, torch.bfloat16 if amp else torch.float32):
        out = temb(torch.from_numpy(chars))
    assert out.dtype == torch.float32 and expected.dtype == jnp.float32
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    tol = 2.0 ** -7 if amp else 1e-5  # a bf16 weight's gradient is rounded to bf16
    for name, p in temb.named_parameters():
        conv, key = name.split(".")
        want = np.asarray(jgrads[conv][key], np.float32)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=tol, atol=tol * np.abs(want).max(), err_msg=name)


def _reduce_pairs():
    sum_query = (lambda: jreduce.SimpleVarSizedElementReduce("sum"), lambda: treduce.SimpleVarSizedElementReduce("sum"))
    return {
        "simple_sum": sum_query,
        "simple_mean": (lambda: jreduce.SimpleVarSizedElementReduce("mean"),
                        lambda: treduce.SimpleVarSizedElementReduce("mean")),
        "simple_max": (lambda: jreduce.SimpleVarSizedElementReduce("max"),
                       lambda: treduce.SimpleVarSizedElementReduce("max")),
        "simple_min": (lambda: jreduce.SimpleVarSizedElementReduce("min"),
                       lambda: treduce.SimpleVarSizedElementReduce("min")),
        "weighted_sum": (lambda: jreduce.WeightedSumVarSizedElementReduce(6),
                         lambda: treduce.WeightedSumVarSizedElementReduce(6)),
        "normalized_weights": (lambda: jreduce.NormalizedWeightsVarSizedElementReduce(6, 5),
                               lambda: treduce.NormalizedWeightsVarSizedElementReduce(6, 5)),
        "self_attention": (
            lambda: jreduce.SelfAttentionVarSizedElementReduce(6, 6, 5, jreduce.SimpleVarSizedElementReduce("mean")),
            lambda: treduce.SelfAttentionVarSizedElementReduce(6, 6, 5, treduce.SimpleVarSizedElementReduce("mean"))),
        "multihead": (
            lambda: jreduce.MultiheadSelfAttentionVarSizedElementReduce(
                6, 6, 5, 2, jreduce.SimpleVarSizedElementReduce("sum")),
            lambda: treduce.MultiheadSelfAttentionVarSizedElementReduce(
                6, 6, 5, 2, treduce.SimpleVarSizedElementReduce("sum"))),
        "multihead_value": (
            lambda: jreduce.MultiheadSelfAttentionVarSizedElementReduce(
                6, 6, 5, 2, jreduce.WeightedSumVarSizedElementReduce(6), use_value_layer=True),
            lambda: treduce.MultiheadSelfAttentionVarSizedElementReduce(
                6, 6, 5, 2, treduce.WeightedSumVarSizedElementReduce(6), use_value_layer=True)),
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("name", sorted(_reduce_pairs()))
def test_var_sized_reduces_match_jax(name):
    """Element rows with a mask, padding rows at sample id S and one empty
    sample; values and gradients (of the elements and every parameter)."""
    make_jax, make_torch = _reduce_pairs()[name]
    jred, tred = make_jax(), make_torch()
    params = _np(jred.init(jax.random.PRNGKey(7)))
    if params:
        _load(tred, _flat(params))
    rng = np.random.RandomState(2)
    e, s = 30, 5
    x = rng.randn(e, 6).astype(np.float32)
    sample_map = rng.randint(0, s - 1, e).astype(np.int32)  # sample s-1 is empty
    sample_map[-4:] = s  # padding rows
    mask = rng.rand(e) < 0.8
    mask[-4:] = False
    out_dim = 6 if name.startswith(("simple", "weighted")) else 5
    cot = rng.randn(s, out_dim).astype(np.float32)

    def f(p, xx):
        inputs = jreduce.ElementsToSummaryRepresentationInput(xx, jnp.asarray(sample_map), s, jnp.asarray(mask))
        return jnp.sum(jred.apply(p, inputs) * cot), jred.apply(p, inputs)

    (_, expected), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tred(treduce.ElementsToSummaryRepresentationInput(tx, torch.from_numpy(sample_map), s,
                                                            torch.from_numpy(mask)))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.detach().numpy()[s - 1], 0.0 * out.detach().numpy()[s - 1])
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    flat_grads = _flat(_np(jgp)) if params else {}
    assert sorted(n for n, _ in tred.named_parameters()) == sorted(flat_grads)
    for pname, p in tred.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat_grads[pname], rtol=1e-5, atol=1e-5, err_msg=pname)


def test_gru_global_state_update_matches_jax():
    """Node states of two graphs plus padding rows (graph id G_pad) through
    the weighted-sum summary and the GRU update."""
    g_pad, n, d = 4, 20, 8
    jlayer = JaxGruGlobalStateUpdate(jreduce.WeightedSumVarSizedElementReduce(d), d, d)
    tlayer = GruGlobalStateUpdate(treduce.WeightedSumVarSizedElementReduce(d), d, d)
    params = _np(jlayer.init(jax.random.PRNGKey(9)))
    _load(tlayer, _flat(params))
    rng = np.random.RandomState(3)
    x = rng.randn(n, d).astype(np.float32)
    node_graph = np.array([0] * 7 + [1] * 9 + [g_pad] * 4, np.int32)
    node_mask = node_graph < g_pad
    graph_mask = np.arange(g_pad) < 2
    cot = rng.randn(n, d).astype(np.float32)
    jctx = JaxGraphContext(adjacency=None, edge_features=None, node_graph=jnp.asarray(node_graph),
                           node_mask=jnp.asarray(node_mask), graph_mask=jnp.asarray(graph_mask), references={})
    tctx = GraphContext(adjacency=None, node_graph=torch.from_numpy(node_graph), node_mask=torch.from_numpy(node_mask),
                        graph_mask=torch.from_numpy(graph_mask), references={})

    def f(p, xx):
        out = jlayer.apply(p, xx, jctx)
        return jnp.sum(out * cot), out

    (_, expected), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tlayer(tx, tctx)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    flat_grads = _flat(_np(jgp))
    assert sorted(n for n, _ in tlayer.named_parameters()) == sorted(flat_grads)
    for pname, p in tlayer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat_grads[pname], rtol=1e-5, atol=1e-5, err_msg=pname)


@pytest.mark.parametrize("architecture", ["mlp", "ggnn"])
def test_model_loss_metrics_and_gradients_match_jax(architecture, monkeypatch):
    force_jax_fused_interpret(monkeypatch)
    samples = _samples()
    jmodule, params, jmbs = _jax_build(architecture, samples)
    _, tmodule, tmbs = _torch_build(architecture, samples)
    load_jax_params(tmodule, _np(params))
    batch = jax.tree_util.tree_map(jnp.asarray, jmbs[0]["batch"])
    correct = jnp.asarray(jmbs[0]["correct_candidate_idxs"])

    def loss_fn(p):
        loss, metrics = jmodule.apply(p, batch, correct, train=False)
        return loss, metrics

    (jloss, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    expected = jax_params_to_state_dict(tmodule, _np(jgrads))
    loss, metrics = module_loss(tmodule, tree_to(tmbs[0], torch.device("cpu")), train=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for key in ("sum_acc", "num_samples", "num_graphs", "num_nodes", "num_edges"):
        assert int(metrics[key]) == int(jmetrics[key]), key
    assert int(metrics["num_samples"]) == 8
    got = {name: p.grad.numpy() for name, p in tmodule.named_parameters()}
    assert sorted(got) == sorted(set(got) & set(expected))
    _assert_close_per_tensor(got, expected)
    assert all(np.abs(g).max() > 0 for g in got.values())
    layers = tmodule.gnn.message_passing_layers
    if architecture == "ggnn":  # one gated layer object at 8 positions, two global updates
        assert sum(layer is layers[2] for layer in layers) == 8
        assert [type(layer).__name__ for layer in layers].count("GruGlobalStateUpdate") == 2


def _write_folds(root):
    for i, fold in enumerate(("train", "valid", "test")):
        (root / fold).mkdir()
        io.write_jsonl_gz(root / fold / "part0.jsonl.gz", synthetic_varmisuse_samples(6, seed=30 + i, mean_tokens=20))
    return [str(root / fold) for fold in ("train", "valid", "test")]


@pytest.mark.parametrize("architecture", ["mlp", "ggnn"])
def test_cli_trains_an_epoch_and_restores(architecture, tmp_path, monkeypatch, capsys):
    folds = _write_folds(tmp_path)
    monkeypatch.chdir(tmp_path)

    def run(model_path, *extra):
        args = vm_train.build_arg_parser().parse_args(
            [*folds, str(model_path), "--max-num-epochs", "1", "--minibatch-size", "4", "--max-nodes", "512",
             "--sequential-run", "--quiet", "--device", "cpu", "--architecture", architecture, *extra])
        return vm_train.run(args)

    acc = run(tmp_path / "vm.pkl.gz")
    assert 0.0 <= acc <= 1.0 and "Test accuracy:" in capsys.readouterr().out
    model, state = VarMisuseModel.restore_model(tmp_path / "vm.pkl.gz")
    module = model.build_neural_module(device="cpu")
    module.load_state_dict(state)
    kinds = {type(layer).__name__ for layer in module.gnn.message_passing_layers}
    assert ("GruGlobalStateUpdate" in kinds) == (architecture == "ggnn")
    run(tmp_path / "vm2.pkl.gz", "--restore-path", str(tmp_path / "vm.pkl.gz"))
    assert "Test accuracy:" in capsys.readouterr().out


def test_cli_rejects_what_is_not_ported(tmp_path):
    parser = vm_train.build_arg_parser()
    with pytest.raises(NotImplementedError, match="autotune"):
        vm_train.run(parser.parse_args(["a", "b", "c", str(tmp_path / "m.pkl.gz"), "--autotune"]))
    with pytest.raises(ValueError, match="pkl.gz"):
        vm_train.run(parser.parse_args(["a", "b", "c", str(tmp_path / "m.pt")]))
    with pytest.raises(ValueError, match="architecture"):
        vm_train.create_var_misuse_gnn_model(architecture="gnn_film")


def test_convert_raises_on_unknown_or_missing_varmisuse_keys():
    samples = _samples(8)
    _, params, _ = _jax_build("ggnn", samples)
    _, tmodule, _ = _torch_build("ggnn", samples)
    params = _np(params)
    update = params["gnn"]["mp_layers"][5]
    assert set(update) == {"summary", "update"} and set(update["summary"]) == {"weights"}
    assert set(params["gnn"]["node_embedder"]["embedder"]) == {"conv1", "conv2", "conv3"}

    def with_layer5(layer):
        return dict(params, gnn=dict(params["gnn"], mp_layers=[*params["gnn"]["mp_layers"][:5], layer,
                                                                 *params["gnn"]["mp_layers"][6:]]))

    with pytest.raises(KeyError, match="bogus"):
        load_jax_params(tmodule, with_layer5(dict(update, summary=dict(update["summary"], bogus=np.zeros(2)))))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(tmodule, with_layer5({"update": update["update"]}))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(tmodule, {k: v for k, v in params.items() if k != "candidate_scores"})
    load_jax_params(tmodule, params)
    np.testing.assert_array_equal(tmodule.gnn.node_embedder.embedder.conv3.weight.detach().numpy(),
                                  params["gnn"]["node_embedder"]["embedder"]["conv3"]["weight"])
