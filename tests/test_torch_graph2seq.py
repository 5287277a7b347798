"""The port's Graph2Seq against the JAX package's on the CPU, at a small size
(embedding 32, so the decoder at hidden 32 and embedding 64; the 512-node,
16-graph padding of tests/test_graph2seq.py; ``max_seq_len`` 6): the
synthetic samples, the token vocabulary and node ids, and the finalized
minibatches (the ``backbone_nodes`` reference set and the decoder arrays
included) bitwise; the token embedder with converted params; the whole
model's loss and gradients in eval mode with converted params, with the JAX
side's fused path interpreted; greedy and beam decode through the model;
the position-aligned results of dropped and duplicate samples;
``jaro_winkler``; the three CLIs for one epoch, a restored run and the test
CLI on the saved model; and ``convert.py``'s refusal of unknown and missing
Graph2Seq keys.

Tolerances. A module alone: rtol/atol 1e-5. The whole model: the loss to
rtol 1e-5, every parameter gradient to rtol 1e-4 and 1e-4 of its tensor's
largest magnitude. Decoded tokens exactly, their log-probabilities to 1e-4.
Dropout is off: torch cannot reproduce JAX's random bits."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.embedders import StrElementRepresentationModel as JaxStrModel
from ptgnn_tpu.graph.embedders import TokenUnitEmbedder as JaxTokenUnitEmbedder
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.implementations.graph2seq.train import create_graph2seq_model as jax_create
from ptgnn_tpu.utils.strsim import jaro_winkler as jax_jaro_winkler
from ptgnn_tpu.utils.synthetic import synthetic_graph2seq_samples as jax_samples
from ptgnn_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from ptgnn_tpu_torch.core.trainer import module_loss
from ptgnn_tpu_torch.graph.embedders import StrElementRepresentationModel, TokenUnitEmbedder
from ptgnn_tpu_torch.graph.structs import BatchPadding, tree_to
from ptgnn_tpu_torch.implementations.graph2seq import test as g2s_test
from ptgnn_tpu_torch.implementations.graph2seq import train as g2s_train
from ptgnn_tpu_torch.implementations.graph2seq import trainandtest as g2s_trainandtest
from ptgnn_tpu_torch.implementations.graph2seq.graph2seq import Graph2Seq
from ptgnn_tpu_torch.implementations.graph2seq.harness import batch_sizes, build_graph2seq
from ptgnn_tpu_torch.utils import io
from ptgnn_tpu_torch.utils.strsim import jaro_winkler
from ptgnn_tpu_torch.utils.synthetic import synthetic_graph2seq_samples
from tests.test_torch_batching import assert_adjacency_equal
from tests.test_torch_ggnn import _assert_close_per_tensor
from tests.torch_port_helpers import force_jax_fused_interpret

EMBEDDING = 32
PAD = dict(max_nodes=512, max_edge_slots=512 * 8, max_graphs=16, edge_tile=64,
           reference_budgets=(("backbone_nodes", 256),))


def _samples(n=40, seed=1):
    return list(synthetic_graph2seq_samples(n, seed=seed, mean_nodes=30, max_nodes=60))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_build(samples, seed=1):
    """(JAX model, module, params, host minibatches) on the same samples."""
    model = jax_create(embedding_size=EMBEDDING, padding=JaxBatchPadding(**PAD), max_seq_len=6, dropout_rate=0.0)
    model.compute_metadata(iter(samples), parallelize=False)
    module = model.build_neural_module()
    params = module.init(jax.random.PRNGKey(seed))
    mbs = [mb for mb, _ in model.minibatch_iterator(
        model.tensorize_dataset(iter(samples), parallelize=False), max_minibatch_size=8, parallelize=False)]
    return model, module, params, mbs


def _torch_build(samples):
    return build_graph2seq(padding=BatchPadding(**PAD), samples=samples, embedding_size=EMBEDDING, max_seq_len=6,
                           device="cpu", minibatch_size=8, seed=3)


@pytest.mark.parametrize("kwargs", [dict(), dict(seed=3, mean_nodes=200, max_nodes=500),
                                    dict(seed=5, backbone_fraction=0.99, name_len=5)])
def test_synthetic_samples_bitwise(kwargs):
    assert list(synthetic_graph2seq_samples(30, **kwargs)) == list(jax_samples(30, **kwargs))


def test_jaro_winkler_matches_jax():
    pairs = [("abc", "abc"), ("", "abc"), ("abc", ""), ("", ""), ("martha", "marhta"), ("prefixed", "prefixxx"),
             ("xxprefed", "yyprefxx"), ("dixon", "dicksonx"), ("getvalue", "getvalues"), ("a", "b"),
             ("jellyfish", "smellyfish"), ("crate", "trace"), ("dwayne", "duane")]
    for a, b in pairs:
        assert jaro_winkler(a, b) == jax_jaro_winkler(a, b), (a, b)
    assert jaro_winkler("prefixed", "prefixxx") > jaro_winkler("xxprefed", "yyprefxx")


def test_token_vocabulary_and_node_ids_bitwise():
    labels = [label.lower() for s in _samples(30, seed=4) for label in s["node_labels"]] + ["never_seen"]
    jm = JaxStrModel(token_splitting="token", embedding_size=8, vocabulary_size=20, min_freq_threshold=2)
    tm = StrElementRepresentationModel(token_splitting="token", embedding_size=8, vocabulary_size=20,
                                       min_freq_threshold=2)
    jm.compute_metadata(iter(labels[:-1]), parallelize=False)
    tm.compute_metadata(iter(labels[:-1]), parallelize=False)
    assert tm.vocabulary.id_to_token == jm.vocabulary.id_to_token and len(tm.vocabulary) == 20
    jmb, tmb = jm.initialize_minibatch(), tm.initialize_minibatch()
    for label in labels:
        assert tm.tensorize(label) == jm.tensorize(label)
        jm.extend_minibatch_with(jm.tensorize(label), jmb)
        tm.extend_minibatch_with(tm.tensorize(label), tmb)
    got, want = tm.finalize_minibatch(tmb, pad_to=len(labels) + 5), jm.finalize_minibatch(jmb, pad_to=len(labels) + 5)
    assert got.keys() == want.keys() == {"token_idxs"}
    assert got["token_idxs"].dtype == want["token_idxs"].dtype == np.int32
    np.testing.assert_array_equal(got["token_idxs"], want["token_idxs"])
    assert type(tm.build_neural_module()).__name__ == "TokenUnitEmbedder"


def test_token_unit_embedder_matches_jax():
    jemb = JaxTokenUnitEmbedder(30, 12, dropout_rate=0.2)
    params = _np(jemb.init(jax.random.PRNGKey(5)))
    temb = TokenUnitEmbedder(30, 12, dropout_rate=0.2)
    temb.load_state_dict({"embeddings.weight": torch.from_numpy(params["embeddings"]["weight"].copy())})
    ids = np.random.RandomState(0).randint(0, 30, 50).astype(np.int32)
    cot = np.random.RandomState(1).randn(50, 12).astype(np.float32)

    def f(p):
        return jnp.sum(jemb.apply(p, jnp.asarray(ids)) * cot)

    expected = jemb.apply(params, jnp.asarray(ids))
    jgrad = jax.grad(f)(params)["embeddings"]["weight"]
    out = temb(torch.from_numpy(ids))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(expected), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(temb.embeddings.weight.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-5)


def test_minibatches_bitwise_and_memories_contiguous():
    """Every array of the batches equal to JAX's, and each sample's
    memories one contiguous run of the backbone reference set, in the
    samples' order, as the decoder's copy matrix assumes."""
    samples = _samples()
    _, _, _, jmbs = _jax_build(samples)
    model, _, tmbs = _torch_build(samples)
    assert len(tmbs) == len(jmbs) == 5
    for jmb, tmb in zip(jmbs, tmbs):
        assert tmb.keys() == jmb.keys() == {"batch", "target_token_ids", "target_lengths", "copy_matrix"}
        for key in ("target_token_ids", "target_lengths", "copy_matrix"):
            assert tmb[key].dtype == jmb[key].dtype
            np.testing.assert_array_equal(tmb[key], jmb[key], err_msg=key)
        jb, tb = jmb["batch"], tmb["batch"]
        assert_adjacency_equal(jb.adjacency, tb.adjacency)
        np.testing.assert_array_equal(tb.node_data["token_idxs"], np.asarray(jb.node_data["token_idxs"]))
        for name in ("node_graph", "node_mask", "graph_mask", "num_nodes", "num_edges", "num_graphs"):
            np.testing.assert_array_equal(getattr(tb, name), np.asarray(getattr(jb, name)), err_msg=name)
        for field in ("node_ids", "graph_ids", "mask"):
            np.testing.assert_array_equal(getattr(tb.references["backbone_nodes"], field),
                                          np.asarray(getattr(jb.references["backbone_nodes"], field)))
    sample_iter = iter(samples)
    for tmb in tmbs:
        ref = tmb["batch"].references["backbone_nodes"]
        graphs = int(tmb["batch"].num_graphs)
        runs = [len(next(sample_iter)["backbone_sequence"]) for _ in range(graphs)]
        expected_graph_ids = np.repeat(np.arange(graphs), runs)
        real = int(ref.mask.sum())
        assert real == sum(runs) and ref.mask[:real].all()
        np.testing.assert_array_equal(ref.graph_ids[:real], expected_graph_ids)
        assert (ref.graph_ids[real:] == PAD["max_graphs"]).all() and (ref.node_ids[real:] == 0).all()
        memories = tmb["copy_matrix"].any(axis=1).nonzero()[0]
        assert (memories < real).all()
    assert batch_sizes(tmbs)[0] == (8, int(tmbs[0]["batch"].num_nodes), int(tmbs[0]["batch"].num_edges),
                                    int(tmbs[0]["batch"].references["backbone_nodes"].mask.sum()))


def _converted_pair(samples):
    jmodel, jmodule, params, jmbs = _jax_build(samples)
    tmodel, tmodule, tmbs = _torch_build(samples)
    load_jax_params(tmodule, _np(params))
    return jmodel, jmodule, params, jmbs, tmodel, tmodule, tmbs


def test_model_loss_and_gradients_match_jax(monkeypatch):
    force_jax_fused_interpret(monkeypatch)
    jmodel, jmodule, params, jmbs, tmodel, tmodule, tmbs = _converted_pair(_samples())
    jmb = jax.tree_util.tree_map(jnp.asarray, jmbs[0])

    def loss_fn(p):
        return jmodule.apply(p, jmb["batch"], jmb["target_token_ids"], jmb["target_lengths"], jmb["copy_matrix"])

    (jloss, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    expected = jax_params_to_state_dict(tmodule, _np(jgrads))
    loss, metrics = module_loss(tmodule, tree_to(tmbs[0], torch.device("cpu")), train=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for key in ("num_sequences", "num_graphs", "num_nodes", "num_edges"):
        assert int(metrics[key]) == int(jmetrics[key]), key
    assert int(metrics["num_sequences"]) == 8
    got = {name: p.grad.numpy() for name, p in tmodule.named_parameters()}  # a shared layer once
    assert set(got) <= set(expected) and len(got) == 22
    _assert_close_per_tensor(got, expected)
    assert all(np.abs(g).max() > 0 for g in got.values())
    layers = tmodule.gnn.message_passing_layers
    assert sum(layer is layers[1] for layer in layers) == 7 and layers[1] is not layers[-1]


@pytest.mark.parametrize("beam_size", [None, 3])
def test_model_decode_matches_jax(beam_size):
    """Greedy (``beam_size`` None) and beam decode through the model: the
    same tokens as JAX's, log-probabilities within 1e-4."""
    samples = _samples(24, seed=2)
    jmodel, jmodule, params, _, tmodel, tmodule, _ = _converted_pair(samples)
    data = samples[:12]
    if beam_size is None:
        got = tmodel.greedy_decode(data, tmodule, max_minibatch_size=8, device="cpu")
        want = jmodel.greedy_decode(data, params, jmodule, max_minibatch_size=8)
        got, want = [[r] for r in got], [[r] for r in want]
    else:
        got = tmodel.beam_decode(data, tmodule, beam_size=beam_size, max_minibatch_size=8, device="cpu")
        want = jmodel.beam_decode(data, params, jmodule, beam_size=beam_size, max_minibatch_size=8)
    assert len(got) == len(want) == len(data)
    for g, w in zip(got, want):
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-4, atol=1e-4)


def _tiny_model(data):
    model = g2s_train.create_graph2seq_model(embedding_size=EMBEDDING, padding=BatchPadding(**PAD), max_seq_len=6)
    model.compute_metadata(iter(data), parallelize=False)
    return model, model.build_neural_module(device="cpu")


def test_decode_aligns_dropped_samples_as_none():
    """A sample dropped by the size caps is None at its own position."""
    data = list(synthetic_graph2seq_samples(6, seed=1, mean_nodes=25, max_nodes=50))
    model, net = _tiny_model(data)
    sizes = [len(d["node_labels"]) for d in data[:3]]
    big = max(range(3), key=lambda i: sizes[i])
    model.gnn_model.max_nodes_per_graph = sizes[big] - 1
    res = model.greedy_decode(data[:3], net, device="cpu")
    assert len(res) == 3 and res[big] is None
    kept = [r for r in res if r is not None]
    assert kept and all(isinstance(r, tuple) for r in kept)
    beams = model.beam_decode(data[:3], net, beam_size=2, device="cpu")
    assert beams[big] is None and all(len(b) == 2 for i, b in enumerate(beams) if i != big)


def test_decode_aligns_equal_duplicates_by_position():
    """With two equal samples of which the first is dropped, the survivor
    keeps its own result: results align by stream position, not equality."""
    data = list(synthetic_graph2seq_samples(5, seed=7, mean_nodes=25, max_nodes=50))
    sizes = [len(d["node_labels"]) for d in data]
    big_idx = max(range(len(data)), key=lambda i: sizes[i])
    dup = copy.deepcopy(data[big_idx])
    data = data[:big_idx] + [dup] + data[big_idx:]
    model, net = _tiny_model(data)
    res_full = model.greedy_decode(data, net, device="cpu")
    assert all(r is not None for r in res_full)
    grown = copy.deepcopy(dup)
    grown["node_labels"] = list(grown["node_labels"]) + ["pad_node"]
    data2 = data[:big_idx] + [grown] + data[big_idx + 1:]
    model.gnn_model.max_nodes_per_graph = len(dup["node_labels"])
    res = model.greedy_decode(data2, net, device="cpu")
    assert len(res) == len(data2) and res[big_idx] is None
    assert res[big_idx + 1] is not None and res[big_idx + 1][0] == res_full[big_idx + 1][0]


def test_clis_train_an_epoch_restore_and_test(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the train CLI's log file goes under the working directory
    paths = {}
    for i, fold in enumerate(("train", "valid", "test")):
        paths[fold] = tmp_path / f"{fold}.jsonl.gz"
        io.write_jsonl_gz(paths[fold], synthetic_graph2seq_samples(8, seed=40 + i, mean_nodes=25, max_nodes=50))
    common = ["--max-num-epochs", "1", "--minibatch-size", "4", "--max-nodes", "512", "--sequential-run",
              "--quiet", "--device", "cpu"]
    model_path = tmp_path / "g2s.pkl.gz"
    trainer = g2s_train.run(g2s_train.build_arg_parser().parse_args(
        [str(paths["train"]), str(paths["valid"]), str(model_path), *common]))
    assert model_path.exists() and isinstance(trainer.model, Graph2Seq)
    layers = trainer.neural_module.gnn.message_passing_layers
    assert layers[1].message_weights.shape[1:] == (128, 128) and layers[1].aggregation_fn == "sum"

    for beam in ("1", "2"):
        metrics = g2s_test.run(g2s_test.build_arg_parser().parse_args(
            [str(model_path), str(paths["test"]), "--device", "cpu", "--beam-size", beam]))
        assert set(metrics) == {"accuracy", "f1", "precision", "recall", "jaro_winkler"}
        assert all(0.0 <= v <= 1.0 for v in metrics.values())
        assert "JW Sim" in capsys.readouterr().out

    g2s_train.run(g2s_train.build_arg_parser().parse_args(
        [str(paths["train"]), str(paths["valid"]), str(tmp_path / "g2s2.pkl.gz"), *common,
         "--restore-path", str(model_path)]))
    metrics = g2s_trainandtest.run(g2s_trainandtest.build_arg_parser().parse_args(
        [str(paths["train"]), str(paths["valid"]), str(tmp_path / "g2s3.pkl.gz"), str(paths["test"]), *common]))
    assert "Test metrics:" in capsys.readouterr().out and 0.0 <= metrics["jaro_winkler"] <= 1.0


def test_cli_rejects_what_is_not_ported(tmp_path):
    parser = g2s_train.build_arg_parser()
    with pytest.raises(NotImplementedError, match="autotune"):
        g2s_train.run(parser.parse_args(["a", "b", str(tmp_path / "m.pkl.gz"), "--autotune"]))
    with pytest.raises(ValueError, match="pkl.gz"):
        g2s_train.run(parser.parse_args(["a", "b", str(tmp_path / "m.pt")]))
    with pytest.raises(NotImplementedError, match="bpe"):
        StrElementRepresentationModel(token_splitting="bpe")


def test_convert_raises_on_unknown_or_missing_graph2seq_keys():
    samples = _samples(16)
    _, _, params, _ = _jax_build(samples)
    _, tmodule, _ = _torch_build(samples)
    params = _np(params)
    assert set(params) == {"gnn", "decoder", "summarizer"}
    assert set(params["decoder"]) == {"embedding", "gru", "mem_to_std", "mem_to_copy", "hidden_to_vocab",
                                      "vocab_bias"}
    assert params["summarizer"]["query"] == {}
    with pytest.raises(KeyError, match="bogus"):
        load_jax_params(tmodule, dict(params, decoder=dict(params["decoder"], bogus=np.zeros(2))))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(tmodule, dict(params, decoder={k: v for k, v in params["decoder"].items()
                                                       if k != "hidden_to_vocab"}))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(tmodule, {k: v for k, v in params.items() if k != "summarizer"})
    load_jax_params(tmodule, params)
    np.testing.assert_array_equal(tmodule.decoder.gru.weight_hh.detach().numpy(),
                                  params["decoder"]["gru"]["weight_hh"])


def test_bf16_amp_step_is_finite_and_close_to_float32():
    """One train step under bf16 AMP (dropout on): a finite loss within 2e-2
    of the float32 step's on the same dropout masks (bf16 rounding), and
    finite gradients for every parameter."""
    samples = _samples(16)
    _, tmodule, tmbs = _torch_build(samples)
    mb = tree_to(tmbs[0], torch.device("cpu"))
    losses = []
    for amp in (False, True):
        tmodule.zero_grad(set_to_none=True)
        loss, _ = module_loss(tmodule, mb, train=True, generator=torch.Generator().manual_seed(0), amp=amp)
        loss.backward()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses[1], losses[0], rtol=2e-2)
    for name, p in tmodule.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
