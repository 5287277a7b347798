"""The PPI slice of the port against the JAX package, at hidden 32 with the
JAX parameters loaded through ``convert.py``, plus its loader, trainer and
CLI on the CPU.

Tolerances. Float32: the loss to rtol 1e-5; logits and every gradient of
one step (dropout 0) to rtol 1e-4 and 1e-4 of the tensor's largest
magnitude: each operation differs by a few float32 ulps between the
packages, and sum aggregation routes nothing, so the comparison holds
element by element. bf16 AMP with the typed matmul route forced on both
sides: the loss and each gradient's norm within 2e-2 (bf16 rounds at other
places in the two frameworks). The JAX side runs its fused path with the
Pallas kernels interpreted.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.embedders import FeatureRepresentationModel as JaxFeatureModel
from ptgnn_tpu.graph.messagepassing import MeanResidualLayer as JaxMeanResidual
from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
from ptgnn_tpu.implementations.ppi.dataloader import PPIGraphSample as JaxSample
from ptgnn_tpu.implementations.ppi.train import create_ppi_gnn_model as jax_create
from ptgnn_tpu.utils.synthetic import synthetic_ppi_graphs as jax_synthetic
from ptgnn_tpu_torch.convert import jax_params_to_state_dict, load_jax_params
from ptgnn_tpu_torch.core.trainer import ModelTrainer, module_loss
from ptgnn_tpu_torch.graph.embedders import FeatureRepresentationModel
from ptgnn_tpu_torch.graph.messagepassing import MeanResidualLayer
from ptgnn_tpu_torch.graph.structs import BatchPadding, tree_to
from ptgnn_tpu_torch.implementations.ppi import train as ppi_train
from ptgnn_tpu_torch.implementations.ppi.dataloader import PPIDatasetLoader, PPIGraphSample
from ptgnn_tpu_torch.implementations.ppi.harness import build_ppi, synthetic_ppi_samples
from ptgnn_tpu_torch.implementations.ppi.train import create_ppi_gnn_model
from ptgnn_tpu_torch.ops import segment_kernels as tsk
from ptgnn_tpu_torch.ops import typed_linear as ttl
from ptgnn_tpu_torch.utils import io
from ptgnn_tpu_torch.utils.synthetic import synthetic_ppi_graphs
from tests.torch_port_helpers import force_jax_fused_interpret

HIDDEN = 32
DATA = dict(mean_nodes=100, num_labels=16, edges_per_node=5)
PAD = dict(max_nodes=512, max_edge_slots=512 * 24, max_graphs=4, edge_tile=64)


def _jax_samples(n, seed):
    return [
        JaxSample([np.asarray(g["edges"], np.int32)], g["features"], g["labels"].astype(bool))
        for g in jax_synthetic(n, seed=seed, **DATA)
    ]


@pytest.fixture
def both(monkeypatch):
    """(JAX module, params, JAX minibatch, port module, port minibatch) on
    the same graphs, weights and batch, dropout 0."""
    force_jax_fused_interpret(monkeypatch)
    jmodel = jax_create(hidden_state_size=HIDDEN, padding=JaxBatchPadding(**PAD))
    jmodel.compute_metadata(iter(_jax_samples(4, 0)), parallelize=False)
    jmodule = jmodel.build_neural_module()
    params = jmodule.init(jax.random.PRNGKey(0))
    jmb = next(iter(jmodel.minibatch_iterator(
        jmodel.tensorize_dataset(iter(_jax_samples(4, 0)), parallelize=False),
        max_minibatch_size=2, parallelize=False,
    )))[0]
    _, tmodule, tmbs = build_ppi(padding=BatchPadding(**PAD), samples=synthetic_ppi_samples(4, 0, **DATA),
                                 hidden_state_size=HIDDEN, minibatch_size=2, device="cpu")
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params))
    for layer in jmodule.gnn.message_passing_layers:
        if hasattr(layer, "dropout_rate"):
            layer.dropout_rate = 0.0
    for sub in tmodule.modules():
        if hasattr(sub, "dropout_rate"):
            sub.dropout_rate = 0.0
    return jmodule, params, jmb, tmodule, tmbs[0]


def _jax_loss_fn(jmodule, mb, amp=False):
    batch = jax.tree_util.tree_map(jnp.asarray, mb["batch"])
    targets = jnp.asarray(mb["targets"])
    if amp:  # the JAX trainer's AMP: bf16 parameters and float inputs
        batch = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a, batch
        )

    def loss_fn(params):
        if amp:
            params = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
        loss, _ = jmodule.apply(params, batch, targets, train=True, rng=jax.random.PRNGKey(0))
        return loss.astype(jnp.float32)

    return loss_fn


def _port_step(tmodule, mb, amp=False):
    tmodule.zero_grad(set_to_none=True)
    loss, _ = module_loss(tmodule, tree_to(mb, torch.device("cpu")), train=True,
                          generator=torch.Generator(), amp=amp)
    loss.backward()
    return float(loss.detach()), {name: p.grad.numpy() for name, p in tmodule.named_parameters()}


def test_graphsage_loader_splits_and_rebases_graphs(tmp_path):
    feats = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    labels = np.random.RandomState(1).randint(0, 2, (5, 3))
    np.save(tmp_path / "toy_feats.npy", feats)
    np.save(tmp_path / "toy_labels.npy", labels)
    np.save(tmp_path / "toy_graph_id.npy", np.array([7, 7, 7, 9, 9]))
    links = [{"source": 0, "target": 1}, {"source": 2, "target": 0}, {"source": 3, "target": 4}]
    (tmp_path / "toy_graph.json").write_text(json.dumps({"links": links}))
    samples = PPIDatasetLoader.load_data(tmp_path, "toy")
    assert [s.node_features.shape for s in samples] == [(3, 4), (2, 4)]
    np.testing.assert_array_equal(samples[0].adjacency_lists[0], [[0, 1], [2, 0]])
    np.testing.assert_array_equal(samples[1].adjacency_lists[0], [[0, 1]])
    np.testing.assert_array_equal(samples[1].node_labels, labels[3:].astype(bool))
    assert samples[0].node_labels.dtype == bool
    with pytest.raises(FileNotFoundError):
        PPIDatasetLoader.load_data(tmp_path, "other")


def test_graphsage_loader_reads_an_fsspec_memory_copy(tmp_path):
    """A remote (``://``) path goes through fsspec: a ``memory://`` copy of
    a small fold loads to the same samples as the local files."""
    fsspec = pytest.importorskip("fsspec")
    _write_graphsage(tmp_path, "train", synthetic_ppi_samples(3, 2, mean_nodes=30, num_labels=5, edges_per_node=3))
    fs = fsspec.filesystem("memory")
    remote = "memory://ppi-loader-test/data"
    try:
        for path in sorted(tmp_path.iterdir()):
            fs.pipe(f"/ppi-loader-test/data/{path.name}", path.read_bytes())
        local, copy = PPIDatasetLoader.load_data(tmp_path, "train"), PPIDatasetLoader.load_data(remote, "train")
    finally:
        fs.rm("/ppi-loader-test", recursive=True)
    assert len(copy) == len(local) == 3
    for a, b in zip(local, copy):
        np.testing.assert_array_equal(a.adjacency_lists[0], b.adjacency_lists[0])
        np.testing.assert_array_equal(a.node_features, b.node_features)
        np.testing.assert_array_equal(a.node_labels, b.node_labels)


def test_synthetic_ppi_graphs_equal_jax_bitwise():
    kw = dict(mean_nodes=60, edges_per_node=3.5, num_features=7, num_labels=5)
    for ours, theirs in zip(synthetic_ppi_graphs(3, seed=4, **kw), jax_synthetic(3, seed=4, **kw)):
        assert ours["edges"] == theirs["edges"]
        for key in ("features", "labels"):
            assert ours[key].dtype == theirs[key].dtype
            np.testing.assert_array_equal(ours[key].view(np.uint32), theirs[key].view(np.uint32))


def test_feature_embedder_matches_jax():
    feats = [np.random.RandomState(i).randn(6).astype(np.float32) for i in range(5)]
    jmodel, tmodel = JaxFeatureModel(embedding_size=8, activation="tanh"), FeatureRepresentationModel(
        embedding_size=8, activation="tanh")
    for model in (jmodel, tmodel):
        model.compute_metadata(iter(feats), parallelize=False)
    jmb = jmodel.finalize_minibatch({"features": feats}, pad_to=7)["features"]
    tmb = tmodel.finalize_minibatch({"features": feats}, pad_to=7)["features"]
    np.testing.assert_array_equal(tmb, jmb)
    assert tmodel.finalize_minibatch({"features": []}, pad_to=3)["features"].shape == (3, 6)
    jemb = jmodel.build_neural_module()
    params = jemb.init(jax.random.PRNGKey(3))
    temb = tmodel.build_neural_module()
    temb.load_state_dict({"linear.weight": torch.from_numpy(np.asarray(params["linear"]["weight"]))})
    assert temb.linear.bias is None
    np.testing.assert_allclose(temb(torch.from_numpy(tmb)).detach().numpy(),
                               np.asarray(jemb.apply(params, jnp.asarray(jmb))), rtol=1e-6, atol=1e-6)


def test_mean_residual_layer_matches_jax():
    rng = np.random.RandomState(2)
    a, b = rng.randn(5, 4).astype(np.float32), rng.randn(5, 4).astype(np.float32)
    layer = MeanResidualLayer(4)
    got = layer.combine(torch.from_numpy(a), torch.from_numpy(b))
    want = JaxMeanResidual(4).combine({}, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert layer.input_state_dimension == layer.output_state_dimension == 4
    assert layer.pass_through_dummy_layer().target_layer is layer


def test_stack_is_the_ppi_architecture():
    _, module, _ = build_ppi(padding=BatchPadding(**PAD), samples=synthetic_ppi_samples(2, 0, **DATA),
                             hidden_state_size=HIDDEN, device="cpu")
    kinds = [type(layer).__name__ for layer in module.gnn.message_passing_layers]
    assert kinds == ["_ResidualOriginLayer"] + ["MlpMessagePassingLayer"] * 3 + [
        "MeanResidualLayer", "_ResidualOriginLayer"] + ["MlpMessagePassingLayer"] * 2 + ["MeanResidualLayer"]
    mlp = [layer for layer in module.gnn.message_passing_layers if type(layer).__name__ == "MlpMessagePassingLayer"]
    assert all(l.aggregation_fn == "sum" and l.dropout_rate == 0.2 for l in mlp)
    assert all(l.message_mlp.weights_0.shape == (3, 2 * HIDDEN, HIDDEN) for l in mlp)
    assert module.gnn.node_embedder.linear.weight.shape == (HIDDEN, 50)
    assert module.to_logits.weight.shape == (DATA["num_labels"], HIDDEN)


def test_eval_loss_and_logits_match_jax(both):
    jmodule, params, jmb, tmodule, tmb = both
    jbatch = jax.tree_util.tree_map(jnp.asarray, jmb["batch"])
    jloss, _ = jmodule.apply(params, jbatch, jnp.asarray(jmb["targets"]), train=False)
    jout, _ = jmodule.gnn.apply(params["gnn"], jbatch, train=False)
    jlogits = np.asarray(jmodule.output_representation_to_logits.apply(params["to_logits"], jout.node_table()))
    np.testing.assert_array_equal(tmb["targets"], jmb["targets"])
    tsk.reset_launch_counts()
    with torch.inference_mode():
        tloss, metrics = tmodule(tmb["batch"].to("cpu"), torch.from_numpy(tmb["targets"]))
        tlogits = tmodule.logits(tmb["batch"].to("cpu"))[0].numpy()
    assert sum(tsk.launch_counts().values()) == 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4 * np.abs(jlogits).max())
    assert int(metrics["num_samples"]) == int(np.asarray(jmb["batch"].num_nodes))


def test_float32_step_gradients_match_jax(both):
    jmodule, params, jmb, tmodule, tmb = both
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jmodule, jmb))(params)
    expected = jax_params_to_state_dict(tmodule, jax.tree_util.tree_map(np.asarray, jgrads))
    loss, got = _port_step(tmodule, tmb)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert sorted(got) == sorted(expected)
    for name, e in expected.items():
        e = e.numpy()
        assert np.abs(e).max() > 0, name
        np.testing.assert_allclose(got[name], e, rtol=1e-4, atol=1e-4 * np.abs(e).max(), err_msg=name)


def test_bf16_step_with_the_typed_matmul_route_matches_jax(both, monkeypatch):
    """Both sides take the typed matmul route at every message matmul: the
    JAX package through its environment override (its Pallas kernel,
    interpreted), the port through its gate, opened here for bf16."""
    jmodule, params, jmb, tmodule, tmb = both
    monkeypatch.setenv("PTGNN_TPU_TYPED_MM_PALLAS", "1")
    routed = []
    real = ttl.typed_matmul_plain
    monkeypatch.setattr(ttl, "use_typed_matmul_kernel", lambda x, *a: x.dtype == torch.bfloat16)
    monkeypatch.setattr(ttl, "typed_matmul_plain", lambda *a: routed.append(1) or real(*a))
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jmodule, jmb, amp=True))(params)
    expected = jax_params_to_state_dict(
        tmodule, jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), jgrads))
    loss, got = _port_step(tmodule, tmb, amp=True)
    assert len(routed) == 15  # 5 forward, 2 x 5 backward
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-2)
    for name, e in expected.items():
        e = e.numpy()
        assert got[name].dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(got[name]), np.linalg.norm(e), rtol=2e-2, err_msg=name)


def test_model_trainer_runs_two_epochs_and_reports_f1(tmp_path):
    train = synthetic_ppi_samples(6, 0, **DATA)
    valid = synthetic_ppi_samples(2, 1, **DATA)
    model = create_ppi_gnn_model(hidden_state_size=HIDDEN, padding=BatchPadding(**PAD))
    trainer = ModelTrainer(model, tmp_path / "ppi.pkl.gz", max_num_epochs=2, minibatch_size=2,
                           clip_gradient_norm=1.0, target_validation_metric="f1_score",
                           target_validation_metric_higher_is_better=True, device="cpu")
    seen = []
    trainer.register_validation_epoch_end_hook(lambda m, mod, epoch, metrics: seen.append(metrics))
    trainer.train(train, valid, parallelize=False, store_tensorized_data_in_memory=True)
    assert len(seen) == 3  # before training and after each epoch
    metrics = model.report_metrics(valid, trainer.neural_module, device="cpu")
    assert set(metrics) == {"f1_score", "pr_score", "re_score"}
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
    assert (tmp_path / "ppi.pkl.gz").exists()


def _write_graphsage(directory, fold, samples):
    offset, links, graph_ids = 0, [], []
    for i, s in enumerate(samples):
        links += [{"source": int(u) + offset, "target": int(v) + offset} for u, v in s.adjacency_lists[0]]
        graph_ids += [i] * len(s.node_features)
        offset += len(s.node_features)
    np.save(directory / f"{fold}_feats.npy", np.concatenate([s.node_features for s in samples]))
    np.save(directory / f"{fold}_labels.npy", np.concatenate([s.node_labels for s in samples]).astype(np.int64))
    np.save(directory / f"{fold}_graph_id.npy", np.asarray(graph_ids))
    (directory / f"{fold}_graph.json").write_text(json.dumps({"links": links}))


def test_cli_trains_on_a_graphsage_directory(tmp_path):
    for i, fold in enumerate(("train", "valid", "test")):
        _write_graphsage(tmp_path, fold, synthetic_ppi_samples(2, i, mean_nodes=40, num_labels=6, edges_per_node=3))
    parser = ppi_train.build_arg_parser()
    args = parser.parse_args([str(tmp_path), str(tmp_path / "m.pkl.gz"), "--max-num-epochs", "1",
                              "--minibatch-size", "2", "--max-nodes", "256", "--sequential-run", "--device", "cpu"])
    metrics = ppi_train.run(args)
    assert set(metrics) == {"f1_score", "pr_score", "re_score"}
    with pytest.raises(NotImplementedError):
        ppi_train.run(parser.parse_args([str(tmp_path), str(tmp_path / "m.pkl.gz"), "--autotune"]))
    # --azure-info: a JSON object of fsspec storage options for remote paths.
    (tmp_path / "auth.json").write_text(json.dumps({"anon": True}))
    try:
        with pytest.raises(FileNotFoundError):  # read before any data is
            ppi_train.run(parser.parse_args([str(tmp_path / "none"), str(tmp_path / "m.pkl.gz"), "--azure-info",
                                             str(tmp_path / "auth.json"), "--device", "cpu"]))
        assert io._storage_options == {"anon": True}
    finally:
        io.configure_remote_io()


def test_samples_from_synthetic_graphs():
    graph = next(synthetic_ppi_graphs(1, seed=0, **DATA))
    sample = PPIGraphSample.from_synthetic(graph)
    assert sample.node_labels.dtype == bool and sample.adjacency_lists[0].shape == (len(graph["edges"]), 2)
