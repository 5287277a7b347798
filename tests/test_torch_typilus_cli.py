"""The port's Typilus train and predict CLIs end to end on the CPU, on tiny
synthetic folds written with the port's ``utils/io.write_jsonl_gz``: one
epoch of each architecture ('mlp' under the argmax routing switch, 'ggnn'),
a run restored from a checkpoint, then predict printing one line per
supernode; and the port's dataset IO on a local folder and on fsspec's
in-memory filesystem. This file imports no JAX."""
import gzip
import json

import pytest

from ptgnn_tpu_torch.implementations.typilus import predict as typilus_predict
from ptgnn_tpu_torch.implementations.typilus import train as typilus_train
from ptgnn_tpu_torch.implementations.typilus.graph2class import IGNORED_TYPES, Graph2Class
from ptgnn_tpu_torch.utils import io
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

GRAPHS = dict(mean_nodes=40, max_nodes=80)


def _write_folds(root):
    """train (2 files), valid and test folds of synthetic graphs."""
    for i, (fold, files) in enumerate((("train", 2), ("valid", 1), ("test", 1))):
        (root / fold).mkdir()
        graphs = list(synthetic_typilus_graphs(4 * files, seed=10 + i, **GRAPHS))
        for f in range(files):
            io.write_jsonl_gz(root / fold / f"part{f}.jsonl.gz", graphs[4 * f:4 * f + 4])
    return [str(root / fold) for fold in ("train", "valid", "test")]


def _train(folds, model_path, *extra):
    args = typilus_train.build_arg_parser().parse_args(
        [*folds, str(model_path), "--max-num-epochs", "1", "--minibatch-size", "4", "--max-nodes", "512",
         "--sequential-run", "--quiet", "--device", "cpu", *extra])
    return typilus_train.run(args)


def _routing(model_path):
    model, state = Graph2Class.restore_model(model_path)
    module = model.build_neural_module(device="cpu")
    module.load_state_dict(state)
    return [getattr(l, "argmax_routing", None) for l in module.gnn.message_passing_layers], module


def test_train_both_architectures_restore_and_predict(tmp_path, monkeypatch, capsys):
    folds = _write_folds(tmp_path)
    monkeypatch.chdir(tmp_path)  # the CLI's log file goes under the working directory
    monkeypatch.setenv(typilus_train.ARGMAX_ROUTING_ENV, "1")
    acc = _train(folds, tmp_path / "mlp.pkl.gz", "--architecture", "mlp")
    assert 0.0 <= acc <= 1.0 and "Test accuracy:" in capsys.readouterr().out
    routing, module = _routing(tmp_path / "mlp.pkl.gz")
    assert [r for r in routing if r is not None] == [True] * 8

    monkeypatch.delenv(typilus_train.ARGMAX_ROUTING_ENV)
    _train(folds, tmp_path / "ggnn.pkl.gz", "--architecture", "ggnn")
    routing, module = _routing(tmp_path / "ggnn.pkl.gz")
    assert [r for r in routing if r is not None] == [False] * 8
    layers = module.gnn.message_passing_layers
    assert all(layers[i] is layers[1] for i in range(1, 8))

    # A second run from the checkpoint, with its optimizer state (it writes
    # a checkpoint only if its epoch improves on the restored model).
    _train(folds, tmp_path / "ggnn2.pkl.gz", "--restore-path", str(tmp_path / "ggnn.pkl.gz"),
           "--restore-optimizer")
    assert "Test accuracy:" in capsys.readouterr().out

    args = typilus_predict.build_arg_parser().parse_args(
        [str(tmp_path / "ggnn.pkl.gz"), folds[2], "--device", "cpu"])
    printed = typilus_predict.run(args)
    lines = capsys.readouterr().out.strip().splitlines()
    supernodes = sum(
        1 for g in io.load_from_folder(folds[2], shuffle=False)
        for s in g["supernodes"].values() if s.get("annotation") not in IGNORED_TYPES
    )
    assert printed == len(lines) == supernodes > 0
    assert all(" Predicted: `" in line and line.endswith("%)") for line in lines)


def test_cli_rejects_what_is_not_ported(tmp_path):
    parser = typilus_train.build_arg_parser()
    with pytest.raises(ValueError, match="pkl.gz"):
        typilus_train.run(parser.parse_args(["a", "b", "c", str(tmp_path / "m.pt")]))
    with pytest.raises(SystemExit):
        parser.parse_args(["a", "b", "c", "m.pkl.gz", "--architecture", "gnn_film"])


def test_load_from_folder_local(tmp_path):
    graphs = list(synthetic_typilus_graphs(5, seed=3, **GRAPHS))
    io.write_jsonl_gz(tmp_path / "b.jsonl.gz", graphs[2:])
    io.write_jsonl_gz(tmp_path / "a.jsonl.gz", graphs[:2])
    (tmp_path / "notes.txt").write_text("not data")
    assert list(io.load_from_folder(tmp_path, shuffle=False)) == json.loads(json.dumps(graphs))
    assert sorted(g["filename"] for g in io.load_from_folder(tmp_path, shuffle=True)) == sorted(
        g["filename"] for g in graphs)
    # Round-robin shards over two ranks.
    assert [g["filename"] for g in io.load_from_folder(tmp_path, shuffle=False, rank=1, world_size=2)] == [
        g["filename"] for g in graphs[2:]]
    with pytest.raises(FileNotFoundError):
        list(io.load_from_folder(tmp_path / "missing", shuffle=False))
    with gzip.open(tmp_path / "a.jsonl.gz", "rt") as f:
        assert len(f.read().strip().splitlines()) == 2
    assert io.data_path("memory://x/y") == "memory://x/y" and io.data_path(str(tmp_path)) == tmp_path


def test_load_from_folder_on_fsspec_memory(tmp_path):
    fsspec = pytest.importorskip("fsspec")
    graphs = list(synthetic_typilus_graphs(3, seed=4, **GRAPHS))
    io.write_jsonl_gz(tmp_path / "a.jsonl.gz", graphs)
    remote = "memory://typilus-cli-test/train"
    try:
        io.write_jsonl_gz(f"{remote}/a.jsonl.gz", graphs)
        assert io.is_remote_path(remote)
        assert list(io.load_from_folder(remote, shuffle=False)) == list(io.load_from_folder(tmp_path, shuffle=False))
    finally:
        fsspec.filesystem("memory").rm("/typilus-cli-test", recursive=True)

