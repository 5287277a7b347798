"""The port stands alone: importing all of it loads neither JAX nor the JAX
package, no source imports them, and entry points do not fall back to the
CPU when CUDA is missing."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ptgnn_tpu_torch"
PORT_SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_the_import_check_covers_this_slices_modules():
    names = set(_module_names())
    assert {
        "ptgnn_tpu_torch.graph.messagepassing.gated", "ptgnn_tpu_torch.utils.io",
        "ptgnn_tpu_torch.utils.amlutils", "ptgnn_tpu_torch.implementations.typilus.train",
        "ptgnn_tpu_torch.implementations.typilus.predict",
        "ptgnn_tpu_torch.ops.segment", "ptgnn_tpu_torch.reduceops", "ptgnn_tpu_torch.reduceops.varsizedsummary",
        "ptgnn_tpu_torch.graph.messagepassing.global_exchange",
        "ptgnn_tpu_torch.implementations.varmisuse.candidateannotatedembeddings",
        "ptgnn_tpu_torch.implementations.varmisuse.varmisuse", "ptgnn_tpu_torch.implementations.varmisuse.train",
        "ptgnn_tpu_torch.implementations.varmisuse.harness",
        "ptgnn_tpu_torch.utils.strsim", "ptgnn_tpu_torch.sequence", "ptgnn_tpu_torch.sequence.grucopydecoder",
        "ptgnn_tpu_torch.sequence.luongattention", "ptgnn_tpu_torch.implementations.graph2seq.graph2seq",
        "ptgnn_tpu_torch.implementations.graph2seq.train", "ptgnn_tpu_torch.implementations.graph2seq.test",
        "ptgnn_tpu_torch.implementations.graph2seq.trainandtest",
        "ptgnn_tpu_torch.implementations.graph2seq.harness",
        "ptgnn_tpu_torch.graph.messagepassing.pna", "ptgnn_tpu_torch.graph.messagepassing.egc",
        "ptgnn_tpu_torch.graph.messagepassing.graphnorm", "ptgnn_tpu_torch.graph.messagepassing.selfatt",
        "ptgnn_tpu_torch.graph.messagepassing.mlp_mp", "ptgnn_tpu_torch.graph.messagepassing.base",
        "ptgnn_tpu_torch.utils.profile_serving",
        "ptgnn_tpu_torch.parallel", "ptgnn_tpu_torch.parallel.dp", "ptgnn_tpu_torch.parallel.distributed_trainer",
        "ptgnn_tpu_torch.implementations.typilus.traindistributed", "ptgnn_tpu_torch.utils.text",
        "ptgnn_tpu_torch.graph.embedders", "ptgnn_tpu_torch.graph.gnn", "ptgnn_tpu_torch.graph.batching",
    } <= names


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {list(_module_names())!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ptgnn_tpu' or m.startswith('ptgnn_tpu.'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "ptgnn_tpu"), f"{path}: imports {name}"


def test_entry_points_without_device_raise_when_cuda_is_missing():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_graph2class(padding=small_padding(max_nodes=256), hidden_state_size=8)
    model, module, _ = build_graph2class(
        padding=small_padding(max_nodes=256), hidden_state_size=8, device="cpu"
    )
    graphs = synthetic_typilus_graphs(2, seed=1, mean_nodes=40, max_nodes=100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.report_accuracy(graphs, module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(iter(model.predict(graphs, module)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.build_neural_module()
    from ptgnn_tpu_torch.core.trainer import ModelTrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelTrainer(model, "unused.pkl.gz")


def test_ppi_entry_points_without_device_raise_when_cuda_is_missing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    from ptgnn_tpu_torch.graph.structs import BatchPadding
    from ptgnn_tpu_torch.implementations.ppi import train as ppi_train
    from ptgnn_tpu_torch.implementations.ppi.harness import build_ppi, synthetic_ppi_samples

    padding = BatchPadding(max_nodes=256, max_edge_slots=256 * 24, max_graphs=4, edge_tile=64)
    samples = synthetic_ppi_samples(2, seed=1, mean_nodes=40, num_labels=4, edges_per_node=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_ppi(padding=padding, samples=samples, hidden_state_size=8)
    model, module, _ = build_ppi(padding=padding, samples=samples, hidden_state_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.report_metrics(samples, module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.build_neural_module()
    args = ppi_train.build_arg_parser().parse_args([str(tmp_path), str(tmp_path / "m.pkl.gz")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ppi_train.ModelTrainer(model, args.model_filename, device=args.device)


def test_typilus_clis_without_device_raise_when_cuda_is_missing(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    monkeypatch.chdir(tmp_path)  # the train CLI's log file goes under the working directory
    from ptgnn_tpu_torch.implementations.typilus import predict as typilus_predict
    from ptgnn_tpu_torch.implementations.typilus import train as typilus_train
    from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
    from ptgnn_tpu_torch.utils.io import write_jsonl_gz
    from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

    (tmp_path / "data").mkdir()
    write_jsonl_gz(tmp_path / "data" / "a.jsonl.gz", synthetic_typilus_graphs(2, seed=1, mean_nodes=40, max_nodes=80))
    data = str(tmp_path / "data")
    for architecture in ("mlp", "ggnn"):
        args = typilus_train.build_arg_parser().parse_args(
            [data, data, data, str(tmp_path / "m.pkl.gz"), "--architecture", architecture])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            typilus_train.run(args)
    model, module, _ = build_graph2class(padding=small_padding(max_nodes=256), hidden_state_size=8,
                                         architecture="ggnn", device="cpu")
    model.save(tmp_path / "m.pkl.gz", module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        typilus_predict.run(typilus_predict.build_arg_parser().parse_args([str(tmp_path / "m.pkl.gz"), data]))


def test_varmisuse_entry_points_without_device_raise_when_cuda_is_missing(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
    from ptgnn_tpu_torch.graph.structs import BatchPadding
    from ptgnn_tpu_torch.implementations.varmisuse import train as vm_train
    from ptgnn_tpu_torch.implementations.varmisuse.harness import build_varmisuse
    from ptgnn_tpu_torch.utils.io import write_jsonl_gz
    from ptgnn_tpu_torch.utils.synthetic import synthetic_varmisuse_samples

    padding = BatchPadding(max_nodes=512, max_edge_slots=512 * 10, max_graphs=4, edge_tile=64,
                           reference_budgets=(("candidate_nodes", 32), ("slot_node_idx", 4)))
    samples = list(synthetic_varmisuse_samples(3, seed=1, mean_tokens=15))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_varmisuse(padding=padding, samples=samples, hidden_state_size=8)
    model, module, _ = build_varmisuse(padding=padding, samples=samples, hidden_state_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.report_accuracy(samples, module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.build_neural_module()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelTrainer(model, "unused.pkl.gz")
    (tmp_path / "data").mkdir()
    write_jsonl_gz(tmp_path / "data" / "a.jsonl.gz", samples)
    data = str(tmp_path / "data")
    for architecture in ("mlp", "ggnn"):
        args = vm_train.build_arg_parser().parse_args(
            [data, data, data, str(tmp_path / "m.pkl.gz"), "--architecture", architecture])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vm_train.run(args)


def test_graph2seq_entry_points_without_device_raise_when_cuda_is_missing(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
    from ptgnn_tpu_torch.graph.structs import BatchPadding
    from ptgnn_tpu_torch.implementations.graph2seq import test as g2s_test
    from ptgnn_tpu_torch.implementations.graph2seq import train as g2s_train
    from ptgnn_tpu_torch.implementations.graph2seq import trainandtest as g2s_trainandtest
    from ptgnn_tpu_torch.implementations.graph2seq.harness import build_graph2seq
    from ptgnn_tpu_torch.utils.io import write_jsonl_gz
    from ptgnn_tpu_torch.utils.synthetic import synthetic_graph2seq_samples

    padding = BatchPadding(max_nodes=256, max_edge_slots=256 * 8, max_graphs=4, edge_tile=64,
                           reference_budgets=(("backbone_nodes", 128),))
    samples = list(synthetic_graph2seq_samples(3, seed=1, mean_nodes=20, max_nodes=40))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_graph2seq(padding=padding, samples=samples, embedding_size=8)
    model, module, _ = build_graph2seq(padding=padding, samples=samples, embedding_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.greedy_decode(samples, module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.beam_decode(samples, module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.build_neural_module()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelTrainer(model, "unused.pkl.gz")
    data = tmp_path / "data.jsonl.gz"
    write_jsonl_gz(data, samples)
    model.save(tmp_path / "m.pkl.gz", module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g2s_train.run(g2s_train.build_arg_parser().parse_args([str(data), str(data), str(tmp_path / "n.pkl.gz")]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g2s_test.run(g2s_test.build_arg_parser().parse_args([str(tmp_path / "m.pkl.gz"), str(data)]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g2s_trainandtest.run(g2s_trainandtest.build_arg_parser().parse_args(
            [str(data), str(data), str(tmp_path / "n.pkl.gz"), str(data)]))


def test_traindistributed_without_device_raises_when_cuda_is_missing(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    from ptgnn_tpu_torch.implementations.typilus import traindistributed

    for name in traindistributed.TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    parser = traindistributed.build_arg_parser()
    data = str(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        traindistributed.run(parser.parse_args([data, data, data, str(tmp_path / "m.pkl.gz")]))
    with pytest.raises(NotImplementedError, match="node-sharding slice"):
        traindistributed.run(parser.parse_args([data, data, data, str(tmp_path / "m.pkl.gz"), "--node-shards", "2",
                                                "--device", "cpu"]))
    with pytest.raises(ValueError, match="pkl.gz"):
        traindistributed.run(parser.parse_args([data, data, data, str(tmp_path / "m.pt"), "--device", "cpu"]))
