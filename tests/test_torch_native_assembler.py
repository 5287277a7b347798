"""The port's C++ layout assembler (``ptgnn_tpu_torch/native/``) against its
numpy assembler and the JAX package's ``assemble_layout_arrays``: the nine
layout arrays bitwise equal on seeded random raw edges (with and without
pair ids, an empty batch, a supertile alignment above the tile, a sender
domain, and a budget overflow, which gives None on all three); ids out of
range raise ``ValueError`` on both of the port's paths; ``GraphBatcher.finalize``
gives bitwise equal batches through either (the cases of
``tests/test_native_assembler.py``); two processes that build at once leave
one loadable library; a failed build raises with the compiler's output."""
import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ptgnn_tpu.graph import batching as jax_batching
from ptgnn_tpu_torch import native
from ptgnn_tpu_torch.graph import batching
from ptgnn_tpu_torch.graph.batching import GraphBatcher, assemble_layout_arrays
from ptgnn_tpu_torch.graph.structs import BatchPadding, TensorizedGraphData

ROOT = Path(__file__).resolve().parents[1]

# name: (nodes, edges, types, tile, agg_rows, align, e_pad, pair ids?, sender domain)
CASES = {
    "pairs": (500, 2200, 7, 32, 64, 32, 32 * 200, True, None),
    "no-pairs": (500, 2200, 7, 32, 64, 32, 32 * 200, False, None),
    "empty": (256, 0, 3, 64, 64, 64, 64 * 8, True, None),
    "align-above-tile": (1000, 4000, 5, 32, 128, 128, 32 * 400, True, None),
    "sender-domain": (300, 1500, 4, 64, 64, 128, 64 * 120, True, 900),
    "overflow": (500, 2200, 7, 32, 64, 32, 32 * 40, True, None),
}


def _raw(nodes, edges, types, pairs, sender_domain, seed=7):
    rng = np.random.RandomState(seed)
    senders = rng.randint(0, sender_domain or nodes, edges).astype(np.int32)
    receivers = rng.randint(0, nodes, edges).astype(np.int32)
    edge_types = rng.randint(0, types, edges).astype(np.int32)
    pair_ids = rng.randint(-1, edges, edges).astype(np.int32) if pairs else None
    return senders, receivers, edge_types, pair_ids


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpp_numpy_and_jax_layouts_are_bitwise_equal(case):
    nodes, edges, types, tile, agg_rows, align, e_pad, pairs, domain = CASES[case]
    raw = _raw(nodes, edges, types, pairs, domain)
    kw = dict(max_nodes=nodes, e_pad=e_pad, tile=tile, agg_rows=agg_rows, num_types=types, align=align,
              sender_domain=domain)
    cpp = assemble_layout_arrays(*raw, **kw)
    numpy_ = assemble_layout_arrays(*raw, native_assembler=False, **kw)
    jax_ = jax_batching.assemble_layout_arrays(*raw, **kw)
    if case == "overflow":
        assert cpp is None and numpy_ is None and jax_ is None
        return
    assert len(cpp) == len(numpy_) == len(jax_) == 9
    for i, (a, b, c) in enumerate(zip(cpp, numpy_, jax_)):
        c = np.asarray(c)
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape == c.shape, i
        np.testing.assert_array_equal(a, b, err_msg=f"array {i}")
        np.testing.assert_array_equal(a, c, err_msg=f"array {i}")
    assert int(cpp[4].sum()) == edges
    if not pairs:
        assert (cpp[8] == -1).all()


@pytest.mark.parametrize("native_assembler", [True, False])
@pytest.mark.parametrize("bad", ["sender", "receiver", "type", "negative", "length"])
def test_ids_out_of_range_raise(bad, native_assembler):
    senders, receivers, types, pairs = _raw(100, 300, 3, True, None)
    if bad == "sender":
        senders[5] = 100
    elif bad == "receiver":
        receivers[7] = 100
    elif bad == "type":
        types[9] = 3
    elif bad == "negative":
        receivers[0] = -1
    else:
        pairs = pairs[:-1]
    with pytest.raises(ValueError):
        assemble_layout_arrays(senders, receivers, types, pairs, max_nodes=100, e_pad=64 * 40, tile=64,
                               agg_rows=64, num_types=3, align=64, native_assembler=native_assembler)


def _finalized(track_edge_features):
    """The batch of ``tests/test_native_assembler.py``."""
    rng = np.random.RandomState(7)
    pad = BatchPadding(max_nodes=128, max_edge_slots=8192, max_graphs=4, edge_tile=32, agg_rows=32)
    b = GraphBatcher(3, pad, introduce_backwards_edges=True, add_self_edges=True,
                     track_edge_features=track_edge_features)
    mb = b.initialize()
    for i, n in enumerate((40, 35, 30)):
        adj = [(rng.randint(0, n, 25).astype(np.int32), rng.randint(0, n, 25).astype(np.int32)) for _ in range(3)]
        # a featureless graph in the middle of a feature-tracking batch
        feats = [np.zeros(2, np.float32)] * (3 * 25) if track_edge_features and i != 1 else None
        g = TensorizedGraphData(num_nodes=n, node_tensorized_data=[0] * n, adjacency_lists=adj,
                                edge_features=feats, reference_nodes={"refs": np.arange(3, dtype=np.int32)})
        assert b.can_add(g, mb)
        b.extend(g, mb)
    return b.finalize(mb, node_data={}, reference_names=["refs"])


@pytest.mark.parametrize("track_edge_features", [False, True])
def test_finalize_gives_the_same_batch_through_either_assembler(monkeypatch, track_edge_features):
    fast = _finalized(track_edge_features)
    monkeypatch.setattr(batching, "assemble_layout_arrays",
                        functools.partial(assemble_layout_arrays, native_assembler=False))
    ref = _finalized(track_edge_features)
    for field in fast.adjacency._fields:
        a, b = getattr(fast.adjacency, field), getattr(ref.adjacency, field)
        if a is None:
            assert b is None, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
    np.testing.assert_array_equal(fast.node_graph, ref.node_graph)
    assert int(fast.num_edges) == int(ref.num_edges)


_BUILD = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from ptgnn_tpu_torch import native
native.BUILD_DIR = Path({build!r})
native.load()
print(native.library_path())
"""


def test_two_processes_building_at_once_leave_one_loadable_library(tmp_path):
    code = _BUILD.format(root=str(ROOT), build=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        assert proc.returncode == 0, err
        outs.append(out.strip())
    assert outs[0] == outs[1]
    built = sorted(p.name for p in tmp_path.iterdir() if p.name != "build.lock")
    assert built == [Path(outs[0]).name]
    assert hasattr(ctypes.CDLL(outs[0]), "ptgnn_assemble_edge_layout")


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text("extern \"C\" int ptgnn_assemble_edge_layout( { this is not C++ }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        native.build()
    assert not any(p.suffix in (".so", ".tmp") for p in (tmp_path / "build").iterdir())
