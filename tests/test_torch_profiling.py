"""Profiling and roofline accounting (``ptgnn_tpu_torch/utils/profiling.py``)
against the JAX package's ``utils/profiling.py``: ``mp_layer_roofline``'s
operations and bytes equal over a grid of arguments; the time bounds use
the H100 SXM datasheet peaks; ``Throughput``'s rates equal on one clock;
``profile_trace`` on the CPU writes a Chrome trace holding the block's
operators."""
import itertools
import json

import pytest
import torch

from ptgnn_tpu.utils import profiling as jax_profiling
from ptgnn_tpu_torch.utils import profiling
from ptgnn_tpu_torch.utils.profiling import LayerRoofline, Throughput, mp_layer_roofline, profile_trace


@pytest.mark.parametrize("use_target_state,backward,bytes_per_el", list(itertools.product((True, False), (True, False),
                                                                                           (2, 4))))
def test_mp_layer_roofline_equals_jax(use_target_state, backward, bytes_per_el):
    for edge_slots, state_dim, message_dim, num_nodes in itertools.product((128, 49152, 122880), (64, 256),
                                                                            (64, 128, 256), (4096, 8192)):
        args = (edge_slots, state_dim, message_dim, num_nodes)
        kw = dict(use_target_state=use_target_state, bytes_per_el=bytes_per_el, backward=backward)
        got, want = mp_layer_roofline(*args, **kw), jax_profiling.mp_layer_roofline(*args, **kw)
        assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes), args
        assert got.arithmetic_intensity() == want.arithmetic_intensity()


def test_time_bounds_use_the_h100_datasheet_peaks():
    r = LayerRoofline(flops=989_000_000_000, hbm_bytes=3_350_000_000)
    assert r.time_bounds_ms() == pytest.approx({"compute_ms": 1.0, "memory_ms": 1.0})
    f32 = r.time_bounds_ms(peak_flops=profiling.H100_SXM_FLOAT32_FLOPS)
    assert f32["compute_ms"] == pytest.approx(989 / 67)


def test_throughput_rates_equal_jax_on_one_clock(monkeypatch):
    clock = iter([100.0, 102.5])
    ticks = []

    def time_now():
        if not ticks:
            ticks.append(next(clock))
        return ticks[-1]

    monkeypatch.setattr(profiling.time, "time", time_now)  # the one time module both read
    port, ref = Throughput(), jax_profiling.Throughput()
    assert port.rates() == ref.rates() == {}
    for counts in ({"graphs": 3, "nodes": 7500, "edges": 37700}, {"graphs": 2, "nodes": 5000, "edges": 25000}):
        port.update(**counts)
        ref.update(**counts)
    ticks.append(next(clock))
    assert port.rates() == ref.rates() == {"graphs_per_sec": 2.0, "nodes_per_sec": 5000.0, "edges_per_sec": 25080.0}
    port.reset()
    assert port.rates() == {} and port.totals == {}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profile_trace(tmp_path / "trace", trace_name="cpu.json") as prof:
        (x @ x).relu_()
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    trace = json.loads((tmp_path / "trace" / "cpu.json").read_text())
    assert any(event.get("name") == "aten::mm" for event in trace["traceEvents"])
