"""``typed_dw_roofline`` on hand-worked cases: its count and reading on a
synthetic trace, nothing read where the trace lost launches beyond its
share or other kernels computed some dWs, and names that no other kernel
reader's needles match."""
import pytest

from gnnbench.harness import peaks, pool, report, spec, trace
from gnnbench.metrics import mp_kernels_ms_per_step, typed_dw_roofline, typed_matmul_roofline

MAIN = "void (anonymous namespace)::typed_dw_bf16_kernel<256>(CUtensorMap, CUtensorMap, int const*, float*, int*)"
SUM = "(anonymous namespace)::typed_dw_bf16_kernel_sum(float4 const*, int const*, float4*, int, long long)"
SHAPES = {"gnn.message_passing_layers.1.message_mlp.weights_0": (3, 512, 256)}


def _trace(device, window=(0, 1_000_000_000)):
    events = [(trace.WINDOW, False, window[0], window[1])] + [(n, True, a, b) for n, a, b in device]
    return trace.summarize(events)


def _run(config, groups, device, launches, shapes=SHAPES):
    tr = _trace(device)
    return report.LayerRun(config, tr, len(groups), groups, {"launches": launches}, 1.0, 0, shapes)


def _kernels(launches, ns=(40, 5)):
    """Each launch's products then its sum, back to back."""
    out = []
    for i in range(launches):
        t = 100 * i
        out += [(MAIN, t, t + ns[0]), (SUM, t + ns[0], t + ns[0] + ns[1])]
    return out


def test_typed_dw_roofline_by_hand():
    config = spec.load_config("ppi_mlp_sum")
    assert typed_dw_roofline.gradients(config) == [(512, 256)] * 5
    groups = [pool.Group([], nodes=100, edges=1000), pool.Group([], nodes=90, edges=700)]
    least = 0.0
    for e in (1000, 700):
        for _ in range(5):
            moved = 2 * e * (512 + 256) + 4 * 3 * 512 * 256
            least += max(moved / peaks.HBM_BYTES_PER_S, 2 * e * 512 * 256 / 989e12)
    run = _run(config, groups, _kernels(10), {"typed_dw": 10})
    assert typed_dw_roofline.read(run) == pytest.approx(100 * least / (10 * 45e-9), rel=1e-9)


def test_typed_dw_roofline_scales_a_lost_event_and_reads_nothing_beyond():
    config = spec.load_config("ppi_mlp_sum")
    groups = [pool.Group([], nodes=100, edges=1000)] * 12
    held = _kernels(60)
    full = typed_dw_roofline.read(_run(config, groups, held, {"typed_dw": 60}))
    one_lost = typed_dw_roofline.read(_run(config, groups, held[:-1], {"typed_dw": 60}))
    # the lost operation taken at the held ones' mean: 119 held of 120 ran
    assert one_lost == pytest.approx(full * (60 * 45) / (60 * 45 - 5) * 119 / 120, rel=1e-9)
    # more than the share lost: the counter and the trace disagree
    assert typed_dw_roofline.read(_run(config, groups, held[:-4], {"typed_dw": 60})) is None
    assert typed_dw_roofline.read(_run(config, groups, held, {"typed_dw": 62})) is None


def test_typed_dw_roofline_reads_nothing_where_other_kernels_ran_some_dws():
    config = spec.load_config("ppi_mlp_sum")
    groups = [pool.Group([], nodes=100, edges=1000)] * 2
    # 2 steps need 10 dWs; the kernel ran 8 (the others took another route)
    assert typed_dw_roofline.read(_run(config, groups, _kernels(8), {"typed_dw": 8})) is None
    # a program without the kernel (the parent of the change that added it)
    assert typed_dw_roofline.read(_run(config, groups, [], {"typed_matmul": 15})) is None
    assert typed_dw_roofline.read(_run(config, groups, _kernels(10), {"typed_dw": 10}, shapes={})) is None


@pytest.mark.parametrize("name", [MAIN, SUM])
def test_no_other_kernel_reader_counts_the_typed_dw(name):
    assert any(n in name for n in typed_dw_roofline.KERNELS)
    assert not any(n in name for n in typed_matmul_roofline.KERNELS)
    assert not any(n in name for n in mp_kernels_ms_per_step.KERNELS.values())
    for other in ("void typed_matmul_bf16_kernel<256>(CUtensorMap, CUtensorMap, CUtensorMap, int const*)",
                  "segment_sum_kernel", "broadcast_rows_kernel"):
        assert not any(n in other for n in typed_dw_roofline.KERNELS)


def test_a_whole_window_cannot_pass_its_roofline():
    """At the bound's time the share reads 100 %: the count is of real edges,
    which the kernel reads at least once."""
    config = spec.load_config("ppi_mlp_sum")
    e = 71064
    group = pool.Group([], nodes=2385, edges=e)
    moved = 2 * e * (512 + 256) + 4 * 3 * 512 * 256
    ns = int(round(1e9 * max(moved / peaks.HBM_BYTES_PER_S, 2 * e * 512 * 256 / 989e12)))
    got = typed_dw_roofline.read(_run(config, [group], _kernels(5, (ns - 1, 1)), {"typed_dw": 5}))
    assert got == pytest.approx(100.0, rel=1e-3)
