"""The FLOP and byte counts and the trace's busy time on hand-worked
cases."""
from gnnbench.harness import peaks, pool, report, spec, trace
from gnnbench.metrics import device_idle_pct, step_mfu, typed_matmul_roofline


def _run(config, groups, tr, shapes, launches=None):
    return report.LayerRun(config, tr, len(groups), groups, {"launches": launches or {}}, 1.0, 0, shapes)


def test_forward_flops_by_hand():
    config = spec.load_config("ppi_mlp_sum")
    group = pool.Group([], nodes=10, edges=30)
    shapes = {"to_logits.weight": (121, 256)}
    h = 256
    embed = 2 * 10 * 50 * h
    layer = 2 * 30 * (2 * h) * h + 2 * 10 * h * h
    head = 2 * 10 * h * 121
    assert step_mfu.forward_flops(config, group, shapes) == embed + 5 * layer + head


def test_g2c_flops_count_supernodes_and_wide_layers():
    config = spec.load_config("g2c_typilus_mlp")
    group = pool.Group([], nodes=4, edges=9, references={"supernodes": 2})
    shapes = {"node_to_class.weight": (21, 64)}
    want = 2 * 4 * 64 * 64  # the embedder's dense layer
    want += 6 * (2 * 9 * 128 * 64 + 2 * 4 * 64 * 64) + 2 * (2 * 9 * 256 * 128 + 2 * 4 * 128 * 64)
    want += 2 * 2 * 64 * 21
    assert step_mfu.forward_flops(config, group, shapes) == want


def _trace(device, window=(0, 1_000_000_000)):
    events = [(trace.WINDOW, False, window[0], window[1])] + [(n, True, a, b) for n, a, b in device]
    return trace.summarize(events)


def test_busy_is_the_union_of_device_intervals():
    tr = _trace([("k1", 100, 300), ("k2", 200, 400), ("k3", 600, 700), ("late", 999_999_990, 1_000_000_010)])
    assert tr.busy_ns == 300 + 100 + 10
    assert tr.gaps[0] == (0, 100) and tr.gaps[1] == (400, 600)
    run = _run(spec.load_config("ppi_mlp_sum"), [pool.Group([], 1, 1)], tr, {})
    assert abs(device_idle_pct.read(run) - 100 * (1 - 410e-9)) < 1e-9


def test_typed_matmul_roofline_by_hand():
    config = spec.load_config("ppi_mlp_sum")
    products = typed_matmul_roofline.products(config)
    assert products[:3] == [(512, 256), (256, 256), (256, 256)] and len(products) == 15
    e = 1000
    group = pool.Group([], nodes=100, edges=e)
    least = 0.0
    for d, m in products:
        least += max(2 * (e * d + e * m + 3 * d * m) / peaks.HBM_BYTES_PER_S, 2 * e * d * m / 989e12)
    kernels = [("typed_matmul_bf16_kernel<256>", 10 * i, 10 * i + 5) for i in range(15)]
    tr = _trace(kernels)
    shapes = {"gnn.message_passing_layers.1.message_mlp.weights_0": (3, 512, 256)}
    run = _run(config, [group], tr, shapes, {"typed_matmul": 15})
    assert abs(typed_matmul_roofline.read(run) - 100 * least / (15 * 5e-9)) < 1e-6 * 100 * least / 75e-9
    # a trace that lost launches the program counted reads nothing
    assert typed_matmul_roofline.read(_run(config, [group], tr, shapes, {"typed_matmul": 16})) is None
    # typed products that ran on other kernels read nothing
    assert typed_matmul_roofline.read(_run(config, [group], _trace(kernels[:14]), shapes)) is None


def test_lost_trace_events_are_scaled_up_to_a_share():
    from gnnbench.metrics import mp_kernels_ms_per_step

    config = spec.load_config("g2c_typilus_mlp")
    groups = [pool.Group([], nodes=4, edges=9)] * 2
    held = [("segment_sum_kernel", 10 * i, 10 * i + 5) for i in range(99)]
    tr = _trace(held)
    lost_one = _run(config, groups, tr, {}, {"segment_sum": 100})
    assert abs(mp_kernels_ms_per_step.read(lost_one) - 1e3 * 99 * 5e-9 * 100 / 99 / 2) < 1e-12
    lost_many = _run(config, groups, _trace(held[:90]), {}, {"segment_sum": 100})
    assert mp_kernels_ms_per_step.read(lost_many) is None
