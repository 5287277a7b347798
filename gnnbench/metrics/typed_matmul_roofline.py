"""The typed products' share of their roofline: the least time the card
needs for every typed product of the traced window's steps, over the device
time of the kernels that compute them (K5, ``csrc/typed_matmul.cu``).

The typed products are the per-edge-type linear maps of the MLP
message-passing layers: per layer and step the forward message
([E, D] x [T, D, M]) and the backward's two input products
([E, M] x [T, M, D/2] each, where the message reads the target state too).
Each is counted from the real materialized edges E of the minibatch, not
its padding: [E, D] read, [E, M] written and the T weight blocks read, once
each, at the configuration's item size, and 2 E D M operations; its least
time is the larger of bytes over the HBM bandwidth and operations over the
precision's peak. The same work is counted whatever kernel implements it;
where the listed kernels ran fewer launches than there are typed products,
some ran elsewhere, and nothing is read. Where the trace holds fewer of
them than the program's launch counter says ran, it lost events: up to
``trace.LOST_EVENTS`` of them, the time is scaled by launched over held (a
lost launch taken at the held ones' mean); beyond that, nothing is read."""
from gnnbench.harness import peaks, trace

KERNELS = ("typed_matmul_bf16_kernel", "typed_matmul_f32_kernel")
COMBINE = "rank0"


def products(config):
    """(D, M) of each typed product of one step."""
    out = []
    target = config["mlp_mp"]["target_state_input"]
    for entry in config["stack"]:
        if entry[0] == "mlp_mp":
            d_in, m = entry[1], entry[2]
            width = 2 * d_in if target else d_in
            out.append((width, m))
            out.extend([(m, d_in)] * (2 if target else 1))
    return out


def read(run):
    seconds, launches = run.trace.kernel_seconds(*KERNELS)
    weight = next((s for name, s in run.shapes.items() if name.endswith("message_mlp.weights_0")), None)
    if not launches or not run.steps or weight is None:
        return None
    per_step = products(run.config)
    launched = max(launches, run.counters.get("launches", {}).get("typed_matmul", 0))
    if launched < len(per_step) * run.steps or launches < (1.0 - trace.LOST_EVENTS) * launched:
        return None
    seconds *= launched / launches
    size = peaks.itemsize(run.config)
    least = 0.0
    for g in run.groups:
        for d, m in per_step:
            moved = size * (g.edges * d + g.edges * m + weight[0] * d * m)
            least += peaks.least_seconds(moved, 2.0 * g.edges * d * m, run.config)
    return 100.0 * least / seconds
