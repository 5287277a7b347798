"""The typed weight gradients' share of their roofline: the least time the
card needs for every dW of the traced window's steps, over the device time
of the kernels that compute them (K6, ``csrc/typed_dw.cu``: its products
and the pass that sums their partials, both named ``typed_dw_bf16_kernel``).

A dW is the weight gradient of one MLP message-passing layer's typed
message product, ``dW[t] = sum over type t's edges of x_e^T g_e``, once per
layer and step: x [E, D] (D = 2 x the layer's input width where the
message reads the target state) and g [E, M] read at the configuration's
item size, the T x D x M float32 gradient written, once each, and
2 E D M operations, E the minibatch's real materialized edges, never its
padding; its least time is the larger of bytes over the HBM bandwidth and
operations over the precision's peak. The kernel reads at least those
edges, so the share cannot pass 100 %. Where the counter says the kernel
ran fewer times than there are dWs, some ran elsewhere, and nothing is
read. Where the trace holds fewer of its operations (two a launch) than the
program's launch counter says ran, it lost events: up to
``trace.LOST_EVENTS`` of them, the time is scaled by launched over held;
beyond that, nothing is read."""
from gnnbench.harness import peaks, trace

KERNELS = ("typed_dw_bf16_kernel",)
OPS_PER_LAUNCH = 2  # the products and the sum of their partials
COMBINE = "rank0"


def gradients(config):
    """(D, M) of each dW of one step."""
    target = config["mlp_mp"]["target_state_input"]
    return [(2 * entry[1] if target else entry[1], entry[2]) for entry in config["stack"] if entry[0] == "mlp_mp"]


def read(run):
    seconds, held = run.trace.kernel_seconds(*KERNELS)
    weight = next((s for name, s in run.shapes.items() if name.endswith("message_mlp.weights_0")), None)
    if not held or not run.steps or weight is None:
        return None
    per_step = gradients(run.config)
    launched = run.counters.get("launches", {}).get("typed_dw", 0)
    ran = max(held, OPS_PER_LAUNCH * launched)
    if launched < len(per_step) * run.steps or held < (1.0 - trace.LOST_EVENTS) * ran:
        return None
    seconds *= ran / held
    size = peaks.itemsize(run.config)
    least = 0.0
    for g in run.groups:
        for d, m in per_step:
            moved = size * g.edges * (d + m) + 4 * weight[0] * d * m
            least += peaks.least_seconds(moved, 2.0 * g.edges * d * m, run.config)
    return 100.0 * least / seconds
