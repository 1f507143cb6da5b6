"""The iteration's counted fp32 FLOPs (portbench.work.iteration_flops: the
MLPs' products of the rollout, the update and the adaptation steps, and
the control-step kernel's operations) over the mean seconds of an
iteration timed outside the profiler times the card's fp32 peak."""
from portbench import work
from portbench.trace import ITERATION


def read(ctx):
    t = ctx["spans"].get(ITERATION, [])
    if not t:
        return None
    return 100.0 * ctx["flops"]["total"] / (
        sum(t) / len(t) * work.PEAK_FP32_FLOPS)
