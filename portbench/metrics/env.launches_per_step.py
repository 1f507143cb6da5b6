"""Device operations (kernels, copies, sets) per control step of the
profiled rollouts: the device events that start inside the harness's
rollout ranges, over the control steps of those rollouts."""
from portbench.trace import ROLLOUT, in_ranges


def read(ctx):
    ranges = ctx["profile"]["ranges"].get(ROLLOUT, [])
    if not ranges:
        return None
    n = len(in_ranges(ctx["profile"]["device"], ranges))
    return n / (len(ranges) * ctx["num_steps"])
