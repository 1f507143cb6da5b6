"""Mean milliseconds of the learner's rollout (`collect`): the harness's
span around each call, ending in a synchronise, over the iterations timed
outside the profiler."""
from portbench.trace import ROLLOUT


def read(ctx):
    t = ctx["spans"].get(ROLLOUT, [])
    return 1e3 * sum(t) / len(t) if t else None
