"""Mean milliseconds of the learner's update (`update`: the epochs of
minibatch steps and the adaptation steps): the harness's span around each
call, ending in a synchronise, over the iterations timed outside the
profiler."""
from portbench.trace import UPDATE


def read(ctx):
    t = ctx["spans"].get(UPDATE, [])
    return 1e3 * sum(t) / len(t) if t else None
