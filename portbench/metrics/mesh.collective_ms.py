"""Mean milliseconds per iteration that rank 0 spends in the program's
collectives (`parallel/mesh.all_reduce_sum`, `broadcast_`,
`EnvRows.gather`): the harness's spans around each outermost call, a
synchronise before and after, summed over a stretch of iterations of their
own after the profiled ones (`harness.collectives`) and divided by its
iterations.  Nothing where no collective was timed (a cell of one
rank)."""
from portbench.trace import COLLECTIVE, COLLECTIVE_ITERATION


def read(ctx):
    t = ctx["spans"].get(COLLECTIVE, [])
    its = ctx["spans"].get(COLLECTIVE_ITERATION, [])
    return 1e3 * sum(t) / len(its) if t and its else None
