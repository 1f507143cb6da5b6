"""The control-step kernel's share of its roofline: the least time of one
launch over the cell's envs (the larger of its bytes over the HBM peak and
its fp32 operations over the fp32 peak, from the frozen `work_per_env`)
over the mean device time of the kernel's launches in the profiled
window.  Nothing where the trace holds no launch of it."""
from portbench import work


def read(ctx):
    name = ctx["cell"].config["kernel"]["name"]
    w = ctx["window"]
    times = [en - s for s, en, n in ctx["profile"]["device"]
             if name in n and w["t0"] <= s and en <= w["t1"]]
    if not times:
        return None
    least, _ = work.least_seconds(*ctx["kernel_work"])
    return 100.0 * least / (sum(times) / len(times) / 1e9)
