"""Share of the profiled window (whole iterations, from the first one's
start to the last one's end) in which no device operation ran."""


def read(ctx):
    w = ctx["window"]
    if not w or w["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - w["busy_s"] / w["window_s"])
