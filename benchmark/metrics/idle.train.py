"""idle.train (%): the share of the profiled window, on the host's clock,
in which no operation ran on the card (the profiler's device intervals,
merged)."""


def read(trace):
    if trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
