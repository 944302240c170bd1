"""Percent of the profiled whole windows (a mark between them, no sync but
the port's own) in which no operation ran on the device: one minus the
union of kernel, copy and memset intervals over the span's wall time, both
from the same trace."""


def read(run):
    t = run["trace"]
    if t is None or run["kind"] != "window":
        return None
    c = t["calls"]
    return 100.0 * (1.0 - c["busy_s"] / c["window_s"])
