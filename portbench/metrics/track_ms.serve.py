"""Device kernel milliseconds a window inside the profiled split windows'
``track`` part (between its marks, ``WindowTracker.track`` on the numpy
queries, ending in a sync)."""


def read(run):
    t = run["trace"]
    if t is None or run["kind"] != "window":
        return None
    return t["parts"]["kernel_ms_by_part"].get("track")
