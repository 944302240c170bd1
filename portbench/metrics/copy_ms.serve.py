"""Device milliseconds of host-to-device and device-to-host copies a window
in the profiled whole ``WindowTracker.__call__`` calls: the port's own
upload of the numpy frames and queries and its download of the results."""


def read(run):
    t = run["trace"]
    if t is None or run["kind"] != "window":
        return None
    copy_ms = t["calls"]["copy_ms"]
    return copy_ms if copy_ms > 0 else None
