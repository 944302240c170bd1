"""Point-frames returned to the host per second: every window's N * S over
all the seconds of the measured window (host clock)."""


def read(run):
    return run["point_frames"] / run["window_s"] if run["kind"] == "window" else None
