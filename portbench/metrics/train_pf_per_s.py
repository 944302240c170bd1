"""Training point-frames per second: (clips after flips) * N * S for every
step of the measured window, over all its seconds (host clock, the window
ending in a device sync)."""


def read(run):
    return run["point_frames"] / run["window_s"] if run["kind"] == "train_step" else None
