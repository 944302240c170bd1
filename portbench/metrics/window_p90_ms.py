"""The 90th percentile, over every window of the run, of the host-clock time
from handing numpy frames and queries to ``WindowTracker.__call__`` until its
numpy results are back (numpy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile(run["latencies_s"], 90)) * 1e3 if run["kind"] == "window" else None
