"""Percent of its roofline that the channel block's forward reaches in the
profiled whole training steps: ``chanff_bound`` at R = (clips after flips)
* N * S rows (D 512, F 2048, bf16) over the device time of one call's three
kernels."""

import re

from portbench.roofline import chanff_bound
from portbench.trace import per_call_us

# a demangled name ends each at "<" or "(", a mangled one at its template "I"
KERNELS = [re.compile(rf"chanff_fwd_{k}(?:\b|(?=I))") for k in ("ln", "act", "out")]


def read(run):
    t = run["trace"]
    if t is None or run["kind"] != "train_step" or run["dtype"] != "bfloat16":
        return None
    us = per_call_us(t["calls"]["kernels"], KERNELS, t["chanff_fwd_calls"])
    if us is None:
        return None
    return 100.0 * chanff_bound(run["chanff_rows"], "bfloat16")[0] * 1e3 / us
