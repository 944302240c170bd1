"""Device kernel milliseconds a window launched inside ``mixer.token`` (the
token half of each MLP-Mixer block: norm, ``TokenMixFF``, residual), in the
spans section of the profile (``portbench/spans.py``)."""

from portbench.spans import read as span_value


def read(run):
    return span_value(run, "window", "mixer.token", "dev_ms")
