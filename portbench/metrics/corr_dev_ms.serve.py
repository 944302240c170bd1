"""Device kernel milliseconds a window launched inside ``track.corr`` (each
iteration's correlation lookup in ``Pips.track``), in the spans section of
the profile (``portbench/spans.py``)."""

from portbench.spans import read as span_value


def read(run):
    return span_value(run, "window", "track.corr", "dev_ms")
