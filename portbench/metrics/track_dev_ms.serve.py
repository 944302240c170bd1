"""Device kernel milliseconds a window launched inside ``pips.track``
(``Pips.track``, the whole refinement), in the spans section of the profile
(``portbench/spans.py``)."""

from portbench.spans import read as span_value


def read(run):
    return span_value(run, "window", "pips.track", "dev_ms")
