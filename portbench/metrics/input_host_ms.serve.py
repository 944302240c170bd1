"""Host milliseconds a window inside ``window.input``
(``WindowTracker.__call__``'s conversion of the numpy queries and frames to
f32 and their upload), in the spans section of the profile
(``portbench/spans.py``)."""

from portbench.spans import read as span_value


def read(run):
    return span_value(run, "window", "window.input", "host_ms")
