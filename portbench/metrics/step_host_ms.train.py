"""Host milliseconds a step inside ``step`` (the whole ``make_train_step``
call, which returns without a sync), in the spans section of the profile
(``portbench/spans.py``)."""

from portbench.spans import read as span_value


def read(run):
    return span_value(run, "train_step", "step", "host_ms")
