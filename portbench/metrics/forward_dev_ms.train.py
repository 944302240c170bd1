"""Device kernel milliseconds a step launched inside ``step.forward`` (the
model and the loss), in the spans section of the profile
(``portbench/spans.py``)."""

from portbench.spans import read as span_value


def read(run):
    return span_value(run, "train_step", "step.forward", "dev_ms")
