"""Device-idle milliseconds a step while ``step.optimizer`` was the innermost
span open on the host, in the spans section of the profile
(``portbench/spans.py``)."""

from portbench.spans import read as span_value


def read(run):
    return span_value(run, "train_step", "step.optimizer", "idle_ms")
