"""Device kernel milliseconds a step launched inside ``step.backward``
(``loss.backward()``, from whichever thread), in the spans section of the
profile (``portbench/spans.py``)."""

from portbench.spans import read as span_value


def read(run):
    return span_value(run, "train_step", "step.backward", "dev_ms")
