"""Percent of the card's bf16 dense peak that the training steps reach: three
times the benchmark's count of the step's forward operations (the forward,
and twice it for the backward) times the steps completed, over the measured
window's seconds."""

from portbench.roofline import PEAK_FLOPS


def read(run):
    if run["trace"] is None or run["kind"] != "train_step":
        return None
    return (100.0 * 3.0 * run["forward_flops"] * run["units"] / run["window_s"]
            / PEAK_FLOPS["bfloat16"])
