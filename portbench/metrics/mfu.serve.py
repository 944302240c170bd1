"""Percent of the card's bf16 dense peak that the served windows reach: the
benchmark's own count of a window's forward operations (convs, score maps,
the mixer's products and the heads, ``roofline.forward_flops``) times the
windows completed, over the measured window's seconds."""

from portbench.roofline import PEAK_FLOPS


def read(run):
    if run["trace"] is None or run["kind"] != "window":
        return None
    return 100.0 * run["forward_flops"] * run["units"] / run["window_s"] / PEAK_FLOPS["bfloat16"]
