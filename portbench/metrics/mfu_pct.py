"""Model step: the model operations that the tokens completed in the host
window need (``roofline.counts``: two a weight a token, attention over
the visible keys, the head for each sampled token, a vision model's
patch projection), over the window's length times the card's dense bf16
peak, in percent."""
from roofline.counts import PEAK_FLOPS


def read(rd):
    end, t0 = rd["t_host_end"], rd["t0"]
    f = sum(s["flops"] for s in rd["steps"] if s["te"] <= end)
    return 100.0 * f / ((end - t0) * PEAK_FLOPS["bfloat16"]) if f else None
