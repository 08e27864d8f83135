"""Kernels 2-3 (chunked prefill, flash prefill): the summed bound
seconds of their calls in the profiled sub-window (``roofline.counts``
from each call's shapes and visible pairs) over the summed device
seconds of their CUDA functions there, in percent."""


def read(rd):
    tr = rd["trace"]
    if tr is None or not tr["family_s"]["prefill"] or \
            not tr["bounds"]["exact"]:
        return None
    return 100.0 * tr["bounds"]["prefill"] / tr["family_s"]["prefill"]
