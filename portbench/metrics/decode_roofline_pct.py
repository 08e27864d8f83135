"""Kernel 1 (paged decode): the summed bound seconds of its calls in the
profiled sub-window (``roofline.counts`` from each call's shapes and
visible pairs) over the summed device seconds of its CUDA functions
there, in percent."""


def read(rd):
    tr = rd["trace"]
    if tr is None or not tr["family_s"]["decode"] or \
            not tr["bounds"]["exact"]:
        return None
    return 100.0 * tr["bounds"]["decode"] / tr["family_s"]["decode"]
