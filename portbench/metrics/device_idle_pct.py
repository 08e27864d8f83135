"""Device: the share of the profiled sub-window in which no kernel, copy
or fill ran on the card, in percent."""


def read(rd):
    tr = rd["trace"]
    if tr is None or not tr["window_s"] or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
