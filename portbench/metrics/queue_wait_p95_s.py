"""Engine admission: the 95th percentile, over the requests due before
the host window's end, of the wait from a request's due time to its
first prefill work (the program's ``t_prefill_start``); a request never
started counts as waiting to the end of the drain."""
from lib import percentile


def read(rd):
    w = [(r["prefill_start"] if r["prefill_start"] is not None
          else rd["t_end"]) - r["due"]
         for r in rd["requests"] if r["due"] < rd["t_host_end"]]
    return percentile(w, 95) if w else None
