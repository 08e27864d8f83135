"""Control plane: the change over the host window of the cluster's
``stall_steps`` (steps of an instance inside a cross-instance session in
which its decoding slots emitted no token)."""


def read(rd):
    st = [s for s in rd["steps"] if s["te"] <= rd["t_host_end"]]
    return float(st[-1]["stall"] - rd["stall0"]) if st else None
