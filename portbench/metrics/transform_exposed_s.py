"""Transform sessions: the mean ``exposed_s`` (the program's summed
``StepReport.blocked_s``: dispatch and blocking waits that serving paid)
of the transform-log entries completed inside the host window; nothing
where no session ended there."""


def read(rd):
    xs = [t["exposed_s"] for t in rd["transforms"]
          if rd["t0"] <= t["t_done"] <= rd["t_host_end"]]
    return sum(xs) / len(xs) if xs else None
