"""Engine loop: the mean host wall of the engine steps that generated
tokens and produced no first token (no prefill work), ended inside the
host window: their wall over their count."""


def read(rd):
    st = [s for s in rd["steps"] if rd["t0"] <= s["ts"]
          and s["te"] <= rd["t_host_end"] and s["firsts"] == 0
          and s["gen"] > 0]
    return 1e3 * sum(s["te"] - s["ts"] for s in st) / len(st) if st else None
