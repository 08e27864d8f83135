"""One run of one cell: set up, warm up, measure for ``seconds``, drain,
judge the outputs against the reference, and report.

The window opens when the first request is due (an open loop) or when
the clients start (a closed loop) and lasts ``seconds``.  Every request
due in it is followed to its end, up to ``drain_s`` past the close; one
that has not answered by then is counted as failed, and its times as
the wait up to that moment (so a tail that includes it is at least that
long).  Times are the host clock (``time.monotonic``, the program's own
clock), read after each engine step, which ends in a copy of the
sampled tokens to the host.

What the harness keeps of a run (``Record``): each request's due time,
lengths and the program's timestamps; each engine step's start and end,
the tokens it completed (prompt positions of requests whose first token
it produced, and tokens generated) and the model operations they need
(``roofline.counts``).  The per-layer metrics (``metrics/<name>.py``)
read that record, the cluster's counters and, in a traced run, the
profile of the window's last ``profile_s`` seconds; host-clock metrics
of a traced run read only the part of the window before the profile.
"""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

import lib
import port
import trace as T
from reference import dense as REF
from roofline import counts as RC
from traffic import generate as G


@dataclass
class Live:
    spec: G.Spec
    req: object
    due: float
    n_ctx: int
    seen: int = 0


@dataclass
class Record:
    c: Dict
    t0: float = 0.0
    t_close: float = 0.0
    t_host_end: float = 0.0
    live: List[Live] = field(default_factory=list)
    done: List[Live] = field(default_factory=list)
    steps: List[Dict] = field(default_factory=list)
    lateness: List[float] = field(default_factory=list)

    def submit(self, spec: G.Spec, req, due: float, now: float,
               n_patches: int) -> None:
        self.live.append(Live(spec, req, due, n_patches + spec.prompt_len))
        self.lateness.append(now - due)

    def after_step(self, ts: float, te: float) -> List[Live]:
        """Account the step that ran from ``ts`` to ``te``; returns the
        requests it finished."""
        prefill = gen = firsts = 0
        flops = 0.0
        finished, still = [], []
        for e in self.live:
            r = e.req
            g = len(r.generated)
            if e.seen == 0 and g > 0:
                firsts += 1
                prefill += e.n_ctx
                n_pat = e.n_ctx - e.spec.prompt_len
                flops += RC.prefill_flops(self.c, n_pat, e.spec.prompt_len)
                gen += 1
                e.seen = 1
            for j in range(e.seen, g):
                flops += RC.token_flops(self.c, e.n_ctx + j - 1, True)
                gen += 1
            e.seen = g
            (finished if r.t_done is not None else still).append(e)
        self.live = still
        self.done += finished
        self.steps.append({"ts": ts, "te": te, "prefill": prefill,
                           "gen": gen, "firsts": firsts, "flops": flops})
        return finished

    def all(self) -> List[Live]:
        return self.done + self.live


class Run:
    """A cell's run on ``device`` (``"cuda"`` on the card; ``"cpu"`` only
    in the benchmark's own tests, at a reduced size)."""

    def __init__(self, cell: Dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_proc0: Optional[float] = None):
        self.cell, self.seed, self.seconds = cell, seed, float(seconds)
        self.trace, self.device = trace, device
        self.t_proc0 = time.monotonic() if t_proc0 is None else t_proc0
        self.c = cell["config"]
        self.mix = cell["traffic"]
        self.serve = cell["serve"]
        self.n_patches = self.c.get("patches", 0)
        self.rec = Record(self.c)
        self.profile = None
        self.server = None
        self.tokens: Dict[int, List[int]] = {}
        #: the window's transform-log entries, stamped with the end of the
        #: step that completed them; the entries each engine had before
        self.transforms: List[Dict] = []
        self._logged: Dict[int, int] = {}
        #: seconds spent compiling the kernels (a checkout's first run),
        #: recorded apart from ``setup_s``; loading them counts in it
        self.build_s = 0.0

    def say(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    # -- requests -------------------------------------------------------
    def _request(self, seed: int, rid: int, prompt_len: int, out_len: int,
                 image: bool):
        """A request's tokens (made in set-up for an open loop) and, for
        an image, its patches, made on the device from ``seed``."""
        toks = self.tokens.pop(rid, None) or G.prompt_tokens(
            seed, rid, prompt_len, self.c["vocab_size"])
        pat = None
        if image and self.n_patches:
            pat = G.patches(seed, rid, self.n_patches, self.c["hidden_size"],
                            self.device, getattr(torch, self.c["dtype"]))
        return port.request(toks, out_len, pat)

    def _submit(self, spec: G.Spec, due: float, now: float) -> None:
        req = self._request(self.seed, spec.rid, spec.prompt_len,
                            spec.out_len, spec.image)
        n_pat = self.n_patches if req.patches is not None else 0
        self.rec.submit(spec, req, due, now, n_pat)
        self.server.submit(req)

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        if self.device != "cpu":
            t = time.monotonic()
            if port.build_kernels():
                self.build_s = time.monotonic() - t
        self.server = port.make_server(self.c, self.serve["serve"], self.seed,
                                       self.device)
        self.make_traffic()
        self.warm()
        if self.trace:
            self._warm_profiler()
        self.sync()

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def _warm_profiler(self) -> None:
        """Start and stop the profiler once, so its first start (the
        tracing library's initialisation, seconds) is paid in set-up, and
        load the kernels the traced window's counting runs."""
        with self._profiler():
            T.warm(self.device)
            self.sync()

    def make_traffic(self) -> None:
        if self.mix["kind"] == "open_poisson":
            self.specs = G.open_loop(self.mix, self.seed, self.seconds)
            for s in self.specs:
                self.tokens[s.rid] = G.prompt_tokens(
                    self.seed, s.rid, s.prompt_len, self.c["vocab_size"])
        else:
            self.specs = G.closed_loop(self.mix, self.seed)

    def warm(self) -> None:
        """Serve the cell's own shapes once: each warm-up request of the
        serving file (lengths, count), all at once, to the end.  On a
        cluster its long request merges two instances and the drain
        splits them again."""
        for i, w in enumerate(self.serve["warmup"]):
            self.server.submit(self._request(
                self.seed ^ 0x5EED, i, w["prompt"], w["output"],
                bool(w.get("image"))))
        for _ in range(100_000):
            if port.settled(self.server):
                break
            self.server.step()
        else:
            raise RuntimeError("warm-up did not drain")
        self._logged = {id(e): len(e.transform_log)
                        for e in port.engines(self.server)}

    def sync(self) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()

    # -- the window -----------------------------------------------------
    def _maybe_profile(self, now: float) -> None:
        if not self.trace or self.profile is not None:
            return
        start = self.rec.t_close - self.serve["profile_s"]
        if now < start:
            return
        self.sync()
        prof = self._profiler()
        kern = T.Recorder(port.KERNELS)
        kern.__enter__()
        prof.__enter__()
        self.rec.t_host_end = time.monotonic()
        self.profile = {"prof": prof, "kern": kern,
                        "t_start": self.rec.t_host_end}

    def _stop_profile(self) -> None:
        p = self.profile
        if p is None or "t_stop" in p:
            return
        self.sync()
        # the window ends with the device's last work, before the
        # profiler stops (stopping and reading the trace take seconds)
        p["t_stop"] = time.monotonic()
        p["prof"].__exit__(None, None, None)
        p["kern"].__exit__(None, None, None)

    def _step(self):
        with torch.profiler.record_function("portbench.step"):
            ts = time.monotonic()
            self.server.step()
            te = time.monotonic()
        done = self.rec.after_step(ts, te)
        self.rec.steps[-1]["stall"] = port.stall_steps(self.server)
        for e in port.engines(self.server):
            seen = self._logged.get(id(e), 0)
            self.transforms += [{**t, "t_done": te}
                                for t in e.transform_log[seen:]]
            self._logged[id(e)] = len(e.transform_log)
        return done

    def window(self) -> None:
        rec = self.rec
        rec.t0 = time.monotonic()
        rec.t_close = rec.t0 + self.seconds
        rec.t_host_end = rec.t_close
        self.setup_s = rec.t0 - self.t_proc0 - self.build_s
        self.stall0 = port.stall_steps(self.server)
        deadline = rec.t_close + self.serve["drain_s"]
        if self.mix["kind"] == "open_poisson":
            self._open(deadline)
        else:
            self._closed(deadline)
        self._stop_profile()
        self.t_end = time.monotonic()

    def _open(self, deadline: float) -> None:
        rec, specs = self.rec, self.specs
        i = 0
        while True:
            now = time.monotonic()
            while i < len(specs) and rec.t0 + specs[i].due <= now:
                self._submit(specs[i], rec.t0 + specs[i].due, now)
                i += 1
            if now >= rec.t_close:
                self._stop_profile()
            else:
                self._maybe_profile(now)
            if port.idle(self.server):
                if i >= len(specs):
                    return
                wait = rec.t0 + specs[i].due - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                continue
            if now > deadline:
                return
            self._step()

    def _closed(self, deadline: float) -> None:
        rec, pool = self.rec, self.specs
        nxt = 0
        for _ in range(self.mix["clients"]):
            self._submit(pool[nxt], rec.t0, rec.t0)
            nxt += 1
        while True:
            now = time.monotonic()
            if now >= rec.t_close:
                self._stop_profile()
            else:
                self._maybe_profile(now)
            if port.idle(self.server) or now > deadline:
                return
            for e in self._step():
                t = time.monotonic()
                if e.req.t_done < rec.t_close and nxt < len(pool):
                    self._submit(pool[nxt], e.req.t_done, t)
                    nxt += 1

    # -- results --------------------------------------------------------
    def requests(self) -> List[Dict]:
        """Every request due in the window, with its times; one not done
        by the end of the drain has ``failed`` set and its missing times
        censored at that moment."""
        out = []
        for e in self.rec.all():
            r = e.req
            first = r.t_first_token
            failed = r.t_done is None
            ttft = (first if first is not None else self.t_end) - e.due
            if not failed and len(r.generated) > 1:
                tpot = (r.t_done - first) / (len(r.generated) - 1)
            elif not failed:
                tpot = None
            else:
                tpot = (self.t_end - (first if first is not None
                                      else e.due))
            out.append({"due": e.due, "failed": failed, "ttft": ttft,
                        "tpot": tpot, "prefill_start": r.t_prefill_start})
        return out

    def record(self) -> Dict:
        """What the metric readers read."""
        rec = self.rec
        d = {"t0": rec.t0, "t_close": rec.t_close,
             "t_host_end": rec.t_host_end, "t_end": self.t_end,
             "requests": self.requests(), "steps": rec.steps,
             "stall0": self.stall0, "transforms": self.transforms,
             "trace": None}
        if self.profile is not None and "t_stop" in self.profile:
            p = self.profile
            s = T.summary(p["prof"], p["t_stop"] - p["t_start"])
            s["bounds"] = p["kern"].bounds()
            d["trace"] = s
        return d

    def end_to_end(self, rd: Dict) -> Dict[str, float]:
        reqs = rd["requests"]
        close = rd["t_close"]
        toks = sum(s["prefill"] + s["gen"] for s in rd["steps"]
                   if s["te"] <= close)
        ttfts = [r["ttft"] for r in reqs]
        tpots = [r["tpot"] for r in reqs if r["tpot"] is not None]
        out = {"throughput_tok_s": toks / self.seconds,
               "setup_s": self.setup_s}
        for p in (50, 90, 95, 99):
            out[f"ttft_p{p}_s"] = lib.percentile(ttfts, p)
            out[f"tpot_p{p}_ms"] = lib.percentile(tpots, p) * 1e3
        return out

    # -- correctness ----------------------------------------------------
    def spans(self, e: Live) -> List[Dict]:
        """The sessions that completed while ``e`` was decoding: between
        its first token and its last, its pages were moved."""
        r = e.req
        return [t for t in self.transforms
                if r.t_first_token < t["t_done"] < r.t_done]

    def sample(self) -> List[Live]:
        """Finished requests to judge, drawn from the seed: the one with
        the longest context, the one with the shortest prompt (a whole
        prompt in one prefill), where sessions ran the one that decoded
        across the most of them, then others in a random order until the
        serving file's counts of served tokens and of requests are met
        (``min_requests`` at least, ``max_requests`` at most)."""
        judge = self.serve["judge"]
        done = [e for e in self.rec.all() if e.req.t_done is not None]
        if not done:
            return []
        done.sort(key=lambda e: e.spec.rid)
        pick = [max(done, key=lambda e: (e.n_ctx + len(e.req.generated),
                                         -e.spec.rid)),
                min(done, key=lambda e: (e.spec.prompt_len, e.spec.rid))]
        across = max(done, key=lambda e: (len(self.spans(e)), -e.spec.rid))
        if self.spans(across):
            pick.append(across)
        pick = list({id(e): e for e in pick}.values())
        rest = [e for e in done if all(e is not p for p in pick)]
        order = np.random.default_rng([self.seed & ((1 << 63) - 1), 7]
                                      ).permutation(len(rest))
        served = sum(len(e.req.generated) for e in pick)
        for i in order:
            if len(pick) >= judge["max_requests"] or (
                    served >= judge["served_tokens"]
                    and len(pick) >= judge["min_requests"]):
                break
            pick.append(rest[i])
            served += len(rest[i].req.generated)
        return pick

    def judge(self, pick: List[Live], control: bool = False
              ) -> Dict[str, float]:
        seqs, served = [], []
        for e in pick:
            r = e.req
            pat = None
            if e.n_ctx > e.spec.prompt_len:
                pat = G.patches(self.seed, e.spec.rid, self.n_patches,
                                self.c["hidden_size"], self.device,
                                getattr(torch, self.c["dtype"]))
            seqs.append(REF.sequence(r.prompt, r.generated,
                                     e.n_ctx - e.spec.prompt_len, pat))
            served.append(list(r.generated))
        return REF.judge(self.c, self.seed, seqs, served, self.device,
                         control=control)

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for e in self.rec.all():
            e.req.patches = None
        self.server = None
        self.profile = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()


def result(run: Run, control: bool = False) -> Dict:
    """Run the cell end to end and return the result line's object.
    With ``control`` (which the benchmark's own runs never ask), the fp8
    control is judged on the same sample in the program's place: its
    gap is the one held to the limit, so ``correct`` is the control's,
    and both sides' readings go under ``control``."""
    run.setup()
    run.window()
    rd = run.record()
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device != "cpu" else 0)
    e2e = run.end_to_end(rd)
    if run.trace:
        metrics = {}
        for m in run.cell["per_layer"]:
            v = lib.reader(m["name"])(rd)
            if v is not None and lib.finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in run.cell["end_to_end"]}
    reqs = rd["requests"]
    failed = sum(r["failed"] for r in reqs)
    late = sorted(run.rec.lateness)
    run.say(f"generator lateness s: p50 {lib.percentile(late, 50)!r} "
            f"p99 {lib.percentile(late, 99)!r} max "
            f"{late[-1] if late else float('nan')!r} over {len(late)}")
    run.say("end to end: " + " ".join(f"{k} {v!r}" for k, v in e2e.items()))
    run.say(f"kernel build s {run.build_s!r} (a first run's compile, "
            f"apart from setup_s)")
    pick = run.sample()
    run.free()
    t_ref = time.monotonic()
    verdict = (run.judge(pick, control) if pick
               else {"served_gap": math.inf})
    run.say(f"reference: {len(pick)} requests, "
            f"{sum(len(e.req.generated) for e in pick)} served tokens, "
            f"{time.monotonic() - t_ref:.1f} s; judged (rid, context, "
            f"served, sessions decoded across): "
            + " ".join(f"({e.spec.rid}, {e.n_ctx}, {len(e.req.generated)}, "
                       f"{len(run.spans(e))})" for e in pick))
    limits = run.serve["limits"]
    # the control, where asked, stands in the program's place
    gap = verdict.get("control_gap" if control else "served_gap", math.inf)
    checks = {"served_gap": {"value": gap, "limit": limits["served_gap"]},
              "unanswered": {"value": failed, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": len(reqs),
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if run.device != "cpu" else "cpu",
                      "kind": (torch.cuda.get_device_name(0)
                               if run.device != "cpu" else "cpu"),
                      "count": 1, "memory_peak_bytes": peak}}
    tr = rd["trace"]
    if run.trace and tr is not None:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    if not math.isfinite(checks["served_gap"]["value"]):
        checks["served_gap"]["value"] = 1e30
    out["kernel_build_s"] = run.build_s
    out["checks"] = checks
    run.say("readings: " + " ".join(f"{k} {v!r}" for k, v in verdict.items()))
    if control:
        out["control"] = verdict
    for k, c in checks.items():
        run.say(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return out
