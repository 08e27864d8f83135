"""The metric arithmetic: tails over every request due in the window, a
request that never answered counting as missing, rates over the window
alone, and each per-layer reader on a record made by hand."""
import math
from types import SimpleNamespace

import harness
import lib
from traffic.generate import Spec


def fake_run(reqs, steps, seconds=10.0, t0=100.0):
    run = harness.Run.__new__(harness.Run)
    run.seconds, run.setup_s = seconds, 5.0
    return run, {"requests": reqs, "steps": steps, "t0": t0,
                 "t_close": t0 + seconds, "t_host_end": t0 + seconds,
                 "t_end": t0 + seconds + 30, "stall0": 3,
                 "transforms": [], "trace": None}


def req(ttft, tpot, failed=False, due=100.0, start=None):
    return {"ttft": ttft, "tpot": tpot, "failed": failed, "due": due,
            "prefill_start": start}


def test_tail_over_every_request():
    reqs = [req(float(i), 10.0) for i in range(1, 21)]
    run, rd = fake_run(reqs, [])
    # nearest rank over all 20: index round(0.95 * 19) = 18, and
    # round(0.9 * 19) = 17
    e2e = run.end_to_end(rd)
    assert (e2e["ttft_p95_s"], e2e["ttft_p90_s"]) == (19.0, 18.0)


def test_missing_request_counts_at_its_censored_wait():
    # three of twenty: the nearest rank round(0.9 * 19) = 17 is one
    reqs = [req(1.0, 0.01) for _ in range(17)]
    reqs += [req(40.0, 40.0, failed=True)] * 3
    run, rd = fake_run(reqs, [])
    assert run.end_to_end(rd)["ttft_p90_s"] == 40.0
    assert run.end_to_end(rd)["tpot_p95_ms"] == 40_000.0


def test_rates_over_the_window_only():
    steps = [{"ts": 100.0, "te": 101.0, "prefill": 1000, "gen": 10,
              "firsts": 1, "flops": 1.0, "stall": 3},
             {"ts": 109.0, "te": 110.0, "prefill": 0, "gen": 20,
              "firsts": 0, "flops": 1.0, "stall": 4},
             # ends after the close: not in the window
             {"ts": 109.9, "te": 110.5, "prefill": 5000, "gen": 30,
              "firsts": 1, "flops": 1.0, "stall": 5}]
    run, rd = fake_run([], steps)
    assert run.end_to_end(rd)["throughput_tok_s"] == (1000 + 10 + 20) / 10
    assert lib.reader("decode_step_ms")(rd) == 1000.0
    assert lib.reader("session_stall_steps")(rd) == 1.0
    assert math.isclose(lib.reader("mfu_pct")(rd), 100 * 2 / (10 * 989e12))


def test_queue_wait_and_missing_start():
    reqs = [req(1.0, 0.01, due=100.0 + i, start=100.5 + i)
            for i in range(19)]
    reqs.append(req(9.0, None, failed=True, due=105.0))
    run, rd = fake_run(reqs, [])
    # the unstarted one waits to the end of the drain: 140 - 105
    assert lib.reader("queue_wait_p95_s")(rd) == 35.0


def test_transform_exposed_reads_the_window():
    run, rd = fake_run([], [])
    rd["transforms"] = [{"exposed_s": 0.5, "t_done": 101.0},
                        {"exposed_s": 1.5, "t_done": 109.0},
                        {"exposed_s": 9.0, "t_done": 111.0}]
    assert lib.reader("transform_exposed_s")(rd) == 1.0


def test_device_readers_need_a_trace():
    run, rd = fake_run([], [])
    for m in ("device_idle_pct", "prefill_roofline_pct",
              "decode_roofline_pct"):
        assert lib.reader(m)(rd) is None
    rd["trace"] = {"busy_s": 0.75, "window_s": 1.0,
                   "family_s": {"prefill": 0.2, "decode": 0.0},
                   "bounds": {"prefill": 0.1, "decode": 0.0,
                              "exact": True}}
    assert lib.reader("device_idle_pct")(rd) == 25.0
    assert lib.reader("prefill_roofline_pct.batch")(rd) == 50.0
    # a family with no device time says nothing (never 0)
    assert lib.reader("decode_roofline_pct")(rd) is None


def test_record_counts_prompts_once_and_every_token():
    c = {"hidden_size": 8, "num_attention_heads": 2,
         "num_key_value_heads": 1, "intermediate_size": 16,
         "num_hidden_layers": 1, "vocab_size": 10}
    rec = harness.Record(c)
    r = SimpleNamespace(generated=[], t_done=None)
    rec.submit(Spec(0, 5, 3), r, 0.0, 0.25, 0)
    rec.after_step(0.0, 1.0)
    r.generated = [1, 2]                # prefill and one decode in a step
    rec.after_step(1.0, 2.0)
    r.generated, r.t_done = [1, 2, 3], 3.0
    done = rec.after_step(2.0, 3.0)
    assert [s["prefill"] for s in rec.steps] == [0, 5, 0]
    assert [s["gen"] for s in rec.steps] == [0, 2, 1]
    assert [s["firsts"] for s in rec.steps] == [0, 1, 0]
    assert len(done) == 1 and rec.live == [] and rec.lateness == [0.25]


def test_the_judged_sample_takes_the_longest_shortest_and_across():
    """The sample holds the longest context, the shortest prompt and, where
    sessions ran, the request that decoded across the most of them, then
    random others up to its counts."""
    run = harness.Run.__new__(harness.Run)
    run.seed = 2**33 + 5
    run.serve = {"judge": {"served_tokens": 10, "min_requests": 5,
                           "max_requests": 6}}

    def live(rid, prompt, first, done, n=3):
        r = SimpleNamespace(t_first_token=first, t_done=done,
                            generated=[1] * n)
        return harness.Live(Spec(rid, prompt, n), r, 0.0, prompt)

    done = [live(0, 500, 1.0, 2.0), live(1, 9000, 1.0, 3.0),
            live(2, 64, 5.0, 6.0), live(3, 800, 2.0, 9.0),
            live(4, 700, 2.5, 4.0)] + [live(i, 900, 1.0, 1.5)
                                       for i in range(5, 12)]
    run.rec = harness.Record({})
    run.rec.done = done
    run.transforms = [{"t_done": 3.5}, {"t_done": 7.0}]
    pick = run.sample()
    assert [e.spec.rid for e in pick[:3]] == [1, 2, 3]
    assert [len(run.spans(e)) for e in pick[:3]] == [0, 0, 2]
    assert len(pick) == 5 and len({e.spec.rid for e in pick}) == 5
    run.transforms = []
    assert [e.spec.rid for e in run.sample()[:2]] == [1, 2]
