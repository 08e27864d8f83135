"""Partial merges (rung 2 of the capacity ladder) on the port's
``ClusterEngine`` against the JAX ``ClusterEngine`` — the counterparts
of ``tests/test_cluster_merge.py::test_partial_merge_donor_serves_mid_chunked_prefill``
and ``::test_live_spill_grant_failure_falls_back_to_partial_merge``.

Reduced llama3-8b in float32 on 8 workers: 4 instances of 2 (the
reduced config's 4 kv heads copied twice in the pool-wide plan),
``max_batch=2``, ``max_seq=32``, ``SchedulerConfig(partial_merge=True,
target_tp=4)``.  Each scenario's reference cluster runs in a subprocess
of its own with 8 fake host devices (both start with the module) and
writes its weights, actions, placements, streams and widths to a file.
Actions, placements and greedy streams must be EQUAL; the donors shed a
worker each in place and never park, the target widens to TP4, the
split returns every loan, and the streams equal each request served
alone by a static engine.
"""
import dataclasses
import pickle
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.padding import make_plan
from repro_torch.core.scheduler import (GygesScheduler, PrefillPolicy,
                                        ScaleUp, SchedulerConfig, Spill)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import start

Q = 16
KW = dict(n_instances=4, max_batch=2, max_seq=2 * Q, dwell_steps=4)
LENS = [(0, 12), (1, 12), (2, 12), (3, 12), (9, 40)]

JAX_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.core.scheduler import (GygesScheduler, PrefillPolicy,
                                      SchedulerConfig)
    from repro.models import model as M
    from repro.serving.cluster import ClusterEngine
    from repro.serving.request import ServeRequest

    case = sys.argv[2]
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    devs = jax.devices()
    params = M.init_params(jax.random.PRNGKey(11), cfg,
                           make_plan(cfg, len(devs), mode="page"))
    Q = %(Q)d
    spill = case == "spill"
    policy = PrefillPolicy(token_budget=16 if spill else 4, mode="mixed",
                           long_threshold=Q, order="sjf")
    sched = GygesScheduler(SchedulerConfig(
        long_threshold=Q, target_tp=4, partial_merge=True, spill=spill,
        spill_slack=2.0))
    cl = ClusterEngine(cfg, devs[:8], params=params, scheduler=sched,
                       prefill_policy=policy,
                       page_tokens=Q if spill else 4, **%(kw)r)
    rng = np.random.default_rng(0)
    prompts = {rid: rng.integers(0, cfg.vocab_size, size=n).tolist()
               for rid, n in %(lens)r}
    if spill:
        for e in cl.engines:
            e.host_spilled = lambda n_pages: None
        reqs = [ServeRequest(rid=9, prompt=prompts[9][:24],
                             max_new_tokens=16)]
    else:
        reqs = [ServeRequest(rid=r, prompt=list(prompts[r]),
                             max_new_tokens=4) for r in range(4)]
        for r in reqs:
            cl.submit(r)
        cl.step()
        reqs.append(ServeRequest(rid=9, prompt=list(prompts[9]),
                                 max_new_tokens=16))
    cl.submit(reqs[-1])
    widths = [e.W for e in cl.engines]
    cl.run(max_steps=8000)
    out = {"params": jax.tree.map(np.asarray, params),
           "actions": [(type(a).__name__, a.iid, a.tp_to,
                        tuple(getattr(a, "donor_iids", ())),
                        tuple(getattr(a, "donor_devices", ())), a.reason)
                       for a in cl.actions],
           "placements": dict(cl.placements),
           "streams": {r.rid: r.generated for r in reqs},
           "widths": widths, "final": [(e.W, e.tp) for e in cl.engines],
           "partial_merges": cl.metrics()["partial_merges"]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""

CASES = ("prefill", "spill")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Both JAX runs, started together when the module's first test
    starts; ``reference(case)`` waits for one."""
    tmp = tmp_path_factory.mktemp("jax")
    body = textwrap.dedent(JAX_SCRIPT) % {"Q": Q, "kw": KW, "lens": LENS}
    refs = {c: start(body, tmp / c, c, devices=8, timeout=220)
            for c in CASES}
    got = {}

    def wait(case):
        if case not in got:
            refs[case].wait()
            with open(tmp / case, "rb") as f:
                got[case] = pickle.load(f)
        return got[case]

    yield wait
    for ref in refs.values():
        ref.close()


def _cfg():
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return {rid: rng.integers(0, vocab, size=n).tolist()
            for rid, n in LENS}


def _actions(cl):
    return [(type(a).__name__, a.iid, a.tp_to,
             tuple(getattr(a, "donor_iids", ())),
             tuple(getattr(a, "donor_devices", ())), a.reason)
            for a in cl.actions]


def _serve(case, params):
    """The port's run of ``case`` on the reference's weights: the
    cluster, its requests, the widths right after the long request's
    placement and what the donors were doing then."""
    cfg = _cfg()
    plan = make_plan(cfg, 8, mode="page")
    model = Model.empty(cfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg, plan))
    spill = case == "spill"
    policy = PrefillPolicy(token_budget=16 if spill else 4, mode="mixed",
                           long_threshold=Q, order="sjf")
    sched = GygesScheduler(SchedulerConfig(
        long_threshold=Q, target_tp=4, partial_merge=True, spill=spill,
        spill_slack=2.0))
    cl = ClusterEngine(cfg, ["cpu"] * 8, params=model, scheduler=sched,
                       prefill_policy=policy, page_tokens=Q if spill else 4,
                       **KW)
    prompts = _prompts(cfg.vocab_size)
    if spill:
        for e in cl.engines:
            e.host_spilled = lambda n_pages: None
        reqs = [ServeRequest(rid=9, prompt=prompts[9][:24],
                             max_new_tokens=16)]
    else:
        reqs = [ServeRequest(rid=r, prompt=list(prompts[r]),
                             max_new_tokens=4) for r in range(4)]
        for r in reqs:
            cl.submit(r)
        cl.step()
        assert all(e._prefilling and all(
            0 < p["done"] < len(p["req"].prompt)
            for p in e._prefilling.values()) for e in cl.engines)
        reqs.append(ServeRequest(rid=9, prompt=list(prompts[9]),
                                 max_new_tokens=16))
    cl.submit(reqs[-1])
    widths = [e.W for e in cl.engines]
    shed = {e.iid: (e.W, e.tp, e.parked, any(s is not None for s in e.slots))
            for e in cl.engines}
    cl.run(max_steps=8000)
    return cl, reqs, widths, shed, model


@pytest.mark.parametrize("case", CASES)
def test_partial_merge_equals_reference(reference, case):
    want = reference(case)
    cl, reqs, widths, shed, model = _serve(case, want["params"])
    acts = _actions(cl)
    assert acts == want["actions"]
    partial = [a for a in cl.actions
               if isinstance(a, ScaleUp) and a.donor_devices]
    assert len(partial) == 1 and partial[0].tp_to == 4
    assert not any(isinstance(a, Spill) for a in cl.actions)
    assert cl.placements == want["placements"]
    assert {r.rid: r.generated for r in reqs} == want["streams"]
    assert widths == want["widths"]
    # the donors shed a worker in place, kept their work, never parked
    act = partial[0]
    for iid in act.donor_iids:
        W, tp, parked, busy = shed[iid]
        assert (W, tp, parked) == (1, 1, False)
        assert busy or case == "spill"
    assert cl.stall_steps == 0
    assert cl.metrics()["partial_merges"] == want["partial_merges"] == 1
    assert [(e.W, e.tp) for e in cl.engines] == want["final"] == [(2, 1)] * 4
    assert not any(e.parked for e in cl.engines)
    assert not cl.partition._loans
    cl.partition.check_invariants()
    # each request alone on a static engine gives the same stream
    ref = Engine(_cfg(), params=model, max_batch=8, max_seq=64,
                 devices=["cpu"] * 8, plan=cl.plan)
    for got in reqs:
        alone = ServeRequest(rid=100 + got.rid, prompt=list(got.prompt),
                             max_new_tokens=got.max_new_tokens)
        ref.submit(alone)
        ref.run_until_done(2000)
        assert alone.generated == got.generated, got.rid
