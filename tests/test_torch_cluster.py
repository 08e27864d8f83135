"""The port's ``ClusterEngine`` (cross-instance merge and split under the
Gyges scheduler) against the JAX ``ClusterEngine`` — the counterpart of
``tests/test_cluster_merge.py::test_live_merge_bit_exact_and_split_revives_donor``.

Reduced llama3-8b in float32, two instances over a pool of 4 CPU workers
(2 x 2, a merge to TP4, the reference's own shape) and of 2 workers
(2 x 1, a merge to TP2, the card's shape); ``max_batch=4``,
``max_seq=64``, ``page_tokens=16``.  Four workers, not eight: the
reduced config has 4 kv heads and the port has no replicated kv heads.
Short requests land on both instances, then a 96-token request that
only the merged engine holds triggers the merge; Alg 2 splits it after
the dwell and the donor is revived.  (Eight workers, with replicated kv
heads, are ``tests/test_torch_partial_merge.py``'s.)

Each reference cluster runs once, in a subprocess of its own with 4
fake host devices (both start together), and writes its weights,
actions, placements, streams and metric keys to a file.  Actions,
placements and greedy streams must be EQUAL.
"""
import dataclasses
import pickle
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import kv_transform as KT
from repro_torch.core import instance as I
from repro_torch.core.padding import make_plan
from repro_torch.core.scheduler import (GygesScheduler, PrefillPolicy,
                                        SchedulerConfig)
from repro_torch.core.weight_transform import (ffn_reference,
                                               relayout_mlp_for_tp)
from repro_torch.kernels import ref as KR
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import METRIC_KEYS
from repro_torch.serving.request import ServeRequest

from _jaxref import start

CASES = {"2x2": 4, "2x1": 2}       # instances x workers: pool width
KW = dict(n_instances=2, max_batch=4, max_seq=64, page_tokens=16,
          dwell_steps=4)


def _trace():
    """(rid, prompt, max_new) of three shorts and the merge trigger (96
    tokens: above one instance's ceiling, within the merged one)."""
    rng = np.random.default_rng(0)
    shorts = [(i, rng.integers(0, 512, size=5 + i).tolist(), 8)
              for i in range(3)]
    return shorts + [(99, rng.integers(0, 512, size=80).tolist(), 16)]


POST = (200, list(range(7, 11)), 4)   # served by the revived donor

JAX_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.models import model as M
    from repro.serving.cluster import ClusterEngine
    from repro.serving.request import ServeRequest

    ndev = int(sys.argv[2])
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    params = M.init_params(jax.random.PRNGKey(11), cfg,
                           make_plan(cfg, ndev, mode="page"))
    reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in %(trace)r]
    cl = ClusterEngine(cfg, jax.devices()[:ndev], params=params, **%(kw)r)
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    donor = cl.engines[1]
    rid, prompt, n = %(post)r
    post = ServeRequest(rid=rid, prompt=list(prompt), max_new_tokens=n)
    donor.submit(post)
    donor.run_until_done(500)
    out = {"params": jax.tree.map(np.asarray, params),
           "actions": [(type(a).__name__, a.iid, a.tp_to,
                        tuple(getattr(a, "donor_iids", ())), a.reason)
                       for a in cl.actions],
           "placements": dict(cl.placements),
           "streams": {r.rid: r.generated for r in reqs},
           "post": post.generated,
           "metric_keys": list(cl.metrics()),
           "stall_steps": cl.stall_steps,
           "tokens_during_session": cl.tokens_during_session,
           "tps": [e.tp for e in cl.engines]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    body = textwrap.dedent(JAX_SCRIPT) % {"trace": _trace(), "kw": KW,
                                          "post": POST}
    refs = {name: start(body, tmp / name, ndev, devices=4, timeout=300)
            for name, ndev in CASES.items()}
    out = {}
    for name, ref in refs.items():
        ref.wait()
        with open(tmp / name, "rb") as f:
            out[name] = pickle.load(f)
    return out


def _cfg():
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32")


def _model(params, ndev):
    cfg = _cfg()
    plan = make_plan(cfg, ndev, mode="page")
    model = Model.empty(cfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg, plan))
    return model


def _reqs(trace):
    return [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in trace]


def _record_exports(monkeypatch):
    """Every (rid, per-layer exported state) a merge donor hands over."""
    seen = []
    orig = Engine.export_active

    def export_active(self):
        out = orig(self)
        seen.extend((r.rid, [s.pool.clone() for s in sub])
                    for r, sub, _ in out)
        return out

    monkeypatch.setattr(Engine, "export_active", export_active)
    return seen


@pytest.fixture(scope="module")
def ported(reference):
    """Each case's port cluster on the reference's weights and trace:
    the cluster, its requests, what donors exported and what the target
    slots held right after the merge."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, ndev in CASES.items():
            seen = _record_exports(mp)
            model = _model(reference[name]["params"], ndev)
            cl = ClusterEngine(_cfg(), ["cpu"] * ndev, params=model, **KW)
            reqs = _reqs(_trace())
            for r in reqs[:3]:
                cl.submit(r)
            for _ in range(2):
                cl.step()
            busy = [[s is not None for s in e.slots] for e in cl.engines]
            cl.submit(reqs[3])
            target = cl._engine(cl.merge_log[0]["iid"])
            landed = {rid: [I.join_cache(l.cache, l.attn_layout)
                            for l in target.layers]
                      for rid, _ in cl.merge_log[0]["slots"]}
            slot_of = dict(cl.merge_log[0]["slots"])
            state = {"W": target.W, "alloc": target.max_seq_alloc,
                     "adopted": list(target.adopted_devices),
                     "donor_parked": [cl._engine(i).parked
                                      for i in cl.merge_log[0]["donors"]]}
            cl.run(max_steps=5000)
            donor = cl.engines[1]
            post = _reqs([POST])[0]
            donor.submit(post)
            donor.run_until_done(500)
            out[name] = dict(cluster=cl, reqs=reqs, post=post, busy=busy,
                             seen=list(seen), landed=landed, slot_of=slot_of,
                             state=state, model=model)
            mp.undo()
    finally:
        mp.undo()
    return out


def _actions(cl):
    return [(type(a).__name__, a.iid, a.tp_to,
             tuple(getattr(a, "donor_iids", ())), a.reason)
            for a in cl.actions]


@pytest.mark.parametrize("case", list(CASES))
def test_actions_placements_and_streams_equal_reference(reference, ported,
                                                        case):
    want, got = reference[case], ported[case]
    cl = got["cluster"]
    acts = _actions(cl)
    assert acts == want["actions"]
    assert [a[0] for a in acts] == ["ScaleUp", "ScaleDown"]
    assert acts[0][3] == (1,) and acts[0][2] == CASES[case]
    assert cl.placements == want["placements"]
    assert {r.rid: r.generated for r in got["reqs"]} == want["streams"]
    assert got["post"].generated == want["post"]
    assert [e.tp for e in cl.engines] == want["tps"] == [1, 1]


@pytest.mark.parametrize("case", list(CASES))
def test_merge_exports_live_kv_and_widens_the_target(ported, case):
    got = ported[case]
    ndev = CASES[case]
    assert all(any(b) for b in got["busy"])   # both held live work
    st = got["state"]
    assert st["W"] == ndev and st["alloc"] == 128
    assert st["donor_parked"] == [True]
    assert [w.index for w in st["adopted"]] == list(range(ndev // 2, ndev))
    # the imported KV is bit-identical to what the donor exported
    assert got["seen"]
    for rid, pools in got["seen"]:
        slot = got["slot_of"][rid]
        for layer_pool, cache in zip(pools, got["landed"][rid]):
            mps_d = cache.page_table.shape[1]
            mps_s = layer_pool.shape[0]
            head = cache.pool[slot * mps_d:slot * mps_d + mps_s]
            assert torch.equal(head, layer_pool)


@pytest.mark.parametrize("case", list(CASES))
def test_split_returns_every_loan_and_revives_the_donor(reference, ported,
                                                       case):
    cl = ported[case]["cluster"]
    assert not cl.partition.loans_to(0) and not cl._releasing
    cl.partition.check_invariants()
    assert not any(e.parked for e in cl.engines)
    assert [len(e.devices) for e in cl.engines] == [CASES[case] // 2] * 2
    assert all(not e.adopted_devices for e in cl.engines)
    for e in cl.engines:
        e.check_capacity_invariant()
        for layer in e.layers:
            assert layer.mesh.workers == e.devices
    assert len(ported[case]["post"].generated) == POST[2]
    assert cl.stall_steps == 0 == reference[case]["stall_steps"]
    assert cl.tokens_during_session > 0
    assert (cl.tokens_during_session
            == reference[case]["tokens_during_session"])
    logs = [t for e in cl.engines for t in e.transform_log]
    assert [t["cross"] for t in logs] == [True, True]
    assert all(t["kv_bytes"] > 0 and t["weight_bytes"] > 0 for t in logs)
    m = cl.metrics()
    assert list(m) == list(METRIC_KEYS) == reference[case]["metric_keys"]
    assert m["finished"] == m["total"] == 4 and m["n_transforms"] == 2
    assert m["merge_wall_s"] > 0


@pytest.mark.parametrize("case", list(CASES))
def test_merged_streams_equal_an_engine_started_at_the_merged_width(
        ported, case):
    """Every request alone on a port engine at TP<pool> (transformed
    before serving) gives the stream the merged cluster gave it."""
    ndev = CASES[case]
    got = ported[case]
    cfg = _cfg()
    eng = Engine(cfg, params=got["model"], devices=["cpu"] * ndev,
                 max_batch=4, max_seq=128, page_tokens=16,
                 plan=make_plan(cfg, ndev, mode="page"))
    eng.transform(ndev)
    while eng.transforming:
        eng.step()
    for want, r in zip(_reqs(_trace()), got["reqs"]):
        eng.submit(want)
        eng.run_until_done(2000)
        assert want.generated == r.generated, want.rid


def test_a_donor_mid_chunked_prefill_resumes_on_the_target(monkeypatch):
    """A donor whose slot is between two prefill chunks exports its
    chunk plan and progress with its pages; the target finishes the
    prefill, and every stream equals its request served alone."""
    cfg = _cfg()
    plan = make_plan(cfg, 2, mode="page")
    from repro_torch.models import model as M
    model = M.build(cfg, plan, seed=5, device="cpu")
    seen = _record_exports(monkeypatch)
    policy = PrefillPolicy(token_budget=16, mode="mixed")
    cl = ClusterEngine(cfg, ["cpu"] * 2, params=model, prefill_policy=policy,
                       **KW)
    # a 30- and a 40-token prompt, one an instance: after one step both
    # are 16 tokens in; the idler (30) becomes the donor
    reqs = [ServeRequest(rid=0, prompt=list(range(3, 33)), max_new_tokens=6),
            ServeRequest(rid=1, prompt=list(range(10, 50)), max_new_tokens=6)]
    for r in reqs:
        cl.submit(r)
    cl.step()
    assert sorted(cl.placements.values()) == [0, 1]
    assert all(e._prefilling for e in cl.engines)
    long_ = ServeRequest(rid=9, prompt=list(range(20, 100)),
                         max_new_tokens=16)
    cl.submit(long_)
    target = cl._engine(cl.merge_log[0]["iid"])
    assert cl.merge_log[0]["donors"] == (cl.placements[0],)
    assert [rid for rid, _ in seen] == [0]
    moved = [p for p in target._prefilling.values() if p["req"].rid == 0]
    assert len(moved) == 1 and moved[0]["done"] == 16
    assert moved[0]["chunks"] == [16, 14] and moved[0]["ci"] == 1
    cl.run(max_steps=5000)
    for r in reqs + [long_]:
        alone = Engine(cfg, params=model, devices=["cpu"] * 2, max_batch=4,
                       max_seq=128, page_tokens=16, plan=plan)
        alone.transform(2)
        want = ServeRequest(rid=r.rid, prompt=r.prompt,
                            max_new_tokens=r.max_new_tokens)
        alone.submit(want)
        alone.run_until_done(2000)
        assert want.generated == r.generated, r.rid


@pytest.mark.parametrize("t", [1, 2, 4])
def test_mlp_layout_of_a_pool_of_4_at_every_degree(t):
    """Weights laid out for a pool of 4 (Eq. 2, d_ff padded): each of t
    workers' TP-t shard is 4/t consecutive [gate|up] shards, which the
    padded FFN reads as (tp=4/t, ff=d_ff/t); the shards' outputs sum to
    the unpadded FFN."""
    cfg = dataclasses.replace(_cfg(), d_ff=320)
    plan = make_plan(cfg, 4, mode="page")
    ff, ffp, d = cfg.d_ff, plan.d_ff_padded, cfg.d_model
    assert ffp > ff and (ffp // 4) % 128 == 0    # a zero tail per shard
    g = torch.Generator().manual_seed(2)
    gate, up = (torch.randn(d, ff, generator=g) for _ in range(2))
    down = torch.randn(ff, d, generator=g)
    # the reference's init layout: padding at the global tail
    wi = torch.cat([torch.nn.functional.pad(gate, (0, ffp - ff)),
                    torch.nn.functional.pad(up, (0, ffp - ff))], dim=1)
    wo = torch.nn.functional.pad(down, (0, 0, 0, ffp - ff))
    wi, wo = relayout_mlp_for_tp(wi, wo, ff, 4)
    x = torch.randn(5, d, generator=g)
    want = ffn_reference(x, torch.cat([gate, up], dim=1), down)
    tp, ffk = I.mlp_shards(t, 4, ff)
    shards = ([{"wi": wi, "wo": wo}] if t == 1 else
              [I.shard_mlp({"wi": wi, "wo": wo}, t, w, 4) for w in range(t)])
    got = sum(KR.padded_ffn_ref(x, s["wi"], s["wo"], tp=tp, ff=ffk,
                                activation="swiglu") for s in shards)
    assert (tp, ffk) == (4 // t, ff // t)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flag", ["layouts"])
def test_unported_rungs_are_refused(flag):
    """Once refused, now ported: a cluster under the layout rung builds,
    its engines start at pure TP1 (``par_layout``), and the scheduler's
    layout scan proposes nothing for them (layout changes are for wide
    engines; ``tests/test_torch_sp.py`` runs the rung against the JAX
    cluster)."""
    sched = GygesScheduler(SchedulerConfig(**{flag: True}))
    cl = ClusterEngine(_cfg(), ["cpu"] * 2, scheduler=sched, **KW)
    assert all(str(e.par_layout) == "TP1" for e in cl.engines)
    assert sched.decide_layout(cl.engines) == []


def test_engine_refuses_partial_and_same_degree_moves():
    """Once refused, now ported: a same-degree shrink onto fewer workers
    lands at once (no session), with the pool at the retained width's
    allocation; what is still refused is moving a slot off an engine
    at TP > 1 (export and import assert TP1)."""
    cfg = _cfg()
    cl = ClusterEngine(cfg, ["cpu"] * 4, **KW)
    eng = cl.engines[0]
    home = list(eng.devices)
    assert eng.transform(1, devices=home[:1]) == 0
    assert not eng.transforming and eng.W == 1 and eng.tp == 1
    assert eng.max_seq_alloc == eng.seq_quantum
    assert eng.layers[0].mesh.workers == home[:1]
    assert eng.transform(1, devices=home) == 0 and eng.W == 2
    eng.check_capacity_invariant()
    # a slot moves at TP1 only: export and import assert it
    eng.transform(2)
    with pytest.raises(AssertionError):
        eng.export_active()
    sub = [KT.export_slot(l.cache[0], 0) for l in cl.engines[1].layers]
    with pytest.raises(AssertionError):
        eng.import_request(ServeRequest(prompt=[1]), sub)
