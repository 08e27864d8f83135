"""KV spill of a MoE engine in the port against the JAX reference.

Reduced granite-moe-3b-a800m (every layer MOE, 4 experts, top-2,
``capacity_factor`` 8.0: no choice ever overflows), float32, weights from
``repro.models.model.init_params``.

A spilled request decodes batch-1 on its extended view (its local pages
and the host's) and prefills its chunks past the local ceiling the same
way.  Those extended calls route their own rows alone, as the
reference's spill path does: it has no MoE branch
(``repro/serving/engine.py``, ``_assemble_spilled`` and its callers).
The reference's spilled streams are no target, because its spill data
plane writes decode filler over spilled KV (ROADMAP queue 3), so:

* every extended call's routing (each token's experts, its buffer
  positions and which choices are kept) EQUALS the reference's
  ``apply_moe_mlp`` on the same rows, on one engine and on a worker
  engine of a cluster;
* the spilled stream equals an unspilled port engine's that holds the
  whole request;
* a ``ClusterEngine`` of two one-worker instances under
  ``SchedulerConfig(spill=True)`` takes the JAX cluster's actions (one
  ``Spill``) and placements, and the requests that did not spill give
  its streams.  The JAX cluster runs in a subprocess with 2 fake host
  devices, started when the module's first test starts.
"""
import dataclasses
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.padding import make_plan as jplan
from repro.models import blocks as JB
from repro.models import model as JM
from repro_torch.configs import get_config as tget
from repro_torch.core.padding import make_plan as tplan
from repro_torch.core.scheduler import GygesScheduler, SchedulerConfig, Spill
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import start

NAME = "granite-moe-3b-a800m"
KW = dict(n_instances=2, max_batch=4, max_seq=64, page_tokens=16,
          dwell_steps=4)
SCHED = dict(long_threshold=64, target_tp=2, spill=True, spill_slack=2.0)


def _trace():
    """Three short requests and one of 96 tokens (80 prompt, 16 new),
    above one instance's 64-token ceiling: it spills into the
    neighbour's free slot."""
    rng = np.random.default_rng(0)
    shorts = [(i, rng.integers(0, 512, size=5 + i).tolist(), 8)
              for i in range(3)]
    return shorts + [(99, rng.integers(0, 512, size=80).tolist(), 16)]


JAX_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.core.scheduler import GygesScheduler, SchedulerConfig
    from repro.models import model as M
    from repro.serving.cluster import ClusterEngine
    from repro.serving.request import ServeRequest

    cfg = dataclasses.replace(get_config(%(name)r).reduced(),
                              dtype="float32")
    params = M.init_params(jax.random.PRNGKey(11), cfg,
                           make_plan(cfg, 2, mode="page"))
    reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in %(trace)r]
    cl = ClusterEngine(cfg, jax.devices()[:2], params=params,
                       scheduler=GygesScheduler(SchedulerConfig(**%(sched)r)),
                       **%(kw)r)
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    out = {"params": jax.tree.map(np.asarray, params),
           "actions": [(type(a).__name__, a.iid,
                        getattr(a, "host_iid", None),
                        getattr(a, "tokens", None), a.reason)
                       for a in cl.actions],
           "placements": dict(cl.placements),
           "streams": {r.rid: r.generated for r in reqs},
           "spill_pages": cl.metrics()["spill_pages"]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module", autouse=True)
def _reference(tmp_path_factory):
    """The JAX cluster, started with the module's first test; tests that
    need it wait for it."""
    path = tmp_path_factory.mktemp("jax") / "moe_spill.pkl"
    body = textwrap.dedent(JAX_SCRIPT) % {"name": NAME, "trace": _trace(),
                                          "kw": KW, "sched": SCHED}
    ref = start(body, path, devices=2, timeout=120)
    result = {}

    def wait():
        if not result:
            ref.wait()
            with open(path, "rb") as f:
                result.update(pickle.load(f))
        return result

    yield wait
    ref.close()


@pytest.fixture(scope="module")
def reference(_reference):
    return _reference()


def _cfgs():
    return [dataclasses.replace(get(NAME).reduced(), dtype="float32")
            for get in (jget, tget)]


@pytest.fixture(scope="module")
def weights():
    """The reference's weights (PRNGKey 11, the JAX cluster's), built in
    this process so the port-only tests need not wait for it."""
    jc, _ = _cfgs()
    return jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(11), jc, jplan(jc, 2, mode="page")))


def _model(np_params, W):
    _, tc = _cfgs()
    plan = tplan(tc, W) if W == 1 else tplan(tc, W, mode="page")
    model = Model.empty(tc, plan, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tc, plan))
    return model


def _layer(np_params, li):
    return jax.tree.map(lambda a: a[li], np_params["blocks"][0])


def reference_routing(mlp, x, cfg, plan):
    """``topi`` from the reference's own ``jax.lax.top_k`` call inside
    ``apply_moe_mlp`` on rows x (T, d), and ``pos`` / ``keep`` from its
    cumsum formula on them (``repro/models/blocks.py:281-286``)."""
    seen = []
    top_k = jax.lax.top_k

    def spy(a, k):
        out = top_k(a, k)
        seen.append(out)
        return out

    jax.lax.top_k = spy
    try:
        JB.apply_moe_mlp(jax.tree.map(jnp.asarray, mlp),
                         jnp.asarray(x)[None], cfg, plan)
    finally:
        jax.lax.top_k = top_k
    topi = np.asarray(seen[-1][1])[0]
    T, k = topi.shape
    cap = max(1, int(T * k * cfg.moe.capacity_factor / plan.num_experts))
    flat = np.asarray(jax.nn.one_hot(topi, plan.experts_padded,
                                     dtype=jnp.int32)).reshape(T * k, -1)
    pos = ((np.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(T, k)
    return topi, pos, pos < cap


def _record_extended(mp, engines):
    """Every MoE call made inside an extended compute (between a spilled
    slot's ``_assemble_spilled`` and its ``spill_slot``): (layer index,
    the call's rows (T, d) as numpy, the port's routing of them)."""
    state = {"ext": False}
    calls = []
    assemble, spill = Engine._assemble_spilled, Engine.spill_slot

    def assemble_spy(self, slot):
        state["ext"] = True
        return assemble(self, slot)

    def spill_spy(self, slot, ext):
        state["ext"] = False
        return spill(self, slot, ext)

    def route(router, x, cfg, plan, li):
        topv, topi = B.moe_route(router, x, cfg, plan)
        cap = B.moe_capacity(x.shape[0], cfg)
        pos, keep = B.moe_positions(topi, plan.experts_padded, cap)
        calls.append((li, x.numpy().copy(), topi.numpy(), pos.numpy(),
                      keep.numpy()))

    apply_moe = B.apply_moe_mlp
    workers = M.moe_workers

    def apply_spy(p, x, cfg, plan):
        if state["ext"]:
            li = next(i for e in engines if e.model is not None
                      for i, blk in enumerate(e.model.layers)
                      if blk.mlp is p)
            route(p["router"], x.reshape(-1, x.shape[-1]), cfg, plan, li)
        return apply_moe(p, x, cfg, plan)

    def workers_spy(layer, hs, cfg, plan, tp, ff):
        if state["ext"]:
            li = next(i for e in engines for i, l in enumerate(e.layers)
                      if l is layer)
            rows = [h for h in hs if h is not None]
            assert len(rows) == 1, "an extended call is one slot's rows"
            route(layer.mlp[hs.index(rows[0])]["router"],
                  rows[0].reshape(-1, rows[0].shape[-1]), cfg, plan, li)
        return workers(layer, hs, cfg, plan, tp, ff)

    mp.setattr(Engine, "_assemble_spilled", assemble_spy)
    mp.setattr(Engine, "spill_slot", spill_spy)
    mp.setattr(B, "apply_moe_mlp", apply_spy)
    mp.setattr(M, "moe_workers", workers_spy)
    return calls


def _check_routing(calls, np_params, spilled_steps):
    jc, _ = _cfgs()
    plan = jplan(jc, 1)
    layers = jc.num_layers
    # the chunk past the local ceiling and every decode on the extended
    # view, each through every layer
    assert len(calls) == layers * spilled_steps, len(calls)
    for li, x, topi, pos, keep in calls:
        want = reference_routing(_layer(np_params, li)["mlp"], x, jc, plan)
        for got, ref in zip((topi, pos, keep), want):
            assert np.array_equal(got, ref), li
        assert keep.all()            # capacity 8.0 drops nothing


def _reqs():
    return [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in _trace()]


def _alone(model, devices=None):
    """The long request alone on an engine whose pool holds it whole."""
    _, tc = _cfgs()
    kw = dict(device="cpu") if devices is None else dict(
        devices=devices, plan=tplan(tc, 2, mode="page"))
    eng = Engine(tc, params=model, max_batch=4, max_seq=128,
                 page_tokens=16, **kw)
    r, p, n = _trace()[3]
    req = ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
    eng.submit(req)
    eng.run_until_done(2000)
    return req.generated


def test_one_engine_spill_routes_each_call_alone(weights):
    """A single-device guest spills into a single-device host: each
    extended call routes its rows as the reference routes them, and the
    stream is the whole engine's."""
    _, tc = _cfgs()
    model = _model(weights, 1)
    guest = Engine(tc, params=model, device="cpu", max_batch=4, max_seq=64,
                   page_tokens=16, iid=0)
    host = Engine(tc, params=model, device="cpu", max_batch=4, max_seq=64,
                  page_tokens=16, iid=1)
    r, p, n = _trace()[3]
    req = ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
    hosting = host.host_spilled(-(-(len(p) + n - 64) // 16))
    assert hosting is not None
    mp = pytest.MonkeyPatch()
    calls = _record_extended(mp, [guest, host])
    try:
        guest.admit_spilled(req, host, hosting)
        guest.run_until_done(2000)
    finally:
        mp.undo()
    assert len(req.generated) == n
    _check_routing(calls, weights, 1 + (n - 1))
    assert guest.spill_log and all(x["pages"] > 0 for x in guest.spill_log)
    assert req.generated == _alone(model)


@pytest.fixture(scope="module")
def ported(weights):
    model = _model(weights, 2)
    _, tc = _cfgs()
    cl = ClusterEngine(tc, ["cpu"] * 2, params=model,
                       scheduler=GygesScheduler(SchedulerConfig(**SCHED)),
                       **KW)
    mp = pytest.MonkeyPatch()
    calls = _record_extended(mp, cl.engines)
    try:
        reqs = _reqs()
        for r in reqs[:3]:
            cl.submit(r)
        for _ in range(2):
            cl.step()
        cl.submit(reqs[3])
        regions = len(cl.partition.spills())
        cl.run(max_steps=5000)
    finally:
        mp.undo()
    return dict(cluster=cl, reqs=reqs, calls=calls, model=model,
                regions=regions)


def test_cluster_spill_routes_each_extended_call_as_reference(ported,
                                                              weights):
    reqs = ported["reqs"]
    _check_routing(ported["calls"], weights,
                   1 + (reqs[3].max_new_tokens - 1))


def test_spilled_stream_equals_an_unspilled_engine(ported):
    long_ = ported["reqs"][3]
    assert len(long_.generated) == long_.max_new_tokens
    assert long_.generated == _alone(ported["model"], ["cpu"])


def test_cluster_spill_actions_and_placements_equal_reference(ported,
                                                              reference):
    cl = ported["cluster"]
    acts = [(type(a).__name__, a.iid, getattr(a, "host_iid", None),
             getattr(a, "tokens", None), a.reason) for a in cl.actions]
    assert acts == reference["actions"]
    assert [a[0] for a in acts] == ["Spill"]
    assert isinstance(cl.actions[0], Spill)
    assert cl.placements == reference["placements"]
    assert cl.metrics()["spill_pages"] == reference["spill_pages"] > 0
    assert ported["regions"] == 1 and not cl.partition.spills()
    for r in ported["reqs"][:3]:
        assert r.generated == reference["streams"][r.rid], r.rid
    assert all(not e._spills and not e._hosted for e in cl.engines)
    cl.partition.check_invariants()
