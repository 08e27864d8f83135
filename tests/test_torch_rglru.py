"""recurrentgemma's RG-LRU blocks in the port against the JAX reference.

A hybrid config cut from recurrentgemma-9b: ``reduced()`` (d_model 256,
4 heads, MQA, window 64) with 5 layers of the Griffin pattern
``(RGLRU, RGLRU, SLIDING)``, one group and a 2-layer remainder, float32
(``reduced()`` alone keeps only ``(RGLRU, RGLRU)``).  Weights come from
the reference's ``init_params`` through ``params_from_jax``.

* The layers (``rglru``, ``rglru_step``, ``causal_conv1d``) with and
  without a carry: within ``TOL_LAYER`` (1e-5) of the reference's.
* The blocked scan: a sequence split at block boundaries, each part
  carrying the state of the one before, gives the bits of the whole
  sequence; so do the model's chunked and whole-prompt prefills.
* The model: prefill and decode logits within ``TOL`` (1e-4) of the
  reference's, greedy streams equal.
* A single engine (whole prompts, and budgeted chunks with decodes
  interleaved and more requests than slots), a two-worker engine
  changed live TP1x2 -> TP2 -> TP1x2 mid-decode and mid-chunked-prefill,
  and a ``ClusterEngine`` merge and split whose donor is mid-prefill
  (3 layers, one group): streams (and the cluster's actions and
  placements) equal the JAX engines' and cluster's, run in three
  subprocesses with 2 fake host devices, started when the module's
  first test starts.
* A whole prompt longer than the window gives the chunked prompt's
  ring, logits and stream.
* A migration leaves the ring pools bit-equal to ``split_cache`` of the
  global cache and the recurrent state rows equal.
* A prefilling slot's state is restored over the batched decode's
  filler: without the restore, the stream departs.
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
from repro.configs.base import RGLRU as JRGLRU
from repro.configs.base import SLIDING as JSLIDING
from repro.core.padding import make_plan as jplan
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import RGLRU, SLIDING
from repro_torch.core import instance as I
from repro_torch.core import transform_engine as TE
from repro_torch.core.padding import make_plan as tplan
from repro_torch.core.scheduler import PrefillPolicy
from repro_torch.launch.mesh import Layout
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.paged.recurrent import RecState
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import QUICK_COMPILES, start

TOL = 1e-4          # whole-model logits (the frameworks sum in other orders)
TOL_LAYER = 1e-5    # one layer's output
NAME = "recurrentgemma-9b"
PATTERN = ("rglru", "rglru", "sliding")
EKW = dict(max_batch=2, max_seq=128, page_tokens=16)
CKW = dict(n_instances=2, max_batch=4, max_seq=64, page_tokens=16,
           dwell_steps=4)
# the cluster's model: one group of the pattern (its reference run
# compiles most, so it takes the fewest layers)
CLUSTER_LAYERS = 3
BUDGET = dict(token_budget=16, mode="mixed")
# whole 16-token pages but one prompt (a tail of 8): the reference
# engines compile a program for every chunk and prompt shape
ENGINE_LENS = (16, 64, 40, 48, 32)
# prompts longer than the 64-token window: their whole-prompt prefill
# keeps each kept key at ring slot p % 64, where chunks put it (the
# reference's whole prefill rolls them the other way: ROADMAP queue 3)
LONG_LENS = (96, 80)
NEW = 6


def _cfg(get, layers=5):
    return dataclasses.replace(get(NAME).reduced(), num_layers=layers,
                               layer_pattern=PATTERN, dtype="float32")


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=n).tolist() for n in lens]


def _cluster_trace():
    """(rid, prompt, max_new): two 48-token prompts that prefill in
    16-token chunks, a short one, and the merge trigger (80 tokens,
    above one instance's 64): the donor is mid-prefill when it parks."""
    rng = np.random.default_rng(1)
    return [(0, rng.integers(0, 512, size=48).tolist(), 6),
            (1, rng.integers(0, 512, size=48).tolist(), 6),
            (2, rng.integers(0, 512, size=16).tolist(), 6),
            (99, rng.integers(0, 512, size=80).tolist(), 8)]


COMMON = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.core.scheduler import PrefillPolicy
    from repro.models import model as M
    from repro.serving.request import ServeRequest

    cfg = dataclasses.replace(get_config(%(name)r).reduced(),
                              num_layers=%(layers)d,
                              layer_pattern=%(pattern)r, dtype="float32")
    params = M.init_params(jax.random.PRNGKey(11), cfg,
                           make_plan(cfg, 2, mode="page"))
"""

SERVE = """
    from repro.serving.engine import Engine

    def serve(eng, before=0, transform=None, prompts=%(prompts)r):
        reqs = [ServeRequest(rid=i, prompt=list(p), max_new_tokens=%(new)d)
                for i, p in enumerate(prompts)]
        if transform:
            eng.transform(transform)
            while eng.transforming:
                eng.step()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return [r.generated for r in reqs]

    policy = PrefillPolicy(**%(budget)r)
    out = {}
"""

# one device: whole prompts, chunks, and prompts longer than the window
SINGLE_SCRIPT = COMMON + SERVE + """
    out["params"] = jax.tree.map(np.asarray, params)
    out["whole"] = serve(Engine(cfg, params=params, **%(ekw)r))
    out["chunked"] = serve(Engine(cfg, params=params, prefill_policy=policy,
                                  **%(ekw)r))
    out["long"] = serve(Engine(cfg, params=params, prefill_policy=policy,
                               **%(ekw)r), prompts=%(long)r)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""

# two workers, started at TP1x2 and at TP2
WORKERS_SCRIPT = COMMON + SERVE + """
    two = jax.devices()[:2]
    for name, tp in (("tp1", None), ("tp2", 2)):
        out[name] = serve(Engine(cfg, params=params, devices=two,
                                 prefill_policy=policy, **%(ekw)r),
                          transform=tp)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""

CLUSTER_SCRIPT = COMMON + """
    from repro.serving.cluster import ClusterEngine

    reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in %(trace)r]
    out = {"params": jax.tree.map(np.asarray, params)}
    cl = ClusterEngine(cfg, jax.devices()[:2], params=params,
                       prefill_policy=PrefillPolicy(**%(budget)r),
                       **%(ckw)r)
    for r in reqs[:3]:
        cl.submit(r)
    cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    out.update(actions=[(type(a).__name__, a.iid, a.tp_to,
                         tuple(getattr(a, "donor_iids", ())), a.reason)
                        for a in cl.actions],
               placements=dict(cl.placements),
               streams={r.rid: r.generated for r in reqs},
               tps=[e.tp for e in cl.engines])
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


def _start(tmp_path_factory, name, script, **fill):
    path = tmp_path_factory.mktemp("jax") / f"{name}.pkl"
    body = textwrap.dedent(script) % dict(name=NAME, pattern=PATTERN,
                                          budget=BUDGET, **fill)
    # the reference engines run most ops eagerly, each a small XLA
    # compile: unoptimised compiles halve their time
    ref = start(body, path, devices=2, timeout=300,
                xla_flags=QUICK_COMPILES)
    result = {}

    def wait():
        if not result:
            ref.wait()
            with open(path, "rb") as f:
                result.update(pickle.load(f))
        return result

    return ref, wait


@pytest.fixture(scope="module", autouse=True)
def _references(tmp_path_factory):
    """The three JAX runs, started when the module's first test
    starts."""
    fill = dict(prompts=_prompts(ENGINE_LENS), ekw=EKW, new=NEW,
                long=_prompts(LONG_LENS, seed=5), layers=5)
    procs = {
        "single": _start(tmp_path_factory, "single", SINGLE_SCRIPT, **fill),
        "workers": _start(tmp_path_factory, "workers", WORKERS_SCRIPT,
                          **fill),
        "cluster": _start(tmp_path_factory, "cluster", CLUSTER_SCRIPT,
                          trace=_cluster_trace(), ckw=CKW,
                          layers=CLUSTER_LAYERS),
    }
    yield {k: wait for k, (_, wait) in procs.items()}
    for ref, _ in procs.values():
        ref.close()


@pytest.fixture(scope="module")
def engine_ref(_references):
    return {**_references["single"](), **_references["workers"]()}


@pytest.fixture(scope="module")
def cluster_ref(_references):
    return _references["cluster"]()


@pytest.fixture(scope="module")
def pair():
    """(reference config, plan, numpy params, port config, model) with
    weights of their own (PRNGKey 0), for the in-process checks."""
    jc, tc = _cfg(jget), _cfg(tget)
    jp = jplan(jc, 1)
    params = JM.init_params(jax.random.PRNGKey(0), jc, jp)
    return jc, jp, params, tc, _model(jax.tree.map(np.asarray, params), tc)


def _model(np_params, tc, W=1):
    plan = tplan(tc, W) if W == 1 else tplan(tc, W, mode="page")
    model = Model.empty(tc, plan, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tc, plan))
    return model


# ---------------------------------------------------------------------------
# layers and the scan

def _arrays(seed, B_=2, S=40, D=24):
    rng = np.random.default_rng(seed)
    x, gx, ga = (rng.standard_normal((B_, S, D)).astype(np.float32)
                 for _ in range(3))
    a = np.linspace(0.5, 2.0, D).astype(np.float32)
    h0 = rng.standard_normal((B_, D)).astype(np.float32)
    conv_w = (rng.standard_normal((4, D)) / 2).astype(np.float32)
    conv_b = rng.standard_normal(D).astype(np.float32)
    state = rng.standard_normal((B_, 3, D)).astype(np.float32)
    return x, gx, ga, a, h0, conv_w, conv_b, state


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("block", [8, 16])
def test_rglru_layers_match_reference(carry, block):
    x, gx, ga, a, h0, cw, cb, st = _arrays(0)
    h = h0 if carry else None
    jy, jh = JL.rglru(*(jnp.asarray(v) for v in (x, gx, ga, a)),
                      None if h is None else jnp.asarray(h))
    ty, th = L.rglru(*_t(x, gx, ga, a), None if h is None else _t(h)[0],
                     block=block)
    assert np.abs(np.asarray(jy) - ty.numpy()).max() < TOL_LAYER
    assert np.abs(np.asarray(jh) - th.numpy()).max() < TOL_LAYER
    jy, jh = JL.rglru_step(*(jnp.asarray(v[:, 0]) for v in (x, gx, ga)),
                           jnp.asarray(a), jnp.asarray(h0))
    ty, th = L.rglru_step(*_t(x[:, 0], gx[:, 0], ga[:, 0], a, h0))
    assert np.abs(np.asarray(jy) - ty.numpy()).max() < TOL_LAYER
    assert np.abs(np.asarray(jh) - th.numpy()).max() < TOL_LAYER
    s = st if carry else None
    jy, js = JL.causal_conv1d(*(jnp.asarray(v) for v in (x, cw, cb)),
                              None if s is None else jnp.asarray(s))
    ty, ts = L.causal_conv1d(*_t(x, cw, cb), None if s is None
                             else _t(s)[0])
    assert np.abs(np.asarray(jy) - ty.numpy()).max() < TOL_LAYER
    assert np.array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("cuts", [(16,), (8, 24), (32,)])
def test_blocked_scan_chunked_equals_whole_bit_for_bit(cuts):
    """Each part a tensor of its own, as an engine's chunk is, and rows a
    multiple of 16 wide: the CPU's vectorised exp and sigmoid round a
    vector body and a scalar tail differently, so the elementwise
    coefficients are the same bits only where both calls vectorise the
    same elements (on the card every element takes one path)."""
    x, gx, ga, a, h0, *_ = _arrays(1, S=45, D=64)
    xs, gxs, gas, at = _t(x, gx, ga, a)
    whole, last = L.rglru(xs, gxs, gas, at, block=8)
    parts, h = [], None
    for lo, hi in zip((0,) + cuts, cuts + (45,)):
        y, h = L.rglru(xs[:, lo:hi].clone(), gxs[:, lo:hi].clone(),
                       gas[:, lo:hi].clone(), at, h0=h, block=8)
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=1), whole)
    assert torch.equal(h, last)


def test_model_logits_and_greedy_stream_match_reference(pair):
    jc, jp, params, tc, model = pair
    toks = np.random.default_rng(2).integers(0, 512, size=(2, 37))
    prefill = jax.jit(JM.prefill, static_argnums=(1, 2))
    decode = jax.jit(JM.decode_step, static_argnums=(1, 2))
    jcache = JM.init_decode_caches(jc, jp, 2, 128, 16)
    jl, jcache = prefill(params, jc, jp, {"tokens": jnp.asarray(toks)},
                         jcache)
    caches = model.init_decode_caches(2, 128, 16)
    with torch.no_grad():
        tl = model.prefill(torch.from_numpy(toks), caches)
    assert np.abs(np.asarray(jl) - tl.numpy()).max() < TOL
    jt = np.asarray(jl)[:, -1].argmax(-1)
    tt = tl[:, -1].argmax(-1).numpy()
    assert np.array_equal(jt, tt)
    for step in range(6):
        pos = np.full((2,), 37 + step, np.int32)
        jl, jcache = decode(params, jc, jp, jcache, jnp.asarray(jt),
                               jnp.asarray(pos))
        with torch.no_grad():
            tl = model.decode_step(caches, torch.from_numpy(tt),
                                   torch.from_numpy(pos))
        assert np.abs(np.asarray(jl) - tl.numpy()).max() < TOL, step
        jt, tt = np.asarray(jl).argmax(-1), tl.argmax(-1).numpy()
        assert np.array_equal(jt, tt), step
    # the recurrent state rows, as the reference's cache holds them
    rec = [c for c in caches if isinstance(c, RecState)]
    jrec = [jax.tree.map(lambda a: np.asarray(a)[g], jcache["groups"][i])
            for g in range(1) for i in range(2)] + jcache["rem"]
    for t, j in zip(rec, jrec):
        assert np.abs(t.h.numpy() - np.asarray(j["h"])).max() < TOL
        assert np.abs(t.conv.numpy() - np.asarray(j["conv"])).max() < TOL


def test_model_chunked_prefill_equals_whole_bit_for_bit(pair):
    *_, tc, model = pair
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 512, size=(1, 62)))
    whole = model.init_decode_caches(1, 128, 16)
    chunked = model.init_decode_caches(1, 128, 16)
    with torch.no_grad():
        lw = model.prefill(toks, whole)
        for s in range(0, 62, 32):
            lc = model.prefill_chunk(toks[:, s:s + 32], torch.tensor([s]),
                                     chunked, first_chunk=s == 0)
    assert torch.equal(lw, lc)
    for w, c in zip(whole, chunked):
        if isinstance(w, RecState):
            assert torch.equal(w.h, c.h) and torch.equal(w.conv, c.conv)


def test_whole_prompt_longer_than_window_equals_chunked(pair,
                                                        engine_ref):
    """A 100-token prompt over the 64-token ring of the sliding layer:
    the whole prefill keeps positions 36..99, each at slot p % 64, the
    bytes of the chunked prefill; the decode after it appends at slot
    100 % 64 over the oldest key, and logits stay within ``TOL`` of the
    chunked run's.  Whole and chunked engines give the reference's
    chunked stream."""
    *_, tc, model = pair
    S = 100
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, size=(1, S)))
    whole = model.init_decode_caches(1, 128, 16)
    chunked = model.init_decode_caches(1, 128, 16)
    with torch.no_grad():
        lw = model.prefill(toks, whole)
        for s in range(0, S, 16):
            lc = model.prefill_chunk(toks[:, s:s + 16], torch.tensor([s]),
                                     chunked, first_chunk=s == 0)
        assert (lw - lc).abs().max() < TOL
        rings = [(w, c) for w, c in zip(whole, chunked)
                 if not isinstance(w, RecState)]
        assert rings and all(w.capacity == 64 for w, _ in rings)
        for w, c in rings:
            assert torch.equal(w.positions, c.positions)
            assert (w.positions % 64 == torch.arange(64)).all()
            assert torch.allclose(w.pool, c.pool, atol=TOL_LAYER, rtol=0)
        tok = lc[:, -1].argmax(-1)
        for step in range(4):
            pos = torch.tensor([S + step], dtype=torch.int32)
            lw = model.decode_step(whole, tok, pos)
            lc = model.decode_step(chunked, tok, pos)
            assert (lw - lc).abs().max() < TOL, step
            assert torch.equal(lw.argmax(-1), lc.argmax(-1)), step
            tok = lc.argmax(-1)
    emodel = _model(engine_ref["params"], tc)
    for kw in ({}, {"prefill_policy": _policy()}):
        got = _serve(Engine(tc, params=emodel, device="cpu", **EKW, **kw),
                     _reqs(LONG_LENS, seed=5))
        assert got == engine_ref["long"], kw


def test_rglru_is_ported_and_a_param_stays_fp32():
    B.check_kind("rglru")
    cfg = dataclasses.replace(_cfg(tget), dtype="bfloat16")
    model = Model.empty(cfg, tplan(cfg, 1), device="cpu")
    assert model.layers[0].rec.a_param.dtype == torch.float32
    assert model.layers[0].rec.w_in.dtype == torch.bfloat16
    B.check_kind("mlstm")
    B.check_kind("slstm")
    with pytest.raises(NotImplementedError, match="unknown kind"):
        B.check_kind("mamba")


# ---------------------------------------------------------------------------
# engines

def _reqs(lens=ENGINE_LENS, new=NEW, seed=0):
    return [ServeRequest(rid=i, prompt=list(p), max_new_tokens=new)
            for i, p in enumerate(_prompts(lens, seed))]


def _serve(eng, reqs, before=0, plan=(), during=None):
    for r in reqs:
        eng.submit(r)
    for _ in range(before):
        eng.step()
    for tp in plan:
        eng.transform(tp)
        while eng.transforming:
            if during is not None:
                during(eng)
            eng.step()
            eng.check_capacity_invariant()
    eng.run_until_done()
    return [r.generated for r in reqs]


def _policy():
    return PrefillPolicy(**BUDGET)


@pytest.mark.parametrize("scenario", ["whole", "chunked"])
def test_single_engine_streams_equal_reference(engine_ref, scenario):
    tc = _cfg(tget)
    model = _model(engine_ref["params"], tc)
    kw = {} if scenario == "whole" else {"prefill_policy": _policy()}
    got = _serve(Engine(tc, params=model, device="cpu", **EKW, **kw),
                 _reqs())
    assert got == engine_ref[scenario]
    # chunks on block (page) boundaries: the whole-prompt stream
    assert engine_ref["whole"] == engine_ref["chunked"]


def _workers(engine_ref, **kw):
    tc = _cfg(tget)
    model = _model(engine_ref["params"], tc, W=2)
    return Engine(tc, params=model, devices=["cpu"] * 2,
                  prefill_policy=_policy(), **{**EKW, **kw})


@pytest.mark.parametrize("before", [2, 9])
def test_live_tp_change_equals_engines_started_at_each_degree(engine_ref,
                                                              before):
    """TP1x2 -> TP2 -> TP1x2 while requests prefill (2 steps in, the
    64-token prompt is mid-chunk) and while they decode (9 steps in)."""
    want = engine_ref["tp1"]
    assert engine_ref["tp2"] == want
    states = []
    eng = _workers(engine_ref)
    got = _serve(eng, _reqs(), before=before, plan=(2, 1),
                 during=lambda e: states.append(
                     (e.tp_pending, bool(e._prefilling))))
    assert got == want and eng.tp == 1
    assert {t for t, _ in states} == {2, 1}
    if before == 2:
        assert any(p for t, p in states if t == 2), \
            "the change ran mid chunked prefill"
    kinds = {l.kind for l in eng.layers}
    assert kinds == {"rglru", "sliding"}
    reps = eng.transform_reports
    # the recurrent layers' state ops are priced as the reference prices
    # a layer without a pool: nothing
    rec_ops = [r for r in reps if all(
        o.component == "kv" and eng.layers[o.layer].kind == RGLRU
        for o in r.ops)]
    assert rec_ops and all(r.modeled_s == 0.0 and r.kv_bytes > 0
                           for r in rec_ops)


def test_migration_lands_split_cache_and_equal_state_rows(engine_ref):
    eng = _workers(engine_ref)
    for r in _reqs():
        eng.submit(r)
    for _ in range(6):
        eng.step()
    before = eng.global_caches()
    for tp in (2, 1):
        eng.transform(tp)
        while not eng._session.done:
            eng._session.step()
        eng._finish_transform()
        lay = Layout(1, tp)
        for layer, g in zip(eng.layers, before):
            want = I.split_cache(g, lay, layer.mesh.devices)
            for got, w in zip(layer.cache, want):
                if isinstance(got, RecState):
                    assert torch.equal(got.h, w.h)
                    assert torch.equal(got.conv, w.conv)
                else:
                    for f in ("pool", "seq_lens", "positions"):
                        assert torch.equal(getattr(got, f),
                                           getattr(w, f)), f
    assert eng.tp == 1


def test_recurrent_weights_follow_the_reference_spec(engine_ref):
    """At TP2 worker p holds columns [p*d, (p+1)*d) of ``w_in`` (the x
    branch on one worker, the y branch on the other) and rows [p*d/2,
    (p+1)*d/2) of ``w_out``; the rest is replicated."""
    eng = _workers(engine_ref)
    full = dict(eng.layers[0].attn[0])
    eng.transform(2)
    while eng.transforming:
        eng.step()
    d = _cfg(tget).d_model
    for p, shard in enumerate(eng.layers[0].attn):
        assert torch.equal(shard["w_in"], full["w_in"][:, p * d:(p + 1) * d])
        assert torch.equal(shard["w_out"],
                           full["w_out"][p * d // 2:(p + 1) * d // 2])
        for k in ("conv_w", "conv_b", "w_gx", "w_ga", "a_param"):
            assert torch.equal(shard[k], full[k])
            assert shard[k].data_ptr() != eng.layers[0].attn[1 - p][k] \
                .data_ptr()
    assert eng.layers[0].attn[0]["a_param"].dtype == torch.float32


def test_filler_does_not_advance_a_prefilling_slot(engine_ref, monkeypatch):
    """The carry restore is what keeps a prefilling slot's state: with it
    switched off the batched decode's filler advances the state between
    chunks and the stream departs."""
    tc = _cfg(tget)
    model = _model(engine_ref["params"], tc)

    def run():
        return _serve(Engine(tc, params=model, device="cpu",
                             prefill_policy=_policy(), **EKW), _reqs())

    assert run() == engine_ref["chunked"]
    monkeypatch.setattr(Engine, "_restore_carry",
                        lambda self, slot, prog: None)
    assert run() != engine_ref["chunked"]


def test_cluster_merge_and_split_with_donor_mid_prefill(cluster_ref):
    tc = _cfg(tget, CLUSTER_LAYERS)
    want = cluster_ref
    model = _model(cluster_ref["params"], tc, W=2)
    exports = []
    orig = Engine.export_active

    def spy(self):
        out = orig(self)
        exports.append([(r.rid, None if x is None else x["done"])
                        for r, _, x in out])
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(Engine, "export_active", spy)
    try:
        cl = ClusterEngine(tc, ["cpu"] * 2, params=model,
                           prefill_policy=_policy(), **CKW)
        reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
                for r, p, n in _cluster_trace()]
        for r in reqs[:3]:
            cl.submit(r)
        cl.step()
        cl.submit(reqs[3])
        cl.run(max_steps=5000)
    finally:
        mp.undo()
    acts = [(type(a).__name__, a.iid, a.tp_to,
             tuple(getattr(a, "donor_iids", ())), a.reason)
            for a in cl.actions]
    assert acts == want["actions"]
    assert [a[0] for a in acts] == ["ScaleUp", "ScaleDown"]
    assert cl.placements == want["placements"]
    assert {r.rid: r.generated for r in reqs} == want["streams"]
    assert [e.tp for e in cl.engines] == want["tps"] == [1, 1]
    # the donor parked with a request mid chunked prefill
    assert any(done for ex in exports for _, done in ex), exports


def test_transform_session_prices_the_mlp_as_the_reference(engine_ref):
    """A session's modeled seconds are the reference's ``schedule_cost``
    of the same schedule: the MLP ops' accounting, and nothing for the
    recurrent layers' state (no pool) while the sliding layers' KV ops
    carry their migration's."""
    from repro.core import transform_engine as JTE
    from repro.core import kv_transform as JKT
    eng = _workers(engine_ref)
    for r in _reqs():
        eng.submit(r)
    for _ in range(9):
        eng.step()
    eng.transform(2)
    while eng.transforming:
        eng.step()
    jc = _cfg(jget)
    sched = JTE.scale_up_schedule(jc.num_layers, 1, 1, 2)
    mlp_s = JWT_up(jc)
    got = [r.modeled_s for r in eng.transform_reports]
    mlp_steps = got[:jc.num_layers]
    assert all(abs(s - mlp_s) < 1e-15 for s in mlp_steps), (mlp_steps,
                                                            mlp_s)
    kv_steps = got[jc.num_layers:]
    # reversed traversal: layers 4, 3 (rglru), 2 (sliding), 1, 0 (rglru)
    kinds = [jc.pattern[i] for i in range(jc.num_layers - 1, -1, -1)]
    for kind, s in zip(kinds, kv_steps):
        assert (s == 0.0) == (kind == JRGLRU), (kind, s)
    assert len(sched.steps) == len(got)
    assert JKT.LinkModel().bandwidth == TE.KT.LinkModel().bandwidth


def JWT_up(jc):
    from repro.core import kv_transform as JKT
    from repro.core import weight_transform as JWT
    plan = jplan(jc, 2, mode="page")
    return JWT.account_scale_up(jc, plan, 2, "padded").time_s(
        JKT.LinkModel(), overlap=True)


def test_jax_configs_agree():
    jc, tc = _cfg(jget), _cfg(tget)
    assert jc.pattern == tc.pattern == ("rglru", "rglru", "sliding",
                                        "rglru", "rglru")
    assert JSLIDING == SLIDING and JRGLRU == RGLRU
