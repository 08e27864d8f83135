"""Elastic sequence parallelism in the port against the JAX reference —
the counterpart of ``tests/test_elastic_sp.py``.

* The plain partial walks (``layers.paged_partials`` /
  ``chunked_partials``, the kernels' plain versions) and the sharded
  forms of ``paged_decode_attention`` / ``chunked_attention`` against
  the reference's ``_paged_partials`` / ``_chunked_partials`` and its
  ``sp > 1`` forms, on ``test_elastic_sp.py``'s sweeps (2e-6, as
  there); the port's shard pipeline (partial entry a shard, then the
  combine) against the dense oracle.
* The chunk scatter split over shards lands the bytes of the sp = 1
  scatter.
* ``migrate_sharded`` between ``(rep, sp, tp)`` layouts lands the pools
  ``split_cache`` gives, gathering exactly the bytes and segments
  ``layout_migration_stats`` accounts.
* A port engine on four CPU workers runs the reference's live round
  trip (reduced llama3-8b, float32, ``init_params(PRNGKey(11))``):
  TP4 -> SP2xTP2 -> TP4 and TP2x2 -> SP2xTP2 -> TP2x2 mid-decode, SP4xTP1,
  and a chunked prefill at SP2xTP2 whose chunk straddles the shard
  boundary; its streams equal the JAX engines' and its
  ``transform_log`` holds the two layout changes.  After a cycle with
  no decode between its steps every worker's cache is ``split_cache``'s.
* A ``ClusterEngine`` under ``SchedulerConfig(layouts=True)`` (2
  instances x 1 worker): the merged TP2 engine holding the long request
  moves to SP2xTP1; its actions, placements and streams equal the JAX
  cluster's.

The two JAX runs (the engines with 4 fake host devices, the cluster
with 2) start together in subprocesses of their own when the module's
first test starts.
"""
import dataclasses
import pickle
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.core import instance as I
from repro_torch.core import kv_transform as KT
from repro_torch.core.padding import make_plan
from repro_torch.core.scheduler import (GygesScheduler, PrefillPolicy,
                                        SchedulerConfig)
from repro_torch.kernels import chunk_prefill as CP
from repro_torch.kernels import page_migrate as PM
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref as KR
from repro_torch.launch.mesh import InstanceMesh, Layout
from repro_torch.models import layers as Lyr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.paged import pool as pp
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import start

TOL = dict(rtol=2e-6, atol=2e-6)

#: test_elastic_sp.py's sweeps: B, Hq, kvs, P, n, dh, sp and B, S, Hq,
#: Hkv, dh, sp
PAGED_SWEEP = [(2, 8, 4, 8, 4, 64, 2), (1, 4, 2, 16, 8, 32, 4),
               (3, 8, 8, 8, 6, 64, 2), (1, 2, 1, 16, 4, 128, 2)]
CHUNK_SWEEP = [(2, 48, 8, 4, 64, 2), (1, 37, 4, 2, 32, 3),
               (2, 64, 8, 8, 64, 4)]

ENGINE_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.core.scheduler import PrefillPolicy
    from repro.launch.mesh import Layout
    from repro.models import model as M
    from repro.serving.engine import Engine
    from repro.serving.request import ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    devs = jax.devices()[:4]
    plan = make_plan(cfg, 4, mode="page")
    params = M.init_params(jax.random.PRNGKey(11), cfg, plan)
    out = {"params": jax.tree.map(np.asarray, params)}
    for name, plan_ in %(plans)r.items():
        policy = (None if plan_["budget"] is None else
                  PrefillPolicy(token_budget=plan_["budget"], mode="mixed"))
        e = Engine(cfg, params=params, max_batch=4, max_seq=64,
                   page_tokens=plan_["page"], devices=devs, plan=plan,
                   prefill_policy=policy)
        reqs = [ServeRequest(rid=i, prompt=list(p), max_new_tokens=n)
                for i, (p, n) in enumerate(plan_["reqs"])]
        def goto(stage):
            tp, lay = stage
            e.transform(tp, layout=None if lay is None else Layout(*lay))
            while e.transforming:
                e.step()
        try:
            for stage in plan_["start"]:
                goto(stage)
            for r in reqs:
                e.submit(r)
            for stage, before in plan_["live"]:
                for _ in range(before):
                    e.step()
                goto(stage)
            e.run_until_done(1000)
        except Exception as err:
            out[name] = {"error": repr(err)}
            continue
        out[name] = {"streams": [r.generated for r in reqs],
                     "layout": str(e.par_layout),
                     "log": [(r["tp_from"], r["tp_to"], r["layout_from"],
                              r["layout_to"]) for r in e.transform_log]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""

CLUSTER_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.core.scheduler import GygesScheduler, SchedulerConfig
    from repro.models import model as M
    from repro.serving.cluster import ClusterEngine
    from repro.serving.request import ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    params = M.init_params(jax.random.PRNGKey(11), cfg,
                           make_plan(cfg, 2, mode="page"))
    reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in %(trace)r]
    sched = GygesScheduler(SchedulerConfig(**%(sched)r))
    cl = ClusterEngine(cfg, jax.devices()[:2], params=params,
                       scheduler=sched, **%(kw)r)
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    out = {"params": jax.tree.map(np.asarray, params),
           "actions": [(type(a).__name__, a.iid, a.tp_to,
                        tuple(getattr(a, "donor_iids", ())),
                        str(getattr(a, "layout", None)), a.reason)
                       for a in cl.actions],
           "placements": dict(cl.placements),
           "streams": {r.rid: r.generated for r in reqs},
           "tps": [e.tp for e in cl.engines]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


def _prompts():
    return [(list(range(5 + i, 21 + i)), 32) for i in range(3)]


#: the engines both sides run: (start stages, live (stage, steps before
#: it) pairs, requests, page tokens, prefill token budget); a stage is
#: (degree, (sp, tp) or None for pure TP)
PLANS = {
    "tp4": {"start": [(4, None)], "live": [], "reqs": _prompts(),
            "page": 16, "budget": None},
    "sp2tp2": {"start": [(4, (2, 2))], "live": [], "reqs": _prompts(),
               "page": 16, "budget": None},
    "round_trip": {"start": [(4, None)],
                   "live": [((4, (2, 2)), 4), ((4, (1, 4)), 3)],
                   "reqs": _prompts(), "page": 16, "budget": None},
    "tp2x2_cycle": {"start": [(2, None)],
                    "live": [((4, (2, 2)), 4), ((2, None), 3)],
                    "reqs": _prompts(), "page": 16, "budget": None},
    "sp4tp1": {"start": [(4, (4, 1))], "live": [], "reqs": _prompts(),
               "page": 16, "budget": None},
    # 8-token pages, a 24-token budget: a 40-token prompt prefills in
    # chunks 0-23 and 24-39, the second straddling the shards' boundary
    # at 32 (4 pages of 8 each)
    "sp_chunks": {"start": [(4, (2, 2))], "live": [],
                  "reqs": [(list(range(3, 43)), 12),
                           (list(range(9, 29)), 12)],
                  "page": 8, "budget": 24},
}

CLUSTER_KW = dict(n_instances=2, max_batch=4, max_seq=64, page_tokens=16,
                  dwell_steps=4)
CLUSTER_SCHED = dict(long_threshold=64, target_tp=1, page_tokens=16,
                     layouts=True)


def _trace():
    """test_torch_cluster.py's trace: three shorts and a 96-token request
    only the merged engine holds."""
    rng = np.random.default_rng(0)
    shorts = [(i, rng.integers(0, 512, size=5 + i).tolist(), 8)
              for i in range(3)]
    return shorts + [(99, rng.integers(0, 512, size=80).tolist(), 16)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Both JAX runs, started together with the module's first test;
    ``reference(name)`` waits for one."""
    tmp = tmp_path_factory.mktemp("jax")
    runs = {"engines": (4, textwrap.dedent(ENGINE_SCRIPT)
                        % {"plans": PLANS}),
            "cluster": (2, textwrap.dedent(CLUSTER_SCRIPT)
                        % {"trace": _trace(), "kw": CLUSTER_KW,
                           "sched": CLUSTER_SCHED})}
    refs = {name: start(body, tmp / name, devices=ndev, timeout=300)
            for name, (ndev, body) in runs.items()}

    def wait(name):
        refs[name].wait()
        with open(tmp / name, "rb") as f:
            return pickle.load(f)

    yield wait
    for ref in refs.values():
        ref.close()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    """Start the JAX runs before the first test of the module."""


def _cfg():
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32")


# ---------------------------------------------------------------------------
# plain partial walks against the reference
# ---------------------------------------------------------------------------

def _paged_case(B, Hq, kvs, P, n, dh, sp):
    rng = np.random.default_rng(hash((B, Hq, kvs, P, n, dh, sp)) % 2 ** 32)
    NP = B * n
    q = rng.normal(size=(B, Hq, dh)).astype(np.float32)
    pool = rng.normal(size=(NP, kvs, 2, P, dh)).astype(np.float32)
    pt = rng.permutation(NP).reshape(B, n).astype(np.int32)
    sl = rng.integers(1, n * P + 1, size=(B,)).astype(np.int32)
    pos = np.arange(n * P)[None, :]
    kv_pos = np.where(pos < sl[:, None], pos, -1).astype(np.int32)
    return q, pool, pt, sl, kv_pos


@pytest.mark.parametrize("B,Hq,kvs,P,n,dh,sp", PAGED_SWEEP)
def test_paged_partials_equal_reference(B, Hq, kvs, P, n, dh, sp):
    """Each shard's plain partial walk equals the reference's
    ``_paged_partials`` of its page slice, the sharded decode equals the
    reference's ``sp`` form, and the shard pipeline (partial entry a
    shard into its row, then the combine) equals the dense oracle."""
    q, pool, pt, sl, kv_pos = _paged_case(B, Hq, kvs, P, n, dh, sp)
    rep, ns = Hq // kvs, n // sp
    pages = pool[pt]
    want = np.asarray(JR.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pt),
        jnp.asarray(sl)))
    got = Lyr.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pages),
        torch.from_numpy(kv_pos), torch.from_numpy(sl - 1), sp=sp)
    jsp = JL.paged_decode_attention(jnp.asarray(q), jnp.asarray(pages),
                                    jnp.asarray(kv_pos),
                                    jnp.asarray(sl - 1), sp=sp)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsp), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    qg = jnp.asarray(q).reshape(B, kvs, rep, dh) * (1.0 / np.sqrt(dh))
    buf = torch.empty((sp, KR.partials_numel(B, kvs, 1, rep, dh)))
    for s in range(sp):
        cols = slice(s * ns, (s + 1) * ns)
        pcols = slice(s * ns * P, (s + 1) * ns * P)
        jm, jl, jacc = JL._paged_partials(
            qg, jnp.asarray(pages[:, cols]),
            jnp.asarray(kv_pos[:, pcols].reshape(B, ns, P)),
            jnp.asarray(sl - 1), 0)
        m, l, acc = KR.paged_decode_partials_ref(
            torch.from_numpy(q), torch.from_numpy(pool),
            torch.from_numpy(np.ascontiguousarray(pt[:, cols])),
            torch.from_numpy(np.ascontiguousarray(kv_pos[:, pcols])),
            torch.from_numpy(sl - 1))
        for x, y in ((m, jm), (l, jl), (acc, jacc)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)
        assert PA.paged_decode_partials(
            torch.from_numpy(q), torch.from_numpy(pool),
            torch.from_numpy(np.ascontiguousarray(pt[:, cols])),
            torch.from_numpy(np.ascontiguousarray(kv_pos[:, pcols])),
            torch.from_numpy(sl - 1), buf[s], shard=(s, sp)) == 1
    out = PA.softmax_combine(buf, B, kvs, 1, rep, dh, torch.float32)
    np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,sp", CHUNK_SWEEP)
def test_chunked_partials_equal_reference(B, S, Hq, Hkv, dh, sp):
    """The sharded chunked attention equals the reference's ``sp`` form
    and the dense causal oracle; the partial walk of each key slice
    equals the reference's ``_chunked_partials``."""
    rng = np.random.default_rng(hash((B, S, Hq, Hkv, dh, sp)) % 2 ** 32)
    q, k, v = (rng.normal(size=(B, S, h, dh)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    posn = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    want = np.asarray(JR.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    jsp = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(posn),
                               jnp.asarray(posn), kv_chunk=16, sp=sp)
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (q, k, v, posn)]
    got = Lyr.chunked_attention(t[0], t[1], t[2], t[3], t[3], kv_chunk=16,
                                sp=sp)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsp), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rep, cut = Hq // Hkv, -(-S // sp)
    qs = q.reshape(B, S, Hkv, rep, dh) * np.float32(1.0 / np.sqrt(dh))
    qg = qs.transpose(0, 2, 3, 1, 4)
    for lo in range(0, S, cut):
        sl = slice(lo, min(S, lo + cut))
        valid = np.ones((B, sl.stop - lo), bool)
        jm, jl, jacc = JL._chunked_partials(
            jnp.asarray(qs),
            jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(posn), jnp.asarray(posn[:, sl]),
            jnp.asarray(valid), True, 0, 16)
        m, l, acc = Lyr.chunked_partials(
            torch.from_numpy(np.ascontiguousarray(qg)),
            t[1][:, sl], t[2][:, sl], t[3], t[3][:, sl],
            torch.from_numpy(valid), True, 0, 16)
        for x, y in ((m, jm), (l, jl), (acc, jacc)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL)


def _shard(state, s, sp):
    """Shard s of sp of a batch of identity-paged rows (``split_cache``'s
    page slice, tp 1)."""
    return I.split_cache(state, Layout(sp, 1), ["cpu"] * sp)[s]


#: B, P, pages a slot, chunk start, chunk tokens, sp: a chunk inside
#: shard 1, one straddling the boundary, a first chunk, and three shards
CHUNK_CASES = [(2, 8, 8, 40, 8, 2), (1, 8, 8, 24, 16, 2),
               (2, 4, 8, 0, 12, 2), (1, 4, 6, 10, 7, 3)]


@pytest.mark.parametrize("B,P,n,start,S,sp", CHUNK_CASES)
def test_sharded_chunk_equals_one_shard(B, P, n, start, S, sp):
    """A chunk's attention from its shards' partial entries (shard 0
    also attending the chunk's own keys) combined equals the sp = 1
    chunk attention, and the shards' scatters land the sp = 1 pool
    bytes and positions."""
    rng = np.random.default_rng(start + 7 * S)
    Hq, kvs, dh = 8, 4, 32
    rep = Hq // kvs
    state = pp.make_state(B * n, kvs, P, dh, B, n, torch.float32,
                          device="cpu")
    state.pool.copy_(torch.from_numpy(
        rng.normal(size=tuple(state.pool.shape)).astype(np.float32)))
    state.positions[:, :start] = torch.arange(start, dtype=torch.int32)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, dh)).astype(
        np.float32)) for h in (Hq, kvs, kvs))
    qpos = (start + torch.arange(S, dtype=torch.int32))[None].expand(
        B, S).contiguous()
    shards = [_shard(state, s, sp) for s in range(sp)]
    one = pp.PagedState(state.pool.clone(), state.page_table,
                        state.seq_lens.clone(), state.positions.clone())
    want = CP.chunk_prefill_attention(q, k, v, one.pool, one.page_table,
                                      one.positions, qpos,
                                      attend_prefix=start > 0)
    pp.adopt_chunk_pool(one, qpos)
    if start == 0:
        outs = [CP.chunk_prefill_attention(
            q, k, v, c.pool, c.page_table, c.positions, qpos,
            attend_prefix=False, shard=(s, sp))
            for s, c in enumerate(shards)]
        for o in outs:
            torch.testing.assert_close(o, want, rtol=0, atol=0)
    else:
        buf = torch.empty((sp, KR.partials_numel(B * S, kvs, 1, rep, dh)))
        for s, c in enumerate(shards):
            CP.chunk_prefill_partials(q, k, v, c.pool, c.page_table,
                                      c.positions, qpos, buf[s],
                                      attend_self=s == 0, shard=(s, sp))
        out = PA.softmax_combine(buf, B * S, kvs, 1, rep, dh, torch.float32)
        torch.testing.assert_close(out.view(B, S, Hq, dh), want,
                                   rtol=2e-6, atol=2e-6)
    for s, c in enumerate(shards):
        pp.adopt_chunk_pool(c, qpos, (s, sp))
    joined = I.join_cache(shards, Layout(sp, 1))
    assert torch.equal(joined.pool, one.pool)
    assert torch.equal(joined.positions, one.positions)
    assert torch.equal(joined.seq_lens, one.seq_lens)


def test_sharded_append_and_prefill_write_own_pages():
    """``append_token`` and ``write_prefill`` on each shard land, joined,
    the bytes of the one-shard writes."""
    rng = np.random.default_rng(3)
    B, kvs, P, n, dh, sp = 3, 2, 4, 6, 8, 3
    one = pp.make_state(B * n, kvs, P, dh, B, n, torch.float32,
                        device="cpu")
    k, v = (torch.from_numpy(rng.normal(size=(B, 13, kvs, dh)).astype(
        np.float32)) for _ in range(2))
    shards = [_shard(one, s, sp) for s in range(sp)]
    pp.write_prefill(one, k, v)
    for s, c in enumerate(shards):
        pp.write_prefill(c, k, v, shard=(s, sp))
    for _ in range(5):          # crosses the boundary at 16 (n/sp pages)
        k1, v1 = (torch.from_numpy(rng.normal(size=(B, kvs, dh)).astype(
            np.float32)) for _ in range(2))
        pp.append_token(one, k1, v1)
        for s, c in enumerate(shards):
            pp.append_token(c, k1, v1, shard=(s, sp))
    joined = I.join_cache(shards, Layout(sp, 1))
    for a, b in ((joined.pool, one.pool), (joined.positions, one.positions),
                 (joined.seq_lens, one.seq_lens)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the sharded migration between layouts
# ---------------------------------------------------------------------------

MOVES = [((1, 4), (2, 2)), ((2, 2), (1, 4)), ((1, 2), (2, 2)),
         ((2, 2), (1, 2)), ((1, 4), (4, 1)), ((4, 1), (2, 2)),
         ((1, 1), (2, 1)), ((2, 1), (1, 4))]


@pytest.mark.parametrize("la,lb", MOVES,
                         ids=[f"{Layout(*a)}-{Layout(*b)}" for a, b in MOVES])
def test_migrate_between_layouts(la, lb, monkeypatch):
    """On four workers: the pools a migration lands equal
    ``split_cache`` at the target layout bit for bit, and the gather
    kernel packs exactly the bytes and segments
    ``layout_migration_stats`` counts off their workers."""
    la, lb = Layout(*la), Layout(*lb)
    W, B, mps, kvs, P, dh = 4, 4, 8, 4, 4, 8
    rng = np.random.default_rng(la.sp * 10 + lb.tp)
    g = pp.make_state(B * mps, kvs, P, dh, B, mps, torch.float32,
                      device="cpu")
    g.pool.copy_(torch.from_numpy(
        rng.normal(size=tuple(g.pool.shape)).astype(np.float32)))
    src = I.split_cache(g, la, ["cpu"] * W)
    gathered = []
    orig = PM.gather_page_slices

    def gather(pool, pages, hblocks, *, heads_per_slice):
        out = orig(pool, pages, hblocks, heads_per_slice=heads_per_slice)
        gathered.append((out.numel() * out.element_size(), pages.numel()))
        return out

    monkeypatch.setattr(PM, "gather_page_slices", gather)
    ma, mb = InstanceMesh(["cpu"] * W, la), InstanceMesh(["cpu"] * W, lb)
    pools, moved = KT.migrate_sharded([c.pool for c in src], ma, la, mb,
                                      lb, mps)
    want = I.split_cache(g, lb, ["cpu"] * W)
    for got, exp in zip(pools, want):
        assert torch.equal(got, exp.pool)
    stats = KT.layout_migration_stats(W, la, W, lb, B, mps, kvs, P, dh,
                                      dtype_bytes=4)
    assert sum(b for b, _ in gathered) == stats.bytes_moved
    assert sum(n for _, n in gathered) == stats.segments
    assert moved >= 4 * stats.bytes_moved


# ---------------------------------------------------------------------------
# the engine and the cluster against the JAX ones
# ---------------------------------------------------------------------------

def _model(params, ndev):
    cfg = _cfg()
    plan = make_plan(cfg, ndev, mode="page")
    model = Model.empty(cfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg, plan))
    return model


def _run_plan(model, p):
    policy = (None if p["budget"] is None
              else PrefillPolicy(token_budget=p["budget"], mode="mixed"))
    e = Engine(_cfg(), params=model, max_batch=4, max_seq=64,
               page_tokens=p["page"], devices=["cpu"] * 4,
               prefill_policy=policy)
    reqs = [ServeRequest(rid=i, prompt=list(pr), max_new_tokens=n)
            for i, (pr, n) in enumerate(p["reqs"])]

    def goto(stage):
        tp, lay = stage
        e.transform(tp, layout=None if lay is None else Layout(*lay))
        while e.transforming:
            e.step()
            e.check_capacity_invariant()

    for stage in p["start"]:
        goto(stage)
    for r in reqs:
        e.submit(r)
    for stage, before in p["live"]:
        for _ in range(before):
            e.step()
        assert all(r.slot is not None for r in reqs), "decode in flight"
        goto(stage)
    e.run_until_done(1000)
    return e, reqs


@pytest.fixture(scope="module")
def engines(reference):
    want = reference("engines")
    model = _model(want["params"], 4)
    return want, {name: _run_plan(model, p) for name, p in PLANS.items()}


@pytest.mark.parametrize("name", list(PLANS))
def test_engine_streams_equal_reference(engines, name):
    """Each engine's greedy streams equal the JAX engine's on the same
    plan, and its layout at the end is the JAX one's."""
    want, got = engines
    assert "error" not in want[name], want[name]
    e, reqs = got[name]
    assert [r.generated for r in reqs] == want[name]["streams"]
    assert str(e.par_layout) == want[name]["layout"]


def test_layout_round_trip_streams_and_log(engines):
    """The live round trips: streams equal the engines started at TP4 and
    at SP2xTP2, and ``transform_log`` holds the two same-degree layout
    changes (and, around TP2x2, the degree changes to and from
    SP2xTP2), as the JAX engine logs them."""
    want, got = engines
    streams = {n: [r.generated for r in got[n][1]] for n in got}
    assert streams["round_trip"] == streams["tp4"] == streams["sp2tp2"]
    assert streams["tp2x2_cycle"] == streams["tp4"]
    assert streams["sp4tp1"] == streams["tp4"]
    for name in ("round_trip", "tp2x2_cycle"):
        e = got[name][0]
        log = [(r["tp_from"], r["tp_to"], r["layout_from"], r["layout_to"])
               for r in e.transform_log]
        assert log == [tuple(x) for x in want[name]["log"]]
    lays = [(r["layout_from"], r["layout_to"])
            for r in got["round_trip"][0].transform_log
            if r["layout_from"] != r["layout_to"]
            and r["tp_from"] == r["tp_to"]]
    assert lays == [("TP4", "SP2xTP2"), ("SP2xTP2", "TP4")]


def test_cycle_with_no_decode_lands_split_cache():
    """TP1x4 -> TP4 -> SP2xTP2 -> TP2x2 -> SP2xTP2 -> SP4xTP1 -> TP4 ->
    TP1x4 with no decode between the steps: after every landing each
    worker's cache is ``split_cache``'s at the layout, and the global
    bytes are those before the cycle."""
    cfg = _cfg()
    model = Model.empty(cfg, make_plan(cfg, 4, mode="page"), device="cpu")
    gen = torch.Generator().manual_seed(5)
    for t in model.parameters():
        t.data.copy_(torch.randn(t.shape, generator=gen) * 0.05)
    e = Engine(cfg, params=model, max_batch=4, max_seq=64, page_tokens=16,
               devices=["cpu"] * 4)
    for r in [ServeRequest(rid=i, prompt=list(range(3 + i, 20 + 2 * i)),
                           max_new_tokens=20) for i in range(4)]:
        e.submit(r)
    for _ in range(6):
        e.step()
    before = e.global_caches()
    for tp, lay in ((4, None), (4, (2, 2)), (2, None), (4, (2, 2)),
                    (4, (4, 1)), (4, None), (1, None)):
        e.transform(tp, layout=None if lay is None else Layout(*lay))
        while not e._session.done:
            e._session.step()
        e._finish_transform()
        e.check_capacity_invariant()
        for x, layer in zip(before, e.layers):
            y = I.join_cache(layer.cache, layer.attn_layout)
            mps = y.page_table.shape[1]
            keep = x.pool.view(4, -1, *x.pool.shape[1:])[:, :mps]
            assert torch.equal(keep.reshape(y.pool.shape), y.pool)
            assert torch.equal(x.seq_lens, y.seq_lens)
            for c, s in zip(layer.cache,
                            I.split_cache(y, layer.attn_layout,
                                          ["cpu"] * 4)):
                assert torch.equal(c.pool, s.pool)
                assert torch.equal(c.positions, s.positions)


def test_layout_that_splits_no_pages_evenly_raises():
    cfg = _cfg()
    e = Engine(cfg, max_batch=4, max_seq=48, page_tokens=16,
               devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="do not split"):
        e.transform(4, layout=Layout(2, 2))
    assert not e.transforming and e.par_layout == Layout(1, 1)


@pytest.fixture(scope="module")
def cluster(reference):
    want = reference("cluster")
    cl = ClusterEngine(_cfg(), ["cpu"] * 2, params=_model(want["params"], 2),
                       scheduler=GygesScheduler(SchedulerConfig(
                           **CLUSTER_SCHED)), **CLUSTER_KW)
    reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in _trace()]
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.submit(reqs[3])
    layouts = []
    orig = Engine.transform

    def transform(self, tp_to, *a, layout=None, **kw):
        layouts.append((self.iid, str(self.par_layout), tp_to,
                        str(layout)))
        return orig(self, tp_to, *a, layout=layout, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(Engine, "transform", transform)
    try:
        cl.run(max_steps=5000)
    finally:
        mp.undo()
    return want, cl, reqs, layouts


def test_cluster_layouts_equal_reference(cluster):
    """Actions (with their layouts), placements and streams equal the
    JAX cluster's; the merged TP2 engine moved to SP2xTP1 while the long
    request was in service, and every engine ends at TP1."""
    want, cl, reqs, layouts = cluster
    got = [(type(a).__name__, a.iid, a.tp_to,
            tuple(getattr(a, "donor_iids", ())),
            str(getattr(a, "layout", None)), a.reason) for a in cl.actions]
    assert got == want["actions"]
    assert dict(cl.placements) == want["placements"]
    assert {r.rid: r.generated for r in reqs} == want["streams"]
    assert [e.tp for e in cl.engines] == want["tps"] == [1, 1]
    assert any(a[0] == "ScaleUp" and a[4] == "SP2xTP1" for a in got)
    assert (0, "TP2", 2, "SP2xTP1") in layouts or \
        (1, "TP2", 2, "SP2xTP1") in layouts
    assert cl.stall_steps == 0
