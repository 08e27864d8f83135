"""KV spill in the port (rung 1 of the capacity ladder) against the JAX
reference: ``paged/allocator.py``, ``paged/pool.py::concat_spilled`` /
``split_spilled``, the engine's spill methods and the cluster's
``_execute_spill`` / ``_finalize_spills``.

The cluster case is reduced llama3-8b in float32 on 2 instances x 1
worker (``max_seq=64``, ``page_tokens=16``, ``max_batch=4``) under
``SchedulerConfig(spill=True, spill_slack=2.0)``: three short requests
land on both instances, then a 96-token request (80 prompt tokens, 16
new) above one instance's 64-token ceiling spills its overflow into the
neighbour's free slot.  The reference cluster runs once, in a
subprocess with 2 fake host devices, and writes its weights, actions,
placements, streams and spill accounting to a file.

The spilled request's stream is held against the REFERENCE ENGINE that
holds the whole request in its own pool, not against the reference
cluster's spilled stream.  The reference's batched decode appends its
masked filler at every row's cursor: into the spilled slot's local
pages, stepping that slot's cursor a second time, while the slot decodes
on the extended view, and into the host's reserved slot, over hosted
overflow pages (``repro/serving/engine.py`` ``step``: ``protect`` saves
neither), so its spilled stream departs from that engine's after 3 of 16
tokens here.  The port saves and restores both kinds of slot around its
batched decode; every other request's stream equals the reference
cluster's.
"""
import dataclasses
import pickle
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.paged import pool as JP
from repro.paged.allocator import OutOfPages as JOutOfPages
from repro.paged.allocator import PageAllocator as JPageAllocator
from repro_torch.configs import get_config
from repro_torch.core.padding import make_plan
from repro_torch.core.scheduler import (GygesScheduler, ScaleUp,
                                        SchedulerConfig, Spill)
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.paged import OutOfPages, PageAllocator
from repro_torch.paged import pool as pp
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import run

KW = dict(n_instances=2, max_batch=4, max_seq=64, page_tokens=16,
          dwell_steps=4)
SCHED = dict(long_threshold=64, target_tp=2, spill=True, spill_slack=2.0)


# ---------------------------------------------------------------------------
# the page allocator

def _allocator_ops(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        op = rng.choice(["alloc", "alloc", "free", "shrink", "compact",
                         "trim"])
        rid = int(rng.integers(0, 6))
        if op == "alloc":
            yield op, (rid, int(rng.integers(1, 9)))
        elif op == "free":
            yield op, (rid,)
        elif op in ("shrink", "compact"):
            yield op, (rid, float(rng.choice([0.25, 0.5, 0.75, 1.0])))
        else:
            yield op, (rid,)


def _apply(alloc, err, op, args):
    fn = {"alloc": alloc.alloc, "free": alloc.free_request,
          "shrink": alloc.shrink, "compact": alloc.compact_headercentric,
          "trim": alloc.trim}[op]
    try:
        return fn(*args)
    except err:
        return "out of pages"


@pytest.mark.parametrize("seed", [0, 1])
def test_page_allocator_matches_reference(seed):
    mine, ref = PageAllocator(24), JPageAllocator(24)
    for op, args in _allocator_ops(seed):
        got = _apply(mine, OutOfPages, op, args)
        want = _apply(ref, JOutOfPages, op, args)
        assert got == want, (op, args)
        assert mine.free == ref.free and mine.tables == ref.tables
        assert mine.occupancy == ref.occupancy
        assert mine.peak_used == ref.peak_used and mine.used == ref.used


# ---------------------------------------------------------------------------
# the extended view

def _parts(seed: int, mps=(4, 4, 2), kvs=2, P=16, dh=8):
    """Batch-1 identity-paged states (numpy): the local part, then two
    host segments."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(mps):
        pool = rng.standard_normal((n, kvs, 2, P, dh)).astype(np.float32)
        pos = rng.integers(-1, 500, size=(1, n * P)).astype(np.int32)
        seq = np.array([77 if i == 0 else 0], np.int32)
        out.append((pool, np.arange(n, dtype=np.int32)[None], seq, pos))
    return out


def test_concat_and_split_spilled_match_reference_and_round_trip():
    parts = _parts(3)
    mine = [pp.PagedState(*(torch.from_numpy(a.copy()) for a in p))
            for p in parts]
    ref = [JP.PagedState(*(jnp.asarray(a) for a in p)) for p in parts]
    ext = pp.concat_spilled(mine)
    want = JP.concat_spilled(ref)
    for got_t, want_a in zip((ext.pool, ext.page_table, ext.seq_lens,
                              ext.positions), want):
        assert tuple(got_t.shape) == tuple(want_a.shape)
        assert np.array_equal(got_t.numpy(), np.asarray(want_a))
    # the view is a copy: writing it leaves the parts alone
    keep = ext.pool.clone()
    ext.pool.add_(1.0)
    assert np.array_equal(mine[1].pool.numpy(), parts[1][0])
    ext.pool.copy_(keep)
    counts = [p[0].shape[0] for p in parts]
    back = pp.split_spilled(ext, counts)
    want_back = JP.split_spilled(want, counts)
    for got, ref_part, orig in zip(back, want_back, mine):
        for got_t, want_a, orig_t in zip(
                (got.pool, got.page_table, got.seq_lens, got.positions),
                ref_part, (orig.pool, orig.page_table, orig.seq_lens,
                           orig.positions)):
            assert np.array_equal(got_t.numpy(), np.asarray(want_a))
    # split is the exact inverse of concat (host parts' cursors are 0)
    for got, orig in zip(back, mine):
        assert torch.equal(got.pool, orig.pool)
        assert torch.equal(got.positions, orig.positions)
        assert torch.equal(got.page_table, orig.page_table)
    assert torch.equal(back[0].seq_lens, mine[0].seq_lens)
    assert all(int(b.seq_lens) == 0 for b in back[1:])


# ---------------------------------------------------------------------------
# the cluster against the JAX cluster

def _trace():
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
    from repro.serving.engine import Engine
    from repro.serving.request import ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    params = M.init_params(jax.random.PRNGKey(11), cfg,
                           make_plan(cfg, 2, mode="page"))
    trace = %(trace)r
    reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in trace]
    cl = ClusterEngine(cfg, jax.devices()[:2], params=params,
                       scheduler=GygesScheduler(SchedulerConfig(**%(sched)r)),
                       **%(kw)r)
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    # the long request alone on an engine whose pool holds it whole
    eng = Engine(cfg, params=params, max_batch=4, max_seq=128,
                 page_tokens=16)
    r, p, n = trace[3]
    alone = ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
    eng.submit(alone)
    eng.run_until_done(2000)
    out = {"params": jax.tree.map(np.asarray, params),
           "actions": [(type(a).__name__, a.iid,
                        getattr(a, "host_iid", None),
                        getattr(a, "tokens", None), a.reason)
                       for a in cl.actions],
           "placements": dict(cl.placements),
           "streams": {r.rid: r.generated for r in reqs},
           "alone": alone.generated,
           "spill_pages": cl.metrics()["spill_pages"],
           "spill_log": [[(x["kind"], x["pages"], x["bytes"])
                          for x in e.spill_log] for e in cl.engines],
           "open_spills": len(cl.partition.spills())}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_spill") / "out.pkl"
    body = textwrap.dedent(JAX_SCRIPT) % {"trace": _trace(), "kw": KW,
                                          "sched": SCHED}
    run(body, tmp, devices=2, timeout=160)
    with open(tmp, "rb") as f:
        return pickle.load(f)


def _cfg():
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32")


def _model(params):
    cfg = _cfg()
    plan = make_plan(cfg, 2, mode="page")
    model = Model.empty(cfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg, plan))
    return model


def _reqs():
    return [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in _trace()]


def _cluster(model):
    return ClusterEngine(_cfg(), ["cpu"] * 2, params=model,
                         scheduler=GygesScheduler(SchedulerConfig(**SCHED)),
                         **KW)


@pytest.fixture(scope="module")
def ported(reference):
    """The port's cluster on the reference's weights and trace, with a
    check after every write-back that the host's reserved slot holds,
    bit for bit, the overflow pages of the guest's extended view."""
    model = _model(reference["params"])
    cl = _cluster(model)
    checks = []
    orig = Engine.spill_slot

    def spill_slot(self, slot, ext):
        orig(self, slot, ext)
        sp = self._spills[slot]
        host, j = sp["host"], sp["hosting"]["slots"][0]
        n_local = self._local_page_cap() // self.page_tokens
        for view, hosted in zip(ext, host._slot_caches(j)):
            over = view.pool[n_local:]
            checks.append(
                torch.equal(hosted.pool[:over.shape[0]], over)
                and torch.equal(hosted.positions[0, :over.shape[0]
                                                 * self.page_tokens],
                                view.positions[0, n_local
                                               * self.page_tokens:]))

    mp = pytest.MonkeyPatch()
    mp.setattr(Engine, "spill_slot", spill_slot)
    try:
        reqs = _reqs()
        for r in reqs[:3]:
            cl.submit(r)
        for _ in range(2):
            cl.step()
        cl.submit(reqs[3])
        spilled = dict(regions=len(cl.partition.spills()),
                       hosted=[dict(e._hosted) for e in cl.engines])
        cl.run(max_steps=5000)
    finally:
        mp.undo()
    return dict(cluster=cl, reqs=reqs, checks=checks, model=model,
                spilled=spilled)


def test_spill_actions_placements_and_accounting_equal_reference(
        reference, ported):
    cl = ported["cluster"]
    acts = [(type(a).__name__, a.iid, getattr(a, "host_iid", None),
             getattr(a, "tokens", None), a.reason) for a in cl.actions]
    assert acts == reference["actions"]
    assert [a[0] for a in acts] == ["Spill"]
    assert cl.placements == reference["placements"]
    m = cl.metrics()
    assert m["spill_pages"] == reference["spill_pages"] > 0
    assert m["n_transforms"] == 0 and m["finished"] == m["total"] == 4
    assert [[(x["kind"], x["pages"], x["bytes"]) for x in e.spill_log]
            for e in cl.engines] == reference["spill_log"]
    # the region was open while the request ran, and closed after it
    assert ported["spilled"]["regions"] == 1
    assert any(ported["spilled"]["hosted"])
    assert not cl.partition.spills() and reference["open_spills"] == 0
    assert all(not e._spills and not e._hosted for e in cl.engines)
    cl.partition.check_invariants()


def test_spill_streams_equal_reference(reference, ported):
    reqs = ported["reqs"]
    # the short requests: the reference cluster's own streams
    for r in reqs[:3]:
        assert r.generated == reference["streams"][r.rid], r.rid
    # the spilled request: the stream of the reference engine that holds
    # it whole, and of the port's own such engine
    long_ = reqs[3]
    assert long_.generated == reference["alone"]
    cfg = _cfg()
    eng = Engine(cfg, params=ported["model"], devices=["cpu"],
                 max_batch=4, max_seq=128, page_tokens=16,
                 plan=make_plan(cfg, 2, mode="page"))
    alone = ServeRequest(rid=99, prompt=list(long_.prompt),
                         max_new_tokens=long_.max_new_tokens)
    eng.submit(alone)
    eng.run_until_done(2000)
    assert alone.generated == long_.generated


def test_hosted_pages_equal_the_extended_view_overflow(ported):
    # one check a layer at every write-back: the chunk past the local
    # ceiling and each of the decode steps on the extended view
    checks = ported["checks"]
    layers = _cfg().num_layers
    assert len(checks) == layers * (1 + 15) and all(checks)


def test_refused_grant_falls_back_to_a_full_merge(monkeypatch):
    """The counterpart of ``tests/test_cluster_merge.py::
    test_live_spill_grant_failure_falls_back_to_partial_merge`` with
    partial merges off: the scheduler decides a spill, the host cannot
    grant it, and the placement falls down the ladder to a full merge;
    the request is served, not dropped."""
    cfg = _cfg()
    from repro_torch.models import model as M
    model = M.build(cfg, make_plan(cfg, 2, mode="page"), seed=3,
                    device="cpu")
    cl = _cluster(model)
    for e in cl.engines:
        monkeypatch.setattr(e, "host_spilled", lambda n_pages: None)
    rng = np.random.default_rng(1)
    long_ = ServeRequest(rid=9, prompt=rng.integers(0, 512, size=80
                                                    ).tolist(),
                         max_new_tokens=16)
    assert isinstance(cl.scheduler.decide_capacity(cl._transformable(),
                                                   96), Spill)
    cl.submit(long_)
    assert not any(isinstance(a, Spill) for a in cl.actions), cl.actions
    merges = [a for a in cl.actions
              if isinstance(a, ScaleUp) and a.donor_iids]
    assert merges and merges[0].tp_to == 2, cl.actions
    assert not cl.partition.spills()
    cl.run(max_steps=5000)
    assert long_.finished and len(long_.generated) == 16
    m = cl.metrics()
    assert m["spill_pages"] == 0 and m["n_transforms"] == 2, m
    assert all(not e.parked and e.W == 1 for e in cl.engines)
    cl.partition.check_invariants()


def test_refused_grant_falls_back_to_a_partial_merge(monkeypatch):
    """The same with ``partial_merge=True`` on 4 instances of 2 workers
    (the reference's shape): the refused grant falls one rung, to a
    partial merge; the donors shed a worker each and keep serving, and
    the split widens them back."""
    cfg = _cfg()
    from repro_torch.models import model as M
    model = M.build(cfg, make_plan(cfg, 8, mode="page"), seed=3,
                    device="cpu")
    cl = ClusterEngine(cfg, ["cpu"] * 8, params=model, n_instances=4,
                       max_batch=2, max_seq=32, page_tokens=16,
                       dwell_steps=4, scheduler=GygesScheduler(
                           SchedulerConfig(long_threshold=16, target_tp=4,
                                           spill=True, partial_merge=True,
                                           spill_slack=2.0)))
    for e in cl.engines:
        monkeypatch.setattr(e, "host_spilled", lambda n_pages: None)
    rng = np.random.default_rng(1)
    long_ = ServeRequest(rid=9, prompt=rng.integers(0, 512, size=24
                                                    ).tolist(),
                         max_new_tokens=16)
    assert isinstance(cl.scheduler.decide_capacity(cl._transformable(),
                                                   40), Spill)
    cl.submit(long_)
    assert not any(isinstance(a, Spill) for a in cl.actions), cl.actions
    partial = [a for a in cl.actions
               if isinstance(a, ScaleUp) and a.donor_devices]
    assert partial and partial[0].tp_to == 4, cl.actions
    assert sorted(e.W for e in cl.engines) == [1, 1, 2, 2]
    cl.run(max_steps=5000)
    assert long_.finished and len(long_.generated) == 16
    m = cl.metrics()
    assert m["spill_pages"] == 0 and m["partial_merges"] == 1, m
    assert all(not e.parked and e.W == 2 for e in cl.engines)
    assert not cl.partition._loans
    cl.partition.check_invariants()


def test_spilled_streams_equal_an_unspilled_engine_after_idle_steps():
    """Shorts decode on both instances for a while before the long
    request spills, so the host's free slot has taken the batched
    decode's filler at its idle cursor: the reservation empties it, and
    every stream equals an engine whose own pool holds the request."""
    from repro_torch.core.weight_transform import relayout_mlp_for_tp
    from repro_torch.models import model as M
    cfg = _cfg()
    plan = make_plan(cfg, 2, mode="page")
    model = M.build(cfg, plan, seed=0, device="cpu")
    for blk in model.layers:
        blk.mlp["wi"].data, blk.mlp["wo"].data = relayout_mlp_for_tp(
            blk.mlp["wi"].data, blk.mlp["wo"].data, cfg.d_ff, 2)
    cl = _cluster(model)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 512, size=n).tolist() for n in (6, 7, 8, 80)]
    reqs = [ServeRequest(rid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(3):
        cl.step()
    cl.submit(reqs[3])
    assert [type(a).__name__ for a in cl.actions] == ["Spill"]
    cl.run(max_steps=5000)
    alone = Engine(cfg, params=model, devices=["cpu"], max_batch=4,
                   max_seq=128, page_tokens=16, plan=plan)
    for r in reqs:
        want = ServeRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=8)
        alone.submit(want)
        alone.run_until_done(2000)
        assert want.generated == r.generated, r.rid
