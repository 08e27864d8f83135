"""The port's MoE blocks against the JAX reference.

Reduced granite-moe-3b-a800m (every layer MOE, 4 experts, top-2) and
reduced llama4-maverick-400b-a17b (``(ATTN, MOE)``, 4 experts, top-1,
a shared expert), float32, weights from ``repro.models.model.
init_params`` carried over by ``params_from_jax``.

* ``apply_moe_mlp``: outputs within ``TOL_MLP`` (1e-5 absolute) of the
  reference's, and the routing decisions (each token's experts, its
  buffer positions and which choices are kept) EQUAL to the reference's.
  The reference's choices are read from its own ``jax.lax.top_k`` call;
  its positions from its own cumsum formula on them.
* A forced overflow (``capacity_factor`` 0.5): the routing is still the
  reference's; the port's output is a numpy oracle's in which a dropped
  choice writes nothing; the reference's is the same oracle with every
  overflowing expert's position ``cap - 1`` overwritten by a dropped
  choice's zero row (XLA's CPU scatter: last write wins), a documented
  difference (ROADMAP queue 3).
* The whole model: ``prefill``, ``prefill_chunk`` and ``decode_step``
  logits within ``TOL`` (1e-4) of the reference's, and the single
  engine's greedy streams (whole prompts and budgeted chunks) equal the
  JAX engine's.
* A two-worker engine at TP1x2 whose decode overflows capacity across
  its two replicas routes every decode over the global slot order: its
  choices, positions and keeps equal the reference's routing of the
  same rows, and its streams equal a single-device engine's.
* A live TP1x2 -> TP2 -> TP1x2 gives the streams of an engine started
  at each degree; the weight accounting takes the swap path for
  granite's plan (``page_aligned`` False), as the reference's does.
* A ``ClusterEngine`` of two one-worker instances merges and splits
  under the Gyges scheduler: actions, placements and streams equal the
  JAX cluster's (run in a subprocess with 2 fake devices, started with
  the module).
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
from repro.core import weight_transform as JWT
from repro.core.padding import make_plan as jplan
from repro.core.scheduler import PrefillPolicy as JPolicy
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import ServeRequest as JReq
from repro_torch.configs import get_config as tget
from repro_torch.core import weight_transform as TWT
from repro_torch.core.padding import make_plan as tplan
from repro_torch.core.scheduler import PrefillPolicy as TPolicy
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import ServeRequest as TReq

from _jaxref import start

TOL = 1e-4        # whole-model logits (the frameworks sum in other orders)
TOL_MLP = 1e-5    # one MoE MLP's output
MODELS = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
GRANITE = MODELS[0]


def _cfgs(name, capacity_factor=None):
    """(reference config, port config): reduced, float32, and at
    ``capacity_factor`` when given."""
    out = []
    for get in (jget, tget):
        cfg = dataclasses.replace(get(name).reduced(), dtype="float32")
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def _np_params(cfg, plan, seed=0):
    return jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(seed), cfg, plan))


def _model(np_params, tcfg, plan):
    model = Model.empty(tcfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg, plan))
    return model


def _layer(np_params, cfg, li):
    """Layer ``li``'s reference parameter tree."""
    unit = len(cfg.layer_pattern) if cfg.layer_pattern else 1
    G = cfg.num_layers // unit
    if li >= G * unit:
        return np_params["rem"][li - G * unit]
    return jax.tree.map(lambda a: a[li // unit],
                        np_params["blocks"][li % unit])


def _moe_layers(cfg):
    return [i for i, k in enumerate(cfg.pattern) if k == "moe"]


def reference_routing(mlp, x, cfg, plan):
    """The reference's ``apply_moe_mlp`` on rows x (T, d), with its own
    routing decisions: ``topi`` from its ``jax.lax.top_k`` call, and
    ``pos`` / ``keep`` from its cumsum formula on them
    (``repro/models/blocks.py:281-286``), ``topv`` renormalised as its
    next line does.  Returns y (T, d), topv, topi,
    pos, keep, cap as numpy."""
    seen = []
    top_k = jax.lax.top_k

    def spy(a, k):
        out = top_k(a, k)
        seen.append(out)
        return out

    jax.lax.top_k = spy
    try:
        y, _ = JB.apply_moe_mlp(jax.tree.map(jnp.asarray, mlp),
                                jnp.asarray(x)[None], cfg, plan)
    finally:
        jax.lax.top_k = top_k
    topv, topi = (np.asarray(a)[0] for a in seen[-1])
    topv = topv / np.maximum(topv.sum(-1, keepdims=True), 1e-9)
    T, k = topi.shape
    Ep = plan.experts_padded
    cap = max(1, int(T * k * cfg.moe.capacity_factor / plan.num_experts))
    flat = np.asarray(jax.nn.one_hot(topi, Ep, dtype=jnp.int32)).reshape(
        T * k, Ep)
    pos_in_e = np.cumsum(flat, axis=0) - flat
    pos = (pos_in_e * flat).sum(-1).reshape(T, k)
    return np.asarray(y)[0], topv, topi, pos, pos < cap, cap


def port_routing(p, x, tcfg, tp):
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y = B.apply_moe_mlp(p, xt[None], tcfg, tp)[0]
        topv, topi = B.moe_route(p["router"], xt, tcfg, tp)
        cap = B.moe_capacity(x.shape[0], tcfg)
        pos, keep = B.moe_positions(topi, p["wi"].shape[0], cap)
    return (y.numpy(), topv.numpy(), topi.numpy(), pos.numpy(),
            keep.numpy(), cap)


def _silu(x):
    return x / (1.0 + np.exp(-x))


def oracle(mlp, x, topv, topi, keep, cap, pos, overwrite=False):
    """numpy MoE output under a routing decision: each kept choice adds
    its weight times its expert's gated product of its token.  With
    ``overwrite`` (the reference's scatter on this CPU), an expert with
    a dropped choice loses the input of its kept choice at ``cap - 1``,
    which the dropped choice's zero row overwrote."""
    wi, wo = mlp["wi"].astype(np.float64), mlp["wo"].astype(np.float64)
    ffp = wo.shape[1]
    x = x.astype(np.float64)
    full = {e for e in range(wi.shape[0]) if (~keep & (topi == e)).any()}
    y = np.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(topi.shape[1]):
            if not keep[t, j]:
                continue
            e = int(topi[t, j])
            xin = x[t]
            if overwrite and e in full and pos[t, j] == cap - 1:
                xin = np.zeros_like(xin)
            h = xin @ wi[e]
            y[t] += topv[t, j] * ((_silu(h[:ffp]) * h[ffp:]) @ wo[e])
    return y


@pytest.fixture(scope="module", autouse=True)
def _start_reference(cluster_reference):
    """Start the JAX cluster before the first test of the module."""


@pytest.fixture(scope="module")
def pairs():
    """name -> (reference cfg, port cfg, reference plan, port plan,
    numpy params, port model), at one device."""
    out = {}
    for name in MODELS:
        cfg, tcfg = _cfgs(name)
        plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
        params = _np_params(cfg, plan)
        out[name] = (cfg, tcfg, plan, tp, params, _model(params, tcfg, tp))
    return out


def test_moe_blocks_are_ported():
    """MOE is a block kind the port builds and serves (the parent tree
    refused it in ``Model`` and ``Engine``)."""
    assert "moe" not in B.NOT_PORTED
    B.check_kind("moe")
    _, tcfg = _cfgs(GRANITE)
    eng = TEngine(tcfg, max_batch=2, max_seq=32, page_tokens=8, seed=1,
                  device="cpu")
    assert all(blk.kind == "moe" for blk in eng.model.layers)
    assert eng.model.layers[0].mlp["wi"].dim() == 3
    r = TReq(list(range(3, 12)), max_new_tokens=4)
    eng.submit(r)
    eng.run_until_done()
    assert len(r.generated) == 4


@pytest.mark.parametrize("name", MODELS)
def test_apply_moe_mlp_matches_reference(pairs, name):
    cfg, tcfg, plan, tp, params, model = pairs[name]
    x = np.random.default_rng(0).standard_normal(
        (26, cfg.d_model)).astype(np.float32)
    for li in _moe_layers(cfg):
        want = reference_routing(_layer(params, cfg, li)["mlp"], x, cfg,
                                 plan)
        got = port_routing(model.layers[li].mlp, x, tcfg, tp)
        assert got[5] == want[5]                                  # cap
        for a, b in zip(got[2:5], want[2:5]):                # topi/pos/keep
            assert np.array_equal(a, b), li
        assert np.abs(got[1] - want[1]).max() < TOL_MLP       # topv
        assert np.abs(got[0] - want[0]).max() < TOL_MLP, li
        assert want[4].all()             # the reduced config drops nothing
    assert ("shared_wi" in model.layers[_moe_layers(cfg)[0]].mlp) == (
        name != GRANITE)


def test_forced_overflow_routes_as_reference_and_drops_write_nothing():
    cfg, tcfg = _cfgs(GRANITE, capacity_factor=0.5)
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = _np_params(cfg, plan, seed=2)
    model = _model(params, tcfg, tp)
    mlp = _layer(params, cfg, 0)["mlp"]
    x = np.random.default_rng(4).standard_normal(
        (26, cfg.d_model)).astype(np.float32)
    want = reference_routing(mlp, x, cfg, plan)
    got = port_routing(model.layers[0].mlp, x, tcfg, tp)
    y_ref, topv, topi, pos, keep, cap = want
    assert cap == 6 and not keep.all()          # every expert overflows
    for a, b in zip(got[2:6], want[2:6]):
        assert np.array_equal(a, b)
    intent = oracle(mlp, x, topv, topi, keep, cap, pos)
    assert np.abs(got[0] - intent).max() < TOL_MLP
    # the reference: its kept choices at cap - 1 of an overflowing expert
    # lost their input to a dropped choice's zero row
    hit = np.zeros(len(x), bool)
    for e in set(topi[~keep].tolist()):
        hit |= ((topi == e) & (pos == cap - 1) & keep).any(-1)
    assert hit.any()
    assert np.abs(y_ref - oracle(mlp, x, topv, topi, keep, cap, pos,
                                 overwrite=True)).max() < TOL_MLP
    assert np.abs(y_ref[~hit] - got[0][~hit]).max() < TOL_MLP
    assert (np.abs(y_ref[hit] - got[0][hit]).max(-1) > 1e-3).all()


def _tokens(cfg, B_, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B_, S)).astype(np.int32)


def _diff(j, t):
    return float(np.abs(np.asarray(j) - t.numpy()).max())


@pytest.mark.parametrize("name", MODELS)
def test_model_prefill_chunk_and_decode_match_reference(pairs, name):
    cfg, tcfg, plan, tp, np_params, model = pairs[name]
    params = jax.tree.map(jnp.asarray, np_params)
    toks = _tokens(cfg, 2, 29)
    jc = JM.init_decode_caches(cfg, plan, 2, 64, 8)
    jl, jc = JM.prefill(params, cfg, plan, {"tokens": jnp.asarray(toks)}, jc)
    tc = model.init_decode_caches(2, 64, 8)
    with torch.no_grad():
        tl = model.prefill(torch.from_numpy(toks).long(), tc)
    assert _diff(jl, tl) < TOL
    nxt, pos = np.array([3, 5], np.int32), np.array([29, 29], np.int32)
    for step in range(3):
        jl, jc = JM.decode_step(params, cfg, plan, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        with torch.no_grad():
            tl = model.decode_step(tc, torch.from_numpy(nxt).long(),
                                   torch.from_numpy(pos))
        assert _diff(jl, tl) < TOL, step
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(nxt, tl.argmax(-1).numpy())
        pos = pos + 1
    one = toks[:1]
    jc = JM.init_decode_caches(cfg, plan, 1, 64, 8)
    tc = model.init_decode_caches(1, 64, 8)
    for start, size in [(0, 16), (16, 13)]:
        ch = one[:, start:start + size]
        jl, jc = JM.prefill_chunk(params, cfg, plan, jnp.asarray(ch),
                                  jnp.asarray([start], jnp.int32), jc,
                                  first_chunk=start == 0)
        with torch.no_grad():
            tl = model.prefill_chunk(
                torch.from_numpy(ch).long(),
                torch.tensor([start], dtype=torch.int32), tc,
                first_chunk=start == 0)
        assert _diff(jl, tl) < TOL, start


# name, prompt lengths, max_batch, policy kwargs (None = whole prompts)
SCENARIOS = [("whole_prompt", (5, 23, 40), 3, None),
             ("budgeted_mixed_chunks", (9, 31, 47), 3,
              dict(token_budget=16, mode="mixed"))]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s[0] for s in SCENARIOS])
@pytest.mark.parametrize("name", MODELS)
def test_engine_streams_equal_reference(pairs, name, scenario):
    cfg, tcfg, plan, tp, np_params, model = pairs[name]
    _, lens, max_batch, pol = scenario
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in lens]
    je = JEngine(cfg, params=jax.tree.map(jnp.asarray, np_params),
                 max_batch=max_batch, max_seq=64, page_tokens=8,
                 prefill_policy=JPolicy(**pol) if pol else None)
    te = TEngine(tcfg, params=model, max_batch=max_batch, max_seq=64,
                 page_tokens=8, device="cpu",
                 prefill_policy=TPolicy(**pol) if pol else None)
    jr = [JReq(p, max_new_tokens=10) for p in prompts]
    tr = [TReq(p, max_new_tokens=10) for p in prompts]
    for r in jr:
        je.submit(r)
    for r in tr:
        te.submit(r)
    je.run_until_done()
    te.run_until_done()
    assert [r.generated for r in tr] == [r.generated for r in jr]


def _worker_reqs(lens=(5, 9, 12, 7), new=8, seed=3):
    rng = np.random.default_rng(seed)
    return [TReq(list(map(int, rng.integers(0, 512, n))), max_new_tokens=new)
            for n in lens]


def test_two_replicas_route_decode_over_the_global_slot_order(monkeypatch):
    """TP1x2, capacity factor 0.5: a decode of 4 slots has one buffer
    slot an expert (cap 1) for 8 choices, so replicas compete for the
    same buffer slots.  Every decode's routing equals the reference's
    over all 4 rows, differs from routing each replica alone in some
    step, and the streams equal a single-device engine's."""
    cfg, tcfg = _cfgs(GRANITE, capacity_factor=0.5)
    plan2, tp2, tp1 = (jplan(cfg, 2, mode="page"),
                       tplan(tcfg, 2, mode="page"), tplan(tcfg, 1))
    assert (tp2.d_ff_padded, tp2.experts_padded, tp2.vocab_padded) == (
        tp1.d_ff_padded, tp1.experts_padded, tp1.vocab_padded)
    params = _np_params(cfg, plan2, seed=5)
    eng = TEngine(tcfg, params=_model(params, tcfg, tp2),
                  devices=["cpu"] * 2, max_batch=4, max_seq=64,
                  page_tokens=8)
    seen = []
    orig = M.moe_workers

    def spy(layer, hs, *a):
        used = []
        positions = B.moe_positions

        def rec(topi, E, cap):
            out = positions(topi, E, cap)
            used.append((topi.clone(), cap, *out))
            return out

        B.moe_positions = rec
        try:
            return orig(layer, hs, *a)
        finally:
            B.moe_positions = positions
            reps = [h for w, h in enumerate(hs)
                    if w % layer.mlp_layout.degree == 0 and h is not None]
            li = next(i for i, x in enumerate(eng.layers) if x is layer)
            seen.append((li, reps, used[0],
                         layer.mlp_layout))

    monkeypatch.setattr(M, "moe_workers", spy)
    reqs = _worker_reqs()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    decodes = [s for s in seen if sum(h.shape[0] for h in s[1]) == 4]
    assert decodes and all(len(s[1]) == 2 for s in decodes)
    crossed = False
    for li, reps, (topi, cap, pos, keep), _ in decodes:
        x = torch.cat(reps).reshape(-1, cfg.d_model).numpy()
        _, _, rtopi, rpos, rkeep, rcap = reference_routing(
            _layer(params, cfg, li)["mlp"], x, cfg, plan2)
        assert cap == rcap == 1
        assert np.array_equal(topi.numpy(), rtopi)
        assert np.array_equal(pos.numpy(), rpos)
        assert np.array_equal(keep.numpy(), rkeep)
        alone = [B.moe_positions(t, 4, B.moe_capacity(2, tcfg))[1]
                 for t in topi.split(2)]
        crossed |= not torch.equal(torch.cat(alone), keep)
    assert crossed, "no decode overflowed across the replicas"
    single = TEngine(tcfg, params=_model(params, tcfg, tp1), max_batch=4,
                     max_seq=64, page_tokens=8, device="cpu")
    want = _worker_reqs()
    for r in want:
        single.submit(r)
    single.run_until_done()
    assert [r.generated for r in reqs] == [r.generated for r in want]


def _engine_streams(model, tcfg, before, plan, start_tp2=False):
    eng = TEngine(tcfg, params=model, devices=["cpu"] * 2, max_batch=4,
                  max_seq=64, page_tokens=8)
    if start_tp2:
        eng.transform(2)
        while eng.transforming:
            eng.step()
    reqs = _worker_reqs(new=10)
    for r in reqs:
        eng.submit(r)
    for _ in range(before):
        eng.step()
    for tp in plan:
        eng.transform(tp)
        while eng.transforming:
            eng.step()
            eng.check_capacity_invariant()
    eng.run_until_done()
    return eng, [r.generated for r in reqs]


def test_live_tp_change_equals_an_engine_started_at_each_degree():
    cfg, tcfg = _cfgs(GRANITE)
    tp2 = tplan(tcfg, 2, mode="page")
    model = _model(_np_params(cfg, jplan(cfg, 2, mode="page"), seed=7),
                   tcfg, tp2)
    eng, mid = _engine_streams(model, tcfg, 4, (2,))
    _, at_tp2 = _engine_streams(model, tcfg, 0, (), start_tp2=True)
    assert mid == at_tp2
    rt_eng, rt = _engine_streams(model, tcfg, 4, (2, 1))
    _, plain = _engine_streams(model, tcfg, 0, ())
    assert rt == plain
    assert eng.tp == 2 and rt_eng.tp == 1
    logs = rt_eng.transform_log
    assert [(t["tp_from"], t["tp_to"]) for t in logs] == [(1, 2), (2, 1)]
    for layer in rt_eng.layers:                  # every expert, unsharded
        assert layer.mlp[0]["wi"].shape == (4, tcfg.d_model,
                                            2 * tp2.d_ff_padded)
        assert torch.equal(layer.mlp[0]["router"], layer.mlp[1]["router"])


def test_weight_accounting_takes_the_swap_path_for_granite():
    """granite's 512-wide experts cannot be page-aligned at any W: the
    MLP step copies the kept shard (the paper's swap path), and the
    port's bytes equal the reference's."""
    for W in (2, 4, 8):
        jcfg, tcfg = jget(GRANITE), tget(GRANITE)
        jp, tp = jplan(jcfg, W, mode="page"), tplan(tcfg, W, mode="page")
        assert not tp.page_aligned and tp.d_ff_padded == (
            1024 if W == 8 else 512)
        assert TWT.mlp_layer_bytes(tcfg, tp) == JWT.mlp_layer_bytes(jcfg, jp)
        for t in (2, 4):
            if t > W:
                continue
            a = TWT.account_scale_up(tcfg, tp, t, "padded")
            b = JWT.account_scale_up(jcfg, jp, t, "padded")
            assert a.bytes_copied == b.bytes_copied > 0
            assert a.page_ops == b.page_ops
            a = TWT.account_scale_down(tcfg, tp, t, "padded")
            b = JWT.account_scale_down(jcfg, jp, t, "padded")
            assert (a.bytes_copied, a.bytes_transferred) == (
                b.bytes_copied, b.bytes_transferred)


def test_expert_relayout_is_per_expert_eq2():
    """The 3-D relayout puts every expert in the per-shard Eq. 2 layout
    of ``relayout_mlp_for_tp``, and a TP shard of it holds every
    expert's shard columns."""
    from repro_torch.core import instance as I
    g = torch.Generator().manual_seed(0)
    E, d, ff, ffp, S = 3, 8, 6, 8, 2
    wi = torch.zeros(E, d, 2 * ffp)
    wo = torch.zeros(E, ffp, d)
    wi[..., :ff] = torch.randn(E, d, ff, generator=g)
    wi[..., ffp:ffp + ff] = torch.randn(E, d, ff, generator=g)
    wo[:, :ff] = torch.randn(E, ff, d, generator=g)
    a, b = TWT.relayout_mlp_for_tp(wi, wo, ff, S)
    for e in range(E):
        ae, be = TWT.relayout_mlp_for_tp(wi[e], wo[e], ff, S)
        assert torch.equal(a[e], ae) and torch.equal(b[e], be)
    shard = I.shard_mlp({"router": torch.ones(d, E), "wi": a, "wo": b}, 2,
                        1, S)
    assert set(shard) == {"wi", "wo"}
    assert torch.equal(shard["wi"], torch.cat(
        [a[..., ffp // 2:ffp], a[..., ffp + ffp // 2:]], dim=-1))
    assert torch.equal(shard["wo"], b[:, ffp // 2:])


# ---------------------------------------------------------------------------
# A ClusterEngine of MoE engines against the JAX cluster
# ---------------------------------------------------------------------------

KW = dict(n_instances=2, max_batch=4, max_seq=64, page_tokens=16,
          dwell_steps=4)


def _trace():
    """(rid, prompt, max_new): three shorts and the merge trigger (80
    tokens: above one instance's ceiling, within the merged one)."""
    rng = np.random.default_rng(0)
    shorts = [(i, rng.integers(0, 512, size=5 + i).tolist(), 8)
              for i in range(3)]
    return shorts + [(99, rng.integers(0, 512, size=80).tolist(), 16)]


JAX_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.models import model as M
    from repro.serving.cluster import ClusterEngine
    from repro.serving.request import ServeRequest

    cfg = dataclasses.replace(get_config(%(name)r).reduced(),
                              dtype="float32")
    params = M.init_params(jax.random.PRNGKey(11), cfg,
                           make_plan(cfg, 2, mode="page"))
    reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in %(trace)r]
    cl = ClusterEngine(cfg, jax.devices()[:2], params=params, **%(kw)r)
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    out = {"params": jax.tree.map(np.asarray, params),
           "actions": [(type(a).__name__, a.iid, a.tp_to,
                        tuple(getattr(a, "donor_iids", ())), a.reason)
                       for a in cl.actions],
           "placements": dict(cl.placements),
           "streams": {r.rid: r.generated for r in reqs},
           "tps": [e.tp for e in cl.engines]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def cluster_reference(tmp_path_factory):
    """The JAX cluster, started when the module's first test starts and
    waited for on first use."""
    path = tmp_path_factory.mktemp("jax") / "moe_cluster.pkl"
    body = textwrap.dedent(JAX_SCRIPT) % {"name": GRANITE, "trace": _trace(),
                                          "kw": KW}
    ref = start(body, path, devices=2, timeout=300)

    def wait():
        ref.wait()
        with open(path, "rb") as f:
            return pickle.load(f)

    yield wait
    ref.close()


def test_cluster_merge_and_split_equal_reference(cluster_reference):
    want = cluster_reference()
    _, tcfg = _cfgs(GRANITE)
    model = _model(want["params"], tcfg, tplan(tcfg, 2, mode="page"))
    cl = ClusterEngine(tcfg, ["cpu"] * 2, params=model, **KW)
    reqs = [TReq(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in _trace()]
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    acts = [(type(a).__name__, a.iid, a.tp_to,
             tuple(getattr(a, "donor_iids", ())), a.reason)
            for a in cl.actions]
    assert acts == want["actions"]
    assert [a[0] for a in acts] == ["ScaleUp", "ScaleDown"]
    assert cl.placements == want["placements"]
    assert {r.rid: r.generated for r in reqs} == want["streams"]
    assert [e.tp for e in cl.engines] == want["tps"] == [1, 1]
    assert cl.stall_steps == 0
    logs = [t for e in cl.engines for t in e.transform_log]
    assert all(t["weight_bytes"] > 0 for t in logs)
