"""Attention kept whole under TP (the reference's
``transform_attn=False``, the paper's own placement) in the port against
the JAX reference — the counterpart of
``tests/test_transform_integration.py::test_transformation_faithful_mode_mlp_only``
and of the reference's ``Engine`` / ``ClusterEngine(transform_attn=
False)``.

Reduced llama3-8b in float32, ``init_params(PRNGKey(11))``:

* engines on 2 CPU workers, d_ff 512 and 448 (whose W = 2 plan pads
  d_ff to 512): TP1x2 -> TP2 mid-decode, then back to TP1x2; and
  same-degree moves onto one worker and back onto two;
* an engine on 4 workers: TP1x4 -> TP2x2 -> TP4 -> SP2xTP2 mid-decode;
* a ``ClusterEngine(transform_attn=False)`` of 2 instances x 1 worker: a
  long request merges them to TP2, Alg 2 splits them back.

Greedy streams, actions and placements must EQUAL the JAX runs', which
start together in three subprocesses (the W = 2 engines, the W = 4
engine, the cluster; as many fake host devices as workers, XLA's quick
CPU compiles, one schedule step moving both layers) when the module's
first test starts.  The port alone: in every plan the streams equal
the default (sharded-attention) engine's, pool bytes are identical
after every move, no worker's attention tensor aliases another
worker's, and a session on the same workers copies 0 attention bytes
(a TP2 -> TP1x2 scale-down gathers none; the default mode gathers half
a replica a worker), while a merge copies one whole replica to each
adopted worker and its split gathers none.  ``InstanceGroup(
transform_attn=False)`` (gemma-2b reduced, bf16, 4 workers: replicated kv
heads) keeps every replica in place through TP2 and tracks an
untransformed group's logits within the reference test's 3e-2.
"""
import dataclasses
import pickle
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.instance import InstanceGroup
from repro_torch.core.padding import make_plan
from repro_torch.launch.mesh import Layout
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import QUICK_COMPILES, start


def _short(n, new):
    return [(list(range(5 + i, 21 + i)), new) for i in range(n)]


#: name -> d_ff, workers, slots, requests (prompt, new), the live stages
#: ((tp, (sp, tp) or None, the engine's first n workers or None),
#: engine steps before it) and the layers a schedule step moves (both
#: of the reduced config's two: the reference's runs compile a layer
#: walk for each session step)
PLANS = {
    # a full change and back, d_ff 448 padded to 512 in the W = 2 plan
    "w2_512": dict(d_ff=512, W=2, batch=2, reqs=_short(2, 24),
                   live=[((2, None, None), 6), ((1, None, None), 4)],
                   lps=2),
    "w2_448": dict(d_ff=448, W=2, batch=2, reqs=_short(2, 24),
                   live=[((2, None, None), 6), ((1, None, None), 4)],
                   lps=2),
    # same-degree moves: onto one worker, then widened back onto two
    "w2_move": dict(d_ff=512, W=2, batch=2, reqs=_short(2, 12),
                    live=[((1, None, 1), 4), ((1, None, 2), 2)], lps=2),
    # a partial change, a full one, an SP layout change
    "w4": dict(d_ff=512, W=4, batch=4, reqs=_short(4, 16),
               live=[((2, None, None), 3), ((4, None, None), 2),
                     ((4, (2, 2), None), 2)], lps=2),
}
CLUSTER_KW = dict(n_instances=2, max_batch=4, max_seq=64, page_tokens=16,
                  dwell_steps=4)

#: the reference's runs: a subprocess runs its engine plans, or the
#: cluster
SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.launch.mesh import Layout
    from repro.models import model as M
    from repro.serving.cluster import ClusterEngine
    from repro.serving.engine import Engine
    from repro.serving.request import ServeRequest

    out = {"params": {}}
    for name, p in %(plans)r.items():
        cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                                  dtype="float32", d_ff=p["d_ff"])
        plan = make_plan(cfg, p["W"], mode="page")
        params = M.init_params(jax.random.PRNGKey(11), cfg, plan)
        out["params"][(p["d_ff"], p["W"])] = jax.tree.map(np.asarray, params)
        e = Engine(cfg, params=params, max_batch=p["batch"], max_seq=64,
                   page_tokens=16, devices=jax.devices()[:p["W"]],
                   plan=plan, transform_attn=False)
        reqs = [ServeRequest(rid=i, prompt=list(pr), max_new_tokens=n)
                for i, (pr, n) in enumerate(p["reqs"])]
        for r in reqs:
            e.submit(r)
        for (tp, lay, on), before in p["live"]:
            for _ in range(before):
                e.step()
            e.transform(tp, layers_per_step=p["lps"],
                        layout=None if lay is None else Layout(*lay),
                        devices=None if on is None else jax.devices()[:on])
            while e.transforming:
                e.step()
        e.run_until_done(1000)
        out[name] = {"streams": [r.generated for r in reqs],
                     "layout": str(e.par_layout),
                     "log": [(r["tp_from"], r["tp_to"], r["layout_from"],
                              r["layout_to"]) for r in e.transform_log]}
    if %(cluster)r:
        cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                                  dtype="float32")
        params = M.init_params(jax.random.PRNGKey(11), cfg,
                               make_plan(cfg, 2, mode="page"))
        reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
                for r, p, n in %(trace)r]
        cl = ClusterEngine(cfg, jax.devices()[:2], params=params,
                           transform_attn=False, **%(kw)r)
        for r in reqs[:3]:
            cl.submit(r)
        for _ in range(2):
            cl.step()
        cl.submit(reqs[3])
        cl.run(max_steps=5000)
        out["cluster"] = {
            "actions": [(type(a).__name__, a.iid, a.tp_to,
                         tuple(getattr(a, "donor_iids", ())), a.reason)
                        for a in cl.actions],
            "placements": dict(cl.placements),
            "streams": {r.rid: r.generated for r in reqs}}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


def _trace():
    """Three shorts and the merge trigger (80-token prompt: above one
    instance's 64-token ceiling, within the merged one)."""
    rng = np.random.default_rng(0)
    shorts = [(i, rng.integers(0, 512, size=5 + i).tolist(), 8)
              for i in range(3)]
    return shorts + [(99, rng.integers(0, 512, size=80).tolist(), 16)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    w2 = {k: v for k, v in PLANS.items() if v["W"] == 2}
    runs = {"w2": (w2, False, 2), "w4": ({"w4": PLANS["w4"]}, False, 4),
            "cluster": ({}, True, 2)}
    # the reference's runs are compile-bound (each session step compiles
    # its layer walk)
    refs = {name: start(
        textwrap.dedent(SCRIPT % {
            "plans": plans, "cluster": cluster, "trace": _trace(),
            "kw": CLUSTER_KW}), tmp / name, devices=ndev, timeout=250,
        xla_flags=QUICK_COMPILES)
        for name, (plans, cluster, ndev) in runs.items()}
    out = {"params": {}}
    for name, ref in refs.items():
        ref.wait()
        with open(tmp / name, "rb") as f:
            got = pickle.load(f)
        out["params"].update(got.pop("params"))
        out.update(got)
    return out


def _cfg(d_ff=512):
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32", d_ff=d_ff)


def _model(params, d_ff, W):
    cfg = _cfg(d_ff)
    plan = make_plan(cfg, W, mode="page")
    model = Model.empty(cfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(params, cfg, plan))
    return model


def _run(model, p, transform_attn, probe=None):
    """One plan on a port engine; ``probe(engine)`` runs after each live
    stage lands."""
    e = Engine(model.cfg, params=model, max_batch=p["batch"], max_seq=64,
               page_tokens=16, devices=["cpu"] * p["W"],
               transform_attn=transform_attn)
    reqs = [ServeRequest(rid=i, prompt=list(pr), max_new_tokens=n)
            for i, (pr, n) in enumerate(p["reqs"])]
    for r in reqs:
        e.submit(r)
    for (tp, lay, on), before in p["live"]:
        for _ in range(before):
            e.step()
        assert all(r.slot is not None for r in reqs), "decode in flight"
        e.transform(tp, layers_per_step=p["lps"],
                    layout=None if lay is None else Layout(*lay),
                    devices=None if on is None else e.home_devices[:on])
        while e.transforming:
            out = e.step()
            assert out["emitted"] > 0        # decoding never stalls
        if probe is not None:
            probe(e)
    e.run_until_done(1000)
    return e, [r.generated for r in reqs]


def _no_alias(e):
    """No attention tensor of a worker shares storage with another
    worker's, and each worker's views lie inside its own replica."""
    for layer in e.layers:
        owners = {}
        for w, whole in enumerate(layer.attn_whole):
            for t in whole.values():
                ptr = t.untyped_storage().data_ptr()
                assert owners.setdefault(ptr, w) == w
            mine = {t.untyped_storage().data_ptr() for t in whole.values()}
            assert {t.untyped_storage().data_ptr()
                    for t in layer.attn[w].values()} <= mine


@pytest.fixture(scope="module")
def engines(reference):
    want = reference
    out = {}
    for name, p in PLANS.items():
        model = _model(want["params"][(p["d_ff"], p["W"])], p["d_ff"],
                       p["W"])
        out[name] = (_run(model, p, False, probe=_no_alias),
                     _run(model, p, True))
    return want, out


@pytest.mark.parametrize("name", list(PLANS))
def test_streams_equal_reference_faithful_engine(engines, name):
    """The reference's faithful engine's streams and sessions, and the
    port's default engine's streams: the paper's placement changes no
    stream."""
    want, got = engines
    (e, streams), (d, default) = got[name]
    assert streams == want[name]["streams"]
    assert str(e.par_layout) == want[name]["layout"]
    assert [(r["tp_from"], r["tp_to"], r["layout_from"], r["layout_to"])
            for r in e.transform_log] == want[name]["log"]
    assert streams == default
    assert str(e.par_layout) == str(d.par_layout)
    assert all(layer.attn_whole is not None for layer in e.layers)
    assert all(layer.attn_whole is None for layer in d.layers)


@pytest.mark.parametrize("name", [n for n in PLANS if n != "w2_move"])
def test_faithful_sessions_copy_no_attention_bytes(engines, name):
    """On the same workers the faithful sessions write no attention
    tensor and gather none; the default sessions copy their shards
    (a scale-down gathers half a replica a worker from its peer)."""
    _, got = engines
    (e, _), (d, _) = got[name]
    assert all(r["attn_copied_bytes"] == r["attn_gathered_bytes"] == 0
               and r["weight_bytes"] == 0 for r in e.transform_log)
    assert all(r["kv_bytes"] > 0 for r in e.transform_log)
    assert all(r["attn_copied_bytes"] > 0 for r in d.transform_log)
    if name.startswith("w2"):
        cfg = d.cfg
        layer = cfg.d_model * d.plan.q_heads_padded * \
            cfg.resolved_head_dim * 2 * 4
        kv = cfg.d_model * d.plan.kv_padded * cfg.resolved_head_dim * 2 * 4
        half = (layer + kv) // 2 * cfg.num_layers
        up, down = d.transform_log
        assert up["attn_gathered_bytes"] == 0
        assert up["attn_copied_bytes"] == 2 * half
        assert down["attn_gathered_bytes"] == 2 * half


def test_pool_bytes_identical_after_each_faithful_move(engines):
    """A faithful engine's global caches hold the same bytes before and
    after TP1x2 -> TP2 -> TP1x2 (sessions stepped with no decode between
    them), as the default engine's do."""
    want, _ = engines
    p = PLANS["w2_448"]
    model = _model(want["params"][(448, 2)], 448, 2)
    e = Engine(model.cfg, params=model, max_batch=2, max_seq=64,
               page_tokens=16, devices=["cpu"] * 2, transform_attn=False)
    for i, (pr, n) in enumerate(p["reqs"]):
        e.submit(ServeRequest(rid=i, prompt=list(pr), max_new_tokens=n))
    for _ in range(6):
        e.step()
    before = e.global_caches()
    for tp in (2, 1):
        e.transform(tp)
        while not e._session.done:
            e._session.step()
        e._finish_transform()
        after = e.global_caches()
        for x, y in zip(before, after):
            mps = y.page_table.shape[1]
            keep = x.pool.view(2, -1, *x.pool.shape[1:])[:, :mps]
            assert torch.equal(keep.reshape(y.pool.shape), y.pool)
            assert torch.equal(x.seq_lens, y.seq_lens)
            assert torch.equal(x.positions[:, :mps * 16], y.positions)


@pytest.fixture(scope="module")
def cluster(reference):
    want = reference["cluster"]
    cfg = _cfg()
    model = _model(reference["params"][(512, 2)], 512, 2)
    cl = ClusterEngine(cfg, ["cpu"] * 2, params=model, transform_attn=False,
                       **CLUSTER_KW)
    reqs = [ServeRequest(rid=r, prompt=list(p), max_new_tokens=n)
            for r, p, n in _trace()]
    for r in reqs[:3]:
        cl.submit(r)
    for _ in range(2):
        cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    return want, cl, reqs


def test_cluster_merge_and_split_equal_reference(cluster):
    want, cl, reqs = cluster
    acts = [(type(a).__name__, a.iid, a.tp_to,
             tuple(getattr(a, "donor_iids", ())), a.reason)
            for a in cl.actions]
    assert acts == want["actions"]
    assert [a[0] for a in acts] == ["ScaleUp", "ScaleDown"]
    assert cl.placements == want["placements"]
    assert {r.rid: r.generated for r in reqs} == want["streams"]


def test_cluster_copies_whole_replicas_to_adopted_workers_only(cluster):
    """The merge copies one whole attention replica a layer to the
    adopted worker; the split returns the loan gathering none, and the
    revived donor holds whole replicas again."""
    _, cl, _ = cluster
    eng = next(e for e in cl.engines if e.transform_log)
    merge, split = eng.transform_log
    cfg, plan = eng.cfg, eng.plan
    dh = cfg.resolved_head_dim
    whole = cfg.d_model * dh * 4 * 2 * (plan.q_heads_padded
                                        + plan.kv_padded)
    assert merge["cross"] and split["cross"]
    assert merge["attn_copied_bytes"] == merge["attn_gathered_bytes"] \
        == whole * cfg.num_layers
    assert split["attn_copied_bytes"] == split["attn_gathered_bytes"] == 0
    for e in cl.engines:
        assert all(layer.attn_whole is not None for layer in e.layers)
        _no_alias(e)


def test_instance_group_faithful_mode_mlp_only():
    """The counterpart of the reference's
    ``test_transformation_faithful_mode_mlp_only``: gemma-2b reduced
    (bf16, one kv head: replicated over the workers) on 4 workers with
    attention kept whole; after ``transform(2)`` its teacher-forced
    logits track an untransformed group's within 3e-2 of their scale,
    every worker's attention replica is the tensor it held before, and
    the steps copied no attention weight."""
    cfg = get_config("gemma-2b").reduced()
    kw = dict(batch_per_replica=1, max_seq=64, seed=5,
              transform_attn=False)
    inst = InstanceGroup(cfg, ["cpu"] * 4, **kw)
    ref = InstanceGroup(cfg, ["cpu"] * 4, **kw)
    B, S = inst.batch, 8
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)))
    t = inst.prefill({"tokens": toks}).argmax(-1)
    ref.prefill({"tokens": toks})
    ref_logits, fed = [], []
    for i in range(4):
        fed.append(t)
        lg = ref.decode(t, torch.full((B,), S + i, dtype=torch.int32))
        t = lg.argmax(-1)
        ref_logits.append(lg.float())
    held = [[w["wq"].untyped_storage().data_ptr() for w in layer.attn_whole]
            for layer in inst.layers]
    reports = inst.transform_scheduled(2)
    assert inst.tp == 2 and inst.layers[0].attn_layout == Layout(1, 2)
    assert all(r.attn_copied_bytes == 0 == r.weight_bytes for r in reports)
    assert held == [[w["wq"].untyped_storage().data_ptr()
                     for w in layer.attn_whole] for layer in inst.layers]
    for i in range(4):
        got = inst.decode(fed[i], torch.full((B,), S + i,
                                             dtype=torch.int32)).float()
        scale = ref_logits[i].abs().max() + 1e-9
        err = ((got - ref_logits[i]).abs().max() / scale).item()
        assert err < 3e-2, f"step {i}: rel err {err}"
