"""The port's engine spread over W CPU workers, transformed live, against
the JAX ``Engine(devices=...)`` — the counterpart of
``tests/test_transform_integration.py::test_engine_live_transform_mid_decode``.

Reduced llama3-8b in float32 (bf16 reduction order could flip near-tie
argmaxes), W = 2, with d_ff = 512 and with d_ff = 448, whose W = 2
padding plan pads d_ff to 512 so the per-shard zero tails are exercised.
The JAX engines run in one subprocess with 8 fake host devices (the
main pytest process must keep seeing one); it writes its weights and
greedy streams to a file the port reads.  Streams must be EQUAL.
"""
import dataclasses
import pickle
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.padding import make_plan
from repro_torch.launch.mesh import Layout
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import run

D_FFS = (512, 448)
KW = dict(max_batch=2, max_seq=64, page_tokens=16)

JAX_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.models import model as M
    from repro.serving.engine import Engine
    from repro.serving.request import ServeRequest

    out = {}
    for d_ff in %(d_ffs)r:
        cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                                  dtype="float32", d_ff=d_ff)
        params = M.init_params(jax.random.PRNGKey(11), cfg,
                               make_plan(cfg, 2, mode="page"))

        def mk():
            return Engine(cfg, params=params, devices=jax.devices()[:2],
                          **%(kw)r)

        def reqs():
            return [ServeRequest(rid=i, prompt=list(range(5 + i, 21 + i)),
                                 max_new_tokens=24) for i in range(2)]

        b = mk()
        b.transform(2)
        while b.transforming:
            b.step()
        rb = reqs()
        for r in rb:
            b.submit(r)
        b.run_until_done()
        a = mk()
        ra = reqs()
        for r in ra:
            a.submit(r)
        for _ in range(6):
            a.step()
        a.transform(2)
        while a.transforming:
            a.step()
        a.run_until_done()
        out[d_ff] = {"params": jax.tree.map(np.asarray, params),
                     "tp2": [r.generated for r in rb],
                     "mid": [r.generated for r in ra]}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "streams.pkl"
    body = textwrap.dedent(JAX_SCRIPT) % {"d_ffs": D_FFS, "kw": KW}
    run(body, path, devices=8, timeout=200)
    with open(path, "rb") as f:
        return pickle.load(f)


def _cfg(d_ff=512):
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32", d_ff=d_ff)


def _model(reference, d_ff, W=2):
    cfg = _cfg(d_ff)
    plan = make_plan(cfg, W, mode="page")
    model = Model.empty(cfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(reference[d_ff]["params"], cfg,
                                          plan))
    return cfg, model


def _reqs(n=2, new=24):
    return [ServeRequest(rid=i, prompt=list(range(5 + i, 21 + i)),
                         max_new_tokens=new) for i in range(n)]


def _engine(cfg, model, W=2, **kw):
    return Engine(cfg, params=model, devices=["cpu"] * W, **{**KW, **kw})


def _serve(eng, reqs, before=0, plan=()):
    """Submit, run ``before`` steps, then for each target degree of
    ``plan`` transform and step through the session (checking the
    capacity contract after every step), then run to done."""
    for r in reqs:
        eng.submit(r)
    for _ in range(before):
        eng.step()
    steps = []
    for tp in plan:
        n, mid = eng.transform(tp), 0
        while eng.transforming:
            out = eng.step()
            eng.check_capacity_invariant()
            mid += 1
            assert out["emitted"] > 0     # decoding never stalls
        steps.append((n, mid))
    eng.run_until_done()
    return [r.generated for r in reqs], steps


@pytest.mark.parametrize("d_ff", D_FFS)
def test_streams_equal_reference_mid_decode_and_at_tp2(reference, d_ff):
    cfg, model = _model(reference, d_ff)
    want = reference[d_ff]
    assert want["mid"] == want["tp2"]          # the reference's own claim
    b = _engine(cfg, model)
    b.transform(2)
    while b.transforming:
        b.step()
    assert b.tp == 2 and b.max_seq() == 64
    tp2, _ = _serve(b, _reqs())
    a = _engine(cfg, model)
    mid, [(n, steps)] = _serve(a, _reqs(), before=6, plan=(2,))
    assert tp2 == want["tp2"] and mid == want["mid"]
    assert a.tp == 2 and n == steps == 2 * cfg.num_layers
    kv = [r for r in a.transform_reports
          if any(o.component == "kv" for o in r.ops)]
    assert kv and all(r.kernel_plane and r.kv_bytes > 0 for r in kv)
    assert a.transform_log[-1]["steps"] == n


def _cache_equal(xs, ys):
    for x, y in zip(xs, ys):
        for f in ("pool", "page_table", "seq_lens", "positions"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


@pytest.mark.parametrize("d_ff", D_FFS)
def test_cache_bytes_identical_across_migration(reference, d_ff):
    cfg, model = _model(reference, d_ff)
    c = _engine(cfg, model)
    for r in _reqs():
        c.submit(r)
    for _ in range(6):
        c.step()
    before = c.global_caches()
    c.transform(2)
    while not c._session.done:
        c._session.step()
    c._finish_transform()
    assert c.layers[0].attn_layout == Layout(1, 2)
    _cache_equal(before, c.global_caches())
    c.transform(1)
    while not c._session.done:
        c._session.step()
    c._finish_transform()
    # back at TP1 x 2 the pool is trimmed to the live contexts (48 of
    # 64 tokens a slot): every kept page holds the same bytes
    after = c.global_caches()
    assert c.max_seq_alloc == 48 and c.tp == 1
    for x, y in zip(before, after):
        mps = y.page_table.shape[1]
        keep = x.pool.view(2, -1, *x.pool.shape[1:])[:, :mps]
        assert torch.equal(keep.reshape(y.pool.shape), y.pool)
        assert torch.equal(x.seq_lens, y.seq_lens)
        assert torch.equal(x.positions[:, :mps * 16], y.positions)


@pytest.mark.parametrize("d_ff", D_FFS)
def test_round_trip_mid_decode_equals_untransformed(reference, d_ff):
    cfg, model = _model(reference, d_ff)
    plain, _ = _serve(_engine(cfg, model), _reqs(new=30))
    got, steps = _serve(_engine(cfg, model), _reqs(new=30), before=4,
                        plan=(2, 1))
    assert got == plain
    assert [n for n, _ in steps] == [2 * cfg.num_layers, cfg.num_layers]


def test_round_trip_on_four_workers():
    cfg = _cfg()
    plan = make_plan(cfg, 4, mode="page")
    from repro_torch.models import model as M
    model = M.build(cfg, plan, seed=3, device="cpu")
    reqs = [ServeRequest(rid=i, prompt=list(range(3 + 2 * i, 19 + 3 * i)),
                         max_new_tokens=20) for i in range(4)]
    plain, _ = _serve(_engine(cfg, model, W=4, max_batch=4, max_seq=128),
                      [dataclasses.replace(r, generated=[]) for r in reqs])
    eng = _engine(cfg, model, W=4, max_batch=4, max_seq=128)
    got, _ = _serve(eng, reqs, before=5, plan=(4, 1))
    assert got == plain and eng.tp == 1


def test_only_full_merges_and_decompositions():
    """Once only full merges and decompositions; now any degree dividing
    the workers: ``transform(2)`` on 4 workers lands at TP2 x 2 (two
    groups of two, each over its own slots)."""
    cfg = _cfg()
    from repro_torch.models import model as M
    eng = Engine(cfg, params=M.build(cfg, make_plan(cfg, 4, mode="page"), 0,
                                         device="cpu"),
                 devices=["cpu"] * 4, max_batch=4, max_seq=128,
                 page_tokens=16)
    assert eng.transform(2) == 2 * cfg.num_layers
    while eng.transforming:
        eng.step()
    assert eng.tp == 2 and eng.mesh.rep == 2
    assert eng.max_seq_alloc == 2 * eng.seq_quantum
    for layer in eng.layers:
        assert layer.attn_layout == layer.mlp_layout == Layout(1, 2)
        assert [c.page_table.shape[0] for c in layer.cache] == [2] * 4
        assert layer.cache[0].pool.shape[1] == cfg.num_kv_heads // 2
    with pytest.raises(AssertionError):
        eng.transform(3)
    assert eng.transform(2) == 0
    eng.transform(1)
    while eng.transforming:
        eng.step()
    assert eng.transform(1) == 0 and not eng.transforming
    single = Engine(cfg, max_seq=64, page_tokens=16, device="cpu")
    with pytest.raises(AssertionError, match="devices="):
        single.transform(2)
    assert single.max_tp == 1 and eng.max_tp == eng.width == 4
    assert eng.max_seq_at(1) == 32 and eng.max_seq_at(4) == 128


def test_memory_and_ceiling_follow_the_degree():
    """Scale-down trims the pool to TP1's quantum; the next scale-up grows
    it back before its session, and a request longer than TP1's ceiling
    submitted mid-session is served in full at TP2."""
    cfg = _cfg()
    from repro_torch.models import model as M
    eng = Engine(cfg, params=M.build(cfg, make_plan(cfg, 2, mode="page"), 0,
                                         device="cpu"),
                 devices=["cpu"] * 2, **KW)
    assert eng.max_seq_alloc == 64 and eng.max_seq() == 32
    for tp in (2, 1):
        eng.transform(tp)
        while eng.transforming:
            eng.step()
    assert eng.max_seq_alloc == 32 == eng.max_seq()
    eng.transform(2)
    assert eng.max_seq_alloc == 64 and eng.max_seq() == 64
    long_ = ServeRequest(prompt=list(range(40)), max_new_tokens=10)
    assert long_.total_tokens > eng.max_seq_at(1)
    eng.submit(long_)
    eng.run_until_done()
    assert len(long_.generated) == 10 and eng.tp == 2


def test_workers_hold_their_own_tensors():
    cfg = _cfg()
    from repro_torch.models import model as M
    eng = Engine(cfg, params=M.build(cfg, make_plan(cfg, 2, mode="page"), 0,
                                         device="cpu"),
                 devices=["cpu"] * 2, **KW)
    for r in _reqs():
        eng.submit(r)
    eng.step()
    eng.transform(2)
    while eng.transforming:
        eng.step()
    for layer in eng.layers:
        ptrs = [t.data_ptr() for w in range(2)
                for t in (layer.attn[w]["wq"], layer.mlp[w]["wi"],
                          layer.cache[w].pool, layer.cache[w].positions)]
        assert len(set(ptrs)) == len(ptrs)
        assert layer.mlp[0]["wi"].shape[1] == cfg.d_ff  # [gate_w | up_w]
        assert layer.cache[0].pool.shape[1] == 2        # kv heads / W
