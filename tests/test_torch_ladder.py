"""Partial TP degrees on one engine: the port's TP1 x 4 -> TP2 x 2 -> TP4
ladder against the JAX ``Engine(devices=...)`` — the counterpart of
``tests/test_chunked_prefill.py::test_inplace_transforms_resize_pool_and_serve``.

Reduced llama3-8b in float32 on 4 workers (``max_batch=4``,
``max_seq=64``, ``page_tokens=16``), so a worker's admission quantum is
16 tokens and every degree of the cycle 2 -> 4 -> 1 -> 2 holds the
requests.  The JAX engine runs the cycle mid-decode in a subprocess with
8 fake host devices (4 used) and writes its weights, greedy streams and
pool allocations to a file; the port's streams must be EQUAL and its
pool ``max_seq_alloc == seq_quantum * tp`` after every landing.

The port alone: the pools after each landing are bit-equal to the
layout an engine at the target degree holds for the same bytes
(``core.instance.split_cache`` of the pre-transform global cache); TP2 x
2 decode logits equal TP1 x 4's within 1e-5, which a sum over all four
workers (two groups' partial ``wo`` products of other slots) would
break; and a same-degree move onto one worker and back, mid-chunked-
prefill, leaves the streams of an engine that never moved.
"""
import dataclasses
import pickle
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import instance as I
from repro_torch.core import kv_transform as KT
from repro_torch.core.padding import make_plan
from repro_torch.core.scheduler import PrefillPolicy
from repro_torch.launch.mesh import Layout
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import start

KW = dict(max_batch=4, max_seq=64, page_tokens=16)
CYCLE = (2, 4, 1, 2)
LENS = (6, 9, 5, 7)          # prompt + 8 new tokens <= 16: TP1 holds each

JAX_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.models import model as M
    from repro.serving.engine import Engine
    from repro.serving.request import ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    devs = jax.devices()[:4]
    plan = make_plan(cfg, 4, mode="page")
    params = M.init_params(jax.random.PRNGKey(3), cfg, plan)
    eng = Engine(cfg, params=params, devices=devs, plan=plan, **%(kw)r)
    reqs = [ServeRequest(rid=i, prompt=list(range(3 + i, 3 + i + n)),
                         max_new_tokens=8) for i, n in enumerate(%(lens)r)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    allocs = []
    for tp in %(cycle)r:
        eng.transform(tp)
        while eng.transforming:
            eng.step()
            eng.check_capacity_invariant()
        allocs.append((eng.tp, eng.max_seq_alloc, eng.seq_quantum))
    eng.run_until_done(1000)
    with open(sys.argv[1], "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, params),
                     "streams": [r.generated for r in reqs],
                     "allocs": allocs}, f)
"""


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    """Start the JAX run before the first test of the module."""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX run, started when the module's first test starts (the
    port-only tests run while it works) and waited for on first use."""
    path = tmp_path_factory.mktemp("jax") / "ladder.pkl"
    body = textwrap.dedent(JAX_SCRIPT) % {"kw": KW, "lens": LENS,
                                          "cycle": CYCLE}
    ref = start(body, path, devices=8, timeout=300)

    def wait():
        ref.wait()
        with open(path, "rb") as f:
            return pickle.load(f)

    yield wait
    ref.close()


def _cfg():
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="float32")


@pytest.fixture(scope="module")
def model():
    """Random weights for the port-only tests."""
    from repro_torch.models import model as M
    cfg = _cfg()
    return M.build(cfg, make_plan(cfg, 4, mode="page"), seed=3,
                   device="cpu")


def _reqs():
    return [ServeRequest(rid=i, prompt=list(range(3 + i, 3 + i + n)),
                         max_new_tokens=8) for i, n in enumerate(LENS)]


def _engine(model, W=4, **kw):
    return Engine(_cfg(), params=model, devices=["cpu"] * W,
                  **{**KW, **kw})


def _land(eng, tp):
    """Run a whole session with no decode between its steps."""
    eng.transform(tp)
    while not eng._session.done:
        eng._session.step()
    eng._finish_transform()


def test_landed_pools_equal_an_engine_started_at_the_degree(model):
    eng = _engine(model)
    for r in _reqs():
        eng.submit(r)
    for _ in range(4):
        eng.step()
    B, workers = eng.max_batch, [w.device for w in eng.devices]
    for tp in CYCLE:
        before = eng.global_caches()
        _land(eng, tp)
        mps = eng.layers[0].cache[0].page_table.shape[1]
        for layer, glob in zip(eng.layers, before):
            assert layer.attn_layout == layer.mlp_layout == Layout(1, tp)
            want = I.split_cache(KT.resize_slot_capacity(glob, mps, B), tp,
                                 workers)
            for got, exp in zip(layer.cache, want):
                for f in ("pool", "page_table", "seq_lens", "positions"):
                    assert torch.equal(getattr(got, f), getattr(exp, f)), (
                        tp, f)
        # every worker's tensors are its own
        ptrs = [c.pool.data_ptr() for l in eng.layers for c in l.cache]
        assert len(set(ptrs)) == len(ptrs)


def test_tp2x2_logits_equal_tp1x4(model):
    """A sum over every worker instead of each TP group's would add the
    other group's partial products, which belong to other slots."""
    engines = [_engine(model), _engine(model)]
    for eng in engines:
        for r in _reqs():
            eng.submit(r)
        for _ in range(5):               # every slot admitted
            eng.step()
    _land(engines[1], 2)
    assert engines[1].mesh.rep == 2 and engines[1].tp == 2
    toks = torch.tensor([r.generated[-1] for r in engines[0].slots])
    pos = torch.tensor([r.context_len - 1 for r in engines[0].slots],
                       dtype=torch.int32)
    a, b = (eng._decode(toks, pos) for eng in engines)
    torch.testing.assert_close(b, a, rtol=0, atol=1e-5)


def test_same_degree_shrink_and_widen_mid_chunked_prefill(model):
    pol = PrefillPolicy(token_budget=4, mode="mixed", long_threshold=16,
                        order="sjf")

    def reqs():
        return [ServeRequest(rid=i, prompt=list(range(5 + i, 17 + i)),
                             max_new_tokens=4) for i in range(2)]

    eng = _engine(model, W=2, max_batch=2, page_tokens=4,
                  prefill_policy=pol)
    got = reqs()
    for r in got:
        eng.submit(r)
    eng.step()
    assert eng._prefilling and all(
        0 < p["done"] < len(p["req"].prompt)
        for p in eng._prefilling.values())
    home = list(eng.devices)
    assert eng.transform(1, devices=home[:1]) == 0
    assert eng.W == 1 and eng.max_seq_alloc == eng.seq_quantum
    eng.step()
    eng.step()
    assert eng.transform(1, devices=home) == 0 and eng.W == 2
    assert [m["layout_to"] for m in eng.move_log] == ["1xTP1", "2xTP1"]
    eng.run_until_done(1000)
    still = _engine(model, W=2, max_batch=2, page_tokens=4,
                    prefill_policy=pol)
    want = reqs()
    for r in want:
        still.submit(r)
    still.run_until_done(1000)
    assert [r.generated for r in got] == [r.generated for r in want]


def test_cycle_streams_and_pool_equal_reference(reference):
    reference = reference()
    cfg = _cfg()
    plan = make_plan(cfg, 4, mode="page")
    model = Model.empty(cfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(reference["params"], cfg, plan))
    eng = _engine(model)
    reqs = _reqs()
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    allocs = []
    for tp in CYCLE:
        n, mid = eng.transform(tp), 0
        while eng.transforming:
            out = eng.step()
            assert out["emitted"] > 0 or not out["active"]   # no stall
            eng.check_capacity_invariant()
            mid += 1
        assert mid == n
        allocs.append((eng.tp, eng.max_seq_alloc, eng.seq_quantum))
        assert eng.max_seq_alloc == eng.seq_quantum * tp
    eng.run_until_done(1000)
    assert allocs == reference["allocs"]
    assert [r.generated for r in reqs] == reference["streams"]
    # the cycle's streams are those of an engine that never moved
    still = _engine(model)
    want = _reqs()
    for r in want:
        still.submit(r)
    still.run_until_done(1000)
    assert [r.generated for r in want] == reference["streams"]


def test_instance_group_decodes_through_every_degree(model):
    """The port's ``InstanceGroup`` (the reference's ``core/instance.py``
    owner): a scheduled TP1x4 -> TP2x2 -> TP4 -> TP1x4 ladder with a
    decode step between schedule steps gives the logits of a group that
    never transformed, within fp32 reduction noise."""
    from repro_torch.core.instance import InstanceGroup
    cfg = _cfg()
    groups = [InstanceGroup(cfg, ["cpu"] * 4, 1, 64, params=model)
              for _ in range(2)]
    toks = torch.randint(0, cfg.vocab_size, (4, 9),
                         generator=torch.Generator().manual_seed(0))
    nxt = [g.prefill(toks).argmax(-1) for g in groups]
    assert torch.equal(nxt[0], nxt[1])
    pos = 9
    for tp in (2, 4, 1):
        def between(_):
            nonlocal pos
            a, b = (g.decode(nxt[0], torch.full((4,), pos)) for g in groups)
            torch.testing.assert_close(b, a, rtol=0, atol=1e-5)
            pos += 1
        reports = groups[1].transform_scheduled(tp, between_steps=between)
        assert groups[1].tp == tp and reports
        assert all(l.attn_layout == l.mlp_layout == Layout(1, tp)
                   for l in groups[1].layers)
    assert groups[1].transform_count == 3
