"""Replicated kv heads on the port's engine with workers (fewer kv heads
than workers: the padding plan's ``kv_replication > 1``) against the JAX
``Engine(devices=...)``.

Two cases, float32: reduced llama3-8b (4 kv heads) on 8 workers, each
kv head copied twice, and reduced gemma-2b (1 kv head, geglu) on 4
workers, its head copied four times.  Each JAX engine serves a batch
that goes TP1 -> TPW -> TP1 mid-decode, in a subprocess of its own with
8 fake host devices (both start with the module), and writes its
weights and greedy streams to a file; the port's streams must be EQUAL.

The port alone: ``shard_attn`` / ``gather_attn`` round trips at every
degree (gemma-2b on 8 workers too), each TP shard holding the whole
``wk``/``wv`` columns of the kv heads its kv slots copy; and the pools
after a TP1 -> TPW -> TP1 cycle with no decode between its steps are
bit-equal to the pools before it.
"""
import dataclasses
import pickle
import textwrap

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import instance as I
from repro_torch.core.padding import make_plan
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import start

CASES = {"llama3-8b": 8, "gemma-2b": 4}

JAX_SCRIPT = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.models import model as M
    from repro.serving.engine import Engine
    from repro.serving.request import ServeRequest

    name, W = sys.argv[2], int(sys.argv[3])
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    plan = make_plan(cfg, W, mode="page")
    assert plan.kv_replication > 1
    params = M.init_params(jax.random.PRNGKey(5), cfg, plan)
    eng = Engine(cfg, params=params, devices=jax.devices()[:W], plan=plan,
                 max_batch=W, max_seq=16 * W, page_tokens=16)
    reqs = [ServeRequest(rid=i, prompt=list(range(2 + i, 8 + 2 * i)),
                         max_new_tokens=6) for i in range(W)]
    for r in reqs:
        eng.submit(r)
    for _ in range(W + 1):
        eng.step()
    for tp in (W, 1):
        eng.transform(tp)
        while eng.transforming:
            eng.step()
    eng.run_until_done(1000)
    with open(sys.argv[1], "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, params),
                     "streams": [r.generated for r in reqs]}, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Both JAX runs, started together when the module's first test
    starts; ``reference(name)`` waits for one."""
    body = textwrap.dedent(JAX_SCRIPT)
    procs = {}
    for name, W in CASES.items():
        path = tmp_path_factory.mktemp("jax") / f"{name}.pkl"
        procs[name] = (path, start(body, path, name, W, devices=8,
                                   timeout=240))

    def wait(name):
        path, ref = procs[name]
        ref.wait()
        with open(path, "rb") as f:
            return pickle.load(f)

    yield wait
    for _, ref in procs.values():
        ref.close()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    """Start the JAX runs before the first test of the module."""


def _cfg(name):
    return dataclasses.replace(get_config(name).reduced(), dtype="float32")


def _reqs(W):
    return [ServeRequest(rid=i, prompt=list(range(2 + i, 8 + 2 * i)),
                         max_new_tokens=6) for i in range(W)]


def _engine(name, W, model):
    return Engine(_cfg(name), params=model, devices=["cpu"] * W,
                  max_batch=W, max_seq=16 * W, page_tokens=16)


@pytest.mark.parametrize("name,W", [("llama3-8b", 8), ("gemma-2b", 4),
                                    ("gemma-2b", 8)])
def test_shard_and_gather_attn_round_trip(name, W):
    cfg = _cfg(name)
    plan = make_plan(cfg, W, mode="page")
    r, dh = plan.kv_replication, cfg.resolved_head_dim
    assert r > 1
    p = M.build(cfg, plan, seed=1, device="cpu").layers[0].attn
    full = {k: v.data for k, v in p.items()}
    t = 1
    while t <= W:
        shards = [I.shard_attn(full, t, q, plan) for q in range(t)]
        for q, s in enumerate(shards):
            lo, hi = I.kv_heads_of(plan, t, q)
            # whole kv heads, copied: never a blind column slice
            assert torch.equal(s["wk"], full["wk"][:, lo * dh:hi * dh])
            assert s["wq"].shape[1] == plan.q_heads_padded * dh // t
            slots = plan.kv_slots // t
            assert slots % (hi - lo) == 0
        back = I.gather_attn(shards, plan)
        for k in full:
            assert torch.equal(back[k], full[k]), (t, k)
        t *= 2


@pytest.mark.parametrize("name", CASES)
def test_cycle_keeps_pool_bytes(name):
    W = CASES[name]
    cfg = _cfg(name)
    model = M.build(cfg, make_plan(cfg, W, mode="page"), seed=2,
                    device="cpu")
    eng = _engine(name, W, model)
    for r in _reqs(W):
        eng.submit(r)
    for _ in range(W + 2):
        eng.step()
    before = eng.global_caches()
    for tp in (W, 1):
        eng.transform(tp)
        while not eng._session.done:
            eng._session.step()
        eng._finish_transform()
    assert eng.layers[0].cache[0].pool.shape[1] == eng.plan.kv_slots
    for x, y in zip(before, eng.global_caches()):
        mps = y.page_table.shape[1]
        keep = x.pool.view(W, -1, *x.pool.shape[1:])[:, :mps]
        assert torch.equal(keep.reshape(y.pool.shape), y.pool)
        assert torch.equal(x.seq_lens, y.seq_lens)


@pytest.mark.parametrize("name", CASES)
def test_streams_equal_reference(reference, name):
    W = CASES[name]
    want = reference(name)
    cfg = _cfg(name)
    plan = make_plan(cfg, W, mode="page")
    model = Model.empty(cfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(want["params"], cfg, plan))
    eng = _engine(name, W, model)
    reqs = _reqs(W)
    for r in reqs:
        eng.submit(r)
    for _ in range(W + 1):
        eng.step()
    for tp in (W, 1):
        eng.transform(tp)
        while eng.transforming:
            eng.step()
            eng.check_capacity_invariant()
        assert eng.tp == tp
    eng.run_until_done(1000)
    assert [r.generated for r in reqs] == want["streams"]
