"""xLSTM's mLSTM and sLSTM blocks in the port against the JAX reference.

A config cut from xlstm-1.3b by hand: ``reduced()`` (d_model 256, 4
heads, so ``up`` 512 and an mLSTM head 128 wide) with 3 layers of the
pattern ``(MLSTM, SLSTM)`` (one group and an MLSTM remainder), float32
(``reduced()`` alone keeps only ``(MLSTM, MLSTM)``).  Weights come from
the reference's ``init_params`` through ``params_from_jax``.

* The layers (``mlstm_chunkwise`` at a divisor block and at a ragged
  one, ``mlstm_step``, ``slstm_seq``) with and without a carried state:
  within ``TOL_LAYER`` (1e-5) of the reference's; the blocked mLSTM
  split at block boundaries gives the whole call's bits.
* Each block's sequence, chunk and decode forms against the reference's
  ``apply_block_*``; the ``convert`` round trip.
* The model and single engines (whole prompts, page chunks, a reused
  slot): logits within ``TOL`` (1e-4), greedy streams equal the
  reference's.  A 300-token prompt, which the reference's
  ``mlstm_chunkwise`` refuses whole (256 does not divide it), serves
  whole in the port and gives the reference's page-chunked stream.
* Port invariants: chunked prefill equals whole prefill bit for bit; a
  live TP1x2 -> TP2 -> TP1x2 change gives the stream of the reference
  engines started at each degree; a TP group's replicated state stays
  bit-equal; a carry crosses a cross-assembly session; a cluster merge
  of two TP1 engines gives an unmerged engine's streams.

The reference engines run in two subprocesses with 2 fake host devices,
started when the module's first test starts; prompts lie on whole
16-token pages (they compile a program for each chunk and prompt
shape).
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
from repro.core import kv_transform as JKT
from repro.core import transform_engine as JTE
from repro.core import weight_transform as JWT
from repro.core.padding import make_plan as jplan
from repro.models import blocks as JB
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import MLSTM, SLSTM
from repro_torch.core import instance as I
from repro_torch.core.padding import make_plan as tplan
from repro_torch.core.scheduler import PrefillPolicy
from repro_torch.launch.mesh import workers_of
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.paged.recurrent import make_state_of
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _jaxref import QUICK_COMPILES, start

TOL = 1e-4          # whole-model logits (the frameworks sum in other orders)
TOL_LAYER = 1e-5    # one layer's output
NAME = "xlstm-1.3b"
PATTERN = ("mlstm", "slstm")
LAYERS = 3
EKW = dict(max_batch=2, max_seq=512, page_tokens=16)
BUDGET = dict(token_budget=16, mode="mixed")
# whole 16-token pages; five requests over two slots reuse both
ENGINE_LENS = (16, 64, 48, 32, 16)
# 300 tokens: longer than 256 and not a multiple of it
LONG_LEN = 300
NEW = 6


def _cfg(get, layers=LAYERS, dtype="float32"):
    return dataclasses.replace(get(NAME).reduced(), num_layers=layers,
                               layer_pattern=PATTERN, dtype=dtype)


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=n).tolist() for n in lens]


COMMON = """
    import dataclasses, pickle, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.core.padding import make_plan
    from repro.core.scheduler import PrefillPolicy
    from repro.models import model as M
    from repro.serving.engine import Engine
    from repro.serving.request import ServeRequest

    cfg = dataclasses.replace(get_config(%(name)r).reduced(),
                              num_layers=%(layers)d,
                              layer_pattern=%(pattern)r, dtype="float32")
    params = M.init_params(jax.random.PRNGKey(11), cfg,
                           make_plan(cfg, 2, mode="page"))

    def serve(eng, prompts, before=0, transform=None):
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

SINGLE_SCRIPT = COMMON + """
    out["params"] = jax.tree.map(np.asarray, params)
    out["whole"] = serve(Engine(cfg, params=params, **%(ekw)r), %(prompts)r)
    out["chunked"] = serve(Engine(cfg, params=params, prefill_policy=policy,
                                  **%(ekw)r), %(prompts)r)
    # the reference serves a 300-token prompt only in chunks <= 256
    out["long"] = serve(Engine(cfg, params=params, prefill_policy=policy,
                               **%(ekw)r), %(long)r)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""

WORKERS_SCRIPT = COMMON + """
    two = jax.devices()[:2]
    for name, tp in (("tp1", None), ("tp2", 2)):
        out[name] = serve(Engine(cfg, params=params, devices=two,
                                 prefill_policy=policy, **%(ekw)r),
                          %(prompts)r, transform=tp)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
"""


def _start(tmp_path_factory, name, script, **fill):
    path = tmp_path_factory.mktemp("jax") / f"{name}.pkl"
    body = textwrap.dedent(script) % dict(
        name=NAME, pattern=PATTERN, budget=BUDGET, layers=LAYERS, new=NEW,
        ekw=EKW, **fill)
    # the reference engines run most ops eagerly, each a small XLA
    # compile: unoptimised compiles halve their time
    ref = start(body, path, devices=2, timeout=140,
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
    """The two JAX runs, started when the module's first test starts."""
    fill = dict(prompts=_prompts(ENGINE_LENS),
                long=_prompts((LONG_LEN, 32), seed=5))
    procs = {"single": _start(tmp_path_factory, "single", SINGLE_SCRIPT,
                              **fill),
             "workers": _start(tmp_path_factory, "workers", WORKERS_SCRIPT,
                               **fill)}
    yield {k: wait for k, (_, wait) in procs.items()}
    for ref, _ in procs.values():
        ref.close()


@pytest.fixture(scope="module")
def engine_ref(_references):
    return {**_references["single"](), **_references["workers"]()}


@pytest.fixture(scope="module")
def pair():
    """(reference config, plan, params, port config, model) with weights
    of their own (PRNGKey 0), for the in-process checks."""
    jc, tc = _cfg(jget), _cfg(tget)
    jp = jplan(jc, 1)
    params = JM.init_params(jax.random.PRNGKey(0), jc, jp)
    return jc, jp, params, tc, _model(jax.tree.map(np.asarray, params), tc)


def _model(np_params, tc, W=1):
    plan = tplan(tc, W) if W == 1 else tplan(tc, W, mode="page")
    model = Model.empty(tc, plan, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tc, plan))
    return model


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(j, t, tol=TOL_LAYER):
    return float(np.abs(np.asarray(j) - t.numpy()).max()) < tol


# ---------------------------------------------------------------------------
# layers

def _mlstm_arrays(seed, B_=2, S=40, H=4, dh=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B_, S, H, dh)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((B_, S, H)).astype(np.float32)
    fg = (rng.standard_normal((B_, S, H)) + 2.0).astype(np.float32)
    state = (rng.standard_normal((B_, H, dh, dh)).astype(np.float32) * 0.1,
             rng.standard_normal((B_, H, dh)).astype(np.float32) * 0.1,
             rng.standard_normal((B_, H)).astype(np.float32))
    return q, k, v, ig, fg, state


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("block", [8, 16])
def test_mlstm_layers_match_reference(carry, block):
    """The blocked form at a block that divides the 40 tokens (8) and at
    one that leaves a ragged last block (16: 16 + 16 + 8), against the
    reference's chunkwise form at a divisor chunk and against a loop of
    its ``mlstm_step``; the port's step against the reference's."""
    q, k, v, ig, fg, state = _mlstm_arrays(0)
    st = state if carry else None
    jh, js = JL.mlstm_chunkwise(*map(jnp.asarray, (q, k, v, ig, fg)),
                                state=st, chunk=20)
    th, ts = L.mlstm_chunkwise(*_t(q, k, v, ig, fg),
                               state=None if st is None else _t(*st),
                               block=block)
    assert _close(jh, th)
    assert all(_close(a, b) for a, b in zip(js, ts))
    loop = st if carry else tuple(np.asarray(a) for a in
                                  L._mlstm_fresh(2, 4, 32, "cpu"))
    for t in range(q.shape[1]):
        jy, loop = JL.mlstm_step(*(jnp.asarray(a[:, t])
                                   for a in (q, k, v, ig, fg)), loop)
        assert _close(jy, th[:, t])
    assert all(_close(a, b) for a, b in zip(loop, ts))
    jy, js = JL.mlstm_step(*(jnp.asarray(a[:, 0]) for a in (q, k, v, ig, fg)),
                           state)
    ty, ts = L.mlstm_step(*_t(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]),
                          _t(*state))
    assert _close(jy, ty)
    assert all(_close(a, b) for a, b in zip(js, ts))


def test_reference_refuses_a_ragged_long_call_the_port_serves():
    """The reference's ``mlstm_chunkwise`` takes chunks of ``min(256,
    S)`` and raises on 300 tokens; the port's blocked form serves them
    and agrees with the reference's page-sized chunks carried along."""
    q, k, v, ig, fg, _ = _mlstm_arrays(1, B_=1, S=LONG_LEN, dh=16)
    with pytest.raises(AssertionError, match="chunk multiple"):
        JL.mlstm_chunkwise(*map(jnp.asarray, (q, k, v, ig, fg)))
    th, ts = L.mlstm_chunkwise(*_t(q, k, v, ig, fg), block=64)
    st, parts = None, []
    for lo in range(0, LONG_LEN, 64):
        sl = slice(lo, lo + 64)
        jh, st = JL.mlstm_chunkwise(*(jnp.asarray(a[:, sl])
                                      for a in (q, k, v, ig, fg)), state=st)
        parts.append(np.asarray(jh))
    assert _close(np.concatenate(parts, axis=1), th)
    assert all(_close(a, b) for a, b in zip(st, ts))


@pytest.mark.parametrize("cuts", [(16,), (8, 24), (32,)])
def test_mlstm_blocked_chunks_equal_whole_bit_for_bit(cuts):
    """Each part a tensor of its own, as an engine's chunk is, starting
    on a block boundary with the carried state."""
    q, k, v, ig, fg, _ = _mlstm_arrays(2, B_=1, S=45, dh=32)
    ts = _t(q, k, v, ig, fg)
    whole, last = L.mlstm_chunkwise(*ts, block=8)
    parts, st = [], None
    for lo, hi in zip((0,) + cuts, cuts + (45,)):
        y, st = L.mlstm_chunkwise(*(a[:, lo:hi].clone() for a in ts),
                                  state=st, block=8)
        parts.append(y)
    assert torch.equal(torch.cat(parts, dim=1), whole)
    assert all(torch.equal(a, b) for a, b in zip(st, last))


@pytest.mark.parametrize("carry", [False, True])
def test_slstm_matches_reference(carry):
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 24, 4, 64)).astype(np.float32)
    r = (rng.standard_normal((4, 64)) * 0.5).astype(np.float32)
    st = (tuple((rng.standard_normal((2, 64)) * s).astype(np.float32)
                for s in (1.0, 1.0, 0.5, 0.5)) if carry else None)
    jh, js = JL.slstm_seq(jnp.asarray(z), jnp.asarray(r), state=st)
    th, ts = L.slstm_seq(*_t(z, r), state=None if st is None else _t(*st))
    assert _close(jh, th)
    assert all(_close(a, b) for a, b in zip(js, ts))


# ---------------------------------------------------------------------------
# blocks, convert, model

@pytest.mark.parametrize("kind", [MLSTM, SLSTM])
def test_block_forms_match_reference(pair, kind):
    """Sequence (16 tokens), chunk (16 more, carrying the sequence's
    state) and decode (one token) of one block of each kind."""
    jc, jp, params, tc, model = pair
    li = PATTERN.index(kind)
    jp_layer = jax.tree.map(lambda a: a[0], params["blocks"][li])
    blk = model.layers[li]
    x = np.random.default_rng(4).standard_normal(
        (1, 33, tc.d_model)).astype(np.float32)
    pos = np.arange(33, dtype=np.int32)[None]
    state = make_state_of(kind, tc, 1, 16, device="cpu")
    jy, ex = JB.apply_block_seq(kind, jp_layer, jc, jp, jnp.asarray(x[:, :16]),
                                jnp.asarray(pos[:, :16]))
    with torch.no_grad():
        ty, _ = B.apply_block_seq(kind, blk, tc, model.plan,
                                  _t(x[:, :16])[0], _t(pos[:, :16])[0],
                                  state)
        assert _close(jy, ty)
        jy, jst = JB.apply_block_chunk(kind, jp_layer, jc, jp,
                                       jnp.asarray(x[:, 16:32]),
                                       jnp.asarray(pos[:, 16:32]),
                                       ex["state"])
        ty, _ = B.apply_block_chunk(kind, blk, tc, model.plan,
                                    _t(x[:, 16:32])[0], _t(pos[:, 16:32])[0],
                                    state)
        assert _close(jy, ty)
        jy, jst = JB.apply_block_decode(kind, jp_layer, jc, jp,
                                        jnp.asarray(x[:, 32:]),
                                        jnp.asarray(pos[:, 32:]), jst)
        ty, _ = B.apply_block_decode(kind, blk, tc, model.plan,
                                     _t(x[:, 32:])[0], _t(pos[:, 32:])[0],
                                     state)
    assert _close(jy, ty)
    leaves = jst["mlstm"] if kind == MLSTM else jst["slstm"]
    names = ("C", "n", "m") if kind == MLSTM else tuple("cnmh")
    assert all(_close(a, getattr(state, n), TOL)
               for a, n in zip(leaves, names))


def test_convert_round_trip(pair):
    """Every leaf of the reference's tree lands in the port's model
    unchanged (``ln`` and ``rec`` for the xLSTM blocks, no MLP and no
    ``ln2``), and the port's state dict loads back into an empty model
    bit for bit."""
    jc, jp, params, tc, model = pair
    unit = len(PATTERN)
    for li, blk in enumerate(model.layers):
        tree = (jax.tree.map(lambda a: np.asarray(a)[li // unit],
                             params["blocks"][li % unit])
                if li < tc.num_layers // unit * unit
                else jax.tree.map(np.asarray, params["rem"][li % unit]))
        assert blk.mlp is None and blk.ln2 is None
        assert set(tree) == {"ln"} | set(blk.rec), li
        for name, arr in tree.items():
            got = blk.ln if name == "ln" else blk.rec[name]
            assert np.array_equal(got.numpy(), arr), (li, name)
    again = Model.empty(tc, model.plan, device="cpu")
    again.load_state_dict(model.state_dict())
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k


def test_model_logits_and_greedy_stream_match_reference(pair):
    jc, jp, params, tc, model = pair
    toks = np.random.default_rng(5).integers(0, 512, size=(2, 32))
    prefill = jax.jit(JM.prefill, static_argnums=(1, 2))
    decode = jax.jit(JM.decode_step, static_argnums=(1, 2))
    jcache = JM.init_decode_caches(jc, jp, 2, 128, 16)
    jl, jcache = prefill(params, jc, jp, {"tokens": jnp.asarray(toks)},
                         jcache)
    caches = model.init_decode_caches(2, 128, 16)
    with torch.no_grad():
        tl = model.prefill(torch.from_numpy(toks), caches)
    assert _close(jl, tl, TOL)
    jt = np.asarray(jl)[:, -1].argmax(-1)
    tt = tl[:, -1].argmax(-1).numpy()
    assert np.array_equal(jt, tt)
    for step in range(6):
        pos = np.full((2,), 32 + step, np.int32)
        jl, jcache = decode(params, jc, jp, jcache, jnp.asarray(jt),
                            jnp.asarray(pos))
        with torch.no_grad():
            tl = model.decode_step(caches, torch.from_numpy(tt),
                                   torch.from_numpy(pos))
        assert _close(jl, tl, TOL), step
        jt, tt = np.asarray(jl).argmax(-1), tl.argmax(-1).numpy()
        assert np.array_equal(jt, tt), step


def test_model_chunked_prefill_equals_whole_bit_for_bit(pair):
    """Page-aligned chunks and a ragged last one (70 = 32 + 32 + 6)."""
    *_, tc, model = pair
    toks = torch.from_numpy(
        np.random.default_rng(6).integers(0, 512, size=(1, 70)))
    whole = model.init_decode_caches(1, 128, 16)
    chunked = model.init_decode_caches(1, 128, 16)
    with torch.no_grad():
        lw = model.prefill(toks, whole)
        for s in range(0, 70, 32):
            lc = model.prefill_chunk(toks[:, s:s + 32], torch.tensor([s]),
                                     chunked, first_chunk=s == 0)
    assert torch.equal(lw, lc)
    for w, c in zip(whole, chunked):
        assert all(torch.equal(w.leaves[k], c.leaves[k]) for k in w.leaves)


def test_xlstm_kinds_are_ported_and_states_stay_fp32():
    for kind in ("mlstm", "slstm", "rglru", "attn", "moe"):
        B.check_kind(kind)
    with pytest.raises(NotImplementedError, match="unknown kind"):
        B.check_kind("mamba")
    cfg = _cfg(tget, dtype="bfloat16")
    model = Model.empty(cfg, tplan(cfg, 1), device="cpu")
    assert [b.kind for b in model.layers] == ["mlstm", "slstm", "mlstm"]
    assert model.layers[0].rec.wq.dtype == torch.bfloat16
    caches = model.init_decode_caches(2, 64, 16)
    for c in caches:
        assert c.recurrent and all(t.dtype == torch.float32
                                   for t in c.leaves.values())
    # fresh values: mLSTM m at NEG_INF, sLSTM n at 1
    assert (caches[0].m == L.NEG_INF).all() and not caches[0].C.any()
    assert (caches[1].n == 1).all() and not caches[1].m.any()
    caches[1].n.zero_()
    caches[1].fresh_()
    assert (caches[1].n == 1).all()


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
    eng.run_until_done()
    return [r.generated for r in reqs]


def _policy():
    return PrefillPolicy(**BUDGET)


@pytest.mark.parametrize("scenario", ["whole", "chunked"])
def test_single_engine_streams_equal_reference(engine_ref, scenario):
    """Five requests over two slots (three reuse a slot, whose state
    starts fresh again), whole prompts or 16-token chunks."""
    tc = _cfg(tget)
    model = _model(engine_ref["params"], tc)
    kw = {} if scenario == "whole" else {"prefill_policy": _policy()}
    got = _serve(Engine(tc, params=model, device="cpu", **EKW, **kw),
                 _reqs())
    assert got == engine_ref[scenario]
    assert engine_ref["whole"] == engine_ref["chunked"]


def test_long_prompt_whole_gives_reference_chunked_stream(engine_ref):
    """A 300-token prompt prefilled whole (one call: the reference would
    refuse it) and in 16-token chunks both give the reference engine's
    page-chunked stream."""
    tc = _cfg(tget)
    model = _model(engine_ref["params"], tc)
    for kw in ({}, {"prefill_policy": _policy()}):
        eng = Engine(tc, params=model, device="cpu", **EKW, **kw)
        assert len(eng.prefill_policy.chunk_sizes(LONG_LEN, 16)) == \
            (1 if not kw else LONG_LEN // 16 + 1)
        got = _serve(eng, _reqs((LONG_LEN, 32), seed=5))
        assert got == engine_ref["long"], kw


def test_prefill_starts_from_the_reference_start_values(engine_ref):
    """A chunked prefill into a reused slot first puts every leaf at its
    start value, the reference's ``init_block_cache`` (mLSTM ``m`` at
    ``NEG_INF``, sLSTM ``n`` at 1), not at zero; and zero is another
    start: an mLSTM whose input gates lie far below its forget gates'
    running sum keeps a stabiliser of 0 from a zero state, and its
    outputs part from the fresh state's."""
    tc, jc = _cfg(tget), _cfg(jget)
    eng = Engine(tc, params=_model(engine_ref["params"], tc), device="cpu",
                 prefill_policy=_policy(), **EKW)
    _serve(eng, _reqs((32,)))
    assert (eng.caches[0].m[0] != L.NEG_INF).all()      # slot 0 was used
    eng._restore_carry(0, {"done": 0})
    want = JB.init_block_cache(JB.MLSTM, jc, jplan(jc, 1), 1, 64, 16)
    for kind, c in zip(tc.pattern, eng.caches):
        leaves = (want if kind == MLSTM else JB.init_block_cache(
            JB.SLSTM, jc, jplan(jc, 1), 1, 64, 16))[kind]
        for name, w in zip(("C", "n", "m") if kind == MLSTM else "cnmh",
                           leaves):
            assert np.array_equal(c.slot(0).leaves[name].numpy(),
                                  np.asarray(w)), (kind, name)
    q, k, v, ig, fg, _ = _mlstm_arrays(9, B_=1, S=32)
    ts = _t(q, k, v, np.full_like(ig, -8.0), fg)
    fresh, st = L.mlstm_chunkwise(*ts, block=16)
    zeros = tuple(torch.zeros_like(t) for t in L._mlstm_fresh(1, 4, 32,
                                                              "cpu"))
    from_zero, st0 = L.mlstm_chunkwise(*ts, state=zeros, block=16)
    assert (fresh - from_zero).abs().max() > 1e-3
    assert (st[2] - st0[2]).abs().max() > 1e-3


def _workers(engine_ref, devices=None, **kw):
    tc = _cfg(tget)
    model = _model(engine_ref["params"], tc, W=2)
    return Engine(tc, params=model, devices=devices or ["cpu"] * 2,
                  plan=tplan(tc, 2, mode="page"), prefill_policy=_policy(),
                  **{**EKW, **kw})


@pytest.mark.parametrize("before", [2, 9])
def test_live_tp_change_equals_engines_started_at_each_degree(engine_ref,
                                                              before):
    """TP1x2 -> TP2 -> TP1x2 while requests prefill (2 steps in, the
    64-token prompt mid-chunk) and while they decode (9 steps in)."""
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


def test_replicated_state_stays_bit_equal_across_the_tp_group(engine_ref):
    """At TP2 both workers hold every slot's state and update it from
    the same gathered products: after prefill and decode steps their
    copies are the same bits, and equal ``split_cache`` of the global
    state."""
    eng = _workers(engine_ref)
    eng.transform(2)
    while eng.transforming:
        eng.step()
    for r in _reqs():
        eng.submit(r)
    for _ in range(10):
        eng.step()
    for layer in eng.layers:
        a, b = layer.cache
        assert a.leaves["C" if layer.kind == MLSTM else "c"].any()
        for k in a.leaves:
            assert torch.equal(a.leaves[k], b.leaves[k]), (layer.kind, k)
            assert a.leaves[k].data_ptr() != b.leaves[k].data_ptr()


def test_weights_and_schedule_follow_the_reference(engine_ref):
    """At TP2 worker p holds column shard p of ``wq``/``wk``/``wv``/
    ``w_og`` (mLSTM) and ``w_zifo`` (sLSTM), row shard p of ``w_out``,
    and copies of the rest.  The session runs the reference's schedule
    (2 x layers steps up, layers down); its MLP ops move nothing and
    cost the reference's accounting, its kv ops move the mixer and its
    state rows together."""
    eng = _workers(engine_ref)
    full = [dict(l.attn[0]) for l in eng.layers]
    for r in _reqs():
        eng.submit(r)
    for _ in range(9):
        eng.step()
    n = eng.transform(2)
    jc = _cfg(jget)
    assert n == JTE.scale_up_schedule(LAYERS, 1, 1, 2).n_steps == 2 * LAYERS
    while eng.transforming:
        eng.step()
    for layer, f in zip(eng.layers, full):
        cols = (("wq", "wk", "wv", "w_og") if layer.kind == MLSTM
                else ("w_zifo",))
        for p, shard in enumerate(layer.attn):
            for k, v in f.items():
                if k in cols:
                    c = v.shape[1] // 2
                    want = v[:, p * c:(p + 1) * c]
                elif k == "w_out":
                    r = v.shape[0] // 2
                    want = v[p * r:(p + 1) * r]
                else:
                    want = v
                assert torch.equal(shard[k], want), (layer.kind, k)
        assert layer.mlp == [None, None] and not layer.has_mlp
    mlp_s = JWT.account_scale_up(jc, jplan(jc, 2, mode="page"), 2,
                                 "padded").time_s(JKT.LinkModel(),
                                                  overlap=True)
    reps = eng.transform_reports
    for r in reps[:LAYERS]:
        assert {o.component for o in r.ops} == {"mlp"}
        assert r.weight_bytes == 0 and r.kv_bytes == 0
        assert abs(r.modeled_s - mlp_s) < 1e-15
    for r in reps[LAYERS:]:
        assert {o.component for o in r.ops} == {"kv"}
        assert r.kv_bytes > 0 and r.modeled_s == 0.0
    n = eng.transform(1)
    assert n == JTE.scale_down_schedule(LAYERS, 1, 2, 1).n_steps == LAYERS


def test_carry_crosses_a_cross_assembly_session(engine_ref):
    """The reference's ``test_recurrent_carry_chunks_through_cross_
    session`` on the port: an engine on one worker is mid chunked
    prefill when it adopts a second worker and changes to TP2 across
    the two; chunks run mid-session, carrying the state across
    assemblies; the stream equals an engine on both workers that never
    changed."""
    workers = workers_of(["cpu"] * 2)
    prompt = _prompts((40,), seed=7)[0]
    eng = _workers(engine_ref, devices=workers[:1], max_seq=256)
    r = ServeRequest(rid=1, prompt=list(prompt), max_new_tokens=NEW)
    eng.submit(r)
    eng.step()
    assert next(iter(eng._prefilling.values()))["done"] == 16
    eng.adopt_devices(workers[1:])
    n = eng.transform(2)
    assert n >= LAYERS and eng._session_cross
    advanced = False
    while eng.transforming:
        eng.step()
        if eng.transforming:
            dones = [p["done"] for p in eng._prefilling.values()]
            advanced |= not dones or dones[0] > 16
    assert advanced, "chunks did not run mid cross session"
    eng.run_until_done()
    ref = _workers(engine_ref, devices=workers, max_seq=512)
    want = ServeRequest(rid=1, prompt=list(prompt), max_new_tokens=NEW)
    ref.submit(want)
    ref.run_until_done()
    assert r.generated == want.generated


def test_cluster_merge_gives_unmerged_streams(engine_ref):
    """Two TP1 engines of one worker; a 96-token request above one
    instance's 64 merges them (the donor mid chunked prefill) and the
    split follows: every stream equals one engine's that holds them all
    and never merges."""
    tc = _cfg(tget)
    model = _model(engine_ref["params"], tc, W=2)
    trace = [(0, 48), (1, 48), (2, 16), (99, 96)]
    prompts = dict(zip([r for r, _ in trace],
                       _prompts([n for _, n in trace], seed=8)))
    cl = ClusterEngine(tc, ["cpu"] * 2, params=model, n_instances=2,
                       max_batch=4, max_seq=64, page_tokens=16,
                       dwell_steps=4, prefill_policy=_policy())
    reqs = [ServeRequest(rid=r, prompt=list(prompts[r]),
                         max_new_tokens=NEW) for r, _ in trace]
    for r in reqs[:3]:
        cl.submit(r)
    cl.step()
    cl.submit(reqs[3])
    cl.run(max_steps=5000)
    assert [type(a).__name__ for a in cl.actions] == ["ScaleUp",
                                                      "ScaleDown"]
    one = Engine(tc, params=_model(engine_ref["params"], tc), device="cpu",
                 max_batch=4, max_seq=256, page_tokens=16,
                 prefill_policy=_policy())
    want = _serve(one, [ServeRequest(rid=r, prompt=list(prompts[r]),
                                     max_new_tokens=NEW)
                        for r, _ in trace])
    assert [r.generated for r in reqs] == want


def test_jax_configs_agree():
    jc, tc = _cfg(jget), _cfg(tget)
    assert jc.pattern == tc.pattern == ("mlstm", "slstm", "mlstm")
    assert (MLSTM, SLSTM) == ("mlstm", "slstm")


def test_leaf_split_follows_the_reference_spec(pair):
    """Each xLSTM mixer leaf splits over tp as the reference's
    ``_leaf_pspec`` places it: by column (its last axis), by row (its
    second-to-last) or not at all."""
    from repro.core.instance import _leaf_pspec
    *_, model = pair
    for blk in model.layers[:2]:
        for name, leaf in blk.rec.items():
            spec = tuple(_leaf_pspec(f"/blocks/0/{name}", leaf.dim(), True))
            spec = (None,) * (leaf.dim() - len(spec)) + spec
            col, row = spec[-1] is not None, spec[:-1] != (None,) * (
                leaf.dim() - 1)
            assert col == (name in I.REC_COLUMN_LEAVES), (name, spec)
            assert row == (name in I.REC_ROW_LEAVES), (name, spec)


def test_entry_points_default_to_the_card(monkeypatch):
    """``Engine(get_config("xlstm-1.3b"))`` and the CLI's ``--model
    xlstm-1.3b`` run on the card: without one they raise before building
    anything, unless the CPU is asked for."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"devices": ["cuda"] * 2}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine(tget(NAME), **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--model", NAME, "--requests", "1"])
