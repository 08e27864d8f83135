"""phi-3-vision's patch prefix in the port against the JAX reference.

The config is ``reduced()`` (2 layers, d_model 256, 4 heads of 64, 8
patches, swiglu) in float32; weights come from the reference's
``init_params`` through ``params_from_jax``, patches and prompts from a
numpy seed.

* ``embed_inputs``: projected patches before the tokens, positions
  0..P+S-1, within ``TOL_LAYER`` (1e-5: a 256-deep fp32 product summed
  in another order) of the reference's.
* ``Model.prefill`` with and without patches, then 8 ``decode_step``s
  from position P+S: logits within ``TOL`` (1e-4) of ``M.prefill`` /
  ``M.decode_step``, greedy tokens equal.
* Engines (one device, 3 slots and 5 requests, some with patches, slots
  reused; two workers at TP1x2): each stream equals the reference's
  model-level loop for that request; a prompt the prefill policy would
  chunk runs whole; the patches count in the context, so they count
  against the slot ceiling.  Text only, the port's engine gives the
  reference ``Engine``'s streams (the reference's engine never passes
  patches: ROADMAP queue 3).  ``transform`` and a cluster's spill are
  refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.padding import make_plan as jplan
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import ServeRequest as JReq
from repro_torch.configs import get_config as tget
from repro_torch.core.padding import make_plan as tplan
from repro_torch.core.scheduler import PrefillPolicy, Spill
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _torch_frontend import jitted, prompts, reference_stream

TOL_LAYER = 1e-5
TOL = 1e-4
NEW = 8


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jget("phi-3-vision-4.2b").reduced(),
                              dtype="float32")
    tcfg = dataclasses.replace(tget("phi-3-vision-4.2b").reduced(),
                               dtype="float32")
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = JM.init_params(jax.random.PRNGKey(4), cfg, plan)
    model = Model.empty(tcfg, tp, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg, tp))
    return cfg, plan, params, tcfg, model


def _patches(rng, cfg, n):
    return rng.standard_normal((n, cfg.vision.num_patches, cfg.d_model),
                               dtype=np.float32)


def test_embed_inputs_and_vision_proj_match_reference(pair):
    cfg, plan, params, tcfg, model = pair
    np.testing.assert_array_equal(model.vision_proj.detach().numpy(),
                                  np.asarray(params["vision_proj"]))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    patches = _patches(rng, cfg, 2)
    jx, jpos = JM.embed_inputs(params, cfg, {"tokens": jnp.asarray(toks),
                                             "patches": jnp.asarray(patches)})
    x, pos = M.embed_inputs(model.static(), tcfg,
                            torch.from_numpy(toks).long(),
                            torch.from_numpy(patches))
    assert x.shape == (2, cfg.vision.num_patches + 9, cfg.d_model)
    assert np.abs(x.detach().numpy() - np.asarray(jx)).max() < TOL_LAYER
    assert np.array_equal(pos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patches", "text only"])
def test_model_prefill_and_decode_match_reference(pair, with_patches):
    cfg, plan, params, tcfg, model = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (2, 10 + NEW)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :10])}
    patches = None
    if with_patches:
        patches = _patches(rng, cfg, 2)
        batch["patches"] = jnp.asarray(patches)
    P = cfg.vision.num_patches if with_patches else 0
    prefill, step = jitted(cfg, plan)
    jc = JM.init_decode_caches(cfg, plan, 2, 64, 8)
    jl, jc = prefill(params, batch=batch, caches=jc)
    tc = model.init_decode_caches(2, 64, 8)
    assert model.init_cross_cache(2) is None
    with torch.no_grad():
        tl = model.prefill(torch.from_numpy(toks[:, :10]).long(), tc,
                           patches=None if patches is None
                           else torch.from_numpy(patches))
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < TOL
    assert int(tc[0].seq_lens[0]) == P + 10
    for i in range(NEW):
        pos = np.full((2,), P + 10 + i, np.int32)
        jl, jc = step(params, caches=jc, tokens=jnp.asarray(toks[:, 10 + i]),
                      positions=jnp.asarray(pos))
        with torch.no_grad():
            tl = model.decode_step(tc, torch.from_numpy(toks[:, 10 + i])
                                   .long(), torch.from_numpy(pos))
        assert np.abs(tl.numpy() - np.asarray(jl)).max() < TOL, i
        assert np.array_equal(tl.numpy().argmax(-1),
                              np.asarray(jl).argmax(-1)), i


#: five prompts on three lengths, the first, third and fifth with
#: patches; 23 and 40 are longer than the 16-token budget
LENS = (5, 23, 40, 23, 5)


@pytest.fixture(scope="module")
def streams(pair):
    cfg, plan, params, _, _ = pair
    ps = prompts(LENS, cfg.vocab_size, seed=3)
    rng = np.random.default_rng(17)
    patches = [p if i % 2 == 0 else None
               for i, p in enumerate(_patches(rng, cfg, len(LENS)))]
    want = [reference_stream(params, cfg, plan, p, NEW, patches=x)[0]
            for p, x in zip(ps, patches)]
    return ps, patches, want


@pytest.mark.parametrize("where", ["one device", "TP1x2"])
def test_engine_streams_equal_reference_loop(pair, streams, where):
    _, _, _, tcfg, model = pair
    ps, patches, want = streams
    kw = dict(max_seq=64, page_tokens=8,
              prefill_policy=PrefillPolicy(token_budget=16, mode="mixed"))
    if where == "one device":
        eng = Engine(tcfg, params=model, max_batch=3, device="cpu", **kw)
    else:
        eng = Engine(tcfg, params=model, max_batch=4, devices=["cpu"] * 2,
                     **kw)
        assert eng.plan.max_tp == 2
    whole = []
    run_whole = eng._prefill_whole
    eng._prefill_whole = lambda r, s: (whole.append(len(r.prompt)),
                                       run_whole(r, s))
    reqs = [ServeRequest(p, max_new_tokens=NEW, patches=x)
            for p, x in zip(ps, patches)]
    for r in reqs:
        eng.submit(r)
    slots = set()
    while not all(r.done for r in reqs):
        eng.step()
        slots |= {r.slot for r in reqs if r.slot >= 0}
    assert [r.generated for r in reqs] == want
    assert sorted(whole) == sorted(LENS)
    assert len(slots) < len(reqs)
    P = tcfg.vision.num_patches
    assert [r.context_len for r in reqs] == [
        (P if x is not None else 0) + n + NEW for n, x in zip(LENS, patches)]


def test_text_only_engine_equals_reference_engine(pair):
    """The reference's engine serves phi-3-vision text only (its whole
    prefill passes only the tokens); the port's, without patches, gives
    its streams."""
    cfg, _, params, tcfg, model = pair
    ps = prompts((6, 19, 33), cfg.vocab_size, seed=8)
    je = JEngine(cfg, params=params, max_batch=2, max_seq=64, page_tokens=8)
    te = Engine(tcfg, params=model, max_batch=2, max_seq=64, page_tokens=8,
                device="cpu")
    jr = [JReq(p, max_new_tokens=NEW) for p in ps]
    tr = [ServeRequest(p, max_new_tokens=NEW) for p in ps]
    for a, b in zip(jr, tr):
        je.submit(a)
        te.submit(b)
    je.run_until_done()
    te.run_until_done()
    assert [r.generated for r in tr] == [r.generated for r in jr]


def test_patches_count_against_the_ceiling_and_changes_are_refused(pair):
    _, _, _, tcfg, model = pair
    P, d = tcfg.vision.num_patches, tcfg.d_model
    eng = Engine(tcfg, params=model, max_batch=1, max_seq=32,
                 page_tokens=8, device="cpu")
    x = np.zeros((P, d), np.float32)
    # 8 patches + 20 tokens leave room for 4 more positions of 32
    r = ServeRequest(list(range(1, 21)), max_new_tokens=10, patches=x)
    assert r.total_tokens == P + 20 + 10
    eng.submit(r)
    assert eng.kv_used_tokens() == P + 20
    eng.run_until_done()
    assert r.context_len == 32 and len(r.generated) == 4
    with pytest.raises(ValueError, match="patches"):
        eng.submit(ServeRequest([1], max_new_tokens=1,
                                patches=np.zeros((P, d + 1), np.float32)))
    with pytest.raises(ValueError, match="no encoder"):
        eng.submit(ServeRequest([1], max_new_tokens=1,
                                frames=np.zeros((4, d), np.float32)))
    with pytest.raises(NotImplementedError,
                       match="does not cover encoder/vision"):
        eng.transform(2)
    cl = ClusterEngine(tcfg, ["cpu"] * 2, n_instances=2, max_batch=2,
                       max_seq=64, page_tokens=8)
    with pytest.raises(NotImplementedError,
                       match="does not cover encoder/vision"):
        cl._execute_spill(ServeRequest([1] * 70, max_new_tokens=2),
                          Spill(iid=0, host_iid=1, tokens=16))
    with pytest.raises(NotImplementedError,
                       match="does not cover encoder/vision"):
        cl.engines[1].host_spilled(2)
