"""whisper-tiny's encoder and cross-attention in the port against the JAX
reference.

The config is ``reduced()`` (2 encoder and 2 decoder layers, d_model
256, 4 heads of 64, 16 frames, the ungated gelu MLP) in float32;
weights come from the reference's ``init_params`` through
``params_from_jax``, frames and prompts from a numpy seed.

* The flash kernel's bidirectional branch: the port's plain version with
  ``causal=False`` against the reference's Pallas kernel in interpret
  mode and its oracle, at lengths the Pallas kernel's block assert
  takes.
* ``run_encoder``, ``encode_cross_kv`` and ``cross_attention`` within
  ``TOL_LAYER`` (1e-5) of the reference's.
* ``Model.prefill`` with frames, then 8 ``decode_step``s: logits within
  ``TOL`` (1e-4) of ``M.prefill`` / ``M.decode_step``, greedy tokens
  equal.
* Engines (one device, 3 slots and 5 requests, slots reused; two
  workers at TP1x2): each request's stream equals the reference's
  model-level loop for it (its own frames).  A prompt the prefill policy
  would chunk runs whole.  The reference's ``Engine`` raises
  ``KeyError: 'frames'`` on the same model (its whole prefill passes
  only the tokens); ``transform`` and a cluster's merge are refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.padding import make_plan as jplan
from repro.kernels import flash_attention as JFA
from repro.kernels import ref as JR
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.request import ServeRequest as JReq
from repro_torch.configs import get_config as tget
from repro_torch.core.padding import make_plan as tplan
from repro_torch.core.scheduler import PrefillPolicy, ScaleUp
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving.cluster import ClusterEngine
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

from _torch_frontend import jitted, prompts as _prompts, reference_stream

TOL_LAYER = 1e-5
TOL = 1e-4
NEW = 8


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jget("whisper-tiny").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("whisper-tiny").reduced(),
                               dtype="float32")
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = JM.init_params(jax.random.PRNGKey(3), cfg, plan)
    model = Model.empty(tcfg, tp, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg, tp))
    return cfg, plan, params, tcfg, model


def _frames(rng, cfg, n=1):
    return rng.standard_normal((n, cfg.encoder.num_frames, cfg.d_model),
                               dtype=np.float32)


# ---------------------------------------------------------------------------
# the flash kernel's bidirectional branch

@pytest.mark.parametrize("S,Hq,kvs", [(16, 4, 4), (96, 6, 6), (256, 4, 2)])
def test_bidirectional_flash_plain_matches_pallas_and_oracle(S, Hq, kvs):
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((1, S, h, 64), dtype=np.float32)
               for h in (Hq, kvs, kvs))
    got = FA.plain(*map(torch.from_numpy, (q, k, v)), causal=False).numpy()
    pallas = np.asarray(JFA.flash_attention(q, k, v, causal=False,
                                            interpret=True))
    oracle = np.asarray(JR.flash_attention_ref(q, k, v, causal=False))
    assert np.abs(got - pallas).max() < TOL_LAYER
    assert np.abs(got - oracle).max() < TOL_LAYER
    causal = FA.plain(*map(torch.from_numpy, (q, k, v)), causal=True)
    assert np.abs(causal.numpy() - got).max() > 1e-3   # a real difference


# ---------------------------------------------------------------------------
# the encoder, its cross K/V and the cross-attention

def test_encoder_cross_kv_and_cross_attention_match_reference(pair):
    cfg, plan, params, tcfg, model = pair
    rng = np.random.default_rng(5)
    frames = _frames(rng, cfg, 2)
    st = model.static()
    with torch.no_grad():
        enc = M.run_encoder(st["encoder"], tcfg, model.plan,
                            torch.from_numpy(frames))
        ks, vs = M.encode_cross_kv(st["cross"], tcfg, model.plan, enc)
    jenc = JM.run_encoder(params, cfg, plan, jnp.asarray(frames))
    jk, jv = JM.encode_cross_kv(params, cfg, plan, jenc)
    assert np.abs(enc.numpy() - np.asarray(jenc)).max() < TOL_LAYER
    assert len(ks) == len(vs) == cfg.num_layers
    for g in range(cfg.num_layers):
        assert ks[g].shape == (2, cfg.encoder.num_frames, plan.kv_slots,
                               cfg.resolved_head_dim)
        assert np.abs(ks[g].numpy() - np.asarray(jk[g])).max() < TOL_LAYER
        assert np.abs(vs[g].numpy() - np.asarray(jv[g])).max() < TOL_LAYER
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    for g in range(cfg.num_layers):
        with torch.no_grad():
            got = B.cross_attention(st["cross"][g], torch.from_numpy(x),
                                    tcfg, model.plan, ks[g], vs[g])
        cp = jax.tree.map(lambda a: a[g], params["cross"])
        want = JM.cross_attention(cp, jnp.asarray(x), cfg, plan, jk[g],
                                  jv[g])
        assert np.abs(got.numpy() - np.asarray(want)).max() < TOL_LAYER


def test_convert_carries_every_encoder_and_cross_leaf(pair):
    cfg, plan, params, tcfg, model = pair
    sd = model.state_dict()
    enc = params["encoder"]
    np.testing.assert_array_equal(sd["encoder.frame_proj"].numpy(),
                                  np.asarray(enc["frame_proj"]))
    np.testing.assert_array_equal(sd["encoder.final_ln"].numpy(),
                                  np.asarray(enc["final_ln"]))
    for li in range(cfg.encoder.num_layers):
        blk = jax.tree.map(lambda a: np.asarray(a[li]), enc["blocks"][0])
        for part in ("attn", "mlp"):
            for k, v in blk[part].items():
                np.testing.assert_array_equal(
                    sd[f"encoder.layers.{li}.{part}.{k}"].numpy(), v)
        for k in ("ln1", "ln2"):
            np.testing.assert_array_equal(
                sd[f"encoder.layers.{li}.{k}"].numpy(), blk[k])
    for g in range(cfg.num_layers):
        for k, v in params["cross"].items():
            np.testing.assert_array_equal(sd[f"cross.{g}.{k}"].numpy(),
                                          np.asarray(v[g]))
    n_enc = sum(1 for k in sd if k.startswith(("encoder.", "cross.")))
    assert n_enc == 2 + 8 * cfg.encoder.num_layers + 5 * cfg.num_layers
    assert "vision_proj" not in sd


def test_model_prefill_and_decode_match_reference(pair):
    cfg, plan, params, tcfg, model = pair
    rng = np.random.default_rng(9)
    frames = _frames(rng, cfg, 2)
    toks = rng.integers(0, cfg.vocab_size, (2, 11 + NEW)).astype(np.int32)
    prefill, step = jitted(cfg, plan)
    jc = JM.init_decode_caches(cfg, plan, 2, 64, 8)
    jl, jc = prefill(params, batch={"tokens": jnp.asarray(toks[:, :11]),
                                    "frames": jnp.asarray(frames)},
                     caches=jc)
    tc = model.init_decode_caches(2, 64, 8)
    cross = model.init_cross_cache(2)
    with torch.no_grad():
        tl = model.prefill(torch.from_numpy(toks[:, :11]).long(), tc,
                           frames=torch.from_numpy(frames), cross=cross)
    for g in range(cfg.num_layers):
        np.testing.assert_allclose(cross.k[g].numpy(),
                                   np.asarray(jc["cross_kv"][0][g]),
                                   atol=TOL_LAYER)
    assert np.abs(tl.numpy() - np.asarray(jl)).max() < TOL
    assert np.array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    for i in range(NEW):
        pos = np.full((2,), 11 + i, np.int32)
        jl, jc = step(params, caches=jc, tokens=jnp.asarray(toks[:, 11 + i]),
                      positions=jnp.asarray(pos))
        with torch.no_grad():
            tl = model.decode_step(tc, torch.from_numpy(toks[:, 11 + i])
                                   .long(), torch.from_numpy(pos),
                                   cross=cross)
        assert np.abs(tl.numpy() - np.asarray(jl)).max() < TOL, i
        assert np.array_equal(tl.numpy().argmax(-1),
                              np.asarray(jl).argmax(-1)), i
    with pytest.raises(ValueError, match="frames"):
        model.prefill(torch.from_numpy(toks[:, :11]).long(), tc,
                      cross=cross)
    with pytest.raises(NotImplementedError, match="causal decoder-only"):
        model.prefill_chunk(torch.from_numpy(toks[:, :8]).long(),
                            torch.zeros(2, dtype=torch.int32), tc)


# ---------------------------------------------------------------------------
# engines

#: five prompts on three lengths (the reference compiles one prefill a
#: length); 23 and 40 are longer than the 16-token budget
LENS = (5, 23, 40, 23, 5)


@pytest.fixture(scope="module")
def streams(pair):
    """The reference's model-level loop for each of ``LENS``'s requests,
    each with its own frames."""
    cfg, plan, params, _, _ = pair
    rng = np.random.default_rng(13)
    prompts = _prompts(LENS, cfg.vocab_size)
    frames = list(_frames(rng, cfg, len(LENS)))
    want = [reference_stream(params, cfg, plan, p, NEW, frames=f)[0]
            for p, f in zip(prompts, frames)]
    return prompts, frames, want


def _requests(prompts, frames):
    return [ServeRequest(p, max_new_tokens=NEW, frames=f)
            for p, f in zip(prompts, frames)]


@pytest.mark.parametrize("where", ["one device", "TP1x2"])
def test_engine_streams_equal_reference_loop(pair, streams, where):
    """3 slots (4 at TP1x2: slots split over the workers), 5 requests:
    slots are reused, and each request decodes on its own frames' cross
    memory.  A 16-token budget would chunk every prompt longer than 16:
    they run whole."""
    _, _, params, tcfg, model = pair
    prompts, frames, want = streams
    kw = dict(max_seq=64, page_tokens=8,
              prefill_policy=PrefillPolicy(token_budget=16, mode="mixed"))
    if where == "one device":
        eng = Engine(tcfg, params=model, max_batch=3, device="cpu", **kw)
    else:
        # at W = 2 the padding plan pads nothing more: the same weights
        eng = Engine(tcfg, params=model, max_batch=4, devices=["cpu"] * 2,
                     **kw)
        assert eng.plan.max_tp == 2 and eng.cross[1].k[0].shape[0] == 2
    whole = []
    run_whole = eng._prefill_whole
    eng._prefill_whole = lambda r, s: (whole.append(len(r.prompt)),
                                       run_whole(r, s))
    reqs = _requests(prompts, frames)
    for r in reqs:
        eng.submit(r)
    slots = set()
    while not all(r.done for r in reqs):
        eng.step()
        slots |= {r.slot for r in reqs if r.slot >= 0}
    assert [r.generated for r in reqs] == want
    assert sorted(whole) == sorted(LENS)     # one whole prefill each
    assert len(eng.prefill_policy.chunk_sizes(40, 8)) > 1
    assert len(slots) < len(reqs)            # slots were reused


def test_reference_engine_raises_on_frames(pair):
    """The reference's engine passes only ``{"tokens": ...}`` to its
    whole prefill (``repro/serving/engine.py:1134-1146``), so its
    whisper cannot serve a request; the port's engine passes the frames
    (ROADMAP queue 3)."""
    cfg, _, params, _, _ = pair
    je = JEngine(cfg, params=params, max_batch=2, max_seq=64, page_tokens=8)
    je.submit(JReq([1, 2, 3, 4, 5], max_new_tokens=4))
    with pytest.raises(KeyError, match="frames"):
        je.run_until_done()


def test_requests_need_their_frames_and_changes_are_refused(pair):
    _, _, _, tcfg, model = pair
    eng = Engine(tcfg, params=model, max_batch=2, max_seq=64,
                 page_tokens=8, device="cpu")
    with pytest.raises(ValueError, match="needs frames"):
        eng.submit(ServeRequest([1, 2, 3], max_new_tokens=2))
    with pytest.raises(ValueError, match="needs frames"):
        eng.submit(ServeRequest([1, 2, 3], max_new_tokens=2,
                                frames=np.zeros((3, tcfg.d_model),
                                                np.float32)))
    with pytest.raises(NotImplementedError,
                       match="does not cover encoder/vision"):
        eng.transform(2)
    weng = Engine(tcfg, max_batch=2, max_seq=64, page_tokens=8,
                  devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError,
                       match="does not cover encoder/vision"):
        weng.transform(2)
    with pytest.raises(NotImplementedError,
                       match="does not cover encoder/vision"):
        weng.export_active()
    cl = ClusterEngine(tcfg, ["cpu"] * 2, n_instances=2, max_batch=1,
                       max_seq=64, page_tokens=8)
    with pytest.raises(NotImplementedError,
                       match="does not cover encoder/vision"):
        cl._execute(ScaleUp(iid=0, tp_to=2, donor_iids=(1,)))
    assert all(e.tp == 1 and not e.parked for e in cl.engines)


def test_cross_memory_is_the_slot_own(pair, streams):
    """Each slot's rows of the cross cache are its request's memory: a
    request prefilled into a slot another used before holds its own
    frames' K/V there, equal to the reference's for those frames."""
    cfg, plan, params, tcfg, model = pair
    prompts, frames, _ = streams
    eng = Engine(tcfg, params=model, max_batch=1, max_seq=64,
                 page_tokens=8, device="cpu")
    for i in (0, 1):
        r = ServeRequest(prompts[i], max_new_tokens=2, frames=frames[i])
        eng.submit(r)
        eng.run_until_done()
        jenc = JM.run_encoder(params, cfg, plan, jnp.asarray(frames[i])[None])
        jk, _ = JM.encode_cross_kv(params, cfg, plan, jenc)
        for g in range(cfg.num_layers):
            assert np.abs(eng.cross.k[g][0].numpy()
                          - np.asarray(jk[g][0])).max() < TOL_LAYER
