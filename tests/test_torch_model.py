"""The port's model against the JAX ``models/model.py`` on weights carried
over by ``params_from_jax`` (reduced llama3-8b, float32).

Logits of ``prefill``, ``prefill_chunk`` and ``decode_step`` agree with
the reference within 1e-4 (absolute; the frameworks sum in other
orders), and inside the port chunked prefill reproduces whole-prompt
prefill (1e-5: the chunk path's key set carries extra masked terms of
exactly zero weight, which can change a matmul's summation order).
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
from repro_torch.configs import get_config as tget
from repro_torch.core.padding import make_plan as tplan
from repro_torch.models import blocks as B
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model, build

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jget("llama3-8b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("llama3-8b").reduced(), dtype="float32")
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = JM.init_params(jax.random.PRNGKey(0), cfg, plan)
    model = Model.empty(tcfg, tp)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg, tp))
    return cfg, plan, params, model


def _tokens(cfg, B_, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B_, S)).astype(np.int32)


def _diff(j, t):
    return float(np.abs(np.asarray(j) - t.numpy()).max())


def test_prefill_and_decode_logits_match_reference(pair):
    cfg, plan, params, model = pair
    toks = _tokens(cfg, 2, 37)
    jc = JM.init_decode_caches(cfg, plan, 2, 64, 8)
    jl, jc = JM.prefill(params, cfg, plan, {"tokens": jnp.asarray(toks)}, jc)
    tc = model.init_decode_caches(2, 64, 8)
    with torch.no_grad():
        tl = model.prefill(torch.from_numpy(toks).long(), tc)
    assert _diff(jl, tl) < TOL
    for li in range(cfg.num_layers):        # the caches hold the same K/V
        np.testing.assert_allclose(
            np.asarray(jc["groups"][0].pool[li]), tc[li].pool.numpy(),
            atol=TOL)
    nxt, pos = np.array([3, 5], np.int32), np.array([37, 37], np.int32)
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


def test_prefill_chunk_matches_reference_and_whole_prompt(pair):
    cfg, plan, params, model = pair
    toks = _tokens(cfg, 1, 37, seed=1)
    jc = JM.init_decode_caches(cfg, plan, 1, 64, 8)
    tc = model.init_decode_caches(1, 64, 8)
    for start, size in [(0, 16), (16, 16), (32, 5)]:
        ch = toks[:, start:start + size]
        jl, jc = JM.prefill_chunk(params, cfg, plan, jnp.asarray(ch),
                                  jnp.asarray([start], jnp.int32), jc,
                                  first_chunk=start == 0)
        with torch.no_grad():
            tl = model.prefill_chunk(
                torch.from_numpy(ch).long(),
                torch.tensor([start], dtype=torch.int32), tc,
                first_chunk=start == 0)
        assert _diff(jl, tl) < TOL, start
    whole_c = model.init_decode_caches(1, 64, 8)
    with torch.no_grad():
        whole = model.prefill(torch.from_numpy(toks).long(), whole_c)
    assert float((whole - tl).abs().max()) < 1e-5
    for a, b in zip(whole_c, tc):
        assert torch.equal(a.positions, b.positions)
        assert torch.equal(a.seq_lens, b.seq_lens)
        assert float((a.pool - b.pool).abs().max()) < 1e-5


def test_random_init_is_seeded_and_padded():
    cfg = dataclasses.replace(tget("llama3-8b").reduced(), dtype="float32")
    plan = tplan(cfg, 2)
    a, b = build(cfg, plan, seed=3), build(cfg, plan, seed=3)
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    assert not a.embed[plan.vocab:].any()          # padded vocab rows
    assert not a.lm_head[:, plan.vocab:].any()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        B.check_kind("moe")
