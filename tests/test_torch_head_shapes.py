"""Every registered head shape on the port's attention kernels.

1. The three CUDA wrappers' shape predicates (``supports``) accept the
   head shape (Hq / kv heads / dh) of every config in
   ``configs/registry.py`` whose layers reach an attention kernel, in
   float32 and bfloat16, with 16- and 64-token pages, and refuse shapes
   outside the kernels' set (no fallback: the wrapper raises on those).
2. For each distinct registered head shape, the reference's Pallas
   kernels (interpret mode: ``flash_attention``, ``paged_attention``,
   ``chunk_prefill_attention``) against the port's wrappers on CPU
   tensors (their plain versions), at a small size: float32, 1e-5
   absolute on O(1) outputs (the frameworks sum in other orders), the
   chunk's pool bytes equal.
3. Reduced configs that keep qwen2.5-32b's rep 5, stablelm-12b's dh 160
   and gemma-2b's dh 256 (MQA), 2 layers, float32: the port's model
   against the reference's on weights carried over by
   ``params_from_jax``: whole-prompt prefill, chunked prefill and decode
   logits within 1e-4 (as ``tests/test_torch_model.py``), and equal
   greedy streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.padding import make_plan as jplan
from repro.kernels import chunk_prefill as jcp
from repro.kernels import flash_attention as jfa
from repro.kernels import paged_attention as jpa
from repro.models import model as JM
from repro_torch.configs import get_config as tget
from repro_torch.configs.registry import all_configs
from repro_torch.core.padding import make_plan as tplan
from repro_torch.kernels import chunk_prefill as CP
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

ATOL = 1e-5
ATTENTION_KINDS = {"attn", "sliding", "moe"}
DTYPES = (torch.float32, torch.bfloat16)


def _attention_configs():
    """Registered configs whose layers run an attention kernel (xlstm's
    mLSTM / sLSTM blocks reach none)."""
    return {n: c for n, c in all_configs(True).items()
            if ATTENTION_KINDS & set(c.pattern)}


def _shape(cfg):
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


CONFIGS = _attention_configs()
SHAPES = sorted({_shape(c) for c in CONFIGS.values()})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_registered_head_shape_is_supported(name):
    Hq, kvs, dh = _shape(CONFIGS[name])
    for dtype in DTYPES:
        assert FA.supports(Hq, kvs, dh, dtype), (name, dtype)
        for P in (16, 64):
            assert CP.supports(Hq, kvs, dh, dtype, P=P), (name, dtype, P)
            assert PA.supports(Hq, kvs, dh, dtype, P=P), (name, dtype, P)


def test_shapes_outside_the_kernels_are_refused():
    bf = torch.bfloat16
    for m in (FA, CP, PA):
        assert not m.supports(4, 4, 512, bf)          # xlstm's dh
        assert not m.supports(4, 4, 80, bf)           # no such tile
        assert not m.supports(6, 4, 64, bf)           # Hq % kvs != 0
        assert not m.supports(8, 1, 64, torch.float16)
    assert FA.supports(64, 1, 128, bf) and not FA.supports(65, 1, 128, bf)
    assert CP.supports(64, 1, 128, bf) and not CP.supports(65, 1, 128, bf)
    assert PA.supports(16, 1, 256, bf) and not PA.supports(17, 1, 256, bf)
    # bf16 tiles: chunk pages that tile 64 keys, decode pages of 16k
    assert not CP.supports(32, 8, 128, bf, P=48)
    assert CP.supports(32, 8, 128, torch.float32, P=48)
    assert not PA.supports(32, 8, 128, bf, P=8)
    assert PA.supports(32, 8, 128, torch.float32, P=8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(want, got, atol=ATOL):
    np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}-{b}-{c}"
                                               for a, b, c in SHAPES])
def test_flash_attention_matches_pallas_interpret(shape):
    Hq, kvs, dh = shape
    rng = np.random.default_rng(Hq + dh)
    S = 64
    q = rng.normal(size=(1, S, Hq, dh)).astype(np.float32)
    k = rng.normal(size=(1, S, kvs, dh)).astype(np.float32)
    v = rng.normal(size=(1, S, kvs, dh)).astype(np.float32)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = FA.flash_attention(_t(q), _t(k), _t(v))
    _close(want, got)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}-{b}-{c}"
                                               for a, b, c in SHAPES])
def test_paged_attention_matches_pallas_interpret(shape):
    Hq, kvs, dh = shape
    rng = np.random.default_rng(Hq * dh)
    B, P, n = 2, 16, 3
    NP = B * n + 1
    q = rng.normal(size=(B, Hq, dh)).astype(np.float32)
    pool = rng.normal(size=(NP, kvs, 2, P, dh)).astype(np.float32)
    pt = rng.permutation(NP)[:B * n].reshape(B, n).astype(np.int32)
    sl = np.array([21, 48], np.int32)
    want = jpa.paged_attention(*map(jnp.asarray, (q, pool, pt, sl)),
                               interpret=True)
    got = PA.paged_attention(_t(q), _t(pool), _t(pt), _t(sl))
    _close(want, got)


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{a}-{b}-{c}"
                                               for a, b, c in SHAPES])
def test_chunk_prefill_matches_pallas_interpret(shape):
    """A 16-token chunk at position 32 over its paged prefix, 16-token
    pages, one slot of 64 tokens."""
    Hq, kvs, dh = shape
    rng = np.random.default_rng(Hq + 3 * dh)
    P, mps, S, done = 16, 4, 16, 32
    cap = mps * P
    pool = rng.normal(size=(mps, kvs, 2, P, dh)).astype(np.float32)
    pt = rng.permutation(mps)[None].astype(np.int32)
    kvpos = np.full((1, cap), -1, np.int32)
    kvpos[0, :done] = np.arange(done)
    qpos = (done + np.arange(S))[None].astype(np.int32)
    q = rng.normal(size=(1, S, Hq, dh)).astype(np.float32)
    k = rng.normal(size=(1, S, kvs, dh)).astype(np.float32)
    v = rng.normal(size=(1, S, kvs, dh)).astype(np.float32)
    want, want_pool = jcp.chunk_prefill_attention(
        *map(jnp.asarray, (q, k, v, pool, pt, kvpos, qpos)), interpret=True)
    tpool = _t(pool)
    got = CP.chunk_prefill_attention(_t(q), _t(k), _t(v), tpool, _t(pt),
                                     _t(kvpos), _t(qpos))
    _close(want, got)
    assert np.array_equal(np.asarray(want_pool), tpool.numpy())


# ---------------------------------------------------------------------------
# the models at those head shapes

#: reduced configs (2 layers) keeping each model's head shape in small
#: widths: qwen2.5-32b's rep 5 (40 / 8 at dh 128), stablelm-12b's dh 160
#: (rep 4), gemma-2b's dh 256 with one kv head (MQA, rep 8)
MODELS = {
    "qwen2.5-32b": dict(num_heads=10, num_kv_heads=2, head_dim=128),
    "stablelm-12b": dict(num_heads=4, num_kv_heads=1, head_dim=160),
    "gemma-2b": dict(num_heads=8, num_kv_heads=1, head_dim=256),
}
TOL = 1e-4


def _pair(name):
    over = dict(MODELS[name], dtype="float32")
    cfg = dataclasses.replace(jget(name).reduced(), **over)
    tcfg = dataclasses.replace(tget(name).reduced(), **over)
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = JM.init_params(jax.random.PRNGKey(5), cfg, plan)
    model = Model.empty(tcfg, tp, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg, tp))
    return cfg, plan, params, model


def _diff(j, t):
    return float(np.abs(np.asarray(j) - t.numpy()).max())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_at_the_head_shape_matches_reference(name):
    cfg, plan, params, model = _pair(name)
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim) == (
        MODELS[name]["num_heads"] // MODELS[name]["num_kv_heads"],
        MODELS[name]["head_dim"])
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (1, 37)).astype(np.int32)
    # whole-prompt prefill
    jc = JM.init_decode_caches(cfg, plan, 1, 64, 16)
    jl, jc = JM.prefill(params, cfg, plan, {"tokens": jnp.asarray(toks)}, jc)
    tc = model.init_decode_caches(1, 64, 16)
    with torch.no_grad():
        tl = model.prefill(torch.from_numpy(toks).long(), tc)
    assert _diff(jl, tl) < TOL
    # chunked prefill (16-token pages, page-aligned chunks)
    jcc = JM.init_decode_caches(cfg, plan, 1, 64, 16)
    tcc = model.init_decode_caches(1, 64, 16)
    for start, size in [(0, 16), (16, 16), (32, 5)]:
        ch = toks[:, start:start + size]
        jlc, jcc = JM.prefill_chunk(params, cfg, plan, jnp.asarray(ch),
                                    jnp.asarray([start], jnp.int32), jcc,
                                    first_chunk=start == 0)
        with torch.no_grad():
            tlc = model.prefill_chunk(
                torch.from_numpy(ch).long(),
                torch.tensor([start], dtype=torch.int32), tcc,
                first_chunk=start == 0)
        assert _diff(jlc, tlc) < TOL, start
    # greedy decode from the whole-prompt caches: logits and tokens
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
    assert np.array_equal(nxt, tl[:, -1].argmax(-1).numpy())
    pos = np.array([37], np.int32)
    stream_j, stream_t = [int(nxt[0])], [int(nxt[0])]
    tn = torch.from_numpy(nxt).long()
    for step in range(6):
        jl, jc = JM.decode_step(params, cfg, plan, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        with torch.no_grad():
            tl = model.decode_step(tc, tn, torch.from_numpy(pos))
        assert _diff(jl, tl) < TOL, step
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        tn = tl.argmax(-1)
        stream_j.append(int(nxt[0]))
        stream_t.append(int(tn[0]))
        pos = pos + 1
    assert stream_j == stream_t
