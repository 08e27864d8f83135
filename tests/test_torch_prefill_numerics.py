"""The bf16 numerics of the tensor-core prefill tile, modelled in plain
PyTorch on the CPU, against the JAX reference and the port's plain
versions.

The CUDA tile (``csrc/attn_wgmma.cuh``) runs only on the card, where
``chip_smoke.py`` holds it against the plain versions.  Its arithmetic
differs from theirs in one place: P is rounded to bf16 before the P.V
product on the tensor cores (the row sum l is taken from the fp32 P
before that).  ``tile_model`` below repeats that arithmetic (64-key
tiles in the kernel's walk order, fp32 scores, log2-domain online
softmax, the finite NEG_INF and the 1e-20 floor), so these tests size
the tolerance the card checks use:

    |out - want| <= 1e-4 + 2^-7 |want| + BF16_ROW_TOL * RMS(row of want)

with ``BF16_ROW_TOL = 2^-7`` (``kernels/flash_attention.py``).  One
bf16 ulp alone (the first two terms) misses 1-3% of the elements.
Inputs are made with numpy from a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as tref

NEG_INF = -1e30
LOG2E = math.log2(math.e)
BK = 64   # keys of a tile


def tile_model(q, keys, values, qpos, kpos, causal=True, window=0,
               drop_tile=None):
    """The tile's arithmetic over ``keys`` (B, Sk, kvs, dh), walked in
    64-key tiles in order (``kpos`` -1: no key).  ``drop_tile`` leaves
    one tile out (a wrong kernel, for the sensitivity check)."""
    B, S, Hq, dh = q.shape
    kvs = keys.shape[2]
    rep = Hq // kvs
    scale = LOG2E / math.sqrt(dh)
    qg = q.float().reshape(B, S, kvs, rep, dh).permute(0, 2, 3, 1, 4)
    kg = keys.float().permute(0, 2, 1, 3)        # (B, kvs, Sk, dh)
    vg = values.float().permute(0, 2, 1, 3)
    qp = qpos[:, None, None, :, None].long()
    m = torch.full((B, kvs, rep, S, 1), NEG_INF)
    l = torch.zeros((B, kvs, rep, S, 1))
    acc = torch.zeros((B, kvs, rep, S, dh))
    for t, i0 in enumerate(range(0, keys.shape[1], BK)):
        if t == drop_tile:
            continue
        kt, vt = kg[:, :, None, i0:i0 + BK], vg[:, :, None, i0:i0 + BK]
        x = (qg @ kt.transpose(-1, -2)) * scale
        p = kpos[:, None, None, None, i0:i0 + BK].long()
        ok = (p >= 0) & (qp >= 0)
        if causal:
            ok &= p <= qp
        if window > 0:
            ok &= p > qp - window
        x = torch.where(ok, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        pr = torch.exp2(x - m_new)
        l = l * corr + pr.sum(-1, keepdim=True)
        acc = acc * corr + pr.bfloat16().float() @ vt
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, dh).bfloat16()


def n_outside(out, want, rows=None) -> int:
    """Elements outside the bf16 prefill tolerance (``chip_smoke``'s)."""
    o, w = out.float(), want.float()
    if rows is not None:
        o, w = o[rows], w[rows]
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    tol = 1e-4 + 2.0 ** -7 * w.abs() + FA.BF16_ROW_TOL * rms
    return int(((o - w).abs() > tol).sum())


def _bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                            ).bfloat16()


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


def _pad_tiles(k, v, pos):
    """Pad a key segment to whole 64-key tiles (positions -1)."""
    pad = -k.shape[1] % BK
    if pad:
        z = torch.zeros((k.shape[0], pad) + k.shape[2:], dtype=k.dtype)
        k, v = torch.cat([k, z], 1), torch.cat([v, z], 1)
        pos = torch.cat([pos, torch.full((pos.shape[0], pad), -1,
                                         dtype=pos.dtype)], 1)
    return k, v, pos


def flash_case(S, window, causal, dh, Hq=8, kvs=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(rng, 1, S, Hq, dh), _bf16(rng, 1, S, kvs, dh),
               _bf16(rng, 1, S, kvs, dh))
    pos = torch.arange(S, dtype=torch.int32)[None]
    kp, vp, kpos = _pad_tiles(k, v, pos)
    return q, k, v, (kp, vp, pos, kpos)


FLASH = [  # (S, window, causal, dh): ragged S, long S, window, dh 64
    (300, 0, True, 128), (1024, 0, True, 128), (600, 256, True, 128),
    (200, 0, True, 64), (160, 0, False, 128)]


@pytest.mark.parametrize("S,window,causal,dh", FLASH)
def test_flash_tile_model_within_tolerance(S, window, causal, dh):
    q, k, v, (kp, vp, pos, kpos) = flash_case(S, window, causal, dh)
    got = tile_model(q, kp, vp, pos, kpos, causal=causal, window=window)
    want_jax = _np(jref.flash_attention_ref(_jnp(q), _jnp(k), _jnp(v),
                                            causal=causal, window=window))
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert n_outside(got, want_jax) == 0
    assert n_outside(got, want) == 0


def chunk_case(S, done, cap, P, window, pad, attend_prefix, dh=128,
               Hq=8, kvs=2, seed=1):
    """A chunk of S tokens at ``done`` over a ring of ``cap`` slots in
    pages of P (a shuffled page table), its last ``pad`` tokens padding."""
    rng = np.random.default_rng(seed)
    n = cap // P
    NP = n + 3
    pool = _bf16(rng, NP, kvs, 2, P, dh)
    pt = torch.from_numpy(rng.permutation(NP)[:n].astype(np.int32))[None]
    kvpos = torch.full((1, cap), -1, dtype=torch.int32)
    prefix = torch.arange(max(0, done - cap), done)
    kvpos[0, prefix % cap] = prefix.to(torch.int32)
    qpos = torch.arange(done, done + S, dtype=torch.int32)[None]
    if pad:
        qpos[:, S - pad:] = -1
    q, k, v = (_bf16(rng, 1, S, Hq, dh), _bf16(rng, 1, S, kvs, dh),
               _bf16(rng, 1, S, kvs, dh))
    # the tile's walk: the prefix slots in page-table order, then the
    # chunk, each in whole 64-key tiles
    kc, vc, pc = _pad_tiles(k, v, qpos)
    if attend_prefix:
        pages = pool[pt.long()]                      # (1, n, kvs, 2, P, dh)
        pk = pages[:, :, :, 0].permute(0, 1, 3, 2, 4).reshape(1, cap, kvs,
                                                              dh)
        pv = pages[:, :, :, 1].permute(0, 1, 3, 2, 4).reshape(1, cap, kvs,
                                                              dh)
        pk, pv, pp = _pad_tiles(pk, pv, kvpos)
        kc, vc = torch.cat([pk, kc], 1), torch.cat([pv, vc], 1)
        pc = torch.cat([pp, pc], 1)
    return (q, k, v, pool, pt, kvpos, qpos), (kc, vc, pc)


CHUNK = [  # (S, done, cap, P, window, pad, attend_prefix)
    (128, 384, 512, 16, 0, 0, True),      # prefix + chunk, 16-token pages
    (96, 200, 512, 64, 0, 0, True),       # prefix ending mid-page
    (256, 0, 512, 64, 0, 0, False),       # a prompt's first chunk
    (200, 1536, 1024, 64, 1024, 8, True),  # ring wrap, window, padding
    (100, 300, 512, 32, 0, 5, True),      # padding tokens
]


@pytest.mark.parametrize("S,done,cap,P,window,pad,attend_prefix", CHUNK)
def test_chunk_tile_model_within_tolerance(S, done, cap, P, window, pad,
                                           attend_prefix):
    args, (kc, vc, pc) = chunk_case(S, done, cap, P, window, pad,
                                    attend_prefix)
    q, k, v, pool, pt, kvpos, qpos = args
    rows = qpos >= 0
    got = tile_model(q, kc, vc, qpos, pc, window=window)
    want = tref.chunk_prefill_ref(q, k, v, pool.clone(), pt, kvpos, qpos,
                                  window=window,
                                  attend_prefix=attend_prefix)
    assert n_outside(got, want, rows) == 0
    if not pad:   # the reference keeps padding tokens as keys
        want_jax, _ = jref.chunk_prefill_ref(
            *(_jnp(a) if a.dtype == torch.bfloat16 else jnp.asarray(a)
              for a in args), window=window, attend_prefix=attend_prefix)
        assert n_outside(got, _np(want_jax), rows) == 0


@pytest.mark.parametrize("tile", [0, 3])
def test_tolerance_catches_a_dropped_key_tile(tile):
    """A tile that leaves out one 64-key tile of a 300-token prompt is
    outside the tolerance: it is no cover for a wrong kernel."""
    q, k, v, (kp, vp, pos, kpos) = flash_case(300, 0, True, 128)
    want = tref.flash_attention_ref(q, k, v)
    assert n_outside(tile_model(q, kp, vp, pos, kpos, drop_tile=tile),
                     want) > 0


def test_one_ulp_alone_is_too_tight():
    """Without the row term the model misses some elements: the row term
    is what P's rounding to bf16 needs, not slack."""
    q, k, v, (kp, vp, pos, kpos) = flash_case(1024, 0, True, 128)
    got = tile_model(q, kp, vp, pos, kpos).float()
    want = tref.flash_attention_ref(q, k, v).float()
    bad = int(((got - want).abs() > 1e-4 + 2.0 ** -7 * want.abs()).sum())
    assert bad > 0
