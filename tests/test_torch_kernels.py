"""The plain versions of the port's CUDA kernels against the JAX
reference, on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds each against its plain version there).  Here the same seeded
numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode, their jnp mirrors and oracles) and through the port's
wrappers, which on CPU tensors run the plain versions.

Tolerances: float32 throughout; 1e-5 absolute on attention outputs of
O(1) values (the two frameworks sum in other orders).  Pools after a
chunk write must be bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_prefill as jcp
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.models import layers as jlyr
from repro_torch.kernels import chunk_prefill as CP
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as tlyr

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


def test_paged_attention_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    B, Hq, kvs, P, dh, n = 2, 4, 2, 8, 16, 3
    NP = B * n + 2
    q = rng.normal(size=(B, Hq, dh)).astype(np.float32)
    pool = rng.normal(size=(NP, kvs, 2, P, dh)).astype(np.float32)
    pt = rng.permutation(NP)[:B * n].reshape(B, n).astype(np.int32)
    sl = np.array([5, 19], np.int32)
    want = jpa.paged_attention(jnp.asarray(q), jnp.asarray(pool),
                               jnp.asarray(pt), jnp.asarray(sl),
                               interpret=True)
    got = PA.paged_attention(_t(q), _t(pool), _t(pt), _t(sl))
    _close(want, got)
    _close(jref.paged_attention_ref(jnp.asarray(q), jnp.asarray(pool),
                                    jnp.asarray(pt), jnp.asarray(sl)), got)
    assert PA.launches == 0      # CPU tensors never reach the kernel


@pytest.mark.parametrize("window", [0, 12])
def test_paged_decode_matches_reference_page_walk(window):
    """Masked by stored positions (ring slots, empty slots, filler past
    the query), as the engine decodes."""
    rng = np.random.default_rng(1)
    B, Hq, kvs, P, dh, n = 3, 8, 2, 4, 16, 5
    q = rng.normal(size=(B, Hq, dh)).astype(np.float32)
    pool = rng.normal(size=(B * n, kvs, 2, P, dh)).astype(np.float32)
    pt = np.arange(B * n).reshape(B, n).astype(np.int32)
    pos = np.full((B, n * P), -1, np.int32)
    pos[0, :9] = np.arange(9)
    pos[1] = (np.arange(n * P) + 20) % (n * P) + 3   # a wrapped ring
    pos[2, :14] = np.arange(14)                       # filler past q_pos
    qpos = np.array([8, 30, 10], np.int32)
    pages = pool[pt]
    want = jlyr.paged_decode_attention(jnp.asarray(q), jnp.asarray(pages),
                                       jnp.asarray(pos), jnp.asarray(qpos),
                                       window=window)
    got = PA.paged_decode(_t(q), _t(pool), _t(pt), _t(pos), _t(qpos),
                          window=window)
    _close(want, got)


def _chunk_case(B, Hq, kvs, P, mps, dh, S, done, seed):
    """``done`` tokens already in the pool (ring-wrapped past the
    capacity); the chunk starts at position ``done``."""
    rng = np.random.default_rng(seed)
    cap = mps * P
    pool = rng.normal(size=(B * mps, kvs, 2, P, dh)).astype(np.float32)
    pt = rng.permutation(B * mps).reshape(B, mps).astype(np.int32)
    kvpos = np.full((B, cap), -1, np.int32)
    for p in range(max(0, done - cap), done):
        kvpos[:, p % cap] = p
    qpos = np.broadcast_to(done + np.arange(S), (B, S)).astype(np.int32)
    q = rng.normal(size=(B, S, Hq, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, kvs, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, kvs, dh)).astype(np.float32)
    return q, k, v, pool, pt, kvpos, qpos


# name, B, Hq, kvs, P, mps, dh, S, done, window, attend_prefix
CHUNK_CASES = [
    ("gqa_partial_page", 2, 8, 4, 8, 4, 16, 12, 16, 0, True),
    ("first_chunk", 2, 8, 4, 8, 4, 16, 12, 0, 0, False),
    ("window", 2, 8, 4, 8, 4, 16, 12, 16, 12, True),
    ("ring_wrap", 1, 8, 4, 8, 2, 16, 8, 24, 16, True),
    ("rep1_full_pages", 2, 4, 4, 8, 4, 16, 16, 8, 0, True),
]


@pytest.mark.parametrize("case", CHUNK_CASES, ids=[c[0] for c in CHUNK_CASES])
def test_chunk_prefill_matches_reference(case):
    _, B, Hq, kvs, P, mps, dh, S, done, window, prefix = case
    q, k, v, pool, pt, kvpos, qpos = _chunk_case(B, Hq, kvs, P, mps, dh, S,
                                                 done, seed=S + done)
    args = [jnp.asarray(a) for a in (q, k, v, pool, pt, kvpos, qpos)]
    want, want_pool = jcp.chunk_prefill_jnp(*args, window=window,
                                            attend_prefix=prefix)
    oracle, _ = jref.chunk_prefill_ref(*args, window=window,
                                       attend_prefix=prefix)
    tpool = _t(pool)
    got = CP.chunk_prefill_attention(_t(q), _t(k), _t(v), tpool, _t(pt),
                                     _t(kvpos), _t(qpos), window=window,
                                     attend_prefix=prefix)
    _close(want, got)
    _close(oracle, got)
    assert np.array_equal(np.asarray(want_pool), tpool.numpy())
    assert CP.launches == 0


@pytest.mark.parametrize("window", [0, 12])
def test_chunk_prefill_padding_is_no_key_and_keeps_pool_bytes(window):
    """A chunk with trailing padding (position -1) gives the reference's
    output for its real tokens and the reference's pool for the chunk
    without the padding: padding is no key and writes nothing."""
    B, Hq, kvs, P, mps, dh, S, done, pad = 2, 8, 4, 8, 4, 16, 12, 16, 5
    q, k, v, pool, pt, kvpos, qpos = _chunk_case(B, Hq, kvs, P, mps, dh, S,
                                                 done, seed=7)
    real = S - pad
    args = [jnp.asarray(a) for a in (q[:, :real], k[:, :real], v[:, :real],
                                     pool, pt, kvpos, qpos[:, :real])]
    want, want_pool = jcp.chunk_prefill_jnp(*args, window=window)
    padded = qpos.copy()
    padded[:, real:] = -1
    tpool = _t(pool)
    got = CP.chunk_prefill_attention(_t(q), _t(k), _t(v), tpool, _t(pt),
                                     _t(kvpos), _t(padded), window=window)
    _close(want, got[:, :real])
    assert np.array_equal(np.asarray(want_pool), tpool.numpy())


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("S,window", [(37, 0), (64, 0), (45, 16)])
def test_flash_attention_matches_reference(rep, S, window):
    rng = np.random.default_rng(rep * 100 + S)
    B, Hkv, dh = 2, 2, 16
    q = rng.normal(size=(B, S, Hkv * rep, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window)
    got = FA.flash_attention(_t(q), _t(k), _t(v), window=window)
    _close(want, got)
    assert FA.launches == 0


def test_chunked_attention_and_partial_combine_match_reference():
    rng = np.random.default_rng(3)
    B, Sq, Sk, Hkv, rep, dh = 2, 5, 40, 2, 2, 8
    q = rng.normal(size=(B, Sq, Hkv * rep, dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, dh)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(30, 35), (B, Sq)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(Sk), (B, Sk)).astype(np.int32)
    valid = rng.random((B, Sk)) > 0.2
    want = jlyr.chunked_attention(*map(jnp.asarray, (q, k, v, qpos, kpos)),
                                  kv_valid=jnp.asarray(valid), window=9,
                                  kv_chunk=16)
    got = tlyr.chunked_attention(*map(_t, (q, k, v, qpos, kpos)),
                                 kv_valid=_t(valid), window=9, kv_chunk=16)
    _close(want, got)
    m = rng.normal(size=(3, 4, 5)).astype(np.float32)
    l = rng.random((3, 4, 5)).astype(np.float32)
    acc = rng.normal(size=(3, 4, 5, 6)).astype(np.float32)
    for a, b in zip(jlyr.combine_softmax_partials(*map(jnp.asarray,
                                                       (m, l, acc))),
                    tlyr.combine_softmax_partials(*map(_t, (m, l, acc)))):
        _close(a, b)


def test_dispatch_is_by_device_only():
    cpu = torch.zeros(2)
    assert ops.on_card(cpu, cpu) is False
    with pytest.raises(ValueError):
        ops.on_card(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        ops.on_card(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        ops.dtype_code(torch.zeros(2, dtype=torch.float16))


def _c_entries():
    from repro_torch.kernels import _build
    return [(lib, fn, argtypes)
            for lib, fns in sorted(_build.SIGNATURES.items())
            for fn, argtypes in sorted(fns.items())]


@pytest.mark.parametrize("lib,fn,argtypes", _c_entries(),
                         ids=[f"{e[0]}.{e[1]}" for e in _c_entries()])
def test_c_entry_points_match_their_bindings(lib, fn, argtypes):
    """Each ``extern "C"`` entry point of ``csrc/<lib>.cu`` takes, in
    order, the pointers and ints its ctypes binding passes (a binding
    that drifts from its source would pass the kernel garbage)."""
    import ctypes
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    assert m, fn
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.startswith("int ") for p in params), params
    assert kinds == list(argtypes)
