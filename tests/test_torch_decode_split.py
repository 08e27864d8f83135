"""The bf16 paged-decode kernel's walk (``csrc/paged_attention.cu``),
modelled in plain PyTorch on the CPU, against the JAX reference.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain version.  Two things it does differ from the plain
walk over every page, and both are modelled here:

* it walks only each row's live page range, ``live_pages(q_pos)``, cut
  evenly into the splits by ``split_pages``: ``walk_ranges`` on the CPU,
  the host model of the kernel's ``bulk::split_range``, which the
  card's check holds against the kernel's own range code;
* its arithmetic: scores in the log2 domain, an fp32 online softmax per
  split, P.V on the tensor cores with P as two bf16 terms (high and low
  part), the splits merged by ``combine_softmax_partials``.

``split_model`` repeats both.  It is held against
``repro.kernels.ref.paged_attention_ref`` (masked by ``seq_lens``) and
``repro.models.layers.paged_decode_attention`` (masked by stored
positions, windows, a wrapped ring) at the card's bf16 tolerance of one
bf16 ulp (``1e-4 + 2^-7 |want|``); a walk that drops a live page falls
outside it.  The last tests check the bound itself on pools the port's
own ``Engine`` wrote on the CPU: after chunked prefill, after decode,
after a live TP1x2 -> TP2 migration, and in a sliding-window ring.
Inputs are made with numpy from a seed.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.core.scheduler import PrefillPolicy
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as Lyr
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import ServeRequest

LOG2E = math.log2(math.e)
NEG_INF = -1e30


def stored_positions(q_pos, cap):
    """The positions ``cap`` ring slots hold once positions 0..q_pos were
    written at slot p % cap (the pools' rule); -1 where none was."""
    s = np.arange(cap)[None]
    q = np.asarray(q_pos)[:, None]
    p = q - (q - s) % cap
    return np.where(p >= 0, p, -1).astype(np.int32)


def visible(pos, q, window):
    ok = (pos >= 0) & (pos <= q)
    if window > 0:
        ok &= pos > q - window
    return ok


def _bf16(t):
    return t.bfloat16().float()


def split_model(q, pool, page_table, kv_pos, q_pos, window, splits,
                drop_page=None, p_terms=2):
    """The kernel's walk and arithmetic; bf16 (B, Hq, dh) out.
    ``drop_page`` leaves each row's live page of that index out;
    ``p_terms=1`` rounds P to one bf16, as the prefill tile does."""
    B, Hq, dh = q.shape
    NP, kvs, _, P, _ = pool.shape
    n = page_table.shape[1]
    rep = Hq // kvs
    scale = LOG2E / math.sqrt(dh)
    qg = q.float().reshape(B, kvs, rep, dh)
    ms = torch.full((splits, B, kvs, rep), NEG_INF)
    ls = torch.zeros((splits, B, kvs, rep))
    accs = torch.zeros((splits, B, kvs, rep, dh))
    walk = PA.walk_ranges(torch.as_tensor(q_pos, dtype=torch.int32), n, P,
                          window, splits)
    for b in range(B):
        lo = int(walk[b, 0, 0])
        for z in range(splits):
            j0, j1 = walk[b, z].tolist()
            m = torch.full((kvs, rep), NEG_INF)
            l = torch.zeros((kvs, rep))
            acc = torch.zeros((kvs, rep, dh))
            for j in range(j0, j1):
                if j - lo == drop_page:
                    continue
                page = pool[int(page_table[b, j])].float()  # (kvs, 2, P, dh)
                pos = kv_pos[b, j * P:(j + 1) * P]
                vis = torch.from_numpy(visible(pos.numpy(), int(q_pos[b]),
                                               window))
                s = torch.einsum("grd,gkd->grk", qg[b], page[:, 0]) * scale
                s = torch.where(vis, s, NEG_INF)
                mx = torch.maximum(m, torch.where(
                    vis, s, NEG_INF).amax(-1))
                corr = torch.exp2(m - mx)
                p = torch.where(vis, torch.exp2(s - mx[..., None]), 0.0)
                p2 = _bf16(p) + (_bf16(p - _bf16(p)) if p_terms == 2
                                 else 0.0)    # P as hi + lo bf16
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "grk,gkd->grd", p2, page[:, 1])
                m = mx
            ms[z, b], ls[z, b], accs[z, b] = m / LOG2E, l, acc
    m, l, acc = Lyr.combine_softmax_partials(ms, ls, accs, 0)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(B, Hq, dh).bfloat16()


def n_outside(out, want) -> int:
    """Elements outside one bf16 ulp (``chip_smoke``'s decode check)."""
    o, w = out.float(), want.float()
    return int(((o - w).abs() > 1e-4 + 2.0 ** -7 * w.abs()).sum())


def decode_case(q_pos, cap, P, window=0, Hq=8, kvs=2, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    B, n = len(q_pos), cap // P
    NP = B * n + 3
    pool = torch.from_numpy(rng.normal(size=(NP, kvs, 2, P, dh)).astype(
        np.float32)).bfloat16()
    pt = torch.from_numpy(rng.permutation(NP)[:B * n].reshape(B, n).astype(
        np.int32))
    q = torch.from_numpy(rng.normal(size=(B, Hq, dh)).astype(
        np.float32)).bfloat16()
    kv_pos = torch.from_numpy(stored_positions(q_pos, cap))
    qp = torch.tensor(q_pos, dtype=torch.int32)
    return q, pool, pt, kv_pos, qp


def _j(t):
    return jnp.asarray(t.float().numpy() if t.is_floating_point()
                       else t.numpy())


# (q_pos of each row, capacity, page size, window): ragged live lengths
# in long slots, 16-token pages, a window, wrapped rings
CASES = [([99, 699, 2047, 3000], 4096, 64, 0),
         ([5, 63, 64, 500], 512, 16, 0),
         ([300, 900, 1500, 2100], 2048, 64, 256),
         ([1500, 3000, 1100, 5000], 1024, 64, 1024),
         ([700, 1023, 1024, 1030], 1024, 32, 300)]


@pytest.mark.parametrize("q_pos,cap,P,window", CASES)
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_model_matches_jax_decode(q_pos, cap, P, window, splits):
    q, pool, pt, kv_pos, qp = decode_case(q_pos, cap, P, window)
    got = split_model(q, pool, pt, kv_pos, qp, window, splits)
    pages = _j(pool)[_j(pt)]
    want = jlayers.paged_decode_attention(_j(q), pages, _j(kv_pos), _j(qp),
                                          window=window)
    assert n_outside(got, torch.from_numpy(np.array(want))) == 0


@pytest.mark.parametrize("P", [16, 64])
def test_split_model_matches_seq_lens_reference(P):
    """The TPU kernel's signature: keys are a row's first seq_len tokens,
    the query at seq_len - 1 (``paged_attention`` builds positions so)."""
    seq_lens = [1, 70, 1000, 2048]
    q, pool, pt, _, _ = decode_case([s - 1 for s in seq_lens], 2048, P)
    idx = np.arange(2048)[None]
    sl = np.asarray(seq_lens)[:, None]
    kv_pos = torch.from_numpy(np.where(idx < sl, idx, -1).astype(np.int32))
    qp = torch.tensor([s - 1 for s in seq_lens], dtype=torch.int32)
    got = split_model(q, pool, pt, kv_pos, qp, 0, 8)
    want = jref.paged_attention_ref(_j(q), _j(pool), _j(pt),
                                    jnp.asarray(seq_lens, jnp.int32))
    assert n_outside(got, torch.from_numpy(np.array(want))) == 0


@pytest.mark.parametrize("drop", [0, 5])
def test_tolerance_catches_a_dropped_page(drop):
    q_pos, cap, P, window = CASES[0]
    q, pool, pt, kv_pos, qp = decode_case(q_pos, cap, P, window)
    want = jlayers.paged_decode_attention(_j(q), _j(pool)[_j(pt)],
                                          _j(kv_pos), _j(qp))
    got = split_model(q, pool, pt, kv_pos, qp, window, 4, drop_page=drop)
    assert n_outside(got, torch.from_numpy(np.array(want))) > 0


def test_one_bf16_term_of_p_is_too_coarse():
    """P rounded to a single bf16 before P.V (as the prefill tile does)
    moves some outputs by more than one bf16 ulp: the low term is what
    the decode check needs, not slack."""
    q, pool, pt, kv_pos, qp = decode_case(*CASES[0])
    want = torch.from_numpy(np.array(jlayers.paged_decode_attention(
        _j(q), _j(pool)[_j(pt)], _j(kv_pos), _j(qp))))
    assert n_outside(split_model(q, pool, pt, kv_pos, qp, 0, 4), want) == 0
    assert n_outside(split_model(q, pool, pt, kv_pos, qp, 0, 4, p_terms=1),
                     want) > 0


def _visible_slots_in_range(kv_pos, q_pos, P, window):
    """Every slot holding a key visible at its row's query lies in the
    row's live range; the range's last page holds the query's own slot
    when the row has not wrapped.  Returns the rows checked."""
    B, cap = kv_pos.shape
    n = cap // P
    rows = 0
    for b in range(B):
        q = int(q_pos[b])
        if q < 0:
            continue
        lo, hi = PA.live_pages(q, n, P, window)
        slots = np.nonzero(visible(kv_pos[b], q, window))[0]
        assert all(lo <= s // P < hi for s in slots), (b, q, lo, hi)
        if q < cap:
            assert hi - 1 == (q % cap) // P
        rows += 1
    return rows


@pytest.mark.parametrize("window", [0, 100, 333])
def test_live_range_bound_on_ring_rule(window):
    """Brute force over positions 0..3000 in rings of 512 and 2048
    slots of 16 and 64 tokens."""
    for cap, P in ((512, 16), (2048, 64)):
        q_pos = np.arange(0, 3001, 7)
        kv_pos = stored_positions(q_pos, cap)
        assert _visible_slots_in_range(kv_pos, q_pos, P, window) == len(
            q_pos)


def test_split_pages_cut_the_range_evenly():
    for lo, hi in ((0, 0), (0, 1), (3, 35), (10, 129)):
        for splits in (1, 2, 9, 40):
            parts = [PA.split_pages(lo, hi, z, splits)
                     for z in range(splits)]
            assert parts[0][0] == lo and parts[-1][1] == hi
            assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
            sizes = [j1 - j0 for j0, j1 in parts]
            assert max(sizes) - min(sizes) <= 1


def test_walk_ranges_by_hand():
    """Rows of 128 pages of 64 slots cut in 3 splits: idle, the first
    position, 100 and 701 live positions, a window of 1024 at 5000, and
    a row past its capacity (every page)."""
    q = torch.tensor([-1, 0, 99, 700, 4999, 9000], dtype=torch.int32)
    got = PA.walk_ranges(q, 128, 64, 0, 3).tolist()
    assert got[:4] == [[[0, 0], [0, 0], [0, 0]], [[0, 0], [0, 0], [0, 1]],
                       [[0, 0], [0, 1], [1, 2]], [[0, 3], [3, 7], [7, 11]]]
    assert got[5] == [[0, 42], [42, 85], [85, 128]]
    assert PA.walk_ranges(q, 128, 64, 1024, 3).tolist()[4] == [
        [62, 67], [67, 73], [73, 79]]


def _engine_positions(eng):
    """Every layer's (kv positions, next query position) of the engine's
    caches as the reference's global arrays hold them."""
    out = []
    for c in eng.global_caches():
        pos = c.positions.numpy()
        out.append((pos, pos.max(axis=1)))
    return out


def _check_engine(eng, P, window=0) -> int:
    rows = 0
    for pos, last in _engine_positions(eng):
        # the query of the next decode step sits one past the last key;
        # the step of the last key had its query there
        for q in (last, np.where(last >= 0, last + 1, -1)):
            rows += _visible_slots_in_range(pos, q, P, window)
    return rows


def test_live_range_bound_on_engine_pools_through_migration():
    """Pools the port's two-worker engine wrote on the CPU (reduced
    llama3-8b, fp32): after chunked prefill, after decode steps, and
    after a live TP1x2 -> TP2 migration."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    eng = Engine(cfg, devices=["cpu"] * 2, seed=0, max_batch=2, max_seq=128,
                 page_tokens=16,
                 prefill_policy=PrefillPolicy(token_budget=24, mode="mixed"))
    reqs = [ServeRequest(list(range(3 + i, 60 + 7 * i)), max_new_tokens=40)
            for i in range(2)]
    for r in reqs:
        eng.submit(r)
    while any(not r.generated for r in reqs):
        eng.step()                      # chunked prefill (24-token chunks)
    assert _check_engine(eng, 16) > 0
    for _ in range(5):
        eng.step()
    assert _check_engine(eng, 16) > 0
    eng.transform(2)
    while eng.transforming:
        eng.step()
    assert eng.tp == 2
    assert _check_engine(eng, 16) > 0
    eng.step()
    assert _check_engine(eng, 16) > 0


def test_live_range_bound_on_a_sliding_ring():
    """A single-device engine whose attention is a 48-token sliding
    window keeps a 48-slot ring that wraps: rows past it keep every
    page, the others are bounded on both sides."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32", attention="sliding",
                              window=48)
    eng = Engine(cfg, max_batch=2, max_seq=128, page_tokens=16,
                 device="cpu", seed=0)
    reqs = [ServeRequest(list(range(5, 25)), max_new_tokens=50),
            ServeRequest(list(range(7, 70)), max_new_tokens=10)]
    for r in reqs:
        eng.submit(r)
    checked = 0
    for _ in range(12):
        eng.step()
        for pos, last in _engine_positions(eng):
            assert pos.shape[1] == 48
            for q in (last, np.where(last >= 0, last + 1, -1)):
                checked += _visible_slots_in_range(pos, q, 16, 48)
    assert checked > 0
