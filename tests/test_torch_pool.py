"""The port's paged pool writes the reference's bytes.

The same numpy inputs (seeded) go through ``repro.paged.pool`` and
``repro_torch.paged.pool``: ``write_prefill`` (with and without a ring
wrap), ``append_token``, ``write_chunk`` (page-table and identity-page
forms) and ``gather_kv`` must give bit-identical pools, page tables,
cursors and positions in all three Table-2 layouts.  The port writes in
place; ``slot_view`` writes land in the engine's pool.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.paged import layout as jlayout
from repro.paged import pool as jp
from repro_torch.paged import layout as tlayout
from repro_torch.paged import pool as tp

LAYOUTS = ["raw", "page_friendly", "header_centric"]


def _same(js, ts):
    for a, b in zip(js, (ts.pool, ts.page_table, ts.seq_lens,
                         ts.positions)):
        assert np.array_equal(np.asarray(a), b.numpy())


def _kv(rng, *shape):
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    return k, v


def _both(fn_j, fn_t, js, ts, *arrays, **kw):
    js = fn_j(js, *[jnp.asarray(a) for a in arrays], **kw)
    fn_t(ts, *[torch.from_numpy(np.array(a)) for a in arrays], **kw)
    return js


@pytest.mark.parametrize("identity", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pool_ops_bit_identical(layout, identity):
    rng = np.random.default_rng(0)
    B, kvs, P, dh, mps = 2, 2, 4, 8, 3
    js = jp.make_state(B * mps, kvs, P, dh, B, mps, jnp.float32, layout)
    ts = tp.make_state(B * mps, kvs, P, dh, B, mps, torch.float32, layout)
    _same(js, ts)
    js = _both(jp.write_prefill, tp.write_prefill, js, ts,
               *_kv(rng, B, 7, kvs, dh), storage_layout=layout)
    _same(js, ts)
    for _ in range(3):
        js = _both(jp.append_token, tp.append_token, js, ts,
                   *_kv(rng, B, kvs, dh), storage_layout=layout)
        _same(js, ts)
    pos = np.broadcast_to(np.arange(8, 12), (B, 4)).astype(np.int32)
    js = _both(jp.write_chunk, tp.write_chunk, js, ts,
               *_kv(rng, B, 4, kvs, dh), pos, storage_layout=layout,
               identity_pages=identity)
    _same(js, ts)
    for a, b in zip(jp.gather_kv(js, layout), tp.gather_kv(ts, layout)):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_write_prefill_ring_wrap_and_scattered_pages(layout):
    """A ring cache shorter than the prompt keeps the trailing tokens,
    rolled to their ring slots; a permuted page table scatters them."""
    rng = np.random.default_rng(1)
    B, kvs, P, dh, mps = 2, 2, 4, 8, 2
    pt = rng.permutation(B * mps).reshape(B, mps).astype(np.int32)
    js = jp.make_state(B * mps, kvs, P, dh, B, mps, jnp.float32, layout)
    js = js._replace(page_table=jnp.asarray(pt))
    ts = tp.make_state(B * mps, kvs, P, dh, B, mps, torch.float32, layout)
    ts.page_table = torch.from_numpy(pt)
    js = _both(jp.write_prefill, tp.write_prefill, js, ts,
               *_kv(rng, B, 13, kvs, dh), storage_layout=layout)
    _same(js, ts)
    # a chunk that wraps the ring, through the permuted page table
    pos = np.broadcast_to(np.arange(13, 17), (B, 4)).astype(np.int32)
    js = _both(jp.write_chunk, tp.write_chunk, js, ts,
               *_kv(rng, B, 4, kvs, dh), pos, storage_layout=layout)
    _same(js, ts)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_write_chunk_padding_keeps_old_bytes(layout):
    """Padding tokens (position -1) of a chunk write no pool bytes: the
    pool equals the reference's after the chunk without its padding."""
    rng = np.random.default_rng(3)
    B, kvs, P, dh, mps = 2, 2, 4, 8, 3
    js = jp.make_state(B * mps, kvs, P, dh, B, mps, jnp.float32, layout)
    ts = tp.make_state(B * mps, kvs, P, dh, B, mps, torch.float32, layout)
    js = _both(jp.write_prefill, tp.write_prefill, js, ts,
               *_kv(rng, B, 7, kvs, dh), storage_layout=layout)
    k, v = _kv(rng, B, 6, kvs, dh)
    pos = np.broadcast_to(np.arange(7, 13), (B, 6)).astype(np.int32)
    js = jp.write_chunk(js, jnp.asarray(k[:, :4]), jnp.asarray(v[:, :4]),
                        jnp.asarray(pos[:, :4]), layout)
    padded = pos.copy()
    padded[:, 4:] = -1
    tp.write_chunk(ts, torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(padded), layout)
    assert np.array_equal(np.asarray(js.pool), ts.pool.numpy())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_slot_view_writes_land_in_the_pool(layout):
    """Writing a prompt through a slot view equals the reference's
    fresh batch-1 prefill adopted into that slot's page range."""
    rng = np.random.default_rng(2)
    B, kvs, P, dh, mps = 3, 2, 4, 8, 2
    ts = tp.make_state(B * mps, kvs, P, dh, B, mps, torch.float32, layout)
    k, v = _kv(rng, 1, 6, kvs, dh)
    tp.write_prefill(tp.slot_view(ts, 1, layout), torch.from_numpy(k),
                     torch.from_numpy(v), layout)
    one = jp.write_prefill(
        jp.make_state(mps, kvs, P, dh, 1, mps, jnp.float32, layout),
        jnp.asarray(k), jnp.asarray(v), layout)
    pool_c = tp.canonical(ts.pool, layout)
    want = np.asarray(jp.canonical(one.pool, layout))
    assert np.array_equal(pool_c[mps:2 * mps].numpy(), want)
    assert not pool_c[:mps].any() and not pool_c[2 * mps:].any()
    assert ts.seq_lens.tolist() == [0, 6, 0]
    assert np.array_equal(ts.positions[1].numpy(),
                          np.asarray(one.positions[0]))


def test_layout_permutations_match():
    for src in LAYOUTS:
        for dst in LAYOUTS:
            assert (tlayout.kv_stride_order(src, dst)
                    == jlayout.kv_stride_order(src, dst))
        assert (tlayout.pool_shape(src, 5, 4, 3, 2)
                == jlayout.pool_shape(src, 5, 4, 3, 2))
