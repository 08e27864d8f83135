"""The port's transformation planes against the JAX package: every
accounting function of ``kv_transform`` and ``weight_transform``, the
schedule costs, the schedules' step lists, the pool resize and page
import, and the sharded migration over W CPU workers.  Accounting must
give the same numbers; data-plane results must be bit-equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import kv_transform as JKT
from repro.core import transform_engine as JTE
from repro.core import weight_transform as JWT
from repro.core.padding import make_plan as jplan
from repro.kernels import page_migrate as JPM
from repro.paged import pool as jpool
from repro_torch.configs import get_config as tget
from repro_torch.core import kv_transform as TKT
from repro_torch.core import transform_engine as TTE
from repro_torch.core import weight_transform as TWT
from repro_torch.core.padding import make_plan as tplan
from repro_torch.launch.mesh import InstanceMesh, Layout, place
from repro_torch.paged import pool as tpool

LAYOUTS = ["header_centric", "page_friendly", "raw"]
MODELS = ["llama3-8b", "gemma-2b", "qwen2.5-32b", "granite-moe-3b-a800m"]


def _plans(name, tp):
    return (jget(name), jplan(jget(name), tp, mode="page"),
            tget(name), tplan(tget(name), tp, mode="page"))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("W,NP,stages", [(2, 100, 1), (4, 64, 4),
                                         (8, 37, 3)])
def test_kv_accounting_equal(layout, W, NP, stages):
    args = (layout, W, NP, 8, 64, 128, stages)
    j, t = JKT.account_scale_up(*args), TKT.account_scale_up(*args)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for overlap in (False, True):
        assert j.time_s(JKT.LinkModel(), overlap) == t.time_s(
            TKT.LinkModel(), overlap)
    assert dataclasses.asdict(JKT.sharded_migration_stats(
        W, NP, 8, 64, 128, 4)) == dataclasses.asdict(
            TKT.sharded_migration_stats(W, NP, 8, 64, 128, 4))
    assert JKT.page_bytes(8, 64, 128, 2) == TKT.page_bytes(8, 64, 128, 2)
    for headroom in (0, 5, 40):
        assert JKT.simulate_phased_migration(
            W, NP, stages, headroom) == TKT.simulate_phased_migration(
                W, NP, stages, headroom)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("tp", [2, 4])
def test_weight_accounting_and_schedule_costs_equal(name, tp):
    jc, jp, tc, tpl = _plans(name, tp)
    for padded in (True, False):
        assert JWT.mlp_layer_bytes(jc, jp, padded) == TWT.mlp_layer_bytes(
            tc, tpl, padded)
    jl, tl = JKT.LinkModel(), TKT.LinkModel()
    for method in ("padded", "partial_swap"):
        for jf, tf in ((JWT.account_scale_up, TWT.account_scale_up),
                       (JWT.account_scale_down, TWT.account_scale_down)):
            j, t = jf(jc, jp, tp, method), tf(tc, tpl, tp, method)
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            for overlap in (False, True):
                assert j.time_s(jl, overlap) == t.time_s(tl, overlap)
    jkv = JKT.account_scale_up("header_centric", tp, 64, 8, 64, 128)
    tkv = TKT.account_scale_up("header_centric", tp, 64, 8, 64, 128)
    for sched in ("up", "down"):
        jfn = JTE.scale_up_schedule if sched == "up" else \
            JTE.scale_down_schedule
        tfn = TTE.scale_up_schedule if sched == "up" else \
            TTE.scale_down_schedule
        tps = (1, tp) if sched == "up" else (tp, 1)
        js, ts = jfn(6, 2, *tps), tfn(6, 2, *tps)
        for overlap in (False, True):
            assert JTE.schedule_cost(js, jc, jp, jkv, jl, "padded",
                                     overlap) == TTE.schedule_cost(
                ts, tc, tpl, tkv, tl, "padded", overlap)
    assert JTE.seesaw_cost(jc, jp, 6, jl) == TTE.seesaw_cost(tc, tpl, 6, tl)


def _steps(sched):
    return [[(o.layer, o.component, o.overlap) for o in s]
            for s in sched.steps]


@pytest.mark.parametrize("n,lps", [(1, 1), (5, 1), (6, 2), (7, 3), (4, 0)])
def test_schedules_equal(n, lps):
    for coherent in (False, True):
        j = JTE.scale_up_schedule(n, lps, 1, 4, coherent=coherent)
        t = TTE.scale_up_schedule(n, lps, 1, 4, coherent=coherent)
        assert _steps(j) == _steps(t)
        assert (j.direction, j.tp_from, j.tp_to, j.n_steps) == (
            t.direction, t.tp_from, t.tp_to, t.n_steps)
        assert JTE.schedule_is_layer_coherent(j) == \
            TTE.schedule_is_layer_coherent(t)
    d = max(lps, 1)
    assert _steps(JTE.scale_down_schedule(n, d, 4, 1)) == _steps(
        TTE.scale_down_schedule(n, d, 4, 1))
    assert TTE.Schedule("up", 1, 4).resolved_layouts() == (Layout(1, 1),
                                                           Layout(1, 4))


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("new_mps", [2, 3, 5])
def test_resize_slot_capacity_equal(new_mps):
    B, mps, kvs, P, dh = 3, 3, 2, 4, 8
    pool = _rand((B * mps, kvs, 2, P, dh), 0)
    pos = np.full((B, mps * P), -1, np.int32)
    pos[0, :5] = np.arange(5)
    pos[2, :8] = np.arange(8)
    if new_mps < mps:
        pool.reshape(B, mps, -1)[:, new_mps:] = 0   # the trimmed pages
        pos[:, new_mps * P:] = -1                   # are empty
    pt = (np.arange(B)[:, None] * mps + np.arange(mps)).astype(np.int32)
    seq = np.array([5, 0, 8], np.int32)
    j = JKT.resize_slot_capacity(jpool.PagedState(
        *map(jnp.asarray, (pool, pt, seq, pos))), new_mps, B)
    t = TKT.resize_slot_capacity(tpool.PagedState(
        *map(torch.from_numpy, (pool, pt, seq, pos))), new_mps, B)
    for a, b in zip(j, (t.pool, t.page_table, t.seq_lens, t.positions)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_migrate_slot_pages_equal():
    src = _rand((4, 4, 2, 4, 8), 1)
    dst = _rand((12, 4, 2, 4, 8), 2)
    j = JKT.migrate_slot_pages(jnp.asarray(src), jnp.asarray(dst), 3, 6,
                               interpret=True)
    t = TKT.migrate_slot_pages(torch.from_numpy(src),
                               torch.from_numpy(dst.copy()), 3, 6)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("W", [2, 4])
def test_sharded_migration_over_workers_equals_local(W):
    NP, H, P, dh = 5, 8, 4, 8
    pools = _rand((W, NP, H, 2, P, dh), W)
    mesh = InstanceMesh(["cpu"] * W, 1)
    up, _ = TKT.migrate_sharded(
        [torch.from_numpy(pools[w].copy()) for w in range(W)], mesh, 1,
        mesh, W)
    jup = np.asarray(JPM.migrate_scale_up_local(jnp.asarray(pools),
                                                interpret=True))
    for w in range(W):
        np.testing.assert_array_equal(up[w].numpy(), jup[w])
    down, _ = TKT.migrate_sharded(up, mesh, W, mesh, 1)
    jdown = np.asarray(JPM.migrate_scale_down_local(jnp.asarray(jup),
                                                    interpret=True))
    for w in range(W):
        np.testing.assert_array_equal(down[w].numpy(), jdown[w])
        np.testing.assert_array_equal(down[w].numpy(), pools[w])
    # no worker's result aliases another's
    ptrs = {t.data_ptr() for t in up + down}
    assert len(ptrs) == 2 * W


# (ta, workers) -> (tb, workers after), and the bytes the move's kernels
# and exchange read and write, in pools: a worker in both assemblies
# copies the slice it keeps once (2x its bytes); the rest is gathered,
# exchanged (4x) and, unless it lands as whole pages, scattered (6x)
MOVES = [((1, 4), (2, 4), 3.0), ((2, 4), (4, 4), 3.5),
         ((4, 4), (2, 4), 5.0), ((2, 4), (1, 4), 4.0),
         ((1, 4), (4, 4), 3.5), ((1, 2), (1, 1), 3.0),
         ((1, 1), (1, 2), 3.0), ((1, 2), (4, 4), 3.5),
         ((4, 4), (1, 2), 5.0)]


@pytest.mark.parametrize("src,dst,pools_moved", MOVES)
def test_sharded_migration_keeps_own_slice(src, dst, pools_moved):
    """Every partial degree and worker set: each destination pool equals
    its rectangle of the global (pages x kv slots) array, and a worker
    in both assemblies keeps its slice without the exchange."""
    (ta, W), (tb, W2) = src, dst
    NPt, H, P, dh = 8, 8, 4, 8
    glob = torch.from_numpy(_rand((NPt, H, 2, P, dh), 11))

    def rect(t, n, w):
        g, pos = divmod(w, t)
        rows, cols = NPt // (n // t), H // t
        return glob[g * rows:(g + 1) * rows, pos * cols:(pos + 1) * cols]

    pools = [rect(ta, W, u).clone() for u in range(W)]
    out, moved = TKT.migrate_sharded(
        pools, InstanceMesh(["cpu"] * W, ta), ta,
        InstanceMesh(["cpu"] * W2, tb), tb)
    assert len(out) == W2
    for w in range(W2):
        assert torch.equal(out[w], rect(tb, W2, w))
    assert moved == pools_moved * glob.numel() * glob.element_size()
    assert not {o.data_ptr() for o in out} & {p.data_ptr() for p in pools}


def test_merge_and_split_references_equal():
    pools = _rand((4, 3, 4, 2, 4, 8), 7)
    j = np.asarray(JKT.merge_pools_local(jnp.asarray(pools), 4))
    t = TKT.merge_pools_local(torch.from_numpy(pools), 4)
    np.testing.assert_array_equal(j, t.numpy())
    np.testing.assert_array_equal(
        np.asarray(JKT.split_pool_local(jnp.asarray(j), 4)),
        TKT.split_pool_local(t, 4).numpy())


def test_mesh_exchanges():
    W = 3
    mesh = InstanceMesh(["cpu"] * W, 1)
    xs = [torch.full((W * 2, 3), float(w)) for w in range(W)]
    recv = mesh.all_to_all(xs)
    for w in range(W):
        assert torch.equal(recv[w][:, 0], torch.arange(W).float()
                           .repeat_interleave(2))
    red = mesh.all_reduce_sum(xs, W)
    assert all(torch.equal(r, torch.full((W * 2, 3), 3.0)) for r in red)
    assert len({r.data_ptr() for r in red}) == W
    gat = mesh.all_gather(xs, 1)
    assert all(tuple(g.shape) == (W * 2, 9) for g in gat)
    # worker w of (rep, sp, tp): replica w // (sp*tp), shard (w // tp) %
    # sp, position w % tp; sp groups are one replica at one position
    sp = InstanceMesh(["cpu"] * 8, Layout(2, 2))
    assert sp.rep == 2 and sp.sp_groups() == [[0, 2], [1, 3], [4, 6],
                                               [5, 7]]
    assert [place(Layout(2, 2), w) for w in range(4)] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    bufs = [torch.full((2, 3), -1.0) for _ in range(8)]
    for w, b in enumerate(bufs):
        b[place(Layout(2, 2), w)[1]] = float(w)
    sp.sp_all_gather(bufs, Layout(2, 2))
    assert torch.equal(bufs[2][:, 0], torch.tensor([0.0, 2.0]))
    assert torch.equal(bufs[7][:, 0], torch.tensor([5.0, 7.0]))
    with pytest.raises(ValueError):
        InstanceMesh(["cpu"] * 3, 2)
    assert str(Layout(1, 4)) == "TP4" and str(Layout(2, 2)) == "SP2xTP2"
