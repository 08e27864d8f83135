"""The port's page-migration kernels (plain versions, on the CPU) and
drivers against the JAX package's Pallas kernels in interpret mode.

Migration only moves bytes, so every comparison is bit-equal: the same
seeded numpy pools through both, including pages no segment names
(which must keep their bytes), head slices of 1, 2 and 4 heads, float32
and bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_transform as JKT
from repro.kernels import page_migrate as JPM
from repro_torch.core import kv_transform as TKT
from repro_torch.kernels import page_migrate as PM

W, NP, H, P, dh = 4, 6, 8, 4, 8
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pools(dtype, shape, seed=0):
    td, jd = DTYPES[dtype]
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (jnp.asarray(a, jd),
            torch.from_numpy(a).to(td))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hps", [1, 2, 4])
def test_copy_page_slices_matches_pallas(dtype, hps):
    jsrc, tsrc = _pools(dtype, (NP, H, 2, P, dh), seed=1)
    jdst, tdst = _pools(dtype, (NP + 3, H, 2, P, dh), seed=2)
    rng = np.random.default_rng(hps)
    n = 5
    sp = rng.integers(0, NP, n).astype(np.int32)
    sh = rng.integers(0, H // hps, n).astype(np.int32)
    # distinct destinations, leaving pages no segment names
    flat = rng.permutation((NP + 3) * (H // hps))[:n]
    dp, dh_ = (flat // (H // hps)).astype(np.int32), (
        flat % (H // hps)).astype(np.int32)
    want = JPM.copy_page_slices(jsrc, jdst, *map(jnp.asarray,
                                                 (sp, sh, dp, dh_)),
                                heads_per_slice=hps, interpret=True)
    before = tdst.clone()
    got = PM.copy_page_slices(tsrc, tdst, *map(torch.from_numpy,
                                               (sp, sh, dp, dh_)),
                              heads_per_slice=hps)
    assert got is tdst                       # written in place
    np.testing.assert_array_equal(_np(got),
                                  np.asarray(want, np.float32))
    untouched = np.setdiff1d(np.arange(NP + 3), dp)
    assert untouched.size and torch.equal(got[untouched], before[untouched])
    assert PM.copy_launches == 0             # CPU never reaches the kernel


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hps", [1, 2, 4])
def test_gather_page_slices_matches_pallas(dtype, hps):
    jpool, tpool = _pools(dtype, (NP, H, 2, P, dh), seed=3)
    rng = np.random.default_rng(10 + hps)
    pages = rng.integers(0, NP, 7).astype(np.int32)
    hblk = rng.integers(0, H // hps, 7).astype(np.int32)
    want = JPM.gather_page_slices(jpool, jnp.asarray(pages),
                                  jnp.asarray(hblk), heads_per_slice=hps,
                                  interpret=True)
    got = PM.gather_page_slices(tpool, torch.from_numpy(pages),
                                torch.from_numpy(hblk), heads_per_slice=hps)
    assert tuple(got.shape) == (7, hps, 2, P, dh)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    assert PM.gather_launches == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_local_drivers_match_pallas(dtype):
    jpools, tpools = _pools(dtype, (W, NP, H, 2, P, dh), seed=4)
    jup = JPM.migrate_scale_up_local(jpools, interpret=True)
    tup = PM.migrate_scale_up_local(tpools)
    np.testing.assert_array_equal(_np(tup), np.asarray(jup, np.float32))
    jdown = JPM.migrate_scale_down_local(jup, interpret=True)
    tdown = PM.migrate_scale_down_local(tup)
    np.testing.assert_array_equal(_np(tdown), np.asarray(jdown, np.float32))
    assert torch.equal(tdown, tpools)        # a round trip is the identity


@pytest.mark.parametrize("n_stages,headroom", [(1, 5), (2, 3), (3, 2),
                                                (6, 1)])
def test_staged_driver_matches_local_and_simulation(n_stages, headroom):
    jpools, tpools = _pools("float32", (W, NP, H, 2, P, dh), seed=5)
    got, peak = PM.migrate_scale_up_staged(tpools, n_stages, headroom)
    assert torch.equal(got, PM.migrate_scale_up_local(tpools))
    jgot, jpeak = JPM.migrate_scale_up_staged(jpools, n_stages, headroom,
                                              interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    sim_peak, fits = TKT.simulate_phased_migration(W, NP, n_stages,
                                                   headroom)
    assert fits
    assert peak == jpeak == sim_peak
    assert (sim_peak, fits) == JKT.simulate_phased_migration(
        W, NP, n_stages, headroom)


def test_staged_driver_overflow_raises():
    _, tpools = _pools("float32", (W, NP, H, 2, P, dh), seed=6)
    with pytest.raises(RuntimeError, match="stage overflow"):
        PM.migrate_scale_up_staged(tpools, n_stages=1, headroom_pages=1)
