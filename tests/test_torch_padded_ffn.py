"""The port's padded FFN (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode and its oracle
``padded_ffn_ref``, over weights in the per-shard Eq. 2 layout: tp in
{1, 2, 4}, shards with zero tails (ff < ffp) and without, and token
counts that no block divides.

Tolerance: float32, 1e-5 absolute on outputs of O(1) (the frameworks
sum in other orders; the weights are scaled so outputs stay O(1)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import weight_transform as JWT
from repro.kernels import ref as jref
from repro.kernels.padded_ffn import padded_ffn as jffn
from repro_torch.core import weight_transform as TWT
from repro_torch.kernels import padded_ffn as PF

ATOL = 1e-5

# T, d, real ff a shard, zero tail a shard, tp
CASES = [(16, 64, 64, 0, 1), (16, 64, 32, 32, 2), (32, 32, 32, 16, 4),
         (8, 64, 96, 32, 2)]


def _weights(T, d, ffs, pad, tp, seed):
    rng = np.random.default_rng(seed)
    ff, ffp = ffs * tp, (ffs + pad) * tp
    x = rng.normal(size=(T, d)).astype(np.float32)
    u = (rng.normal(size=(d, 2 * ff)) / np.sqrt(d)).astype(np.float32)
    dn = (rng.normal(size=(ff, d)) / np.sqrt(ff)).astype(np.float32)
    gate, up = np.split(u, 2, axis=1)
    wi = np.concatenate([
        np.asarray(JWT.pad_columns_for_tp(jnp.asarray(gate), ff, ffp, tp)),
        np.asarray(JWT.pad_columns_for_tp(jnp.asarray(up), ff, ffp, tp))],
        axis=1)
    wo = np.array(JWT.pad_rows_for_tp(jnp.asarray(dn), ff, ffp, tp))
    return x, u, dn, wi, wo, ff, ffp


@pytest.mark.parametrize("T,d,ffs,pad,tp", CASES)
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_plain_matches_pallas_and_oracle(T, d, ffs, pad, tp, act):
    x, u, dn, wi, wo, ff, ffp = _weights(T, d, ffs, pad, tp, seed=T + tp)
    got = PF.padded_ffn(torch.from_numpy(x), torch.from_numpy(wi),
                        torch.from_numpy(wo), tp=tp, ff=ff, activation=act)
    want = jffn(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo), tp=tp,
                ff=ff, activation=act, block_t=8, block_f=16,
                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.padded_ffn_ref(
            jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo), act)),
        atol=ATOL, rtol=0)
    # the unpadded FFN (paper Eq. 1): the padding is invisible
    np.testing.assert_allclose(
        got.numpy(), TWT.ffn_reference(torch.from_numpy(x),
                                       torch.from_numpy(u),
                                       torch.from_numpy(dn), act).numpy(),
        atol=ATOL, rtol=0)
    assert PF.launches == 0


@pytest.mark.parametrize("T", [1, 5, 37])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_ragged_tokens_match_oracle(T, tp):
    x, u, dn, wi, wo, ff, ffp = _weights(T, 32, 24, 8, tp, seed=100 + T)
    got = PF.padded_ffn(torch.from_numpy(x), torch.from_numpy(wi),
                        torch.from_numpy(wo), tp=tp, ff=ff)
    want = jref.padded_ffn_ref(jnp.asarray(x), jnp.asarray(wi),
                               jnp.asarray(wo), "swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gelu_ignores_up_half_as_pallas():
    x, u, dn, wi, wo, ff, ffp = _weights(16, 32, 32, 16, 2, seed=7)
    got = PF.padded_ffn(torch.from_numpy(x), torch.from_numpy(wi),
                        torch.from_numpy(wo), tp=2, ff=ff, activation="gelu")
    want = jffn(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo), tp=2,
                ff=ff, activation="gelu", block_t=8, block_f=16,
                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_relayout_of_global_tail_padding(tp):
    """The reference's init pads d_ff at the global tail; the port's
    re-layout into per-shard tails keeps the function and equals
    ``pad_columns_for_tp`` / ``pad_rows_for_tp`` of the real weights."""
    rng = np.random.default_rng(tp)
    d, ff, ffp = 32, 48 * tp, 64 * tp
    gate, up = rng.normal(size=(2, d, ff)).astype(np.float32)
    dn = rng.normal(size=(ff, d)).astype(np.float32)
    z = np.zeros((d, ffp - ff), np.float32)
    wi_tail = np.concatenate([gate, z, up, z], axis=1)
    wo_tail = np.concatenate([dn, np.zeros((ffp - ff, d), np.float32)])
    wi, wo = TWT.relayout_mlp_for_tp(torch.from_numpy(wi_tail),
                                     torch.from_numpy(wo_tail), ff, tp)
    want_wi = np.concatenate([
        np.asarray(JWT.pad_columns_for_tp(jnp.asarray(gate), ff, ffp, tp)),
        np.asarray(JWT.pad_columns_for_tp(jnp.asarray(up), ff, ffp, tp))],
        axis=1)
    np.testing.assert_array_equal(wi.numpy(), want_wi)
    np.testing.assert_array_equal(
        wo.numpy(), np.asarray(JWT.pad_rows_for_tp(jnp.asarray(dn), ff, ffp,
                                                   tp)))
