"""The bf16 numerics and the TMA box plan of the tensor-core padded FFN
(``csrc/padded_ffn.cu``), modelled in plain PyTorch on the CPU, against
the JAX reference and the Pallas kernel in interpret mode.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain version.  ``ffn_model`` repeats its order of
operations from the wrapper's own ``plan`` (which the kernel walks as
given): operands in the input type, fp32 sums over 64-deep K tiles
walked in order (one accumulator carried over the whole K: no promotion
interval), each split's partial stored in the plan's workspace in the
kernel's layout and summed in split order by the second pass, ``h = f(g) * u`` rounded to the
input type between the products (the down product reads bf16 on the
tensor cores), the down product's K walked over (shard, tile) boxes cut
at each shard's real width.

* In float32 the model is the kernel's walk with no rounding: it equals
  the Pallas kernel and the JAX oracle to 1e-5, so the plan visits every
  real column once, splits and all.
* In bf16 it is held, at the card's tolerance

      |out - want| <= 1e-4 + 2^-7 |want| + FFN_ROW_TOL * RMS(row of want)

  with ``FFN_ROW_TOL = 2^-8`` (``chip_smoke.py``), against the JAX
  oracle with h rounded to bf16 at the kernel's point (the oracle's own
  ``padded_ffn_ref`` gives h through an identity ``wo``) and against the
  port's plain version.  The Pallas kernel keeps h in fp32; rounding h
  moves single outputs by up to about 3 x 2^-8 of their row's RMS
  (``test_rounding_h_is_the_departure_from_pallas``).

The box-plan tests hold ``padded_ffn.weight_boxes`` (the boxes the
kernel's tensor maps read) against every registry config's padding
plan.  Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import weight_transform as JWT
from repro.kernels import ref as jref
from repro.kernels.padded_ffn import padded_ffn as jffn
from repro_torch.configs.registry import all_configs
from repro_torch.core.padding import make_plan
from repro_torch.kernels import padded_ffn as PF
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as Lyr

FFN_ROW_TOL = 2.0 ** -8
SMS = 132      # the H100's SMs: the plan the card runs
BK = PF.BK


def _ksplits(k_tiles: int, splits: int):
    """The K tiles of each split, as the kernel cuts them."""
    return [range(z * k_tiles // splits, (z + 1) * k_tiles // splits)
            for z in range(splits)]


def _product(a, w_rows, k_tiles, splits, planes, drop=None):
    """sum_k a[:, k] w_rows(k) in fp32, K tile by K tile in order within
    a split.  With more than one split, each split's partial goes to its
    plane ``planes[z]`` of the workspace, and the planes are summed in
    split order (the second pass).  ``w_rows(kt)`` gives (columns of
    ``a``, rows of the weight) of K tile ``kt``."""
    parts = []
    for ks in _ksplits(k_tiles, splits):
        part = torch.zeros(planes.shape[1:]) if splits > 1 else None
        for kt in ks:
            if kt == drop:
                continue
            cols, w = w_rows(kt)
            p = a[:, cols].float() @ w.float()
            part = p if part is None else part + p
        if splits > 1:
            planes[len(parts)] = part
            part = planes[len(parts)]
        parts.append(part)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _planes(ws, splits, nb, T, n):
    """The workspace as the kernel lays out a split product's partials:
    (split, operand, token, column); a workspace too small to hold them
    fails the view."""
    if splits == 1:
        return torch.empty((1, nb, T, n))
    return ws[:splits * nb * T * n].view(splits, nb, T, n)


def ffn_model(x, wi, wo, tp, ff, activation="swiglu", drop_tile=None):
    """The kernel's arithmetic; operands and result in x's type.
    ``drop_tile`` leaves one down-product K tile out (a wrong kernel)."""
    T, d = x.shape
    ffp = wi.shape[1] // 2
    ffs, per = ff // tp, ffp // tp
    nb = 1 if activation == "gelu" else 2
    p = PF.plan(T, d, ff, tp, SMS, gated=nb == 2)
    cols = tref.real_ff_index(ff, ffp, tp)
    ws = torch.zeros(p.workspace)
    up = _planes(ws, p.split_up, nb, T, ff)

    def up_rows(o):
        def rows(kt):
            k = slice(kt * BK, min((kt + 1) * BK, d))
            return k, wi[k, o * ffp + cols]
        return rows

    g = _product(x, up_rows(0), p.k_tiles_up, p.split_up, up[:, 0])
    if activation == "gelu":
        h = Lyr._act("gelu", g)
    else:
        u = _product(x, up_rows(1), p.k_tiles_up, p.split_up, up[:, 1])
        h = Lyr._act(activation, g) * u
    h = h.to(x.dtype)

    def down_rows(kt):
        shard, k = divmod(kt, p.kts)
        r0, r1 = k * BK, min((k + 1) * BK, ffs)
        return (slice(shard * ffs + r0, shard * ffs + r1),
                wo[shard * per + r0:shard * per + r1])

    out = _product(h, down_rows, tp * p.kts, p.split_down,
                   _planes(ws, p.split_down, 1, T, d)[:, 0], drop=drop_tile)
    return out.to(x.dtype)


def oracle_h_rounded(jx, jwi, jwo, activation="swiglu"):
    """The JAX oracle with h rounded to bf16 where the kernel rounds it:
    ``padded_ffn_ref`` over an identity ``wo`` gives h exactly."""
    ffp = jwi.shape[1] // 2
    eye = np.eye(ffp, 2048, dtype=np.float32)   # 2048 columns at a time
    h = jnp.concatenate([
        jref.padded_ffn_ref(jx, jwi, jnp.asarray(np.roll(eye, c0, 0)
                                                 [:, :min(2048, ffp - c0)]),
                            activation)
        for c0 in range(0, ffp, 2048)], axis=1)
    h = h.astype(jnp.bfloat16).astype(jnp.float32)
    return torch.from_numpy(np.array(h @ jwo))


def n_outside(out, want) -> int:
    """Elements outside the bf16 FFN tolerance (``chip_smoke``'s)."""
    o, w = out.float(), want.float()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    tol = 1e-4 + 2.0 ** -7 * w.abs() + FFN_ROW_TOL * rms
    return int(((o - w).abs() > tol).sum())


def _weights(T, d, ffs, pad, tp, seed):
    """x and Eq. 2 padded weights (``ffs`` real columns a shard, ``pad``
    zero ones) with bf16 values: as bf16 tensors, and as fp32 JAX arrays
    of the same values."""
    rng = np.random.default_rng(seed)
    ff, ffp = ffs * tp, (ffs + pad) * tp
    x = rng.normal(size=(T, d))
    u = rng.normal(size=(d, 2 * ff)) / np.sqrt(d)
    dn = rng.normal(size=(ff, d)) / np.sqrt(ff)
    x, u, dn = (torch.from_numpy(a.astype(np.float32)).bfloat16().float()
                .numpy() for a in (x, u, dn))
    wi = np.concatenate([
        np.asarray(JWT.pad_columns_for_tp(jnp.asarray(u[:, :ff]), ff, ffp,
                                          tp)),
        np.asarray(JWT.pad_columns_for_tp(jnp.asarray(u[:, ff:]), ff, ffp,
                                          tp))], axis=1)
    wo = np.asarray(JWT.pad_rows_for_tp(jnp.asarray(dn), ff, ffp, tp))
    tw = tuple(torch.from_numpy(np.array(a)).bfloat16() for a in (x, wi, wo))
    jw = tuple(jnp.asarray(a) for a in (x, wi, wo))
    return tw, jw, ff


# T, d, real ff a shard, zero tail a shard, tp: decode (T <= 32, split
# K) and prefill (T > 32) plans, a shard width 64 does not divide (40,
# 88), tails and no tails
SMALL = [(4, 128, 96, 32, 2), (1, 192, 40, 24, 4), (33, 128, 88, 40, 2),
         (70, 64, 64, 0, 1), (16, 256, 128, 0, 2)]


@pytest.mark.parametrize("T,d,ffs,pad,tp", SMALL)
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_walk_in_fp32_equals_pallas_and_oracle(T, d, ffs, pad, tp, act):
    (x, wi, wo), (jx, jwi, jwo), ff = _weights(T, d, ffs, pad, tp, seed=T)
    got = ffn_model(x.float(), wi.float(), wo.float(), tp, ff, act)
    want = jffn(jx, jwi, jwo, tp=tp, ff=ff, activation=act, block_t=T,
                block_f=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if act != "gelu":   # the oracle gates every activation
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jref.padded_ffn_ref(jx, jwi, jwo, act)),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("T,d,ffs,pad,tp", SMALL)
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_bf16_model_within_tolerance(T, d, ffs, pad, tp, act):
    (x, wi, wo), (jx, jwi, jwo), ff = _weights(T, d, ffs, pad, tp, seed=T)
    got = ffn_model(x, wi, wo, tp, ff, act)
    assert n_outside(got, oracle_h_rounded(jx, jwi, jwo, act)) == 0
    assert n_outside(got, tref.padded_ffn_ref(x, wi, wo, tp, ff, act)) == 0


def test_rounding_h_is_the_departure_from_pallas():
    """Against the Pallas kernel (h kept in fp32) the bf16 model's only
    extra error is h's rounding: a few outputs need up to 3 x 2^-8 of
    their row's RMS, none more."""
    (x, wi, wo), (jx, jwi, jwo), ff = _weights(4, 128, 96, 32, 2, seed=4)
    want = torch.from_numpy(np.array(jffn(jx, jwi, jwo, tp=2, ff=ff,
                                          block_t=4, block_f=8,
                                          interpret=True)))
    got = ffn_model(x, wi, wo, 2, ff).float()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    beyond = ((got - want).abs() - 1e-4 - 2.0 ** -7 * want.abs()) / rms
    assert float(beyond.max()) <= 3 * FFN_ROW_TOL


def test_model_at_llama3_width_prefill_chunk():
    """d = 4096 over one TP2 shard's 7168 columns at T = 128, the worker
    engine's prefill chunk: the prefill plan splits both products' K to
    fill the card, and the whole-K fp32 sums hold the tolerance."""
    T, d, ff = 128, 4096, 7168
    (x, wi, wo), (jx, jwi, jwo), ff = _weights(T, d, ff, 0, 1, seed=8)
    p = PF.plan(T, d, ff, 1, SMS)
    assert not p.decode and p.split_up > 1 and p.split_down > 1
    got = ffn_model(x, wi, wo, 1, ff)
    assert n_outside(got, oracle_h_rounded(jx, jwi, jwo)) == 0
    assert n_outside(got, tref.padded_ffn_ref(x, wi, wo, 1, ff)) == 0


@pytest.mark.parametrize("tp", [2, 1])
def test_model_at_llama3_width_decode(tp):
    """d = 4096, ff = 14336 at T = 4 (the full replica at TP1x2, tp 2,
    and one TP2 shard's columns, tp 1): the decode plan splits both
    products' K, and the whole-K fp32 sums hold the tolerance."""
    T, d, ff = 4, 4096, 14336 // (3 - tp)
    (x, wi, wo), (jx, jwi, jwo), ff = _weights(T, d, ff // tp, 0, tp,
                                               seed=3)
    p = PF.plan(T, d, ff, tp, SMS)
    assert p.decode and p.split_up > 1 and p.split_down > 1
    got = ffn_model(x, wi, wo, tp, ff)
    assert n_outside(got, oracle_h_rounded(jx, jwi, jwo)) == 0
    assert n_outside(got, tref.padded_ffn_ref(x, wi, wo, tp, ff)) == 0


def test_tolerance_catches_a_dropped_k_tile():
    """A kernel that skips one 64-row K tile of the down product (of a
    shard's ragged last tile, here) is outside the tolerance."""
    (x, wi, wo), (jx, jwi, jwo), ff = _weights(4, 128, 88, 40, 2, seed=9)
    want = oracle_h_rounded(jx, jwi, jwo)
    assert n_outside(ffn_model(x, wi, wo, 2, ff), want) == 0
    for kt in (1, 2):
        assert n_outside(ffn_model(x, wi, wo, 2, ff, drop_tile=kt),
                         want) > 0


def _configs():
    out = []
    for name, cfg in sorted(all_configs(True).items()):
        if not cfg.d_ff:
            continue
        for W in (2, 4):
            out.append(pytest.param(cfg, W, id=f"{name}-W{W}"))
    return out


@pytest.mark.parametrize("cfg,W", _configs())
@pytest.mark.parametrize("T", [1, 4, 33, 512])
def test_boxes_visit_each_real_column_once(cfg, W, T):
    """Every box of both products, at the decode and the prefill plan of
    the config's W-way page plan, reads only real columns (rows of wo),
    and together they read each real column once."""
    ff, ffp = cfg.d_ff, make_plan(cfg, W, mode="page").d_ff_padded
    p = PF.plan(T, cfg.d_model, ff, W, SMS)
    up, down = PF.weight_boxes(p, W, ff, ffp)
    real = tref.real_ff_index(ff, ffp, W).tolist()
    for boxes in (up, down):
        seen = [c for box in boxes for c in box]
        assert sorted(seen) == real           # each real column once
        assert all(len(box) <= BK for box in boxes)
    # a box lies inside one shard
    per = ffp // W
    assert all(box.start // per == (box.stop - 1) // per
               for box in up + down if len(box))


@pytest.mark.parametrize("T", [1, 4, 32, 33, 512])
def test_plan_splits_and_workspace(T):
    """Decode plans (T <= DECODE_MAX_T) give each split at least 4 K
    tiles and fill about two blocks an SM; prefill plans split only to
    fill the card; a workspace is taken only when a product splits
    (``ffn_model`` lays the partials out in it as the kernel does, so a
    short one fails the model tests at llama3-8b width)."""
    d, ff, tp = 4096, 14336, 2
    p = PF.plan(T, d, ff, tp, SMS)
    assert p.decode == (T <= PF.DECODE_MAX_T)
    kd = tp * p.kts
    for s, kt in ((p.split_up, p.k_tiles_up), (p.split_down, kd)):
        assert 1 <= s and (s == 1 or kt // s >= 4)
    assert (p.workspace > 0) == (p.split_up > 1 or p.split_down > 1)
    if p.decode:
        blocks = p.col_tiles_down * -(-T // p.nt_down)
        assert blocks * p.split_down >= SMS
