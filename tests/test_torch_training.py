"""The port's training path against the JAX ``repro.training`` (CPU,
reduced configs).

* data: ``SyntheticStream.batch`` bit-equal for several (seed, step);
* schedules: ``wsd`` / ``cosine`` within 1e-7 of the reference's;
* AdamW fed the reference's gradients: parameters, ``mu`` and ``nu``
  within 1e-6 relative a leaf (in norm), the same step counter;
* ``loss_fn`` and its gradient for six families in fp32 (dense, MoE,
  RG-LRU hybrid, xLSTM, whisper's frames, phi-3-vision's patches):
  loss within 1e-5 relative, every gradient leaf within 1e-4 relative
  in norm, and every exact zero of the reference's gradient still
  zero (the gradient tree mapped by ``convert.params_from_jax``);
* activation checkpointing on against off, and ``make_eval_step``: the
  same bits;
* the reference's 40-step run (``tests/test_training.py``) mirrored in
  bf16: the first 5 losses within 1e-3, the last below the first by at
  least 0.3 and within 2% of the reference's last;
* the port's ``restore`` of a checkpoint the reference saved (bf16: the
  uint16 bit patterns) gives the weights, so the same logits;
* the CLI's run cut after step 3 and resumed equals the unbroken run
  bit for bit on the CPU.
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
from repro.training import (DataConfig as JData, SyntheticStream as JStream,
                            adamw as jadamw, cosine as jcosine,
                            make_train_step as jmake_step, wsd as jwsd)
from repro.training import checkpoint as jckpt
from repro.training import train_step as JT
from repro_torch.configs import get_config as tget
from repro_torch.core.padding import make_plan as tplan
from repro_torch.launch import train as TL
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.training import (DataConfig, SyntheticStream, adamw,
                                  cosine, make_eval_step, make_train_step,
                                  wsd)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import train_step as TT

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6

FAMILIES = ("llama3-8b", "granite-moe-3b-a800m", "recurrentgemma-9b",
            "xlstm-1.3b", "whisper-tiny", "phi-3-vision-4.2b")


def _cut(cfg, name, dtype="float32"):
    """The reduced config; recurrentgemma and xlstm cut by hand so that
    a sliding layer and an sLSTM layer are in it (``reduced()`` keeps
    the first two kinds of the pattern only)."""
    cfg = cfg.reduced()
    if name == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, num_layers=3, layer_pattern=(
            "rglru", "rglru", "sliding"))
    if name == "xlstm-1.3b":
        cfg = dataclasses.replace(cfg, num_layers=3,
                                  layer_pattern=("mlstm", "slstm"))
    return dataclasses.replace(cfg, dtype=dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_model(params, tcfg, tp):
    model = Model.empty(tcfg, tp, device="cpu")
    model.load_state_dict(params_from_jax(_np(params), tcfg, tp))
    return model.requires_grad_(True)


def _batch(cfg, B=2, S=40, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, S + 1)).astype(np.int32)}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        out["patches"] = rng.standard_normal(
            (B, cfg.vision.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / max(float(a.norm()), 1e-30))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, port config, plan, reference params, batch, reference loss,
    its metrics, its gradients, those mapped to the port's names)."""
    name = request.param
    cfg, tcfg = _cut(jget(name), name), _cut(tget(name), name)
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = JM.init_params(jax.random.PRNGKey(0), cfg, plan)
    batch = _batch(cfg)
    (loss, metrics), grads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        params, cfg, plan, {k: jnp.asarray(v) for k, v in batch.items()})
    return (name, tcfg, tp, params, batch, float(loss),
            {k: float(v) for k, v in metrics.items()}, grads,
            params_from_jax(_np(grads), tcfg, tp))


# ---------------------------------------------------------------------------
# data and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 17), (3, 7), (5, 1000)])
def test_data_batches_bit_equal(seed, step):
    want = JStream(JData(512, 24, 4, seed=seed)).batch(step)["tokens"]
    got = SyntheticStream(DataConfig(512, 24, 4, seed=seed)).batch(step)
    assert got["tokens"].dtype == want.dtype
    np.testing.assert_array_equal(got["tokens"], want)


@pytest.mark.parametrize("kind", ["wsd", "cosine"])
def test_schedules_match_reference(kind):
    if kind == "wsd":
        ref, port = jwsd(3e-3, 5, 20, 25), wsd(3e-3, 5, 20, 25)
    else:
        ref, port = jcosine(1e-3, 10, 100), cosine(1e-3, 10, 100)
    for s in range(0, 130):
        assert abs(float(ref(jnp.int32(s))) - port(s)) < 1e-7, s


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_on_reference_gradients(family):
    """Three steps on the family's reference gradient: as it is, fifty
    times it (the global-norm clip acts) and minus half of it."""
    _, tcfg, tp, params, *_, jgrads, _ = family
    jinit, jupdate = jadamw(jwsd(1e-2, 1, 2, 4))
    jupdate = jax.jit(jupdate)
    tinit, tupdate = adamw(wsd(1e-2, 1, 2, 4))
    jstate = jinit(params)
    tparams = params_from_jax(_np(params), tcfg, tp)
    tstate = tinit(tparams)
    for scale in (1.0, 50.0, -0.5):
        grads = jax.tree.map(lambda g: g * scale, jgrads)
        params, jstate = jupdate(grads, jstate, params)
        tstate = tupdate(params_from_jax(_np(grads), tcfg, tp), tstate,
                         tparams)
    assert tstate.step == int(jstate.step) == 3
    for got, want in ((tparams, params), (tstate.mu, jstate.mu),
                      (tstate.nu, jstate.nu)):
        want = params_from_jax(_np(want), tcfg, tp)
        for k, w in want.items():
            assert _rel(w, got[k]) < OPT_TOL, k


# ---------------------------------------------------------------------------
# loss and gradients, six families
# ---------------------------------------------------------------------------

def test_loss_and_gradients_match_reference(family):
    name, tcfg, tp, params, batch, jloss, jmetrics, _, jgrads = family
    model = _port_model(params, tcfg, tp)
    loss, metrics = TT.loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss)
    assert abs(float(metrics["aux"].detach()) - jmetrics["aux"]) \
        <= LOSS_TOL * max(abs(jmetrics["aux"]), 1.0)
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    for k, p in named.items():
        want, got = jgrads[k], p.grad
        assert got is not None, k
        assert _rel(want, got) < GRAD_TOL, (k, _rel(want, got))
        zero = want == 0
        assert not bool(got[zero].any()), k
    if name == "granite-moe-3b-a800m":
        assert jmetrics["aux"] > 0


def test_remat_on_and_off_give_the_same_bits(family):
    name, tcfg, tp, params, batch, *_ = family
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = []
    for remat in (True, False):
        model = _port_model(params, tcfg, tp)
        loss, _ = TT.loss_fn(model, tb, remat=remat)
        loss.backward()
        runs.append((loss.detach(), {k: p.grad for k, p in
                                     model.named_parameters()}))
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    assert torch.equal(make_eval_step(model)(tb)["loss"], l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


# ---------------------------------------------------------------------------
# the reference's 40-step run, mirrored
# ---------------------------------------------------------------------------

def test_forty_steps_mirror_reference(rng):
    cfg = jget("llama3-8b").reduced()
    tcfg = tget("llama3-8b").reduced()
    params = JM.init_params(rng, cfg, jplan(cfg, 2))
    jinit, jupdate = jadamw(jwsd(3e-3, 5, 20, 25))
    st = jinit(params)
    step = jax.jit(jmake_step(cfg, jplan(cfg, 2), jupdate))
    data = JStream(JData(cfg.vocab_size, 32, 8, seed=0))
    tp = tplan(tcfg, 1)         # no padding at reduced size: same shapes
    model = _port_model(params, tcfg, tp)
    tinit, tupdate = adamw(wsd(3e-3, 5, 20, 25))
    tstep = make_train_step(model, tupdate)
    tst = tinit(dict(model.named_parameters()))
    want, got = [], []
    for i in range(40):
        b = data.batch(i)
        params, st, m = step(params, st, {k: jnp.asarray(v)
                                          for k, v in b.items()})
        want.append(float(m["loss"]))
        tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in b.items()})
        got.append(float(tm["loss"]))
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got[:5], want[:5], atol=1e-3)
    assert got[-1] < got[0] - 0.3
    assert abs(got[-1] - want[-1]) <= 0.02 * want[-1]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_restore_reads_reference_checkpoint(tmp_path, rng):
    name = "granite-moe-3b-a800m"          # bf16: uint16 bit patterns
    cfg, tcfg = jget(name).reduced(), tget(name).reduced()
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = JM.init_params(rng, cfg, plan)
    jinit, _ = jadamw(1e-3)
    jckpt.save(str(tmp_path / "ck"), {"params": params,
                                      "opt": jinit(params)}, step=17)
    tree, step = ckpt.restore(str(tmp_path / "ck"))
    assert step == 17
    assert isinstance(tree["opt"], tuple) and int(tree["opt"][0]) == 0
    assert isinstance(tree["params"]["blocks"], list)
    assert tree["params"]["embed"].dtype == torch.bfloat16
    restored = Model.empty(tcfg, tp, device="cpu")
    restored.load_state_dict(params_from_jax(tree["params"], tcfg, tp))
    direct = Model.empty(tcfg, tp, device="cpu")
    direct.load_state_dict(params_from_jax(_np(params), tcfg, tp))
    for (k, a), b in zip(restored.state_dict().items(),
                         direct.state_dict().values()):
        assert torch.equal(a, b), k
    toks = torch.from_numpy(_batch(cfg)["tokens"][:, :-1]).long()
    with torch.no_grad():
        la, _ = restored.forward_train(toks, remat=False)
        lb, _ = direct.forward_train(toks, remat=False)
    assert torch.equal(la, lb)


def test_cli_cut_and_resumed_equals_unbroken(tmp_path):
    cfg = tget("llama3-8b").reduced()
    kw = dict(steps=5, batch=2, seq=16, lr=3e-3, device="cpu",
              log=lambda _: None)
    whole = TL.train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    first = TL.train(cfg, ckpt_dir=str(tmp_path / "b"), stop_after=3, **kw)
    _, at = ckpt.restore(str(tmp_path / "b"))
    assert at == 3
    rest = TL.train(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert [l for l, _ in first + rest] == [l for l, _ in whole]
    a, sa = ckpt.restore(str(tmp_path / "a"))
    b, sb = ckpt.restore(str(tmp_path / "b"))
    assert sa == sb == 5 and int(a["opt"][0]) == int(b["opt"][0]) == 5
    for part in ("params",):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), k
    for i in (1, 2):
        for k, v in a["opt"][i].items():
            assert torch.equal(v, b["opt"][i][k]), k


def test_cli_main_runs_on_cpu(tmp_path, capsys):
    TL.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
             "--seq", "8", "--log-every", "1",
             "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "step      1 loss" in out and "final checkpoint" in out
    tree, step = ckpt.restore(str(tmp_path / "ck"))
    assert step == 2 and int(tree["opt"][0]) == 2
