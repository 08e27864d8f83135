"""Training over a grid of workers (``training.sharded``, ``launch.train
--mesh``) against the port's single-device step and the JAX reference
(CPU, fp32, reduced configs).

* One sharded step at (2, 2), (1, 2) and (2, 1) for reduced llama3-8b,
  granite-moe, a recurrentgemma hybrid (RG-LRU + sliding) and xlstm
  (mLSTM + sLSTM), under the lane plan of the model axis: the loss and
  every gradient leaf (gathered from the shards) within 1e-5 of the
  port's single-device step and of the reference's jitted single-device
  ``value_and_grad`` (its tree mapped by ``convert.params_from_jax``;
  under the lane plan of 2, which gives these configs the weights and
  function of the plan of 1); the sharded AdamW on those gradients
  equals the single-device AdamW on them (1e-6).  Parameters are
  compared through the optimizer fed one gradient because Adam's first
  step divides each gradient element by its own size: an element whose
  gradient is near zero turns a 1e-6 gradient difference into a step of
  up to the learning rate.
* whisper's frames and phi-3-vision's patches: the sharded step equals
  one device's (1e-5).
* Granite at the reference's ``capacity_factor`` 1.25 drops choices:
  the sharded step routes globally, each worker's kept choices in a
  buffer of its own tokens' rows (fewer than the batch's capacity), and
  equals the single-device step (1e-5); routing per data shard (``hints(moe_blocks=2)``) gives
  another loss, and equals the single-device step under the same hint.
  (The reference overwrites a kept choice at ``cap - 1`` when an expert
  overflows, ROADMAP queue 3, so the reference comparisons use the
  reduced config's own factor 8, which drops nothing.)
* One case at (2, 2) against the reference's own ``--mesh`` path
  (``param_pspecs`` + ``jax.jit(in_shardings=...)`` on 4 fake devices):
  the loss and gradients (1e-5), and the sharded AdamW fed its
  gradients gives the parameters of its jitted step (1e-6).
* After 3 steps every copy of a shard is bit-equal across the workers
  holding it, and no two workers' tensors share storage.
* ``hints(moe_blocks=4)``: the reference under the same hint, and the
  unblocked dispatch when nothing drops.
* ``layers.banded_attention``: the reference's, the masked sliding
  attention, and a gradient through it; ``banded=True`` on a windowed
  config, single-device and sharded, equals the masked attention's
  logits, loss and gradients.
* The CLI ``--mesh 2,2 --smoke --device cpu`` cut after step 3 and
  resumed equals an unbroken run bit for bit; a mesh checkpoint restores
  into the single-device trainer.

The JAX runs start in two subprocesses (one device; 4 fake host
devices for the ``--mesh`` step) with the module's first test.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.padding import make_plan
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as TL
from repro_torch.launch.mesh import Grid
from repro_torch.models import layers as Lyr
from repro_torch.models import shardhints
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.training import adamw, wsd
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import sharded as TS
from repro_torch.training import train_step as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOL = 1e-5
OPT_TOL = 1e-6
FAMILIES = ("llama3-8b", "granite-moe-3b-a800m", "recurrentgemma-9b",
            "xlstm-1.3b")
SHAPES = ((2, 2), (1, 2), (2, 1))
B, S = 4, 32
LR = dict(peak_lr=1e-2, warmup=1, stable=2, decay=4)

CUT = {"recurrentgemma-9b": dict(num_layers=3, layer_pattern=(
    "rglru", "rglru", "sliding")),
       "xlstm-1.3b": dict(num_layers=3, layer_pattern=("mlstm", "slstm"))}

SCRIPT = r'''
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.padding import make_plan
from repro.launch import sharding as SH
from repro.models import layers as JL, model as JM, shardhints
from repro.training import adamw, make_train_step, wsd
from repro.training import train_step as JT

FAMILIES, CUT, B, S, LR = %(families)r, %(cut)r, %(B)d, %(S)d, %(lr)r
np_ = lambda t: jax.tree.map(np.asarray, t)

def cfg_of(name):
    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, dtype="float32", **CUT.get(name, {}))

def batch_of(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (B, S + 1)).astype(np.int32)}

grad = jax.jit(jax.value_and_grad(JT.loss_fn, has_aux=True),
               static_argnums=(1, 2))
out = {}
for name in (FAMILIES if sys.argv[2] == "families" else ()):
    cfg = cfg_of(name)
    b = {k: jnp.asarray(v) for k, v in batch_of(cfg).items()}
    plan = make_plan(cfg, 2, mode="lane")
    params = JM.init_params(jax.random.PRNGKey(0), cfg, plan)
    (loss, m), g = grad(params, cfg, plan, b)
    out[name] = dict(params=np_(params), loss=float(loss),
                     aux=float(m["aux"]), grads=np_(g))

if sys.argv[2] == "families":
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
    sys.exit(0)

# the reference's own --mesh path at (2, 2)
cfg = cfg_of("llama3-8b")
plan = make_plan(cfg, 2, mode="lane")
params = JM.init_params(jax.random.PRNGKey(0), cfg, plan)
# an Auto-axes mesh, as the reference's launcher's make_mesh gave
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2),
                         ("data", "model"))
ps = SH.param_pspecs(params, cfg, plan, fsdp=True, data_size=2)
p_sh = SH.to_shardings(mesh, ps)
init, update = adamw(wsd(**LR))
o_sh = SH.to_shardings(mesh, SH.opt_pspecs(ps))
b = {k: jnp.asarray(v) for k, v in batch_of(cfg).items()}
with mesh:
    params = jax.device_put(params, p_sh)
    opt = jax.device_put(init(params), o_sh)
    g_fn = jax.jit(lambda p, bb: jax.value_and_grad(
        JT.loss_fn, has_aux=True)(p, cfg, plan, bb),
        in_shardings=(p_sh, None), out_shardings=(None, p_sh))
    (loss, _), g = g_fn(params, b)
    step = jax.jit(make_train_step(cfg, plan, update),
                   in_shardings=(p_sh, o_sh, None),
                   out_shardings=(p_sh, o_sh, None))
    new, _, m = step(params, opt, b)
out["mesh"] = dict(params=np_(params), loss=float(loss),
                   mesh_loss=float(m["loss"]), grads=np_(g),
                   after=np_(new))

# blocked MoE dispatch under the hint (capacity factor 8: no drops)
cfg = cfg_of("granite-moe-3b-a800m")
plan = make_plan(cfg, 2, mode="lane")
params = JM.init_params(jax.random.PRNGKey(0), cfg, plan)
b = {k: jnp.asarray(v) for k, v in batch_of(cfg).items()}
with shardhints.hints(moe_blocks=4):
    (loss, m), g = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        params, cfg, plan, b)
out["blocked"] = dict(params=np_(params), loss=float(loss),
                      aux=float(m["aux"]), grads=np_(g))

# banded attention
rng = np.random.default_rng(3)
q = rng.standard_normal((2, 1024, 4, 16)).astype(np.float32)
k = rng.standard_normal((2, 1024, 2, 16)).astype(np.float32)
v = rng.standard_normal((2, 1024, 2, 16)).astype(np.float32)
pos = np.broadcast_to(np.arange(1024, dtype=np.int32), (2, 1024))
out["banded"] = dict(q=q, k=k, v=v, out=np.asarray(JL.banded_attention(
    jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
    jnp.asarray(pos), 256)))

with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The two JAX runs (the families' gradients on one device; the
    ``--mesh`` step on 4 fake devices, the blocked dispatch and the
    banded attention), started together with the module's first test;
    ``reference()`` waits for both and returns their results."""
    tmp = tmp_path_factory.mktemp("jax")
    body = textwrap.dedent(SCRIPT) % dict(families=FAMILIES, cut=CUT, B=B,
                                          S=S, lr=LR)
    procs = {}
    for part, ndev in (("families", 1), ("mesh", 4)):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{ndev} --xla_cpu_collective_call_"
                             f"terminate_timeout_seconds=600")
        procs[part] = subprocess.Popen(
            [sys.executable, "-c", body, str(tmp / part), part],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
    box = {}

    def wait():
        if not box:
            for part, proc in procs.items():
                _, err = proc.communicate(timeout=900)
                assert proc.returncode == 0, err[-4000:]
                with open(tmp / part, "rb") as f:
                    box.update(pickle.load(f))
        return box

    yield wait
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    """Start the JAX runs before the first test of the module."""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, **moe):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32",
                              **CUT.get(name, {}))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))}


def _rel(a, b) -> float:
    return float((a - b).norm() / max(float(a.norm()), 1e-30))


def _model(cfg, plan, np_params=None):
    """The port's model under ``plan``: the reference's weights through
    ``convert`` (MLPs in the plan's per-shard layout), or seed 0's."""
    if np_params is None:
        from repro_torch.core.weight_transform import relayout_block_mlp
        from repro_torch.models.model import build
        model = build(cfg, plan, 0, device="cpu")
        for blk in model.layers:
            relayout_block_mlp(blk.mlp, cfg.d_ff, plan.max_tp,
                               cfg.activation)
    else:
        model = Model.empty(cfg, plan, device="cpu")
        model.load_state_dict(params_from_jax(np_params, cfg, plan))
    return model.requires_grad_(True)


def _sharded(cfg, plan, model, shape, banded=False):
    return TS.ShardedStep.from_model(
        model, Grid(["cpu"] * (shape[0] * shape[1]), shape), banded=banded)


def _sharded_grads(step, batch):
    loss, metrics = step.loss(TS.split_batch(batch, step.grid))
    loss.backward()
    grads = step.reduce_grads()
    return (float(loss.detach()), float(metrics["aux"].detach()), grads,
            SH.gather(grads, step.specs, step.grid))


def _single_grads(model, batch):
    loss, metrics = TT.loss_fn(model, batch)
    loss.backward()
    return (float(loss.detach()), float(metrics["aux"].detach()),
            {k: p.grad for k, p in model.named_parameters()})


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", FAMILIES)
def test_step_equals_single_device_and_reference(name, shape, reference):
    cfg = _cfg(name)
    plan = make_plan(cfg, shape[1], mode="lane")
    ref = reference()[name]
    # the reference ran under the lane plan of 2; the reduced configs'
    # plans of 1 and 2 give every weight one shape (the same function)
    plan2 = make_plan(cfg, 2, mode="lane")
    assert (plan.vocab_padded, plan.d_ff_padded, plan.q_heads_padded,
            plan.kv_padded, plan.experts_padded) == (
        plan2.vocab_padded, plan2.d_ff_padded, plan2.q_heads_padded,
        plan2.kv_padded, plan2.experts_padded)
    model = _model(cfg, plan, ref["params"])
    batch = _batch(cfg)
    step = _sharded(cfg, plan, model, shape)
    loss, aux, grads, full = _sharded_grads(step, batch)
    l1, a1, g1 = _single_grads(model, batch)
    want = params_from_jax(ref["grads"], cfg, plan)
    for other, what in ((l1, "single"), (ref["loss"], "reference")):
        assert abs(loss - other) <= TOL * abs(other), (what, loss, other)
    assert abs(aux - ref["aux"]) <= TOL * max(abs(ref["aux"]), 1.0)
    assert set(full) == set(g1) == set(want)
    for k, g in full.items():
        assert _rel(g1[k], g) < TOL, (k, _rel(g1[k], g))
        assert _rel(want[k], g) < TOL, (k, _rel(want[k], g))
    # AdamW: the sharded update against one device's on the same
    # gradients (``test_reference_mesh_path`` holds it to the
    # reference's step)
    init, update = adamw(wsd(**LR))
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    update(full, init(params), params)
    step.apply(update, TS.opt_init_sharded(step.shards), grads)
    got = SH.gather(step.shards, step.specs, step.grid)
    for k, p in params.items():
        assert _rel(p, got[k]) < OPT_TOL, (k, _rel(p, got[k]))


def test_granite_drops_route_globally(monkeypatch):
    cfg = _cfg("granite-moe-3b-a800m", capacity_factor=1.25)
    plan = make_plan(cfg, 2, mode="lane")
    batch = _batch(cfg)
    model = _model(cfg, plan)
    from repro_torch.models import blocks as Bk
    kept, positions = [], Bk.moe_positions

    def record(*a):
        out = positions(*a)
        kept.append(bool(out[1].all()))
        return out
    monkeypatch.setattr(Bk, "moe_positions", record)
    step = _sharded(cfg, plan, model, (2, 2))
    _, nb, cap, rows = step.moe_dispatch(B * S // 2)
    assert rows < nb * cap           # each worker's buffer: its own rows
    loss, _, _, full = _sharded_grads(step, batch)
    assert not all(kept)             # the capacity drops choices
    l1, _, g1 = _single_grads(model, batch)
    assert abs(loss - l1) <= TOL * abs(l1)
    for k, g in full.items():
        assert _rel(g1[k], g) < TOL, (k, _rel(g1[k], g))
    # per-shard routing trains another function; under the same hint
    # the one device agrees
    with shardhints.hints(moe_blocks=2):
        step = _sharded(cfg, plan, _model(cfg, plan), (2, 2))
        local = float(step.loss(TS.split_batch(batch, step.grid))[0].detach())
        model.zero_grad(set_to_none=True)
        l2, _, _ = _single_grads(model, batch)
    assert abs(local - l1) > 1e-4 * abs(l1)
    assert abs(local - l2) <= TOL * abs(l2)


@pytest.mark.parametrize("name", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_frontends_equal_single_device(name):
    """An encoder-decoder's frames and a vision model's patches: the
    encoder, the cross-attention and the patch projection run whole on
    every worker; the step equals one device's (1e-5)."""
    cfg = _cfg(name)
    plan = make_plan(cfg, 2, mode="lane")
    batch = _batch(cfg)
    rng = np.random.default_rng(1)
    if cfg.encoder is not None:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32))
    if cfg.vision is not None:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision.num_patches, cfg.d_model)).astype(np.float32))
    model = _model(cfg, plan)
    loss, _, _, full = _sharded_grads(_sharded(cfg, plan, model, (2, 2)),
                                      batch)
    l1, _, g1 = _single_grads(model, batch)
    assert abs(loss - l1) <= TOL * abs(l1)
    assert set(full) == set(g1)
    for k, g in full.items():
        assert _rel(g1[k], g) < TOL, (k, _rel(g1[k], g))


def test_reference_mesh_path(reference):
    """The reference's ``--mesh`` step at (2, 2): the same loss and
    gradients; the sharded AdamW fed its gradients gives its
    parameters."""
    mesh = single = reference()["mesh"]
    cfg = _cfg("llama3-8b")
    plan = make_plan(cfg, 2, mode="lane")
    step = _sharded(cfg, plan, _model(cfg, plan, single["params"]), (2, 2))
    loss, _, _, full = _sharded_grads(step, _batch(cfg))
    assert abs(loss - mesh["loss"]) <= TOL * abs(mesh["loss"])
    assert abs(mesh["mesh_loss"] - mesh["loss"]) <= TOL * abs(mesh["loss"])
    want = params_from_jax(mesh["grads"], cfg, plan)
    for k, g in full.items():
        assert _rel(want[k], g) < TOL, (k, _rel(want[k], g))
    step = _sharded(cfg, plan, _model(cfg, plan, single["params"]), (2, 2))
    _, update = adamw(wsd(**LR))
    step.apply(update, TS.opt_init_sharded(step.shards),
               SH.place(want, step.specs, step.grid))
    got = SH.gather(step.shards, step.specs, step.grid)
    for k, p in params_from_jax(mesh["after"], cfg, plan).items():
        assert _rel(p, got[k]) < OPT_TOL, (k, _rel(p, got[k]))


def test_replicated_copies_bit_equal_and_unaliased():
    cfg = _cfg("recurrentgemma-9b")
    plan = make_plan(cfg, 2, mode="lane")
    step = _sharded(cfg, plan, _model(cfg, plan), (2, 2))
    _, update = adamw(wsd(**LR))
    fn = TS.make_sharded_train_step(step, update)
    state = TS.opt_init_sharded(step.shards)
    for i in range(3):
        batch = _batch(cfg)
        batch["tokens"] = (batch["tokens"] + i) % cfg.vocab_size
        state, _ = fn(state, batch)
    g = step.grid
    replicated = 0
    for name, parts in step.shards.items():
        for tree in (step.shards, state.mu, state.nu):
            ts = tree[name]
            assert len({t.untyped_storage().data_ptr() for t in ts}) \
                == len(ts), name
        named = {a for e in step.specs[name] for a in
                 (e if isinstance(e, tuple) else (e,)) if a}
        rep = tuple(a for a in g.axis_names if a not in named)
        for grp in g.groups(rep):
            if len(grp) > 1:
                replicated += 1
            for w in grp[1:]:
                assert torch.equal(parts[grp[0]], parts[w]), name
                assert torch.equal(state.mu[name][grp[0]],
                                   state.mu[name][w]), name
    assert replicated > 0


def test_blocked_moe_dispatch(reference):
    ref = reference()["blocked"]
    cfg = _cfg("granite-moe-3b-a800m")
    plan = make_plan(cfg, 2, mode="lane")
    batch = _batch(cfg)
    model = _model(cfg, plan, ref["params"])
    with shardhints.hints(moe_blocks=4):
        assert shardhints.get("moe_blocks") == 4
        loss, aux, grads = _single_grads(model, batch)
    assert shardhints.get("moe_blocks") is None
    assert abs(loss - ref["loss"]) <= TOL * abs(ref["loss"])
    assert abs(aux - ref["aux"]) <= TOL * abs(ref["aux"])
    want = params_from_jax(ref["grads"], cfg, plan)
    for k, g in grads.items():
        assert _rel(want[k], g) < TOL, (k, _rel(want[k], g))
    # nothing drops at factor 8: the blocks give the global dispatch
    model.zero_grad(set_to_none=True)
    l1, a1, _ = _single_grads(model, batch)
    assert abs(l1 - loss) <= TOL * abs(loss)


def test_banded_attention(reference):
    ref = reference()["banded"]
    q, k, v = (torch.from_numpy(ref[n]).requires_grad_(True)
               for n in "qkv")
    pos = torch.arange(1024, dtype=torch.int32).expand(2, 1024)
    out = Lyr.banded_attention(q, k, v, pos, pos, 256)
    assert float((out.detach() - torch.from_numpy(ref["out"])).abs().max()) \
        < 2e-6
    masked = Lyr.chunked_attention(q, k, v, pos, pos, causal=True,
                                   window=256)
    assert float((out - masked).detach().abs().max()) < 2e-6
    out.sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0)
               for t in (q, k, v))


def test_banded_forward_train_and_sharded_step():
    """``banded=True`` on a windowed config (S a multiple of 512 and
    longer than the window) takes ``banded_attention`` and trains the
    same function: the single-device forward's logits and gradients, and
    the sharded step's loss and gradients at (2, 2), against the masked
    sliding attention's."""
    from repro_torch.launch.specs import long_context_variant
    cfg = dataclasses.replace(long_context_variant(_cfg("llama3-8b")),
                              window=256)
    plan = make_plan(cfg, 2, mode="lane")
    seq = 1024
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, seq + 1)).astype(np.int32))
    calls = []
    banded = Lyr.banded_attention

    def spy(*a, **kw):
        calls.append(1)
        return banded(*a, **kw)
    Lyr.banded_attention = spy
    try:
        out = {}
        for band in (False, True):
            model = _model(cfg, plan)
            logits, _ = model.forward_train(toks[:, :-1].long(), banded=band)
            logits[..., :cfg.vocab_size].logsumexp(-1).mean().backward()
            n = len(calls)
            step = _sharded(cfg, plan, _model(cfg, plan), (2, 2),
                            banded=band)
            loss, _, _, full = _sharded_grads(step, {"tokens": toks})
            out[band] = (logits.detach(), {k: p.grad for k, p in
                                           model.named_parameters()},
                         loss, full, (n, len(calls) - n))
    finally:
        Lyr.banded_attention = banded
    (l0, g0, s0, f0, n0), (l1, g1, s1, f1, n1) = out[False], out[True]
    # every layer, in the forward and again in the recompute
    assert n0 == (0, 0) and n1 == (2 * cfg.num_layers,
                                   2 * cfg.num_layers * 4)
    assert float((l1 - l0).abs().max()) < 2e-5
    assert abs(s1 - s0) <= TOL * abs(s0)
    for k in g0:
        assert _rel(g0[k], g1[k]) < TOL, k
        assert _rel(f0[k], f1[k]) < TOL, k


def test_cli_mesh_cut_resumed_and_restored_single(tmp_path, capsys):
    cfg = get_config("llama3-8b").reduced()
    kw = dict(steps=5, batch=4, seq=16, lr=3e-3, device="cpu",
              log=lambda _: None, mesh=(2, 2))
    whole = TL.train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    first = TL.train(cfg, ckpt_dir=str(tmp_path / "b"), stop_after=3, **kw)
    rest = TL.train(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert [l for l, _ in first + rest] == [l for l, _ in whole]
    a, sa = ckpt.restore(str(tmp_path / "a"))
    b, sb = ckpt.restore(str(tmp_path / "b"))
    assert sa == sb == 5
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    # the mesh checkpoint at step 3 resumes the single-device trainer
    TL.train(cfg, ckpt_dir=str(tmp_path / "c"), stop_after=3, **kw)
    single = TL.train(cfg, ckpt_dir=str(tmp_path / "c"),
                      **dict(kw, mesh=None))
    assert len(single) == 2
    np.testing.assert_allclose([l for l, _ in single],
                               [l for l, _ in whole[3:]], rtol=2e-3)
    TL.main(["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
             "--seq", "8", "--mesh", "2,2"])
    assert "mesh=2x2 on 4 x cpu" in capsys.readouterr().out
