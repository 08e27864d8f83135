"""The port's placements (``launch.sharding``, ``launch.specs``), shard
hints and the grid's exchanges against the JAX reference (CPU).

* For every assigned arch at ``model=16, data=16``: ``param_pspecs``
  equals the reference's leaf for leaf (each port leaf judged as the
  reference's leaf it maps to, the stacked layer dim dropped), with FSDP
  and for every expert mode, on ``meta`` ``param_specs`` against the
  reference's ``eval_shape``; so do ``decide_expert_mode``, the
  optimizer's, the batches' and the decode caches' placements.
* At (2, 2) on reduced llama3-8b each worker's shard of each weight
  equals, byte for byte, the reference's ``addressable_shards`` data on
  the device at the same mesh position (one JAX run on 4 fake devices).
* ``gather`` joins the shards back; the tally's schema is the
  reference's ``collective_bytes``'; the grid's exchanges and their
  gradients count the bytes they move.
* The counterparts of ``tests/test_sharding.py``'s
  ``test_shardhints_scoping`` and ``test_long_context_variant``.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ASSIGNED_ARCHS, SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.core.padding import make_plan as jplan
from repro.launch import sharding as JSH
from repro.launch import specs as JSP
from repro.launch.hlo_analysis import collective_bytes as jcollective_bytes
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.padding import make_plan
from repro_torch.launch import comm_analysis as CA
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (Grid, batch_axes, data_axis_size,
                                     make_production_mesh, model_axis_size)
from repro_torch.models import shardhints
from repro_torch.models.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHARDS_SCRIPT = r'''
import pickle, sys
import jax, numpy as np
from repro.configs import get_config
from repro.core.padding import make_plan
from repro.launch import sharding as SH
from repro.models import model as JM

cfg = get_config("llama3-8b").reduced()
plan = make_plan(cfg, 2, mode="lane")
params = JM.init_params(jax.random.PRNGKey(0), cfg, plan)
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 2),
                         ("data", "model"))
ps = SH.param_pspecs(params, cfg, plan, fsdp=True, data_size=2)
placed = jax.device_put(params, SH.to_shardings(mesh, ps))
where = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
         for d in mesh.devices.flat}
shards = {}
for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
    key = "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path)
    for s in leaf.addressable_shards:
        shards[key, where[s.device]] = np.asarray(s.data).view(np.uint16)
with open(sys.argv[1], "wb") as f:
    pickle.dump({"params": jax.tree.map(np.asarray, params),
                 "shards": shards}, f)
'''


@pytest.fixture(scope="module")
def reference_shards(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "shards.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(SHARDS_SCRIPT), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    box = {}

    def wait():
        if not box:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            with open(path, "rb") as f:
                box.update(pickle.load(f))
        return box

    yield wait
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference_shards):
    """Start the JAX run before the first test of the module."""


def _tree_specs(tree, path=""):
    """A reference pspec tree as {path: spec tuple}."""
    if isinstance(tree, P):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_specs(v, f"{path}/{k}"))
        return out
    if hasattr(tree, "_fields"):          # a NamedTuple (PagedState)
        out = {}
        for k in tree._fields:
            out.update(_tree_specs(getattr(tree, k), f"{path}/{k}"))
        return out
    out = {}
    for i, v in enumerate(tree):
        out.update(_tree_specs(v, f"{path}/{i}"))
    return out


def _pad(spec, ndim):
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    return spec + (None,) * (ndim - len(spec))


def _norm(entry):
    """A spec entry with one-name tuples as the name."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


@pytest.fixture(scope="module")
def grid16():
    return make_production_mesh(["meta"] * 256)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_placements_equal_reference(arch):
    cfg, tcfg = jget(arch), get_config(arch)
    plan, tplan = jplan(cfg, 16, mode="lane"), make_plan(tcfg, 16,
                                                          mode="lane")
    sds = JSP.param_specs(cfg, plan)
    model = SP.param_specs(tcfg, tplan)
    assert all(p.device.type == "meta" for p in model.parameters())
    params = dict(model.named_parameters())
    assert SH.decide_expert_mode(tcfg, tplan, 16) \
        == JSH.decide_expert_mode(cfg, plan, 16)
    for em in ("auto", "model", "tp", "2d"):
        ref = _tree_specs(JSH.param_pspecs(sds, cfg, plan, fsdp=True,
                                           data_size=16, expert_mode=em))
        port = SH.param_pspecs(params, tcfg, tplan, fsdp=True,
                               data_size=16, expert_mode=em)
        seen = set()
        for name, spec in port.items():
            path, shape, lead = SH.reference_leaf(name, params[name].shape,
                                                  tcfg)
            want = _pad(ref[path], len(shape))
            assert want[lead:] == spec, (em, name, path, want, spec)
            seen.add(path)
        assert seen == set(ref), set(ref) - seen
        # the moments are placed like the weights, the step whole
        jopt = JSH.opt_pspecs(JSH.param_pspecs(sds, cfg, plan, fsdp=True,
                                               data_size=16))
        step, mu, nu = SH.opt_pspecs(port)
        assert tuple(jopt.step) == step == () and mu is nu is port
    # without FSDP (the serving placements): model splits only
    ref = _tree_specs(JSH.param_pspecs(sds, cfg, plan, fsdp=False))
    for name, spec in SH.param_pspecs(params, tcfg, tplan).items():
        path, shape, lead = SH.reference_leaf(name, params[name].shape, tcfg)
        assert _pad(ref[path], len(shape))[lead:] == spec, name


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-tiny",
                                  "phi-3-vision-4.2b", "recurrentgemma-9b"])
def test_batch_and_cache_placements_equal_reference(arch, grid16):
    cfg, tcfg = jget(arch), get_config(arch)
    plan, tplan = jplan(cfg, 16), make_plan(tcfg, 16)
    mesh = type("M", (), {"shape": {"data": 16, "model": 16}})()
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        ref = JSH.batch_pspecs(JSP.model_inputs(cfg, JSHAPES[shape]), mesh,
                               ("data",))
        port = SH.batch_pspecs(SP.model_inputs(tcfg, SHAPES[shape]), grid16,
                               batch_axes(grid16))
        assert set(ref) == set(port)
        for k, v in port.items():
            assert tuple(_norm(e) for e in _pad(tuple(ref[k]), len(v))) \
                == tuple(_norm(e) for e in v), (shape, k)
    for shape in ("decode_32k", "long_500k"):
        sh = SHAPES[shape]
        c_ref = JSP.cache_specs(cfg, plan, JSHAPES[shape])
        c_port = SP.cache_specs(tcfg, tplan, sh)
        for mode in ("tp", "tp1"):
            ref = _tree_specs(JSH.cache_pspecs(
                c_ref, mesh, ("data",), sh.global_batch, mode))
            port = SH.cache_pspecs(c_port["layers"], grid16, ("data",),
                                   sh.global_batch, mode, c_port["cross"])
            unit = len(tcfg.layer_pattern) if tcfg.layer_pattern else 1
            G = tcfg.num_layers // unit
            for li, fields in enumerate(port["layers"]):
                pre = (f"/groups/{li % unit}" if li < G * unit
                       else f"/rem/{li - G * unit}")
                lead = 1 if li < G * unit else 0
                for k, spec in fields.items():
                    if k in ("pool", "page_table", "seq_lens", "positions"):
                        want = _pad(ref[f"{pre}/{k}"], len(spec) + lead)
                        want = want[lead:]
                    else:
                        # a recurrent state's leaves: each its batch dim
                        # over the slots, as every reference leaf
                        first = {_norm(_pad(v, 4)[lead])
                                 for p, v in ref.items()
                                 if p.startswith(pre + "/")}
                        assert len(first) == 1
                        want = (first.pop(),) + (None,) * (len(spec) - 1)
                    assert tuple(map(_norm, want)) \
                        == tuple(map(_norm, spec)), (mode, li, k)
            if c_port["cross"] is not None:
                want = _pad(ref["/cross_kv/0"], 5)[1:]
                assert tuple(map(_norm, want)) \
                    == tuple(map(_norm, port["cross_kv"]))


def test_shard_bytes_equal_reference_shards(reference_shards):
    """Each worker's shard at (2, 2) is the reference's shard on the
    device at the same mesh position, byte for byte (bf16 bits)."""
    ref = reference_shards()
    cfg = get_config("llama3-8b").reduced()
    plan = make_plan(cfg, 2, mode="lane")
    tree = params_from_jax(ref["params"], cfg, plan)
    grid = Grid(["cpu"] * 4, (2, 2))
    specs = SH.param_pspecs(tree, cfg, plan, fsdp=True, data_size=2)
    shards = SH.place(tree, specs, grid)
    unit = 1
    G = cfg.num_layers // unit
    n = 0
    for name, parts in shards.items():
        path, _, lead = SH.reference_leaf(name, tree[name].shape, cfg)
        li = int(name.split(".")[1]) if name.startswith("layers.") else 0
        for w, t in enumerate(parts):
            c = grid.coords(w)
            want = ref["shards"][path, (c["data"], c["model"])]
            if lead:
                want = want[li // unit]
            got = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got, want, err_msg=name)
            n += 1
        # no worker's shard aliases another's
        assert len({t.untyped_storage().data_ptr() for t in parts}) == 4
    assert n == 4 * len(shards) and G == 2
    back = SH.gather(shards, specs, grid)
    for k, v in tree.items():
        assert torch.equal(back[k], v), k


def test_grid_order_and_exchanges():
    g = Grid(["cpu"] * 8, (2, 2, 2))
    assert g.axis_names == ("pod", "data", "model")
    assert [g.coords(w) for w in (0, 1, 2, 7)] == [
        {"pod": 0, "data": 0, "model": 0}, {"pod": 0, "data": 0, "model": 1},
        {"pod": 0, "data": 1, "model": 0}, {"pod": 1, "data": 1, "model": 1}]
    assert batch_axes(g) == ("pod", "data")
    assert (model_axis_size(g), data_axis_size(g)) == (2, 4)
    assert g.groups(("pod", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    g = Grid(["cpu"] * 4, (2, 2))
    xs = [torch.full((3, 2), float(w), requires_grad=True) for w in range(4)]
    with CA.counting() as tally:
        ys = g.all_gather(xs, "data", 0)
        zs = g.all_reduce_sum(ys, "model")
        sum(z.sum() * (w + 1) for w, z in enumerate(zs)).backward()
    assert torch.equal(ys[0], torch.cat([xs[0], xs[2]]).detach())
    assert torch.equal(zs[3], (ys[2] + ys[3]).detach())
    # d/dx0: y0's copies feed z0, z1 (weights 1 + 2), y2's feed z2, z3
    assert torch.equal(xs[0].grad, torch.full((3, 2), 10.0))
    b = 3 * 2 * 4
    assert tally.collective_bytes() == {
        "all-gather": 4 * b, "all-reduce": 2 * (2 * 2 * 2 * b),
        "reduce-scatter": 4 * b, "all-to-all": 0, "collective-permute": 0,
        "count": 8}
    assert set(CA.collective_bytes()) == set(jcollective_bytes(""))
    assert CA.total_collective_bytes(tally.collective_bytes()) == 24 * b
    assert ys[0].untyped_storage().data_ptr() \
        != ys[2].untyped_storage().data_ptr()


def test_shardhints_scoping():
    assert shardhints.get("zzz") is None
    with shardhints.hints(zzz=5):
        assert shardhints.get("zzz") == 5
        with shardhints.hints(yyy=1):
            assert shardhints.get("zzz") == 5
            assert shardhints.get("yyy") == 1
        assert shardhints.get("yyy") is None
    assert shardhints.get("zzz") is None


def test_long_context_variant():
    lc = SP.long_context_variant(get_config("llama3-8b"))
    assert lc.sub_quadratic and lc.window == 4096
    rg = get_config("recurrentgemma-9b")
    assert SP.long_context_variant(rg) is rg
    ok, why = SP.supports_shape(get_config("whisper-tiny"),
                                SHAPES["long_500k"])
    assert not ok and "skip" in why.lower()
    for arch in ASSIGNED_ARCHS:
        for name in SHAPES:
            assert SP.supports_shape(get_config(arch), SHAPES[name]) \
                == JSP.supports_shape(jget(arch), JSHAPES[name])[:1] + (
                    SP.supports_shape(get_config(arch), SHAPES[name])[1],)
        want = JSP.long_context_variant(jget(arch))
        got = SP.long_context_variant(get_config(arch))
        assert (got.attention, got.window, got.layer_pattern) == (
            want.attention, want.window, want.layer_pattern), arch


def test_opt_specs_on_meta():
    cfg = get_config("granite-moe-3b-a800m")
    params = dict(SP.param_specs(cfg, make_plan(cfg, 16)).named_parameters())
    step, mu, nu = SP.opt_specs(params)
    assert step == 0 and set(mu) == set(nu) == set(params)
    assert all(m.device.type == "meta" and m.dtype.is_floating_point
               and m.element_size() == 4 and m.shape == params[k].shape
               for k, m in mu.items())


def test_model_inputs_equal_reference():
    for arch in ASSIGNED_ARCHS:
        for name in SHAPES:
            want = JSP.model_inputs(jget(arch), JSHAPES[name])
            got = SP.model_inputs(get_config(arch), SHAPES[name])
            assert {k: tuple(v.shape) for k, v in want.items()} == {
                k: tuple(v.shape) for k, v in got.items()}, (arch, name)
            assert all(v.device.type == "meta" for v in got.values())
