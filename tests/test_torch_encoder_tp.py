"""whisper-tiny at TP > 1 through the port's serving walk
(``models.model.walk_layers``) against the JAX reference's model-level
``M.prefill`` / ``M.decode_step`` and against the port's own TP1 walk.

The config is ``reduced()`` (2 encoder and 2 decoder layers, d_model 256,
4 heads of 64, 16 frames, the ungated gelu MLP) in float32; weights come
from the reference's ``init_params`` through ``params_from_jax``, frames
and prompts from a numpy seed.  The layers, encoder and cross weights
are placed at the layout (``models.model.place_workers``): each worker
holds its heads of every attention (the encoder's, the decoder's and the
cross-attention's) and its column block of the ungated MLP, and each
sub-layer ends in its TP group's all-reduce.  Each slot prefills whole
(its frames through the encoder into its workers' cross memory, their
own kv slots), then every slot decodes together.

* TP1 x 2, TP2 on 2 workers and TP4 on 4 (the reduced config's 4
  heads): the first logits of every request within ``TOL`` (1e-4) of
  the reference's, greedy streams equal to the reference's loop;
* every step's logits at TP2 and TP4 within ``TOL`` of the TP1 x W
  walk's;
* a worker's cross memory holds its own kv slots only (``kv_slots /
  tp``), and the encoder's weights are sharded by heads and columns.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.padding import make_plan as jplan
from repro.models import model as JM
from repro_torch.configs import get_config as tget
from repro_torch.core.padding import make_plan as tplan
from repro_torch.launch.mesh import InstanceMesh, Layout
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

from _torch_frontend import prompts as _prompts, reference_stream

TOL = 1e-4
NEW = 6
LENS = (5, 11)
MAX_SEQ = 64
PAGE = 8
#: (workers, tp): the layouts walked
CASES = ((2, 1), (2, 2), (4, 1), (4, 4))


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(jget("whisper-tiny").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("whisper-tiny").reduced(),
                               dtype="float32")
    plan = jplan(cfg, 4, mode="page")
    params = JM.init_params(jax.random.PRNGKey(7), cfg, plan)
    host = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(9)
    frames = rng.standard_normal((len(LENS), cfg.encoder.num_frames,
                                  cfg.d_model), dtype=np.float32)
    prompts = _prompts(LENS, cfg.vocab_size, seed=4)
    return cfg, tcfg, plan, params, host, frames, prompts


@pytest.fixture(scope="module")
def reference(setup):
    cfg, _, plan, params, _, frames, prompts = setup
    return [reference_stream(params, cfg, plan, p, NEW, frames=f,
                             max_seq=MAX_SEQ)
            for p, f in zip(prompts, frames)]


def _walk(setup, W, t):
    """Each request prefilled whole into its own slot at layout TP``t``
    over ``W`` CPU workers, then greedy decode of both slots together.
    Returns (streams, first logits a slot, every decode step's logits,
    the placed static weights and cross memories)."""
    _, tcfg, _, _, host, frames, prompts = setup
    plan = tplan(tcfg, W, mode="page")
    model = Model.empty(tcfg, plan, device="cpu")
    model.load_state_dict(params_from_jax(host, tcfg, plan))
    lay = Layout(1, t)
    mesh = InstanceMesh(["cpu"] * W, lay)
    Bt = len(prompts) * (W // t)
    layers, static, cross = M.place_workers(model, mesh, lay, Bt, MAX_SEQ,
                                            PAGE)
    # the requests sit in the first replica's slots
    firsts, toks = [], []
    with torch.no_grad():
        for slot, (p, f) in enumerate(zip(prompts, frames)):
            lg = M.walk_layers(
                layers, static, tcfg, plan, mesh, M.RowSet([slot], Bt),
                torch.tensor([p]),
                torch.arange(len(p), dtype=torch.int32)[None], "seq",
                frames=torch.from_numpy(f)[None], cross=cross)
            firsts.append(lg[0])
            toks.append([int(lg[0].argmax())])
        steps = []
        pos = [len(p) for p in prompts]
        for _ in range(NEW - 1):
            tok = torch.zeros((Bt, 1), dtype=torch.long)
            posn = torch.zeros((Bt, 1), dtype=torch.int32)
            for slot in range(len(prompts)):
                tok[slot, 0] = toks[slot][-1]
                posn[slot, 0] = pos[slot]
            lg = M.walk_layers(layers, static, tcfg, plan, mesh,
                               M.RowSet(range(Bt), Bt), tok, posn,
                               "decode", cross=cross)
            steps.append(lg[:len(prompts)])
            for slot in range(len(prompts)):
                toks[slot].append(int(lg[slot].argmax()))
                pos[slot] += 1
    return toks, firsts, steps, static, cross


@pytest.fixture(scope="module")
def walks(setup):
    return {case: _walk(setup, *case) for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=[f"W{w}-TP{t}" for w, t in CASES])
def test_walk_equals_reference_model_loop(reference, walks, case):
    toks, firsts, _, _, _ = walks[case]
    for slot, (want_toks, want_first) in enumerate(reference):
        err = np.abs(firsts[slot].numpy() - want_first).max()
        assert err < TOL, (slot, err)
        assert toks[slot] == want_toks


@pytest.mark.parametrize("W,t", [(2, 2), (4, 4)])
def test_tp_walk_logits_within_tol_of_tp1(walks, W, t):
    _, f1, s1, _, _ = walks[(W, 1)]
    _, ft, st, _, _ = walks[(W, t)]
    for a, b in zip(f1 + s1, ft + st):
        assert (a - b).abs().max().item() < TOL


@pytest.mark.parametrize("W,t", [(2, 2), (4, 4)])
def test_encoder_and_cross_are_placed_by_heads(setup, walks, W, t):
    cfg = setup[0]
    plan = jplan(cfg, W, mode="page")
    _, _, _, static, cross = walks[(W, t)]
    dh = cfg.resolved_head_dim
    for w in range(W):
        enc = static[w]["encoder"]["layers"][0]
        assert enc["attn"]["wq"].shape == (cfg.d_model,
                                           plan.q_heads_padded * dh // t)
        assert enc["mlp"]["wi"].shape == (cfg.d_model,
                                          plan.d_ff_padded // t)
        assert static[w]["cross"][0]["wo"].shape == (
            plan.q_heads_padded * dh // t, cfg.d_model)
        assert cross[w].k[0].shape[2] == plan.kv_slots // t
    # worker storages are their own
    ptrs = {static[w]["cross"][0]["wq"].untyped_storage().data_ptr()
            for w in range(W)}
    assert len(ptrs) == W
