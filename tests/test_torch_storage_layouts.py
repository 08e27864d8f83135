"""The port's one-device engine in each KV storage layout of the paper's
Table 2 (``paged.layout``: ``header_centric``, ``page_friendly``,
``raw``) against the JAX ``Engine(layout=...)``.

Reduced llama3-8b in float32, weights carried over by
``params_from_jax``, prompts from a numpy seed, whole-prompt and budgeted
chunked prefill.  A token-first pool (``page_friendly``, ``raw``) runs
every attention kernel on a canonical copy (``paged.pool.kernel_pool``),
so every layout must give the same bits:

* the port's streams are EQUAL in all three layouts, and equal the
  reference's ``header_centric`` and ``page_friendly`` engines';
* the pools read back in the canonical order are bit-identical across
  layouts;
* an engine with workers refuses a token-first layout, as the
  reference's does;
* the reference's ``raw`` engine departs from its own header-centric
  stream, and its chunked prefill raises
  (``test_reference_raw_engine_departs``, ``_chunks_raise``): its slot
  extraction
  slices the pool at axis ``ndim - 5`` of its stacked pool
  (``repro/serving/engine.py:1207-1208``), which is the block axis in
  the two block-major layouts and the K/V axis in ``raw``.  The port's
  ``slot_view`` narrows the true block axis (``layout.block_axis``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.padding import make_plan as jplan
from repro.core.scheduler import PrefillPolicy as JPolicy
from repro.models import model as JM
from repro.paged import layout as JL
from repro.serving.engine import Engine as JEngine
from repro.serving.request import ServeRequest as JReq
from repro_torch.configs import get_config as tget
from repro_torch.core.padding import make_plan as tplan
from repro_torch.core.scheduler import PrefillPolicy as TPolicy
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.paged import pool as pp
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import ServeRequest as TReq

LAYOUTS = ("header_centric", "page_friendly", "raw")
LENS = (9, 31, 47)
NEW = 10
KW = dict(max_batch=3, max_seq=64, page_tokens=8)
POLICIES = {"whole": None, "chunked": dict(token_budget=16, mode="mixed")}


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jget("llama3-8b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("llama3-8b").reduced(), dtype="float32")
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = JM.init_params(jax.random.PRNGKey(0), cfg, plan)
    model = Model.empty(tcfg, tp, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg, tp))
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in LENS]
    return cfg, tcfg, params, model, prompts


_REF = {}


def _ref(pair, layout, policy):
    if (layout, policy) in _REF:
        return _REF[(layout, policy)]
    cfg, _, params, _, prompts = pair
    pol = POLICIES[policy]
    eng = JEngine(cfg, params=params, layout=layout,
                  prefill_policy=JPolicy(**pol) if pol else None, **KW)
    reqs = [JReq(p, max_new_tokens=NEW) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    _REF[(layout, policy)] = [r.generated for r in reqs]
    return _REF[(layout, policy)]


def _port(pair, layout, policy):
    _, tcfg, _, model, prompts = pair
    pol = POLICIES[policy]
    eng = TEngine(tcfg, params=model, layout=layout, device="cpu",
                  prefill_policy=TPolicy(**pol) if pol else None, **KW)
    reqs = [TReq(p, max_new_tokens=NEW) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    return [r.generated for r in reqs], eng


@pytest.fixture(scope="module")
def ported(pair):
    return {(lay, pol): _port(pair, lay, pol)
            for lay in LAYOUTS for pol in POLICIES}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_port_streams_equal_in_every_layout(ported, policy):
    base, _ = ported[("header_centric", policy)]
    for lay in LAYOUTS:
        streams, eng = ported[(lay, policy)]
        assert streams == base, lay
        assert all(c.layout == lay for c in eng.caches)
    # whole and chunked prefill agree, as in the reference's engine
    assert ported[("header_centric", "whole")][0] \
        == ported[("header_centric", "chunked")][0]


@pytest.mark.parametrize("layout,policy", [
    ("header_centric", "whole"), ("page_friendly", "whole"),
    ("page_friendly", "chunked")])
def test_streams_equal_reference_engine(pair, ported, layout, policy):
    """The reference's engines in the two layouts it serves; the port's
    other runs equal these (``test_port_streams_equal_in_every_layout``)."""
    assert ported[(layout, policy)][0] == _ref(pair, layout, policy)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_pools_read_back_canonical_are_identical(ported, policy):
    _, base = ported[("header_centric", policy)]
    for lay in ("page_friendly", "raw"):
        _, eng = ported[(lay, policy)]
        for a, b in zip(base.caches, eng.caches):
            assert b.pool.shape == JL.pool_shape(lay, *a.pool.shape[:2],
                                                 *a.pool.shape[3:])
            assert torch.equal(pp.canonical(b.pool, lay), a.pool)
            for f in ("page_table", "seq_lens", "positions"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_kernel_pool_copies_only_token_first_layouts(ported):
    """header-centric: the kernels get the pool itself (no copy);
    token-first: a contiguous canonical copy, written back in the
    storage order after an in-place kernel."""
    _, base = ported[("header_centric", "whole")]
    view = base.caches[0].slot(1)
    assert pp.kernel_pool(view) is view.pool
    for lay in ("page_friendly", "raw"):
        _, eng = ported[(lay, "whole")]
        view = eng.caches[0].slot(1)
        pool_c = pp.kernel_pool(view)
        assert pool_c.is_contiguous() and pool_c is not view.pool
        assert torch.equal(pool_c, pp.canonical(view.pool, lay))
        pool_c.add_(1.0)
        pp.commit_kernel_pool(view, pool_c)
        assert torch.equal(pp.canonical(view.pool, lay), pool_c)
        pool_c.sub_(1.0)
        pp.commit_kernel_pool(view, pool_c)


@pytest.mark.parametrize("layout", ("page_friendly", "raw"))
def test_worker_engine_refuses_token_first_layout(pair, layout):
    _, tcfg, _, _, _ = pair
    with pytest.raises(ValueError, match="header-centric"):
        TEngine(tcfg, devices=["cpu"] * 2, layout=layout, **KW)
    with pytest.raises(ValueError, match="unknown KV layout"):
        TEngine(tcfg, device="cpu", layout="head_major", **KW)


def test_reference_raw_engine_departs(pair, ported):
    """A reference-side fact, not a port fault: the reference's ``raw``
    engine departs from its header-centric stream, while the port's raw
    engine gives the header-centric stream.  The cause: the reference
    slices a slot at its stacked pool's axis ``ndim - 5``, which in
    ``raw`` order is K/V, not the block axis."""
    cfg = pair[0]
    stacked = 1 + len(JL.LAYOUTS["raw"]) + 1     # group, 4 axes, head_dim
    for lay in LAYOUTS:
        axis = JL.LAYOUTS[lay][stacked - 5 - 1]
        assert axis == ("kv" if lay == "raw" else "block"), (lay, axis)
    hc = _ref(pair, "header_centric", "whole")
    raw = _ref(pair, "raw", "whole")
    assert raw != hc
    assert ported[("raw", "whole")][0] == hc
    assert cfg.dtype == "float32"


def test_reference_raw_engine_chunks_raise(pair, ported):
    """The same cause in the reference's chunked prefill: the slot slice
    asks the K/V axis (size 2) for a slot's pages and XLA refuses the
    slice.  The port's raw engine chunks and gives the header-centric
    stream."""
    with pytest.raises(TypeError, match="slice_sizes"):
        _ref(pair, "raw", "chunked")
    assert ported[("raw", "chunked")][0] \
        == _ref(pair, "header_centric", "whole")
