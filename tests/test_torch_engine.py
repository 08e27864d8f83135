"""The port's serving engine against the JAX ``Engine`` (reduced
llama3-8b, float32, weights carried over by ``params_from_jax``).

Greedy token streams must be EQUAL, for whole-prompt prefill, budgeted
mixed-mode chunked prefill, and more requests than slots.  Without a GPU
``Engine(cfg)`` must raise rather than drop to the CPU.
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
from repro.serving.engine import Engine as JEngine
from repro.serving.request import ServeRequest as JReq
from repro_torch.configs import get_config as tget
from repro_torch.core.padding import make_plan as tplan
from repro_torch.core.scheduler import PrefillPolicy as TPolicy
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import ServeRequest as TReq


@pytest.fixture(scope="module")
def pair():
    cfg = dataclasses.replace(jget("llama3-8b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("llama3-8b").reduced(), dtype="float32")
    plan, tp = jplan(cfg, 1), tplan(tcfg, 1)
    params = JM.init_params(jax.random.PRNGKey(0), cfg, plan)
    model = Model.empty(tcfg, tp)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg, tp))
    return cfg, tcfg, params, model


def _prompts(lens, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, n))) for n in lens]


# name, prompt lengths, max_batch, policy kwargs (None = whole prompts)
SCENARIOS = [
    ("whole_prompt", (5, 23, 40), 3, None),
    ("budgeted_mixed_chunks", (9, 31, 47), 3,
     dict(token_budget=16, mode="mixed")),
    ("more_requests_than_slots", (5, 23, 40, 17, 31, 9), 2,
     dict(token_budget=16, mode="mixed")),
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s[0] for s in SCENARIOS])
def test_greedy_streams_equal_reference(pair, scenario):
    cfg, tcfg, params, model = pair
    _, lens, max_batch, pol = scenario
    prompts = _prompts(lens, cfg.vocab_size)
    je = JEngine(cfg, params=params, max_batch=max_batch, max_seq=64,
                 page_tokens=8,
                 prefill_policy=JPolicy(**pol) if pol else None)
    te = TEngine(tcfg, params=model, max_batch=max_batch, max_seq=64,
                 page_tokens=8,
                 prefill_policy=TPolicy(**pol) if pol else None,
                 device="cpu")
    jr = [JReq(p, max_new_tokens=10) for p in prompts]
    tr = [TReq(p, max_new_tokens=10) for p in prompts]
    for r in jr:
        je.submit(r)
    for r in tr:
        te.submit(r)
    je.run_until_done()
    te.run_until_done()
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert all(r.done and r.ttft is not None for r in tr)
    assert te.load() == 0.0 and te.kv_free_tokens() == max_batch * 64
    assert te.max_seq_at(1) == 64 and not te.has_long_request()


def test_engine_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(cfg, max_seq=32, page_tokens=8)
    with pytest.raises(RuntimeError):
        tengine.resolve_device("cuda")
    assert tengine.resolve_device("cpu").type == "cpu"


def test_params_on_another_device_are_refused(pair):
    _, tcfg, _, model = pair
    with pytest.raises(ValueError, match="params live on"):
        TEngine(tcfg, params=model, device="meta")
