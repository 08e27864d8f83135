"""The reference against the port's plain path (CPU, fp32, reduced
sizes): the port's prefill logits from the benchmark's weights equal the
reference's, for the dense block and for the patch prefix; and a small
merge serves tokens the reference puts first."""
import pytest
import torch

import harness
import port
from reference import dense as REF
from tiny import DOC, MERGE, MERGE_SERVE, RAG, tiny_cell
from traffic import generate as G

SEED = 3_000_000_777


@pytest.mark.parametrize("name", [RAG, DOC])
def test_port_prefill_logits_equal_the_reference(name):
    c = tiny_cell(name, dtype="float32")["config"]
    cfg = port.model_config(c)
    plan = port.make_plan(cfg, 1)
    model = port.load_model(c, cfg, plan, SEED, "cpu")
    prompt = G.prompt_tokens(SEED, 1, 40, c["vocab_size"])
    pat = (G.patches(SEED, 1, c["patches"], c["hidden_size"], "cpu",
                     torch.float32) if c["patches"] else None)
    caches = model.init_decode_caches(1, 128, 16)
    with torch.no_grad():
        got = model.prefill(torch.tensor([prompt]), caches,
                            patches=None if pat is None else pat[None])
    seq = REF.sequence(prompt, [0], c["patches"], pat)
    want = REF.forward(c, SEED, [seq], "cpu")["fp32"][0]
    got = got[0, -1, :c["vocab_size"]]
    assert torch.allclose(got, want[0], atol=2e-4, rtol=1e-4), \
        (got - want[0]).abs().max()


@pytest.mark.parametrize("name,serve", [(RAG, None), (DOC, None),
                                        (MERGE, MERGE_SERVE)])
def test_served_tokens_are_the_references_best(name, serve):
    """fp32 end to end: every served token is the reference's argmax (a
    gap of rounding only), through chunked prefill, decode and, for the
    merge cell, requests served across a merge and a split."""
    run = harness.Run(tiny_cell(name, dtype="float32", serve=serve), SEED,
                      3.0, False, device="cpu")
    out = harness.result(run)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["served_gap"]["value"] < 1e-3
    if name == MERGE:
        assert run.transforms, "no merge ran"
