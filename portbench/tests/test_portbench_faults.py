"""A run with its timed path broken underneath comes out not correct:
the chip look skipped (CPU, reduced sizes, the cell's own limit), once
for each fault a served cell can have: a token altered where it is
produced, and a decode step that leaves its state (the KV cache)
unchanged.  And the control, the reference in fp8 in the program's
place, which the harness then holds to the limit: here, at a reduced
size, it reads three times the sound path's gap or more; on the card,
at the cell's size, ``correct`` reads false on three seeds
(``control.py``)."""
import json
import os
import subprocess
import sys

import pytest
import torch

import harness
import lib
from tiny import DOC, MERGE, MERGE_SERVE, RAG, tiny_cell

SEED = 3_000_000_555
CELLS = [(RAG, None), (DOC, None), (MERGE, MERGE_SERVE)]


def altered_tokens(monkeypatch):
    """Every fourth batched decode puts first the token after its
    argmax."""
    from repro_torch.serving import engine as E
    orig = E.Engine._decode
    calls = [0]

    def decode(self, tokens, positions):
        out = orig(self, tokens, positions)
        calls[0] += 1
        if calls[0] % 4 == 0:
            nxt = (out.argmax(-1) + 1) % self.cfg.vocab_size
            out.scatter_(1, nxt[:, None], out.max(-1).values[:, None] + 1)
        return out
    monkeypatch.setattr(E.Engine, "_decode", decode)


def unchanged_state(monkeypatch):
    """A decode step appends no key or value to the cache."""
    from repro_torch.paged import pool as pp
    monkeypatch.setattr(pp, "append_token", lambda cache, k, v: cache)


@pytest.mark.parametrize("fault", [altered_tokens, unchanged_state])
@pytest.mark.parametrize("name,serve", CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, name, serve, fault):
    fault(monkeypatch)
    cell = tiny_cell(name, serve=serve)
    out = harness.result(harness.Run(cell, SEED, 3.0, False, device="cpu"))
    gap = out["checks"]["served_gap"]
    assert not out["correct"] and gap["value"] > gap["limit"]


@pytest.mark.parametrize("name,serve", CELLS)
def test_the_sound_path_is_correct_and_the_control_is_far(name, serve):
    cell = tiny_cell(name, serve=serve)
    out = harness.result(harness.Run(cell, SEED, 3.0, False, device="cpu"),
                         control=True)
    limit = out["checks"]["served_gap"]["limit"]
    sound, fp8 = out["control"]["served_gap"], out["control"]["control_gap"]
    assert sound <= limit
    assert fp8 >= max(3 * sound, 0.05)
    # the harness holds the control, not the program, to the limit
    assert out["checks"]["served_gap"]["value"] == fp8
    assert out["correct"] == (fp8 <= limit)


CARD_SEEDS = "3000100001,3000100002,3000100003"


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  lib.benchmark()["workloads"]])
def test_the_control_fails_the_cells_limit_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control at the cell's size")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(here, "control.py"), "--workload",
         name, "--seconds", "10", "--seeds", CARD_SEEDS],
        capture_output=True, text=True, timeout=3000, check=True)
    rows = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{")]
    limit = lib.cell(name)["serve"]["limits"]["served_gap"]
    assert len(rows) == 3
    assert all(r["control_gap"] > limit >= r["served_gap"] for r in rows)
    assert not any(r["correct"] for r in rows)
