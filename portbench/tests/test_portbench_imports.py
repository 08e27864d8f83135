"""No module a run loads is JAX, its libraries or the JAX package
(compared by whole top-level name: the program's own name begins with
the JAX package's), and the reference loads none of those nor the
program."""
import json
import os
import subprocess
import sys

import lib

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(BENCH, "tests")

RUN = f"""
import json, sys
sys.path[:0] = [{BENCH!r}, {TESTS!r}]
import harness
from tiny import RAG, tiny_cell
harness.result(harness.Run(tiny_cell(RAG), 5, 1.0, True, device="cpu"))
print(json.dumps(sorted(sys.modules)))
"""

REF = f"""
import json, sys
sys.path.insert(0, {BENCH!r})
from reference import dense
print(json.dumps(sorted(sys.modules)))
"""


def modules(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = modules(RUN)
    assert "repro_torch" in mods            # it did run the program
    assert lib.forbidden_modules(mods) == []


def test_the_reference_loads_neither_jax_nor_the_program():
    tops = {m.split(".")[0] for m in modules(REF)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    assert not {m for m in tops if m in ("port", "harness")}


def test_forbidden_names_compare_whole():
    assert lib.forbidden_modules(["repro_torch.models", "reprox"]) == []
    assert lib.forbidden_modules(["repro.models", "jax.numpy",
                                  "flax"]) == ["flax", "jax", "repro"]
