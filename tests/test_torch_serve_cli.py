"""The port's ``serve`` CLI (``python -m repro_torch.launch.serve``)
against the reference's (``python -m repro.launch.serve``) on the same
arguments: the same ``[serve]`` header, trace, ``step …`` / ``drain …``
action lines and final TPs, and the same metric names.

The reference runs on 4 fake host devices, the port on
``--device cpu --workers 4``, both started together.  The trace's
lengths decide every action (``eos_id`` is None), so the lines must be
equal.  The trace is short (6 requests, every third long) to keep the
reference's compiles few; it still scales an instance up and down.
Each architecture of ``ARCHS`` runs at its reduced config: the default
llama3-8b and granite-moe-3b-a800m (MoE layers, 4 experts top-2).
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--requests", "6", "--long-every", "3", "--gen-tokens", "4"]
SCHEDULERS = ("gyges",)
ARCHS = ("llama3-8b", "granite-moe-3b-a800m")
CASES = [(s, a) for s in SCHEDULERS for a in ARCHS]
#: the default architecture's cases keep the scheduler's name as id
IDS = [s if a == ARCHS[0] else f"{s}-{a}" for s, a in CASES]


@pytest.fixture(scope="module")
def outputs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_collective_call_terminate_"
                         "timeout_seconds=600")
    procs = {}
    for s, arch in CASES:
        args = ARGS + ["--scheduler", s, "--arch", arch]
        procs[("reference", s, arch)] = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.serve", *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        # one torch thread: its many tiny ops would otherwise wait on a
        # pool the suite's other workers crowd out
        procs[("port", s, arch)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *args,
             "--device", "cpu", "--workers", "4"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(env, OMP_NUM_THREADS="1"))
    out = {}
    for key, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, (key, stderr[-4000:])
        out[key] = [l for l in stdout.splitlines() if l.startswith("[serve]")]
    return out


def _split(lines):
    """(every line but the metrics, the metric names)."""
    *head, metrics = lines
    return head, [kv.split("=")[0] for kv in metrics[8:].split(", ")]


@pytest.mark.parametrize("scheduler,arch", CASES, ids=IDS)
def test_action_lines_equal_reference(outputs, scheduler, arch):
    want, want_keys = _split(outputs[("reference", scheduler, arch)])
    got, got_keys = _split(outputs[("port", scheduler, arch)])
    assert got == want
    assert got_keys == want_keys
    acts = [l for l in got if " -> TP" in l]
    assert any("scale-up" in l for l in acts)
    assert any(l.startswith("[serve] drain: scale-down") for l in acts)
    assert got[-1] == "[serve] final TPs: [1, 1]"
