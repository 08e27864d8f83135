"""The port's ``serve`` CLI (``python -m repro_torch.launch.serve``)
against the reference's (``python -m repro.launch.serve``) on the same
arguments: the same ``[serve]`` header, trace, ``step …`` / ``drain …``
action lines and final TPs, and the same metric names.

The reference runs on 4 fake host devices, the port on
``--device cpu --workers 4``, both started together.  The trace's
lengths decide every action (``eos_id`` is None), so the lines must be
equal.  The trace is short (6 requests, every third long) to keep the
reference's compiles few; it still scales an instance up and down.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--requests", "6", "--long-every", "3", "--gen-tokens", "4"]
SCHEDULERS = ("gyges",)


@pytest.fixture(scope="module")
def outputs():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_collective_call_terminate_"
                         "timeout_seconds=600")
    procs = {}
    for s in SCHEDULERS:
        args = ARGS + ["--scheduler", s]
        procs[("reference", s)] = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.serve", *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        # one torch thread: its many tiny ops would otherwise wait on a
        # pool the suite's other workers crowd out
        procs[("port", s)] = subprocess.Popen(
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


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_action_lines_equal_reference(outputs, scheduler):
    want, want_keys = _split(outputs[("reference", scheduler)])
    got, got_keys = _split(outputs[("port", scheduler)])
    assert got == want
    assert got_keys == want_keys
    acts = [l for l in got if " -> TP" in l]
    assert any("scale-up" in l for l in acts)
    assert any(l.startswith("[serve] drain: scale-down") for l in acts)
    assert got[-1] == "[serve] final TPs: [1, 1]"
