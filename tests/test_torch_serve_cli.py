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

whisper-tiny and phi-3-vision-4.2b (``FRONTEND_ARCHS``) run on the port
alone, at their reduced configs on 2 CPU workers, with stub frames and
patches from ``--seed``: the reference's engine cannot serve whisper
(it never passes the frames) and its phi-3-vision ignores patches.
They serve every request at TP1, and a trace with long requests, which
would make the scheduler transform them, is refused at start.
"""
import pytest

from _jaxref import start

ARGS = ["--requests", "6", "--long-every", "3", "--gen-tokens", "4"]
SCHEDULERS = ("gyges",)
ARCHS = ("llama3-8b", "granite-moe-3b-a800m")
CASES = [(s, a) for s in SCHEDULERS for a in ARCHS]
#: the default architecture's cases keep the scheduler's name as id
IDS = [s if a == ARCHS[0] else f"{s}-{a}" for s, a in CASES]


@pytest.fixture(scope="module")
def outputs():
    procs = {}
    for s, arch in CASES:
        args = ARGS + ["--scheduler", s, "--arch", arch]
        procs[("reference", s, arch)] = start(
            ["-m", "repro.launch.serve", *args], devices=4, timeout=220)
        procs[("port", s, arch)] = start(
            ["-m", "repro_torch.launch.serve", *args,
             "--device", "cpu", "--workers", "4"], timeout=60)
    out = {}
    for key, proc in procs.items():
        stdout = proc.wait()
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


FRONTEND_ARCHS = ("whisper-tiny", "phi-3-vision-4.2b")
FRONTEND_ARGS = ["--device", "cpu", "--workers", "2", "--instances", "1",
                 "--requests", "4", "--long-every", "0", "--gen-tokens",
                 "4", "--max-seq", "64", "--seed", "3"]


@pytest.fixture(scope="module")
def frontend_outputs():
    runs = {a: FRONTEND_ARGS + ["--arch", a] for a in FRONTEND_ARCHS}
    # the default trace has long requests: refused for these models
    runs["refused"] = ["--device", "cpu", "--arch", FRONTEND_ARCHS[0]]
    procs = {k: start(["-m", "repro_torch.launch.serve", *args], timeout=60)
             for k, args in runs.items()}
    return {k: p.wait(check=False) for k, p in procs.items()}


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_arch_serves_at_a_static_degree(frontend_outputs, arch):
    rc, out, err = frontend_outputs[arch]
    assert rc == 0, err[-4000:]
    lines = [l for l in out.splitlines() if l.startswith("[serve]")]
    assert lines[0].startswith(f"[serve] {arch}-smoke: 1 instances x 2")
    assert lines[1] == "[serve] trace: 4 requests (0 long)"
    assert lines[2] == "[serve] final TPs: [1]"
    assert "finished=4, total=4" in lines[3]
    assert "n_transforms=0.000" in lines[3]


def test_frontend_arch_with_long_requests_is_refused(frontend_outputs):
    rc, out, err = frontend_outputs["refused"]
    assert rc == 2 and not out
    assert "does not cover encoder/vision" in err
    assert "--long-every 0" in err
