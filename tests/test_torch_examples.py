"""The port's four examples run on the CPU at reduced size, as
subprocesses started together: the quickstart serves its requests, the
live TP change keeps every stream equal to an untransformed engine's,
the cluster merges and splits with no stall, and the training driver
lowers the loss and writes a checkpoint (each script asserts its own
claims and exits non-zero otherwise)."""
import pathlib

import pytest

from _jaxref import start

ROOT = pathlib.Path(__file__).resolve().parents[1]

RUNS = {
    "torch_quickstart": ([], "req3 prompt=[42]"),
    "torch_serve_transform": ([], "token continuity preserved"),
    "torch_serve_cluster": ([], "act 2: merged to TP8, split back"),
    "torch_train_driver": (["--arch", "llama3-8b", "--steps", "40",
                            "--batch", "8", "--seq", "32"], "(improved)"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = tmp_path_factory.mktemp("ck")
    procs = {}
    for name, (args, _) in RUNS.items():
        extra = ["--ckpt", str(ck)] if name == "torch_train_driver" else []
        procs[name] = start(
            [str(ROOT / "examples" / f"{name}.py"),
             "--device", "cpu", *args, *extra],
            threads=2, cwd=ROOT, timeout=80)
    out = {}
    for name, p in procs.items():
        rc, stdout, stderr = p.wait(check=False)
        out[name] = (stdout + stderr, rc)
    return out, ck


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_cpu(runs, name):
    out, ck = runs
    text, rc = out[name]
    assert rc == 0, text[-3000:]
    assert RUNS[name][1] in text, text[-3000:]
    if name == "torch_train_driver":
        assert (ck / "index.json").exists()
