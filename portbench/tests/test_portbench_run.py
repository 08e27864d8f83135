"""``run.py`` exits non-zero and prints no result without a card, and in
a checkout that holds only ``BENCHMARK.json`` and the benchmark's own
files (no program)."""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(cwd, env=None):
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {}))
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen2.5-32b-l16.rag", "--seed", str(2**33 + 1), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=e, capture_output=True, text=True,
        timeout=300)


def test_no_card_no_result():
    out = run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_files_alone_no_result(tmp_path):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        paths = json.load(f)["paths"]
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in paths:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # and with a card it would still fail: the program is not there
    imp = subprocess.run([sys.executable, "-c",
                          "import sys; sys.path.insert(0, 'portbench'); "
                          "import port"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert imp.returncode != 0 and "repro_torch" in imp.stderr
