"""The launch helper (``_jaxref.py``) and the run's settings (the
repo's root ``conftest.py``): a failing or overlong child fails its test
with the tail of its stderr, a child's environment carries its device
count, XLA's collective limit, its thread setting and the run's compile
cache, and torch runs on one thread."""
import os
import pathlib
import time

import jax
import pytest

from _jaxref import COLLECTIVE_LIMIT_S, env, run, start


def test_nonzero_exit_fails_with_the_stderr_tail():
    body = """
        import sys
        print("x" * 9000, file=sys.stderr)
        print("the last words", file=sys.stderr)
        sys.exit(3)
    """
    with pytest.raises(pytest.fail.Exception,
                       match=r"exit 3\n[\s\S]*the last words$") as e:
        run(body, timeout=30)
    assert len(str(e.value)) < 4500


def test_a_child_past_its_limit_fails_within_seconds():
    body = """
        import sys, time
        print("started", file=sys.stderr, flush=True)
        time.sleep(60)
    """
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match=r"ran past its 1 s limit\n[\s\S]*started"):
        run(body, timeout=1)
    assert time.monotonic() - t0 < 10


def test_env_carries_devices_limit_threads_and_the_runs_cache():
    e = env(devices=4, threads=2)
    flags = e["XLA_FLAGS"].split()
    assert "--xla_force_host_platform_device_count=4" in flags
    assert ("--xla_cpu_collective_call_terminate_timeout_seconds="
            f"{COLLECTIVE_LIMIT_S}") in flags
    assert e["JAX_PLATFORMS"] == "cpu"
    assert e["OMP_NUM_THREADS"] == "2" and env()["OMP_NUM_THREADS"] == "1"
    # the run's cache: made for this run, on in this process, and in the
    # env of every child (also of those started from ``os.environ``)
    cache = jax.config.jax_compilation_cache_dir
    assert pathlib.Path(cache).name.startswith("jax-cache-")
    assert pathlib.Path(cache).is_dir()
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == cache
    assert e["JAX_COMPILATION_CACHE_DIR"] == cache
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
    assert e["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] == "0"
    assert e["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] == "-1"


def test_a_child_sees_its_devices_threads_and_the_runs_cache():
    body = """
        import os, jax
        print(len(jax.devices()), os.environ["OMP_NUM_THREADS"],
              jax.config.jax_compilation_cache_dir)
    """
    out = run(body, devices=3, threads=2, timeout=60).split()
    assert out == ["3", "2", jax.config.jax_compilation_cache_dir]


def test_started_children_run_together_and_report_on_wait():
    body = "import sys; print(sys.argv[1:])"
    a, b = start(body, "a", 1, timeout=30), start(body, "b", timeout=30)
    assert b.wait() == "['b']\n" and a.wait() == "['a', '1']\n"
    rc, out, err = start("import sys; sys.exit('no')", timeout=30).wait(
        check=False)
    assert (rc, out, err) == (1, "", "no\n")


def test_torch_runs_on_one_thread():
    import torch
    assert torch.get_num_threads() == 1
