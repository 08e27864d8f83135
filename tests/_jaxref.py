"""The tests' subprocesses: one environment, a time limit for each.

Every test that runs the JAX reference on fake host devices, and every
other child process a test starts (the CLIs, the examples), goes
through here::

    out = run(body, devices=8, timeout=120)       # a body -> its stdout
    ref = start(body, path, devices=2, timeout=120)  # start it now ...
    ref.wait()                                     # ... wait for it later

``cmd`` is a Python body (dedented and run with ``-c``; ``args`` follow
it in ``sys.argv[1:]``) or a list of arguments for the interpreter
(``["-m", "repro.launch.serve", ...]``, ``[script, ...]``).  The child
sees ``PYTHONPATH`` (``src`` and the repo), ``JAX_PLATFORMS=cpu``, its
own device count and XLA's collective limit in ``XLA_FLAGS``,
``OMP_NUM_THREADS`` and, through ``os.environ``, the run's compile cache
that the repo's root ``conftest.py`` sets up.

Each launch has its own time limit, counted from its start: about three
times its slowest time in the suite, at least 60 s and at most
``MAX_LIMIT_S``.  ``wait()``
kills a child still running at its limit and, as on a non-zero exit,
fails the calling test with the tail of the child's stderr.
"""
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: XLA's CPU collectives abort a run (SIGABRT) whose device threads
#: reach an all-reduce more than 40 s apart (their default), which a
#: machine loaded by the rest of the suite can cause
COLLECTIVE_LIMIT_S = 600
#: the largest time limit a launch may ask for
MAX_LIMIT_S = 300
#: XLA's quicker CPU compiles, for references that are compile-bound
#: (eager ops, each a small compile; a compile per session step)
QUICK_COMPILES = ("--xla_backend_optimization_level=0",
                  "--xla_llvm_disable_expensive_passes=true")


def env(devices=1, threads=1, xla_flags=()) -> dict:
    """The environment of a child with ``devices`` fake host devices."""
    flags = (f"--xla_force_host_platform_device_count={devices}",
             "--xla_cpu_collective_call_terminate_timeout_seconds="
             f"{COLLECTIVE_LIMIT_S}", *xla_flags)
    return dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(flags),
                OMP_NUM_THREADS=str(threads),
                PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]))


def _tail(text, n=4000):
    # every load from the compile cache logs a machine-feature warning
    # of some 3 kB: keep it out of the tail
    return "\n".join(line for line in text.splitlines()
                     if "cpu_aot_loader" not in line)[-n:]


class Launch:
    """A started child.  ``wait()`` returns its stdout, or fails the test
    (``check=False``: returns ``(returncode, stdout, stderr)``)."""

    def __init__(self, cmd, *args, timeout, devices=1, threads=1,
                 xla_flags=(), cwd=None):
        assert timeout <= MAX_LIMIT_S, timeout
        argv = ["-c", textwrap.dedent(cmd)] if isinstance(cmd, str) \
            else list(cmd)
        self.what = " ".join(["python", *(["-c", "<body>"] if isinstance(
            cmd, str) else map(str, cmd)), *map(str, args)])
        self.timeout, self.timed_out = timeout, False
        self.deadline = time.monotonic() + timeout
        self.out = self.err = None
        # files, not pipes: a child that is not being waited for cannot
        # stall on a full pipe
        self._files = [tempfile.TemporaryFile(), tempfile.TemporaryFile()]
        self.proc = subprocess.Popen(
            [sys.executable, *argv, *map(str, args)], stdout=self._files[0],
            stderr=self._files[1], cwd=cwd,
            env=env(devices, threads, xla_flags))

    def _finish(self):
        """Wait for the child up to its limit (and kill it there), then
        read and close its output files."""
        try:
            self.proc.wait(max(self.deadline - time.monotonic(), 0))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            self.timed_out = True
        texts = []
        for f in self._files:
            f.seek(0)
            texts.append(f.read().decode(errors="replace"))
            f.close()
        self.out, self.err = texts

    def wait(self, check=True):
        if self.err is None:
            self._finish()
        if self.timed_out:
            pytest.fail(f"{self.what[:200]}: ran past its {self.timeout} s "
                        f"limit\n{_tail(self.err)}", pytrace=False)
        if not check:
            return self.proc.returncode, self.out, self.err
        if self.proc.returncode != 0:
            pytest.fail(f"{self.what[:200]}: exit {self.proc.returncode}\n"
                        f"{_tail(self.err)}", pytrace=False)
        return self.out

    def close(self):
        """Stop the child if it still runs, and release its files."""
        if self.err is None:
            self.proc.kill()
            self._finish()


#: start a child now; ``.wait()`` for it later
start = Launch


def run(cmd, *args, **kw) -> str:
    """Start a child and wait for it: its stdout."""
    return start(cmd, *args, **kw).wait()
