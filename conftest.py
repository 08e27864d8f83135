"""Settings that every test process of a run shares.  pytest loads this
file before ``tests/conftest.py``, in the controller and in every xdist
worker.

- **Threads.** Torch runs on one intra-op thread in every test process:
  the port's tests run many tiny ops, which on a thread pool wait on
  cores that the suite's other workers crowd out (a file ran up to 6-7x
  its standalone time so).  Children get ``OMP_NUM_THREADS`` from
  ``tests/_jaxref.py``, 1 unless a launch asks for more.
- **Compile cache.** A run shares one JAX persistent compilation cache.
  The controller makes an empty directory for it when the run starts,
  exports it through ``os.environ`` before the workers start, and
  removes it when the run ends, so no run depends on another.  Workers
  and every subprocess a test starts inherit it: one process loads what
  another compiled for the same program.  It keeps every compile (no
  minimum compile time, no minimum size).  It sets no device count and
  changes no numerics: an entry is keyed on the program, the XLA flags
  and the devices, and holds the executable that the same compile would
  have built.
"""
import os
import shutil
import sys
import tempfile

try:
    import torch
except ImportError:  # the JAX package's tests run without torch
    pass
else:
    torch.set_num_threads(1)

CACHE_DIR = "JAX_COMPILATION_CACHE_DIR"


def pytest_configure(config):
    if not hasattr(config, "workerinput"):  # the controller
        os.environ.update({
            CACHE_DIR: tempfile.mkdtemp(prefix="jax-cache-"),
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
            "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "-1"})
    # JAX reads these variables when it is imported; one imported
    # before they were set takes them here, before its first compile
    if "jax" in sys.modules:
        jax = sys.modules["jax"]
        jax.config.update("jax_compilation_cache_dir", os.environ[CACHE_DIR])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def pytest_unconfigure(config):
    if not hasattr(config, "workerinput"):
        shutil.rmtree(os.environ.pop(CACHE_DIR, ""), ignore_errors=True)
