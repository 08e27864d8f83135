"""PyTorch + CUDA port of the Gyges reproduction (``repro`` is the JAX
reference).  This package imports ``torch`` and never ``jax`` or
``repro``; its kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``), built at first use by ``kernels/_build.py``."""
