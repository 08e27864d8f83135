"""The reference's model-level serving loop for one request, shared by
the port's encoder and vision tests: ``M.prefill`` of a prompt with its
frames or patches, then greedy ``M.decode_step``s."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import model as JM


def prompts(lens, vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(0, vocab, n))) for n in lens]


_JITS = {}


def jitted(cfg, plan):
    """The reference's ``prefill`` and ``decode_step``, jitted once a
    config (each prompt length compiles once)."""
    if cfg.name not in _JITS:
        _JITS[cfg.name] = (jax.jit(partial(JM.prefill, cfg=cfg, plan=plan)),
                           jax.jit(partial(JM.decode_step, cfg=cfg,
                                           plan=plan)))
    return _JITS[cfg.name]


def reference_stream(params, cfg, plan, prompt, new, frames=None,
                     patches=None, max_seq=64):
    """The reference's model-level loop for one request: ``M.prefill``
    of the prompt (with its frames or patches) on a fresh batch-1 cache,
    then greedy ``M.decode_step``s.  Returns (tokens, first logits)."""
    batch = {"tokens": jnp.asarray([prompt], jnp.int32)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)[None]
    if patches is not None:
        batch["patches"] = jnp.asarray(patches)[None]
    prefill, step = jitted(cfg, plan)
    caches = JM.init_decode_caches(cfg, plan, 1, max_seq, 8)
    logits, caches = prefill(params, batch=batch, caches=caches)
    first = np.asarray(logits[0, -1])
    toks = [int(np.argmax(first))]
    pos = len(prompt) + (0 if patches is None else len(patches))
    while len(toks) < new:
        lg, caches = step(params, caches=caches,
                          tokens=jnp.asarray([toks[-1]], jnp.int32),
                          positions=jnp.asarray([pos], jnp.int32))
        toks.append(int(np.argmax(np.asarray(lg[0]))))
        pos += 1
    return toks, first
