"""Optional hints for model internals (contextvar-scoped): the
counterpart of ``repro.models.shardhints``.

Model code reads a hint where the launcher has scoped one.  The one
that the port's model code reads is ``moe_blocks``: the number of
blocks a MoE layer routes its tokens in (``models.blocks.
apply_moe_mlp_train``; one block, global routing, when unset).  The
reference's ``constrain`` and ``instance_kv_hint`` place tensors for
GSPMD, and the port places its shards itself (``launch.sharding``), so
they have no counterpart here.
"""
from __future__ import annotations

import contextlib
import contextvars

_HINTS: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "shard_hints", default={})


@contextlib.contextmanager
def hints(**kw):
    tok = _HINTS.set(dict(_HINTS.get(), **kw))
    try:
        yield
    finally:
        _HINTS.reset(tok)


def get(name: str):
    return _HINTS.get().get(name)
