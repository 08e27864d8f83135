"""Carry the reference's parameters over to the port.

``params_from_jax`` takes the tree ``repro.models.model.init_params``
returns, with every leaf already turned into a numpy array (the caller
does ``jax.tree.map(np.asarray, params)``), and gives a state dict for
``Model.load_state_dict``.  This module imports neither JAX nor
``repro``.

The reference stacks the layers of each pattern position over G groups
(``vmap`` in ``init_params``) and keeps R remainder layers apart; the
port's layer ``g * len(unit) + i`` is ``blocks[i][...][g]`` and the R
remainder layers follow.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.padding import PaddingPlan
from repro_torch.models.blocks import dtype_of


def _unit_len(cfg: ModelConfig) -> int:
    return len(cfg.layer_pattern) if cfg.layer_pattern else 1


def params_from_jax(np_tree, cfg: ModelConfig, plan: PaddingPlan
                    ) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg)

    def t(a) -> torch.Tensor:
        # bf16 arrays arrive as ml_dtypes bfloat16; go through float32
        a = np.asarray(a)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(dt)

    unit = _unit_len(cfg)
    G, R = cfg.num_layers // unit, cfg.num_layers % unit
    layers = []
    for g in range(G):
        for i in range(unit):
            layers.append(_index(np_tree["blocks"][i], g))
    layers.extend(np_tree["rem"][:R])

    if np.shape(np_tree["embed"]) != (plan.vocab_padded, cfg.d_model):
        raise ValueError(f"embed {np.shape(np_tree['embed'])} does not "
                         f"match the padding plan's vocab "
                         f"{plan.vocab_padded} x d_model {cfg.d_model}")
    state = {"embed": t(np_tree["embed"]),
             "final_ln": t(np_tree["final_ln"])}
    if "lm_head" in np_tree:
        state["lm_head"] = t(np_tree["lm_head"])
    for li, p in enumerate(layers):
        pre = f"layers.{li}."
        state[pre + "ln1"] = t(p["ln1"])
        state[pre + "ln2"] = t(p["ln2"])
        for k in ("wq", "wk", "wv", "wo"):
            state[pre + "attn." + k] = t(p["attn"][k])
        for k in ("wi", "wo"):
            state[pre + "mlp." + k] = t(p["mlp"][k])
    return state


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]
