"""Carry the reference's parameters over to the port.

``params_from_jax`` takes the tree ``repro.models.model.init_params``
returns, with every leaf already turned into a numpy array (the caller
does ``jax.tree.map(np.asarray, params)``) or a tensor (a reference
checkpoint read by ``training.checkpoint.restore``), and gives a state
dict for ``Model.load_state_dict``; any tree of the same structure
(the reference's gradients, its AdamW moments) maps the same way.
This module imports neither JAX nor ``repro``.

The reference stacks the layers of each pattern position over G groups
(``vmap`` in ``init_params``) and keeps R remainder layers apart; the
port's layer ``g * len(unit) + i`` is ``blocks[i][...][g]`` and the R
remainder layers follow.

A gated MLP is re-laid for the plan's ``max_tp`` shards
(``core.weight_transform.relayout_block_mlp``): the reference pads
``d_ff`` at the global tail, the port at the tail of every shard (the
Eq. 2 layout its padded FFN kernel and its workers' shards read).  The
padding is zero, so the function is the same; at ``max_tp = 1`` the two
layouts are one.  A MoE layer's ``mlp`` carries ``router`` as it is,
its expert tensors ``wi (Ep, d, 2*ffp)`` / ``wo (Ep, ffp, d)`` re-laid
expert by expert, and its shared expert (the reference's
``mlp/shared/{wi,wo}``) as ``mlp.shared_wi`` / ``mlp.shared_wo``.  A
recurrent layer's mixer leaves, which the reference keeps at the
layer's top level, go under ``rec``: RGLRU's (``a_param`` stays fp32 in
every model dtype, as the reference's init makes it), MLSTM's and
SLSTM's; an MLSTM or SLSTM layer has one norm, ``ln``, and no MLP.

A vision model's ``vision_proj`` comes across as it is.  An
encoder-decoder's ``encoder`` (``frame_proj``, its ATTN blocks stacked
over its depth by the reference's ``vmap``, ``final_ln``) becomes
``encoder.*`` with one ``encoder.layers.{l}`` a block, and its
per-group ``cross`` weights (stacked over the groups) ``cross.{g}.*``.
The encoder's MLP is never sharded, so it keeps the reference's layout.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import MLSTM, RGLRU, SLSTM, ModelConfig
from repro_torch.core.padding import PaddingPlan
from repro_torch.core.weight_transform import relayout_block_mlp
from repro_torch.models.blocks import dtype_of

#: the mixer leaves of each recurrent kind
REC_KEYS = {
    RGLRU: ("w_in", "conv_w", "conv_b", "w_gx", "w_ga", "a_param", "w_out"),
    MLSTM: ("wq", "wk", "wv", "w_if", "w_og", "w_out"),
    SLSTM: ("w_zifo", "r_diag", "w_out"),
}


def _unit_len(cfg: ModelConfig) -> int:
    return len(cfg.layer_pattern) if cfg.layer_pattern else 1


def params_from_jax(np_tree, cfg: ModelConfig, plan: PaddingPlan
                    ) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg)

    def t(a, to=dt) -> torch.Tensor:
        if isinstance(a, torch.Tensor):     # e.g. a restored checkpoint
            return a.to(to)
        # bf16 arrays arrive as ml_dtypes bfloat16; go through float32
        a = np.asarray(a)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(to)

    unit = _unit_len(cfg)
    G, R = cfg.num_layers // unit, cfg.num_layers % unit
    layers = []
    for g in range(G):
        for i in range(unit):
            layers.append(_index(np_tree["blocks"][i], g))
    # a checkpoint keeps no empty list: no remainder layers, no "rem"
    layers.extend(np_tree.get("rem", [])[:R])
    kinds = cfg.pattern

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
        kind = kinds[li]
        if kind in REC_KEYS:
            for k in REC_KEYS[kind]:
                state[pre + "rec." + k] = t(
                    p[k], torch.float32 if k == "a_param" else dt)
        if kind in (MLSTM, SLSTM):
            state[pre + "ln"] = t(p["ln"])
            continue
        state[pre + "ln1"] = t(p["ln1"])
        state[pre + "ln2"] = t(p["ln2"])
        if kind not in REC_KEYS:
            for k in ("wq", "wk", "wv", "wo"):
                state[pre + "attn." + k] = t(p["attn"][k])
        mlp = {k: t(v) for k, v in p["mlp"].items() if k != "shared"}
        if "shared" in p["mlp"]:
            mlp["shared_wi"] = t(p["mlp"]["shared"]["wi"])
            mlp["shared_wo"] = t(p["mlp"]["shared"]["wo"])
        relayout_block_mlp(mlp, cfg.d_ff, plan.max_tp, cfg.activation)
        state.update({pre + "mlp." + k: v for k, v in mlp.items()})
    if "vision_proj" in np_tree:
        state["vision_proj"] = t(np_tree["vision_proj"])
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        state["encoder.frame_proj"] = t(enc["frame_proj"])
        state["encoder.final_ln"] = t(enc["final_ln"])
        for li in range(cfg.encoder.num_layers):
            p = _index(enc["blocks"][0], li)
            pre = f"encoder.layers.{li}."
            state[pre + "ln1"] = t(p["ln1"])
            state[pre + "ln2"] = t(p["ln2"])
            for part in ("attn", "mlp"):
                state.update({f"{pre}{part}.{k}": t(v)
                              for k, v in p[part].items()})
        for g in range(cfg.num_layers // unit):
            state.update({f"cross.{g}.{k}": t(v) for k, v in
                          _index(np_tree["cross"], g).items()})
    return state


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]
