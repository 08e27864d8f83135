"""The system under test: the PyTorch and CUDA port (``src/repro_torch``).

The one file of the benchmark that imports the program.  It turns a
configuration file into the port's ``ModelConfig`` (from the registry,
its depth and norm as the file states, every width checked against the
file), loads the benchmark's weights into the port's model (its padded
layouts are the port's own: the reference never sees them), and builds
the serving set-up of a cell: one ``Engine``, or a ``ClusterEngine`` of
one-worker instances.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List

import torch

from lib import ROOT
import weights as W

sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.padding import make_plan  # noqa: E402
from repro_torch.core.weight_transform import relayout_block_mlp  # noqa: E402
from repro_torch.kernels import chunk_prefill as CP  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.cluster import ClusterEngine  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.request import ServeRequest  # noqa: E402

#: the kernel wrappers whose calls the traced run records: module,
#: attribute
KERNELS = {"flash": (FA, "flash_attention"),
           "chunk": (CP, "chunk_prefill_attention"),
           "decode": (PA, "paged_decode")}


def model_config(c: Dict):
    """The port's config for the file ``c``: the registry's entry at the
    file's depth, norm epsilon and rope base; a width that differs from
    the file's is an error, not a silent change of model."""
    base = get_config(c["arch"])
    if c.get("smoke"):
        base = base.reduced()       # the benchmark's CPU tests only
    cfg = dataclasses.replace(
        base, name=c["name"],
        num_layers=c["num_hidden_layers"], norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"], dtype=c["dtype"])
    d, hq, hkv, dh, ff, vocab = W.dims(c)
    have = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.vision.num_patches if cfg.vision else 0, cfg.activation,
            cfg.tie_embeddings, cfg.arch_type in ("dense", "vlm"))
    want = (d, hq, hkv, dh, ff, vocab, c.get("patches", 0), "swiglu",
            False, True)
    if have != want:
        raise ValueError(f"the port's {c['arch']} {have} is not the "
                         f"configuration file's {want}")
    return cfg


def load_model(c: Dict, cfg, plan, seed: int, device) -> Model:
    """The port's model holding the benchmark's weights for ``seed``:
    padded vocabulary rows and columns and padded MLP columns zero, the
    MLP's gate and up side by side as the port keeps them."""
    d, hq, hkv, dh, ff, vocab = W.dims(c)
    if (plan.q_heads_padded, plan.kv_padded) != (hq, hkv):
        raise ValueError(f"plan pads attention heads: {plan}")
    m = Model.empty(cfg, plan, device=device)
    sd = m.state_dict()
    st = W.static(c, seed, device)
    sd["embed"].zero_()[:vocab].copy_(st["embed"])
    sd["lm_head"].zero_()[:, :vocab].copy_(st["head"])
    sd["final_ln"].copy_(st["final_ln"])
    if "vision_proj" in st:
        sd["vision_proj"].copy_(st["vision_proj"])
    del st
    ffp = plan.d_ff_padded
    for i in range(cfg.num_layers):
        w = W.layer(c, seed, i, device)
        p = f"layers.{i}."
        for k in ("ln1", "ln2"):
            sd[p + k].copy_(w[k])
        for k in ("wq", "wk", "wv", "wo"):
            sd[p + "attn." + k].copy_(w[k])
        wi = sd[p + "mlp.wi"].zero_()
        wi[:, :ff].copy_(w["w_gate"])
        wi[:, ffp:ffp + ff].copy_(w["w_up"])
        sd[p + "mlp.wo"].zero_()[:ff].copy_(w["w_down"])
        del w
    return m


def make_server(c: Dict, serve: Dict, seed: int, device):
    """The cell's serving set-up with the benchmark's weights."""
    cfg = model_config(c)
    page = c["engine"]["page_tokens"]
    if serve["kind"] == "engine":
        plan = make_plan(cfg, 1)
        model = load_model(c, cfg, plan, seed, device)
        return Engine(cfg, params=model, max_batch=serve["max_batch"],
                      max_seq=serve["max_seq"], page_tokens=page,
                      device=device, plan=plan)
    if serve["kind"] == "cluster":
        n, per = serve["instances"], serve["workers_per_instance"]
        plan = make_plan(cfg, n * per, mode="page")
        model = load_model(c, cfg, plan, seed, device)
        for blk in model.layers:
            relayout_block_mlp(blk.mlp, cfg.d_ff, n * per, cfg.activation)
        return ClusterEngine(cfg, [device] * (n * per), n_instances=n,
                             max_batch=serve["max_batch"],
                             max_seq=serve["max_seq"], page_tokens=page,
                             params=model,
                             transform_attn=serve["transform_attn"])
    raise ValueError(f"unknown serving kind {serve['kind']!r}")


def build_kernels() -> bool:
    """Load the port's CUDA kernels, building any that this checkout has
    not built yet (its first run); True where one was compiled."""
    from repro_torch.kernels import _build
    return bool(_build.build_all())


def request(prompt: List[int], out_len: int, patches=None) -> ServeRequest:
    """A greedy request (every served token is checked against the
    reference's best)."""
    return ServeRequest(prompt=prompt, max_new_tokens=out_len,
                        temperature=0.0, patches=patches)


def engines(server) -> List[Engine]:
    return server.engines if isinstance(server, ClusterEngine) else [server]


def idle(server) -> bool:
    """No request queued or in service, and no session open."""
    if isinstance(server, ClusterEngine):
        return server.idle
    return (not server.waiting and not server.transforming
            and all(s is None for s in server.slots))


def settled(server) -> bool:
    """Idle, and every instance back at its own workers at TP1 (a
    cluster splits a merged engine some steps after it drains)."""
    return idle(server) and all(e.tp == 1 and not e.parked
                                for e in engines(server))


def stall_steps(server) -> int:
    return getattr(server, "stall_steps", 0)

