"""Dry run on the meta device: every (architecture x input shape) on the
production grid, with zero allocation: the counterpart of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k [--multi-pod] [--decode-mode tp1] [--variant N]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each combination on a 16x16 (or
2x16x16) mesh of fake devices and reads the compiler's cost and memory
analyses.  The port has no compiler to ask, so it runs the combination
on a grid of workers on ``torch.device("meta")``, whose tensors carry
shapes and no data:

* a ``train`` shape runs one sharded train step (``training.sharded``:
  FSDP x TP, AdamW) over the grid;
* a ``prefill`` or ``decode`` shape runs the port's serving forward
  (``models.model.walk_layers``) over the placement ``cache_pspecs``
  gives: the slots (pages) over the batch axes and the kv heads over
  ``model`` (``--decode-mode tp``: TP over the model axis, one replica
  a data row), or the slots over the batch axes and ``model`` together
  and the heads whole (``tp1``: TP1 on every worker); a batch the slot
  axes do not divide runs whole on every replica.

Each record (one JSON a combination under ``experiments/dryrun_torch/``)
keeps the reference's keys.  ``flops_total`` is
``torch.utils.flop_counter.FlopCounterMode``'s count of the whole grid
(every worker's matrix products and attention); ``collectives`` the
bytes the grid's exchanges moved between workers, by kind
(``launch.comm_analysis``: the grid's total; ``collectives_per_device``
divides it by the workers); ``memory`` each worker's bytes of weights,
moments, inputs and caches (the largest over the workers; the
reference's ``argument_bytes`` is their sum); ``devices`` the workers.
A train shape's MoE that routes globally (no ``moe_hints``) gives each
batch shard an expert buffer with a row for each of its tokens (a
token picks an expert once), up to the batch's capacity, where the
reference's one buffer of the batch's capacity is shared out; its
record's ``moe_expert_flops_factor`` says how many times the
reference's expert FLOPs ``flops_total`` then counts.  The
compiler's keys (``compile_s``, ``bytes_accessed_total``, the
temporaries and code sizes) have no counterpart and are null.  A
combination the port cannot run on meta is recorded as skipped with its
reason, as the reference records ``long_500k`` on whisper.

Meta tensors still cost Python time an operation, and the port loops
over workers, so a full-depth combination on 256 workers takes minutes;
``--variant N`` runs N units of the layer pattern (the reference's
roofline variants).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import instance as I
from repro_torch.core.padding import make_plan
from repro_torch.core.weight_transform import relayout_block_mlp
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.comm_analysis import counting
from repro_torch.launch.mesh import (Grid, InstanceMesh, Layout,
                                     batch_axes, make_production_mesh,
                                     model_axis_size)
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models import shardhints
from repro_torch.training import adamw
from repro_torch.training import sharded as TS

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def variant_config(cfg: ModelConfig, n_units: int) -> ModelConfig:
    """Reduced-depth variant: ``n_units`` units of the layer pattern."""
    unit = cfg.layer_pattern if cfg.layer_pattern else (cfg.pattern[:1])
    return dataclasses.replace(cfg, num_layers=n_units * len(unit))


def meta_grid(multi_pod: bool, mesh_shape=None) -> Grid:
    """The production grid (or ``mesh_shape``) of workers on meta."""
    if mesh_shape is not None:
        n = 1
        for s in mesh_shape:
            n *= s
        return Grid([SP.META] * n, mesh_shape)
    n = 512 if multi_pod else 256
    return make_production_mesh([SP.META] * n, multi_pod=multi_pod)


def _bytes(ts) -> int:
    return sum(SP.nbytes(t) for t in ts)


def _train(cfg, shape: ShapeConfig, grid: Grid, plan, moe_hints,
           banded: bool) -> Dict[str, Any]:
    step = TS.ShardedStep.from_model(
        SP.param_specs(cfg, plan), grid,
        expert_mode=moe_hints if moe_hints in ("dp", "tp") else "auto",
        banded=banded)
    shards = step.shards
    inputs = SP.model_inputs(cfg, shape)
    _, opt_update = adamw(1e-3)
    opt = TS.opt_init_sharded(shards)
    fn = TS.make_sharded_train_step(step, opt_update)
    parts = TS.split_batch(inputs, grid)
    per = [{"weight_bytes": _bytes(p[w] for p in shards.values()),
            "moment_bytes": 2 * _bytes(p[w] for p in opt.mu.values()),
            "input_bytes": _bytes(parts[w].values()), "cache_bytes": 0}
           for w in range(grid.W)]
    with counting() as tally, FlopCounterMode(display=False) as fc:
        fn(opt, inputs)
    out = {"flops": fc.get_total_flops(), "tally": tally, "per": per}
    if cfg.moe is not None:
        # a worker's expert rows against its share of the reference's
        Td = parts[0]["tokens"][:, :-1].numel()
        T, nb, cap, rows = step.moe_dispatch(Td)
        out["moe_expert_flops_factor"] = T * rows / (Td * nb * cap)
    return out


def serve_layout(cfg, grid: Grid, batch: int, decode_mode: str):
    """(the serving ``Layout``, the walk's batch): kv heads over
    ``model`` give TP over the model axis, else TP1; a batch the slot
    axes do not divide runs whole on every replica (its rows
    repeated)."""
    slots, heads = SH.cache_axes(grid, batch_axes(grid), batch,
                                 decode_mode)
    tp = grid.shape["model"] if heads else 1
    rep = grid.W // tp
    return Layout(1, tp), batch * rep // grid.extent(slots or ())


def _serve(cfg, shape: ShapeConfig, grid: Grid, plan, decode_mode: str
           ) -> Dict[str, Any]:
    page_tokens = M.PAGE_TOKENS
    lay, Bw = serve_layout(cfg, grid, shape.global_batch, decode_mode)
    if cfg.encoder is not None and lay.tp > 1:
        raise _Skip("an encoder-decoder serves at TP1 x W in the port "
                    "(models.model.walk_layers); the reference's "
                    "placement puts its kv heads over model")
    if cfg.activation not in ("swiglu", "geglu") and lay.tp > 1:
        raise _Skip("an ungated MLP is held whole (TP1 only) in the "
                    "port's serving walk")
    model = SP.param_specs(cfg, plan)
    for blk in model.layers:
        relayout_block_mlp(blk.mlp, cfg.d_ff, plan.max_tp, cfg.activation)
    mesh = InstanceMesh([SP.META] * grid.W, lay)
    tp, S = lay.tp, plan.max_tp
    layers, static = I.place_replicas(
        [b.parts() for b in model.layers], model.static(), mesh, False, Bw,
        lambda kind, rows, dev: B.init_block_cache(
            kind, cfg, plan, rows, shape.seq_len, page_tokens, device=dev))
    if tp > 1:
        for layer in layers:
            full = [(a, m) for a, m in zip(layer.attn, layer.mlp)]
            if layer.kind in B.RECURRENT_KINDS:
                layer.attn = [I.reshard_rec([a], 1, tp, w % tp, SP.META)
                              for w, (a, _) in enumerate(full)]
            else:
                layer.attn = [I.shard_attn(a, tp, w % tp, plan, SP.META)
                              for w, (a, _) in enumerate(full)]
            if layer.has_mlp:
                layer.mlp = [{**I.shard_mlp(m, tp, w % tp, S, SP.META),
                              **({"router": m["router"]} if "router" in m
                                 else {})}
                             for w, (_, m) in enumerate(full)]
            layer.cache = I.split_cache(B.init_block_cache(
                layer.kind, cfg, plan, Bw, shape.seq_len, page_tokens,
                device=SP.META), lay, mesh.devices)
            layer.attn_layout = layer.mlp_layout = lay
    inputs = SP.model_inputs(cfg, shape)
    per = []
    for w in range(grid.W):
        lw = [x for l in layers for x in
              (l.ln1[w], l.ln2[w], *l.attn[w].values(),
               *(l.mlp[w].values() if l.mlp[w] else ())) if x is not None]
        st = [t for t in _leaves(static[w])]
        cache = sum(c.nbytes if c.recurrent else
                    _bytes((c.pool, c.page_table, c.seq_lens, c.positions))
                    for c in (l.cache[w] for l in layers))
        per.append({"weight_bytes": _bytes(lw + st), "moment_bytes": 0,
                    "input_bytes": _bytes(inputs.values()) * Bw
                    // shape.global_batch // max(1, grid.W // tp),
                    "cache_bytes": cache})
    rows = M.RowSet(range(Bw), Bw)
    cross = None
    if cfg.encoder is not None:
        cross = [M.CrossKV.make(cfg, plan, Bw // mesh.W, device=SP.META)
                 for _ in range(mesh.W)]
    with counting() as tally, FlopCounterMode(display=False) as fc, \
            torch.no_grad():
        if shape.kind == "prefill":
            S_tok = inputs["tokens"].shape[1]
            tokens = torch.zeros((Bw, S_tok), dtype=torch.long)
            P = inputs["patches"].shape[1] if "patches" in inputs else 0
            pos = torch.arange(P + S_tok, dtype=torch.int32).expand(
                Bw, P + S_tok)
            M.walk_layers(
                layers, static, cfg, plan, mesh, rows, tokens, pos, "seq",
                frames=(torch.empty((Bw, *inputs["frames"].shape[1:]),
                                    device=SP.META)
                        if "frames" in inputs else None),
                patches=(torch.empty((Bw, *inputs["patches"].shape[1:]),
                                     device=SP.META)
                         if "patches" in inputs else None),
                cross=cross)
        else:
            tokens = torch.zeros((Bw, 1), dtype=torch.long)
            pos = torch.full((Bw, 1), shape.seq_len - 1, dtype=torch.int32)
            M.walk_layers(layers, static, cfg, plan, mesh, rows, tokens,
                          pos, "decode", cross=cross)
    return {"flops": fc.get_total_flops(), "tally": tally, "per": per,
            "layout": str(lay), "walk_batch": Bw}


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


class _Skip(Exception):
    """A combination the port does not run, with its reason."""


def run_one(arch: str, shape_name: str, multi_pod: bool,
            decode_mode: str = "tp", variant: int = 0, save: bool = True,
            moe_hints=False, banded: bool = False, mesh_shape=None
            ) -> Dict[str, Any]:
    """One combination's record (saved under ``OUT_DIR`` with ``save``).
    ``moe_hints``: a train shape's MoE routes in the reference's blocks
    (``moe_hint_specs``: one a data shard; ``"dp"`` / ``"tp"`` also pick
    that expert mode); ``banded``: a train shape's windowed layers
    attend through ``layers.banded_attention`` (a serving shape's
    prefill runs the flash kernel's windowed branch either way);
    ``mesh_shape`` replaces the production grid."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, note = SP.supports_shape(cfg, shape)
    tag = f"{arch}_{shape_name}_{'pod2' if multi_pod else 'pod1'}" + (
        f"_v{variant}" if variant else "") + (
        f"_{decode_mode}" if decode_mode != "tp" else "") + (
        f"_moehints{moe_hints if moe_hints is not True else ''}"
        if moe_hints else "") + ("_banded" if banded else "") + (
        "_mesh" + "x".join(map(str, mesh_shape)) if mesh_shape else "")
    base = {"arch": arch, "shape": shape_name}
    if not ok:
        rec = {**base, "skipped": True, "reason": note}
        _save(tag, rec, save)
        return rec
    if shape.name == "long_500k":
        cfg = SP.long_context_variant(cfg)
    if variant:
        cfg = variant_config(cfg, variant)
    grid = meta_grid(multi_pod, mesh_shape)
    plan = make_plan(cfg, model_axis_size(grid), mode="lane")
    t0 = time.time()
    try:
        if shape.kind == "train":
            hint = {}
            if moe_hints and cfg.moe is not None:
                em = (moe_hints if moe_hints in ("dp", "tp") else
                      SH.decide_expert_mode(cfg, plan, grid.shape["data"]))
                hint = SH.moe_hint_specs(em, grid.shape["data"])
            with (shardhints.hints(**hint) if hint
                  else contextlib.nullcontext()):
                out = _train(cfg, shape, grid, plan, moe_hints, banded)
        else:
            out = _serve(cfg, shape, grid, plan, decode_mode)
    except _Skip as e:
        rec = {**base, "skipped": True, "reason": str(e),
               "decode_mode": decode_mode, "variant": variant}
        _save(tag, rec, save)
        return rec
    per = out["per"]
    worst = {k: max(p[k] for p in per) for k in per[0]}
    coll = out["tally"].collective_bytes()
    rec = {
        **base,
        "mesh": "x".join(str(grid.shape[a]) for a in grid.axis_names),
        "decode_mode": decode_mode, "variant": variant, "note": note,
        "lower_s": round(time.time() - t0, 1), "compile_s": None,
        "flops_total": float(out["flops"]),
        "bytes_accessed_total": None,
        "collectives": coll,
        "collectives_per_device": {k: v // grid.W if k != "count" else v
                                   for k, v in coll.items()},
        "memory": {"argument_bytes": sum(worst.values()),
                   "output_bytes": None, "temp_bytes": None,
                   "generated_code_bytes": None, **worst},
        "devices": grid.W,
    }
    for k in ("layout", "walk_batch"):
        if k in out:
            rec[k] = out[k]
    if out.get("moe_expert_flops_factor", 1) != 1:
        rec["moe_expert_flops_factor"] = out["moe_expert_flops_factor"]
        rec["note"] = (f"{note}; " if note else "") + (
            "MoE expert FLOPs are counted "
            f"{rec['moe_expert_flops_factor']:g}x the reference's: under "
            "global routing each batch shard's expert buffer has a row "
            "for each of its tokens, up to the batch's capacity")
    _save(tag, rec, save)
    return rec


def _save(tag: str, rec: Dict[str, Any], save: bool) -> None:
    if not save:
        return
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--decode-mode", default="tp", choices=["tp", "tp1"])
    ap.add_argument("--variant", type=int, default=0,
                    help="N units of the layer pattern (0 = full depth)")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        combos = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, args.multi_pod, args.decode_mode,
                          args.variant)
            if rec.get("skipped"):
                print(f"SKIP  {arch:26s} {shape:12s} {rec['reason'][:60]}")
            else:
                print(f"OK    {arch:26s} {shape:12s} "
                      f"mesh={rec['mesh']:8s} "
                      f"run={rec['lower_s']:6.1f}s "
                      f"flops={rec['flops_total']:.3e} "
                      f"coll_bytes={sum(v for k, v in rec['collectives'].items() if k != 'count'):.3e}")
        except Exception as e:
            failures += 1
            print(f"FAIL  {arch:26s} {shape:12s} {type(e).__name__}: {e}")
            traceback.print_exc(limit=3)
    if failures:
        raise SystemExit(f"{failures} dry-run failures")


if __name__ == "__main__":
    main()
