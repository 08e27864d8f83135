"""The port's meta-device dry run (``launch.dryrun``) and the dry run of
the transformation itself (``launch.transform_dryrun``) on the small
meshes of ``tests/test_dryrun_small.py`` (2x4, and 2x2x2 multi-pod),
one arch per family as that test picks them, at one unit of the layer
pattern (``--variant 1``):

* every record keeps the reference's keys, and ``flops_total > 0``;
* a train shape's per-worker weight and moment bytes equal the
  reference's per-device shard bytes, computed from its ``param_pspecs``
  (FSDP) on its ``eval_shape`` tree;
* llama3-8b's train-step tally equals the analytic FSDP + TP count
  (``training.sharded.analytic_bytes``);
* ``banded=True`` gives a train shape's windowed layer fewer FLOPs and
  the same exchanges; a MoE train record under global routing carries
  ``moe_expert_flops_factor``, one under the dispatch hints does not;
* the reference's own skip (whisper's ``long_500k``) is recorded with
  its reason, and whisper with its kv heads over ``model`` runs, its
  all-reduces tallied;
* 4 x (TP1) -> TP4 through the port's live transform on meta: 0 weight
  bytes between workers, and pool all-to-all bytes of (k-1)/k of its
  pages;
* the tally's keys are the reference's ``collective_bytes``'.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.core.padding import make_plan as jplan
from repro.launch import sharding as JSH
from repro.launch import specs as JSP
from repro.launch.hlo_analysis import collective_bytes as jcollective_bytes
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.padding import make_plan
from repro_torch.launch import dryrun as DR
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch import transform_dryrun as TD
from repro_torch.launch.mesh import Grid
from repro_torch.models import model as M
from repro_torch.training import sharded as TS

REF_KEYS = {"arch", "shape", "mesh", "decode_mode", "variant", "note",
            "lower_s", "compile_s", "flops_total", "bytes_accessed_total",
            "collectives", "memory", "devices"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes"}

CASES = [("llama3-8b", "train_4k", 256, 8),
         ("granite-moe-3b-a800m", "decode_32k", 512, 8),
         ("xlstm-1.3b", "decode_32k", 512, 8),
         ("recurrentgemma-9b", "prefill_32k", 512, 8),
         ("whisper-tiny", "train_4k", 256, 8)]


@pytest.fixture
def small(monkeypatch):
    """Shrink the shapes as the reference's small-mesh test does."""
    def shrink(shape, seq, batch):
        monkeypatch.setattr(DR, "SHAPES", dict(DR.SHAPES, **{
            shape: dataclasses.replace(SHAPES[shape], seq_len=seq,
                                       global_batch=batch)}))
    return shrink


def _ref_device_bytes(arch, mesh_shape):
    """The reference's per-device weight bytes and elements at
    ``mesh_shape`` under its FSDP pspecs, at one unit of the layer
    pattern."""
    cfg = jget(arch)
    unit = cfg.layer_pattern if cfg.layer_pattern else cfg.pattern[:1]
    cfg = dataclasses.replace(cfg, num_layers=len(unit))
    sizes = dict(zip(("pod", "data", "model") if len(mesh_shape) == 3
                     else ("data", "model"), mesh_shape))
    plan = jplan(cfg, sizes["model"], mode="lane")
    sds = JSP.param_specs(cfg, plan)
    ps = JSH.param_pspecs(sds, cfg, plan, fsdp=True,
                          data_size=sizes["data"])
    import jax
    from jax.sharding import PartitionSpec as P
    leaves = jax.tree.leaves(sds)
    specs = jax.tree.leaves(ps, is_leaf=lambda x: isinstance(x, P))
    nbytes = elems = 0
    for s, spec in zip(leaves, specs):
        n = int(np.prod(s.shape))
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    n //= sizes[a]
        nbytes += n * s.dtype.itemsize
        elems += n
    return nbytes, elems


@pytest.mark.parametrize("arch,shape,seq,batch", CASES)
def test_small_mesh_dryrun(arch, shape, seq, batch, small):
    small(shape, seq, batch)
    rec = DR.run_one(arch, shape, False, variant=1, save=False,
                     mesh_shape=(2, 4))
    assert not rec.get("skipped"), rec
    assert REF_KEYS <= set(rec) and MEM_KEYS <= set(rec["memory"])
    assert rec["flops_total"] > 0 and rec["devices"] == 8
    assert set(rec["collectives"]) == set(jcollective_bytes(""))
    if SHAPES[shape].kind == "train":
        nbytes, elems = _ref_device_bytes(arch, (2, 4))
        assert rec["memory"]["weight_bytes"] == nbytes
        # two fp32 moments, placed like the weights
        assert rec["memory"]["moment_bytes"] == 2 * 4 * elems


def test_train_tally_equals_analytic_count(small):
    small("train_4k", 256, 8)
    rec = DR.run_one("llama3-8b", "train_4k", False, variant=1, save=False,
                     mesh_shape=(2, 4))
    cfg = DR.variant_config(get_config("llama3-8b"), 1)
    plan = make_plan(cfg, 4, mode="lane")
    step = TS.ShardedStep.from_model(SP.param_specs(cfg, plan),
                                     Grid(["meta"] * 8, (2, 4)))
    want = TS.analytic_bytes(step, 8 // 2, 256)
    got = rec["collectives"]
    assert {k: got[k] for k in want} == want
    assert want["all-gather"] > 0 and want["reduce-scatter"] > 0 \
        and want["all-reduce"] > 0 and want["all-to-all"] > 0


def test_banded_train_counts_only_the_band(small):
    """``run_one(banded=True)``: a train shape's windowed layer (S a
    multiple of 512 and longer than the window) attends over its band
    only: fewer FLOPs, the same exchanges."""
    small("train_4k", 4096, 1)
    kw = dict(variant=1, save=False, mesh_shape=(1, 2))
    full = DR.run_one("recurrentgemma-9b", "train_4k", False, **kw)
    band = DR.run_one("recurrentgemma-9b", "train_4k", False, banded=True,
                      **kw)
    assert 0 < band["flops_total"] < full["flops_total"]
    assert band["collectives"] == full["collectives"]


def test_moe_hints_route_in_blocks(small):
    """Under the reference's dispatch hints a train step's MoE routes in
    one block a data shard: no all-gather of the choices."""
    small("train_4k", 256, 8)
    kw = dict(variant=1, save=False, mesh_shape=(2, 4))
    glob = DR.run_one("granite-moe-3b-a800m", "train_4k", False, **kw)
    blocked = DR.run_one("granite-moe-3b-a800m", "train_4k", False,
                         moe_hints=True, **kw)
    assert SH.moe_hint_specs("model", 2)["moe_blocks"] == 2
    # the choices' all-gather: top-k int32 ids of every token, each
    # worker receiving the other data shard's, in the forward and the
    # recompute
    cfg = DR.variant_config(get_config("granite-moe-3b-a800m"), 1)
    ids = 8 // 2 * 256 * cfg.moe.top_k * 4
    assert glob["collectives"]["all-gather"] \
        - blocked["collectives"]["all-gather"] == 2 * 8 * ids
    # a global capacity is every shard's buffer: the blocks' is theirs
    assert blocked["flops_total"] < glob["flops_total"]
    assert glob["moe_expert_flops_factor"] == 2
    assert "moe_expert_flops_factor" not in blocked


def test_multipod_and_tp1_decode(small):
    small("decode_32k", 512, 8)
    rec = DR.run_one("llama3-8b", "decode_32k", True, variant=1,
                     save=False, mesh_shape=(2, 2, 2))
    assert rec["mesh"] == "2x2x2" and rec["flops_total"] > 0
    assert rec["layout"] == "TP2" and rec["collectives"]["all-reduce"] > 0
    tp1 = DR.run_one("llama3-8b", "decode_32k", True, "tp1", variant=1,
                     save=False, mesh_shape=(2, 2, 2))
    assert tp1["layout"] == "TP1"
    assert sum(v for k, v in tp1["collectives"].items() if k != "count") \
        == 0


def test_skips_are_recorded(small, tmp_path, monkeypatch):
    monkeypatch.setattr(DR, "OUT_DIR", str(tmp_path))
    rec = DR.run_one("whisper-tiny", "long_500k", False, variant=1)
    assert rec["skipped"] and "skip" in rec["reason"]
    small("decode_32k", 512, 8)
    rec = DR.run_one("whisper-tiny", "decode_32k", False, variant=1,
                     mesh_shape=(2, 4))
    # whisper's kv heads over model run: TP4 in two groups of four, and
    # one decoder layer's self-attention, MLP and cross-attention each
    # end in an all-reduce of its group's 4 rows (bf16, d_model wide)
    assert not rec.get("skipped") and rec["layout"] == "TP4"
    d = get_config("whisper-tiny").d_model
    assert rec["collectives"]["count"] == 3 * 2
    assert rec["collectives"]["all-reduce"] == 3 * 2 * (2 * 3 * 4 * d * 2)
    saved = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert saved["whisper-tiny_decode_32k_pod1_v1_mesh2x4.json"] == rec
    assert len(saved) == 2


def test_transform_dryrun_moves_weights_free_and_pool_all_to_all(
        tmp_path, monkeypatch):
    monkeypatch.setattr(TD, "OUT", str(tmp_path))
    rec = TD.run("llama3-8b", 256)
    coll = rec["collectives"]
    assert coll["all-gather"] == coll["reduce-scatter"] == 0
    assert coll["all-to-all"] == rec["kv_pool_all_to_all_expected"] > 0
    cfg = get_config("llama3-8b")
    plan = make_plan(cfg, 4, mode="page")
    pages = 4 * 4 * (256 // M.PAGE_TOKENS)
    pool = (cfg.num_layers * pages * plan.kv_slots * 2 * M.PAGE_TOKENS
            * cfg.resolved_head_dim * 2)
    assert rec["kv_pool_bytes_per_host"] == pool
    assert coll["all-to-all"] == pool * 3 // 4
    assert (tmp_path / "transform_llama3-8b.json").exists()
