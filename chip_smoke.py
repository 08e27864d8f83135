#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing JSON lines; any mismatch raises and the script
exits non-zero:

1. build    — compile the CUDA kernels of ``src/repro_torch/kernels/csrc``
              (one nvcc per source, in parallel) into
              ``build/repro_torch_kernels/``; print each library's
              registers and spills and its HGMMA (wgmma), UTMALDG (TMA
              load) and UBLKCP (bulk copy) counts from ``cuobjdump
              -sass``: HGMMA and UTMALDG must not be 0 for the two
              prefill libraries and the padded FFN, UBLKCP not for paged
              decode.
2. kernels  — every kernel against its plain PyTorch version on the card
              at llama3-8b attention shapes (Hq=32, kvs=8, dh=128), fp32
              and bf16, each element within TOL (bf16 prefill also within
              BF16_ROW_TOL of the row's RMS, the bf16 FFN within
              FFN_ROW_TOL): error, kernel / plain / one-PyTorch-call
              times (device time: the card is held ahead of the host),
              and the least time the card could take (bound).  Decode
              also runs at the serve phase's own shape, on ragged rows in
              8192-token slots, on 16-token pages and on a wrapped window
              ring, timed with L2 evicted before every call; one chunk
              case carries padding tokens; the 6000-token request's two
              chunks, 16-token pages and a ragged 600-token prompt are
              the main path's own prefill shapes.  The FFN also runs at
              the worker engine's 128-token prefill chunk and a 44-token
              remainder, and at the W = 4 plans of stablelm-12b and
              minicpm-2b, whose shards carry zero tails.  The
              ffn-tilings line holds both FFN tilings against the plain
              version at 16 token counts from 1 to 512 (and times them),
              the ffn-seeds line reads the FFN's error over four more
              weight seeds, and the decode-walk line holds the decode
              kernel's own page-range code against its host model.
              The three attention kernels also run at every other
              registered head shape (``head_shape_cases``): qwen2.5-32b
              (rep 5), stablelm-12b (dh 160) and gemma-2b (dh 256, one
              kv head) at llama3-8b's three main-path cases,
              phi-3-vision (dh 96), granite-moe (rep 3) and
              recurrentgemma (rep 16, its 2048-token window, decode on
              the wrapped ring) at flash and decode.
3. parity   — llama3-8b at full width, 2 layers, fp32, weights from one
              seed: the same requests through ``Engine(device="cuda")``
              and ``Engine(device="cpu")`` give equal greedy streams, and
              first-token logits agree within 1e-3.
4. serve    — llama3-8b at full width and depth in bf16 with random
              weights serves whole-prompt requests and one 6000-token
              request that must chunk; every kernel's launch counter
              must rise.  Prints TTFT, TPOT and tokens per second, then
              two ``torch.profiler`` breakdowns of device time: a decode
              step of a full batch and the 6000-token request's prefill,
              and the host time a prefill wrapper call takes (its bf16
              tensor-map encoding included) and a decode wrapper call.
              It also measures the decode rate of a batch of 4 rows at
              2048-token prompts (``calibrate.measure_decode_tps``) for
              phase 4a.
4a. calibrate — ``core.calibrate.calibrate`` on 2 and 4 workers of the
              card at llama3-8b's KV geometry in bf16 (``cal_sizes``):
              the sharded migration TP1 x W <-> TPW at 32, 128 and 512
              pages a worker (kernels 5-6), weight copies of half and a
              whole llama3-8b layer, spill copies of 16 and 64 pages
              (kernel 5), overlap pairs at 16 and 128 MiB against a
              4096-wide bf16 chain.  One line a measurement (the
              reference's accounted bytes, the bytes really copied, the
              span, the HBM bound), the fitted ``LinkModel`` beside
              ``LinkModel()``, the drift fractions and ``fit_hardware``
              (the serve engine's decode rate, the prefill rate of the
              6000-token request alone, the card's memory beside the
              H20 prior's).
4b. serve-shapes — qwen2.5-32b (64 layers, 62.3 GB), stablelm-12b and
              gemma-2b at full width and depth in bf16 with random
              weights, each through ``Engine``: prompts of 100, 1000 and
              6000 tokens, 16 greedy tokens each; TTFT, TPOT, tokens/s,
              peak memory and the attention kernels' launches.
5. transform-parity — llama3-8b at full width, 2 layers, fp32, an engine
              on two workers of the card (``devices=["cuda"] * 2``): the
              stream of an engine transformed TP1x2 -> TP2 mid-decode
              equals that of an engine started at TP2; a round trip
              TP1x2 -> TP2 -> TP1x2 equals an untransformed engine; the
              cache bytes are equal across a migration with no decode
              between.
6. transform-serve — llama3-8b at full width and 16 of its 32 layers
              (``TRANSFORM_SERVE_LAYERS``) in bf16 on two
              workers of the card serves four prompts at TP1x2,
              transforms to TP2 mid-decode, then serves a 6000-token
              request, longer than TP1's 4096-token ceiling, and
              transforms back.  Prints each session's steps and times
              against the model, the bytes each KV step moved against
              their bound, tokens per second inside and outside the
              sessions, TTFT, TPOT, peak memory and the launches of all
              six kernels; the three kernels of this path must launch.
              After that timed run, a second batch of the same prompts
              gives two profiled windows of decode steps, at TP1x2 and
              at TP2, with busy time beside the unprofiled wall.
7. transform-w4 — four workers of the card, full width, 8 layers, fp32:
              a TP1x4 -> TP4 -> TP1x4 round trip mid-decode gives the
              stream of an untransformed engine.
8. cluster-parity — llama3-8b at full width, 2 layers, fp32: a
              ``ClusterEngine`` of 2 instances x 1 worker of the card,
              then of 2 x 2, gets short requests on both instances and
              then one only the merged engine holds.  The scheduler's
              ``ScaleUp`` carries ``donor_iids``; the imported slot KV
              equals the donor's export byte for byte; no step stalls;
              the split returns the loan, and the revived donor serves;
              every stream equals an engine started at the merged width.
9. cluster-serve — full-size llama3-8b in bf16, 2 instances x 1 worker
              of the card (4096 tokens a worker): prompts of 300-2500
              tokens on both instances, then a 6000-token request that
              only the merged TP2 holds triggers a live merge while both
              decode; it prefills in chunks on the merged engine, Alg 2
              splits it after the dwell, and the revived donor serves a
              request.  Prints the actions, both sessions (steps, wall,
              blocked against modeled seconds, bytes moved), the stall
              count, steps by phase, TTFT, TPOT, tokens/s, the cluster's
              metrics, memory allocated before the merge, after the
              park, after the split and after the revive, and the six
              kernels' launches on this path, which must all rise.
9b. spill-parity — llama3-8b at full width, 2 layers, fp32, a
              ``ClusterEngine`` of 2 instances x 1 worker under
              ``SchedulerConfig(spill=True, spill_slack=2.0)``: a request
              above one instance's ceiling spills its overflow KV into
              the neighbour's free slot (a ``Spill``, no transform); its
              stream equals an unspilled engine's, and after every
              write-back the hosted pages equal the extended view's
              overflow bit for bit.
9c. cluster-spill — full-size llama3-8b in bf16, 2 instances x 1 worker
              (4096 tokens a worker), the same scheduler: prompts of 300
              and 1200 tokens on both instances, then a 6000-token
              request whose 31 overflow pages spill into one hosted
              slot.  Prints the actions, its TTFT, the decode step with
              and without the spilled slot, the spill log against the
              bytes the extended view's copies move, memory and the
              launches of kernels 1, 2 and 5 on this path.
10. serve-cli — ``python -m repro_torch.launch.serve`` as a subprocess
              with its defaults (reduced llama3-8b, fp32, 8 workers of
              the card, its 4 kv heads copied twice); it must exit 0,
              its ``[serve]`` lines are echoed.  Right after phase 4b
              the same CLI serves full-size qwen2.5-32b in bf16 on one
              worker.
11. ladder-parity — reduced llama3-8b, fp32, 4 workers of the card: the
              degree cycle TP2x2 -> TP4 -> TP1x4 -> TP2x2 mid-decode
              gives the streams of the same run on CPU workers and of
              an engine started at TP1, TP2 and TP4, the pool at
              ``seq_quantum * tp`` after each landing; the same cycle
              with no decode between steps leaves every worker's cache
              bit-equal to the layout an engine at that degree holds
              (``core.instance.split_cache``).
12. ladder-serve — llama3-8b at full width (8 of its 32 layers:
              ``LLAMA_LAYERS``) in bf16 on 4 workers of the card
              (four replicas): TP1x4 -> TP2x2 -> TP4 mid-decode, a
              6000-token request only TP4 holds, TP4 -> TP2x2 ->
              TP1x4.  Prints each session (wall, steps, exposed against
              modeled, KV bytes against their bound, weight bytes),
              stall steps, the long request's TTFT and TPOT, memory at
              TP4 and the peak, and the six kernels' launches.
13. replicated-serve — gemma-2b at full width (5 of its 18 layers:
              ``REPLICATED_LAYERS``) in fp32 on 4 workers (its one
              kv head copied into 4 kv slots, dh 256, geglu): TP1x4 ->
              TP2x2 -> TP4 -> TP1x4 mid-decode gives the streams of a
              TP1x4 engine that never transformed.
14. cluster-partial — full-size gemma-2b in bf16, 4 instances x 2
              workers (kv head copied into 8 slots),
              ``SchedulerConfig(partial_merge=True, target_tp=4)``: a
              short request on every instance, then a 6000-token one
              only TP4 holds.  One ``ScaleUp`` with ``donor_devices``:
              the donors shed a worker in place and never park, the
              target widens to TP4 with no stall, the split returns the
              loans and the donors widen back.  Prints the actions, the
              donors' moves and bytes, the target's sessions, TTFT,
              memory before, during and after, and the launches.
14b. cluster-calibrated — cluster-partial's configuration under the
              capacity ladder (``spill=True, partial_merge=True,
              spill_slack=2.0``) with phase 4a's fitted
              ``CalibratedCostModel`` attached: the reference's ladder
              trace at quantum 2048 (``CAL_TRACE``: a spill, a partial
              merge, its split), drained between submissions, then the
              port's ``Cluster`` replays it at the same geometry with the
              same fit.  Actions and placements must be equal, stalls 0,
              every kernel must launch.  Prints each action's cost under
              the prior, under the fit and the EWMA's estimate beside its
              measured wall and exposed time, each long request's rung
              costs, and memory.
15. moe-parity — reduced granite-moe-3b-a800m and llama4-maverick
              (``(ATTN, MOE)``, a shared expert) in fp32, the same
              weights and requests on the card and on the CPU: one
              device with budgeted chunked prefill, and two workers at
              TP1x2 whose decode overflows capacity across the replicas
              (capacity factor 0.5) through TP1x2 -> TP2 -> TP1x2
              mid-decode (maverick's shared expert on the padded FFN):
              equal streams, first-token logits within ``MOE_TOL``.
16. moe-serve — full-size granite-moe-3b-a800m (32 layers, 40 experts,
              top-8) in bf16 on one device: prompts of 300-5000 tokens
              (the last chunks); TTFT, TPOT, tokens/s, memory; a
              profiled decode step of 4 rows and the MoE MLP's split a
              layer and a step (routing, the expert ``bmm`` against its
              bound, dispatch and combine), at 4 tokens and at a
              4096-token chunk.  Kernels 1-3 must launch.
17. moe-transform — granite on two workers: fp32 at 4 layers, TP1x2 ->
              TP2 mid-decode equals an engine started at TP2 and a round
              trip an untransformed engine; bf16 at 16 of its 32 layers
              (``MOE_TRANSFORM_LAYERS``), TP1x2 ->
              TP2 mid-decode, a 6000-token request only TP2 holds, back
              to TP1x2, every decode row held against an engine started
              at TP2 (teacher forced; ``MOE_BF16_AGREE``); sessions' walls,
              KV bytes and MLP bytes.  Kernels 1-3 and 5-6 must launch.
18. moe-cluster — phase 9 on granite (``phase_moe_cluster``): a merge of
              2 x 1 workers to TP2 for a 6000-token request, the split,
              the revived donor; then the serve CLI on granite at full
              width (``MOE_CLI``).
19. moe-rows-fp32, moe-spill, rg-parity, rg-serve, rg-transform and the
              recurrentgemma CLI (``RG_CLI``): slice 11's phases
              (``phase_rg_*``).
20. xlstm-parity — xlstm-1.3b at full width, 3 layers ``(MLSTM, MLSTM,
              SLSTM)``, fp32, card against CPU engines: one device with
              budgeted chunks and two workers changed TP1x2 -> TP2
              mid-chunk give equal streams; a 300-token prompt (which the
              reference's ``mlstm_chunkwise`` refuses whole) prefilled
              whole agrees with the same prompt in page chunks and across
              the devices within ``XL_TOL``.
21. xlstm-serve — xlstm-1.3b at full width, 24 of its 48 layers
              (``XL_LAYERS``: 21 mLSTM + 3 sLSTM, no MLP) in bf16 on
              one device: prompts of 256-2500 tokens in
              chunks of 1024; weights, state, TTFT, TPOT, memory, a
              profiled decode step and each mixer's parts a layer at a
              decode step and a 1024-token chunk.  No kernel launches.
22. xlstm-transform — the same model on two workers, TP1x2 -> TP2 ->
              TP1x2 mid-decode, every row recorded beside an engine at
              the same degree (fp32 at ``XL_FP32_LAYERS`` layers: every
              row agrees; bf16: the rows before the change bit for bit,
              the rest printed beside two engines that never change),
              the TP2 pair's state copies bit-equal, and sessions with
              no decode between their steps leaving the state bit-equal
              to ``split_cache`` (``xl_exact_moves``); sessions' walls,
              state and weight bytes; then the serve CLI on it
              (``XL_CLI``).
23. enc-parity — whisper-tiny at full width and depth (4 encoder and 4
              decoder layers, 1500 frames) and phi-3-vision-4.2b at full
              width, 3 layers, fp32, card against CPU engines: 3
              requests (whisper's each with its own frames, two of
              phi-3-vision's with 576 patches), 16 greedy tokens each:
              equal streams, first-token logits within ``ENC_TOL``.
24. whisper-serve — full-size whisper-tiny in bf16 on one device: 4
              slots of 448 tokens, 8 requests of 1500 frames and 4-224
              tokens, 64 new; kernel 3's bidirectional branch (the
              encoder) and kernels 1 and 3 (the decoder) must launch.
              Weights, cross K/V bytes a slot, TTFT, TPOT, a profiled
              decode step, one request's encoding against its bound
              and a step's cross-attention (plain PyTorch).
25. vlm-serve — full-size phi-3-vision-4.2b (32 layers) in bf16 on one
              device: 4 slots of 4096, 8 requests of 64-2048 tokens,
              half with 576 patches; the same numbers and peak memory.
26. enc-workers — both models on two workers at TP1x2 in fp32 at 2
              layers: the card's streams equal the CPU's and the
              one-device engine's; ``transform(2)`` is refused.
27. train-parity — one train step (``training.train_step.loss_fn``,
              autograd, AdamW) of reduced llama3-8b, granite-moe, a
              recurrentgemma hybrid (RG-LRU + sliding) and xlstm (mLSTM
              + sLSTM) in fp32 on the card and on the CPU from the same
              weights and batch: the loss within ``TRAIN_LOSS_TOL``,
              each gradient leaf within ``TRAIN_GRAD_TOL`` in norm, no
              weight with a CPU gradient lacking one on the card.
28. train   — ``launch.train.train`` (the CLI's body) on llama3-8b at
              full width, ``TRAIN_LAYERS`` of its 32 layers, bf16, batch
              8 x 1024, 16 steps: finite losses, the last below the
              first; the median step wall, tokens/s, peak memory and
              model FLOP/s against the dense bf16 peak.
29. train-cli — ``python -m repro_torch.launch.train --smoke`` cut after
              step 3 with its checkpoint, then the CLI's ``main``
              resumed from it to step 5: its losses equal an unbroken
              run's within ``TRAIN_CLI_TOL``.
              Training is plain PyTorch autograd: phases 27-29 launch
              none of the six kernels (27 and 28 check it).
30. mesh-train-parity — one train step of phase 27's families (granite
              at capacity factor 1.25, which drops choices) at mesh
              (2, 2) on 4 workers of the card against the single-device
              port step on the card under the same lane plan, fp32: the
              loss within ``MESH_LOSS_TOL``, each gradient leaf within
              ``MESH_GRAD_TOL``, each parameter after AdamW within
              ``MESH_PARAM_TOL`` and the sharded AdamW within
              ``MESH_OPT_TOL`` of one device's on the same gradients; no
              worker's tensor aliases another's and a replicated leaf's
              copies are bit-equal.
31. mesh-train — phase 28's run (llama3-8b, 8 layers, bf16, batch 8 x
              1024, 16 steps) over the 2 x 2 grid (``launch.train.train
              (..., mesh=(2, 2))``): each step's loss within
              ``MESH_TRAIN_TOL`` of phase 28's; step wall, tokens/s,
              peak memory, model FLOP/s, and the exchanges' bytes a step
              by kind equal to the analytic FSDP + TP count.
32. mesh-train-cli — phase 29 with ``--mesh 2,2``: the cut and resumed
              runs' losses equal the unbroken run's exactly.
              Phases 30-32 launch none of the six kernels (checked).

The kernels phase also holds the page-migration and padded FFN kernels
against their plain versions, at the shapes of phases 5-6, and every
shape phases 12-14 give the kernels (``slice7_cases``: each engine's
FFN, decode, chunk and flash shapes at each of its degrees, and each
KV migration, phase 4a's included), granite's shapes on phases
16-18 (``moe_cases``) and whisper's on phases 23-26 (``enc_cases``:
the flash kernel's bidirectional branch at 1500 frames, whose census
key carries ``causal``).  A shape census (``ShapeCensus``)
records the shape key of every kernel launch, phase by phase; its
``shape-census`` line
fails the run if a phase launched a shape that neither the kernels
phase nor a parity phase (card against CPU engines) held against the
plain version.  Then the
card's name and power limit, one ``kernels`` line (launches counted
on phase 9's path, and by path: serve / transform-serve, cluster-serve,
serve-shapes, cluster-spill, ladder-serve, replicated-serve,
cluster-partial, calibrate, cluster-calibrated, layout-serve,
cluster-layout, moe-serve, moe-transform, moe-cluster, moe-spill,
rg-serve, rg-transform, xlstm-serve and xlstm-transform: 0 on those
two, which launch none of the six; whisper-serve and vlm-serve, and
the flash row whisper-serve's bidirectional launches; train-parity,
train, mesh-train-parity, mesh-train and mesh-train-cli, 0), and the
last
line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository around it, it fails before printing a result.
"""
import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s by type
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version, per element: |out - want| <= atol + rtol*|want|.
# Both accumulate in fp32 in other orders (about 1e-6 relative apart).
# fp32: that order noise alone.  bf16: each rounds its fp32 result once,
# so two results differ by at most one bf16 ulp, which is <= 2^-7 |want|;
# nothing else is allowed (the atol covers fp32 noise on outputs near 0).
# A wrong kernel, such as one dropping a page of a 4096-key context,
# moves outputs of size ~0.03 by ~0.01 and fails this.
# The bf16 prefill kernels (tensor-core tile) also get
# ``flash_attention.BF16_ROW_TOL`` = 2^-7 of the output row's RMS: they
# round P to bf16 before P.V, as every tensor-core attention does.
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 2.0 ** -7)}
# The padded FFN in bf16 also gets 2^-8 of its output row's RMS: its sums
# run 4096-14336 products deep on the tensor cores, whose accumulation
# is coarser than an fp32 add, so their noise is absolute at the row's
# scale (an attention output is a convex mix of values, an FFN output a
# long sum); one bf16 ulp alone fails outputs near 0.
FFN_ROW_TOL = 2.0 ** -8


#: every line ``emit`` prints is also appended here: the whole log, for
#: a caller that keeps only the end of the output (the shape-census line
#: alone is some 60 KB)
LOG_PATH = os.path.join(ROOT, "build", "chip_smoke.jsonl")


def emit(**kw):
    line = json.dumps(kw)
    print(line, flush=True)
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    with open(LOG_PATH, "a") as f:
        f.write(line + "\n")


def max_err(what, out, want, dtype, rows=None, row_tol=0.0):
    """Max abs error of ``out`` against ``want`` (over the bool mask
    ``rows`` of leading axes if given); raises unless every element is
    within ``TOL[dtype]``, plus ``row_tol`` times the RMS of its row of
    ``want`` (last axis)."""
    atol, rtol = TOL[dtype]
    o, w = out.float(), want.float()
    if rows is not None:
        o, w = o[rows], w[rows]
    diff = (o - w).abs()
    atol = atol + row_tol * w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    bad = int((diff > atol + rtol * w.abs()).sum())
    err = diff.max().item()
    assert bad == 0, (what, str(dtype), "max abs err", err, "elements "
                      "outside tolerance", bad)
    return err


def tol_text(dtype) -> str:
    atol, rtol = TOL[dtype]
    return f"{atol:g} + {rtol:g}*|want|"


def hold_card(iters: int) -> None:
    """Keep the card busy (``torch.cuda._sleep``) for longer than the host
    takes to enqueue ``iters`` timed calls, so the events time the card's
    own work, not the host's launch rate (a small kernel's wrapper can
    take longer on the host than the kernel on the card)."""
    torch.cuda._sleep(int(2e5 * iters + 2e6))


def time_ms(fn, iters: int, hold: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, calls back
    to back; device time only, see ``hold_card``; ``hold`` times longer
    for a ``fn`` of many launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    hold_card(iters * hold)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


L2_FLUSH_BYTES = 64 << 20   # more than the H100's 50 MB L2


def time_ms_cold(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` on the card with its L2 evicted before
    every call: a 64 MiB buffer is read (summed) between calls, outside
    the timed window (an event pair around each call), so the call reads
    its inputs from device memory, as a decode step's attention does
    after the layer's matmuls have streamed their weights.  Reading, not
    writing, leaves clean lines: the call pays no write-back of the
    flush's bytes."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                       device="cuda")
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    hold_card(iters)
    for t0, t1 in evs:
        flush.sum()
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in evs) / iters


def bound_ms(nbytes: float, flops: float, dtype):
    """The larger of bytes over HBM rate and FLOPs over the type's peak."""
    tb = nbytes / HBM_BPS * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def visible_pairs(qpos, kpos, window: int, causal: bool = True) -> int:
    """(query, key) pairs the mask lets through, from this run's
    positions: (B, Sq) and (B, Sk) int tensors (every stored key of a
    bidirectional call)."""
    q = qpos[:, :, None].long()
    k = kpos[:, None, :].long()
    ok = (k >= 0) & ((k <= q) | (not causal))
    if window > 0:
        ok &= k > q - window
    return int(ok.sum())


def heads_text(Hq: int, kvs: int, dh: int) -> str:
    """A case's head shape where it is not llama3-8b's (32 / 8 / 128)."""
    return "" if (Hq, kvs, dh) == (32, 8, 128) else \
        f" Hq={Hq} kvs={kvs} dh={dh}"


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def expand_kv(k, rep):
    """(B, S, kvs, dh) -> (B, kvs*rep, S, dh) for the library yardstick."""
    return k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()


# ---------------------------------------------------------------------------
# libraries whose SASS must hold tensor-core products and TMA loads, and
# the one whose SASS must hold bulk copies (cp.async.bulk without a
# tensor map, UBLKCP in SASS)
TENSOR_CORE_LIBS = ("flash_attention", "chunk_prefill", "padded_ffn")
BULK_COPY_LIBS = ("paged_attention",)
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP")


def sass_counts(lib) -> dict:
    """HGMMA (wgmma), UTMALDG (TMA load) and UBLKCP (bulk copy)
    instructions in a library's SASS, from ``cuobjdump -sass``."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops = re.findall(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     sass, flags=re.M)
    return {op: sum(x == op for x in ops) for op in SASS_OPS}


def ptxas_summary(log: str) -> dict:
    """A library's ``ptxas -v`` report in brief: its kernels' register
    counts (largest first) and every line that reports spills or stack
    (the whole log is in build.log)."""
    import re
    regs = sorted((int(m) for m in re.findall(r"Used (\d+) registers", log)),
                  reverse=True)
    spills = [ln.strip() for ln in log.splitlines()
              if re.search(r"[1-9]\d* bytes (spill|stack)", ln)]
    return {"registers": regs, "spills": spills}


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    logs = _build.build_all()
    secs = time.monotonic() - t0
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(_build.BUILD_DIR / "build.log", "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    regs = {name: ptxas_summary(log) for name, log in logs.items()}
    sass = {name: sass_counts(_build._lib_path(name))
            for name in _build.SOURCES}
    for name in TENSOR_CORE_LIBS:
        assert sass[name]["HGMMA"] and sass[name]["UTMALDG"], (
            name, "no HGMMA or UTMALDG in its SASS", sass[name])
    for name in BULK_COPY_LIBS:
        assert sass[name]["UBLKCP"], (name, "no UBLKCP in its SASS",
                                      sass[name])
    emit(phase="build", seconds=secs, built=sorted(logs),
         ptxas=regs, sass=sass)


def stored_positions(qpos, cap: int):
    """The positions a row's ``cap`` ring slots hold once positions
    0..q_pos were written at slot p % cap (the pools' rule): slot s holds
    the latest p <= q_pos with p % cap == s, or -1.  (B,) -> (B, cap)."""
    s = torch.arange(cap, dtype=torch.int64, device=qpos.device)[None]
    q = qpos.long()[:, None]
    p = q - torch.remainder(q - s, cap)
    return torch.where(p >= 0, p, -1).to(torch.int32).contiguous()


def case_decode(dtype, B=8, ctx=4096, cap=None, Hq=32, kvs=8, dh=128,
                P=64, q_pos=None, window=0):
    """``ctx`` live keys per row in slots of ``cap`` tokens (the rest
    empty, as in the engine's slots of max_seq tokens); or rows at the
    positions ``q_pos`` (ragged lengths, or past ``cap``: a wrapped
    ring), each having written positions 0..q_pos.  ``ms`` and
    ``library_ms`` are timed with L2 evicted before every call
    (``time_ms_cold``); ``ms_warm_l2`` repeats the calls back to back."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    dev = "cuda"
    cap = cap or ctx
    g = torch.Generator(device=dev).manual_seed(1)
    if q_pos is None:
        q_pos = [ctx - 1] * B
    B = len(q_pos)
    n = cap // P
    NP = B * n
    pool = torch.randn((NP, kvs, 2, P, dh), generator=g, device=dev
                       ).to(dtype)
    pt = torch.randperm(NP, generator=g, device=dev).to(torch.int32
                                                        ).reshape(B, n)
    qpos = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    kvpos = stored_positions(qpos, cap)
    q = torch.randn((B, Hq, dh), generator=g, device=dev).to(dtype)
    kw = dict(window=window)
    out = PA.paged_decode(q, pool, pt, kvpos, qpos, **kw)
    want = PA.plain(q, pool, pt, kvpos, qpos, **kw)
    err = max_err("paged decode", out, want, dtype)
    # the TPU kernel's signature: ragged seq_lens
    sl = torch.randint(1, min(cap, max(q_pos) + 1) + 1, (B,), generator=g,
                       device=dev, dtype=torch.int32)
    err_sl = max_err("paged_attention(seq_lens)",
                     PA.paged_attention(q, pool, pt, sl),
                     ref.paged_attention_ref(q, pool, pt, sl), dtype)
    # yardstick: SDPA on the gathered keys; one length, no wrap and no
    # window: the first ctx keys unmasked, else every slot with the mask
    rep = Hq // kvs
    pages = pool[pt.long()]
    kd, vd = (pages[:, :, :, i].permute(0, 2, 1, 3, 4).reshape(
        B, kvs, cap, dh) for i in (0, 1))
    q4 = q[:, :, None, :].contiguous()
    mask = None
    uniform = len(set(q_pos)) == 1 and q_pos[0] < cap and not window
    if uniform:
        kd, vd = kd[:, :, :q_pos[0] + 1], vd[:, :, :q_pos[0] + 1]
    else:
        vis = (kvpos >= 0) & (kvpos <= qpos[:, None])
        if window:
            vis &= kvpos > qpos[:, None] - window
        mask = vis[:, None, None, :]
    kd = kd.repeat_interleave(rep, dim=1).contiguous()
    vd = vd.repeat_interleave(rep, dim=1).contiguous()

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask)

    def kern():
        return PA.paged_decode(q, pool, pt, kvpos, qpos, **kw)

    pairs = visible_pairs(qpos[:, None], kvpos, window)
    byt = pairs * kvs * 2 * dh * pool.element_size() + nbytes(
        q, out, kvpos, qpos, pt)
    bms, by = bound_ms(byt, 4 * pairs * Hq * dh, dtype)
    what = (f"B={B} ctx={ctx} cap={cap} P={P}" if uniform else
            f"q_pos={list(q_pos)} cap={cap} window={window} P={P}"
            ) + heads_text(Hq, kvs, dh)
    return dict(
        kernel="paged_attention", case=what,
        max_abs_err=err, max_abs_err_seq_lens=err_sl,
        ms=time_ms_cold(kern, 50), ms_warm_l2=time_ms(kern, 50),
        plain_ms=time_ms(lambda: PA.plain(q, pool, pt, kvpos, qpos, **kw),
                         5),
        library_ms=time_ms_cold(lib, 20), library_ms_warm_l2=time_ms(lib, 20),
        timing="L2 evicted before every call (a 64 MiB buffer read)",
        bound_ms=bms, bound_by=by)


def case_chunk(dtype, S=512, done=3584, cap=4096, window=0, pad=0, Hq=32,
               kvs=8, dh=128, P=64, attend_prefix=True):
    """A chunk of S tokens at position ``done``; its last ``pad`` tokens
    are padding (position -1): no keys, no pool bytes, rows unread.
    ``attend_prefix=False`` is a prompt's first chunk (no prefix walk)."""
    from repro_torch.kernels import chunk_prefill as CP
    from repro_torch.paged import pool as pp
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(2)
    mps = cap // P
    pool0 = torch.randn((mps, kvs, 2, P, dh), generator=g, device=dev
                        ).to(dtype)
    pt = torch.arange(mps, dtype=torch.int32, device=dev)[None]
    kvpos = torch.full((1, cap), -1, dtype=torch.int32, device=dev)
    prefix = torch.arange(max(0, done - cap), done, device=dev)
    kvpos[0, prefix % cap] = prefix.to(torch.int32)
    qpos = torch.arange(done, done + S, dtype=torch.int32, device=dev)[None]
    qpos[:, S - pad:] = -1
    q = torch.randn((1, S, Hq, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((1, S, kvs, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((1, S, kvs, dh), generator=g, device=dev).to(dtype)
    kw = dict(window=window, attend_prefix=attend_prefix)
    pool = pool0.clone()
    out = CP.chunk_prefill_attention(q, k, v, pool, pt, kvpos, qpos, **kw)
    pool_ref = pool0.clone()
    want = CP.plain(q, k, v, pool_ref, pt, kvpos, qpos, **kw)
    row_tol = CP.BF16_ROW_TOL if dtype == torch.bfloat16 else 0.0
    err = max_err("chunk prefill", out, want, dtype, rows=qpos >= 0,
                  row_tol=row_tol)
    state = pp.PagedState(pool0.clone(), pt, torch.zeros(
        1, dtype=torch.int32, device=dev), kvpos.clone())
    pp.write_chunk(state, k, v, qpos)
    assert torch.equal(pool, state.pool), "chunk pool != write_chunk's"
    assert torch.equal(pool_ref, state.pool), "plain pool != write_chunk's"
    # yardstick: one SDPA call on the gathered prefix + chunk keys
    rep = Hq // kvs
    kk, vv, kpos = k, v, qpos
    if attend_prefix:
        kk = torch.cat([pool0[:, :, 0].permute(0, 2, 1, 3).reshape(
            1, cap, kvs, dh), k], 1)
        vv = torch.cat([pool0[:, :, 1].permute(0, 2, 1, 3).reshape(
            1, cap, kvs, dh), v], 1)
        kpos = torch.cat([kvpos, qpos], 1)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    if window:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    kd, vd, qd = expand_kv(kk, rep), expand_kv(vv, rep), q.transpose(1, 2)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None]), 20)
    pairs = visible_pairs(qpos, kpos, window)
    live_prefix = int((kvpos >= 0).sum()) if attend_prefix else 0
    byt = (live_prefix * kvs * 2 * dh * pool.element_size()
           + nbytes(q, k, v, out, qpos)
           + (nbytes(kvpos) if attend_prefix else 0)
           + (S - pad) * kvs * 2 * dh * pool.element_size())  # scatter
    bms, by = bound_ms(byt, 4 * pairs * Hq * dh, dtype)
    return dict(
        kernel="chunk_prefill",
        case=(f"S={S} prefix={done} cap={cap} window={window} pad={pad} "
              f"P={P} attend_prefix={attend_prefix}"
              + heads_text(Hq, kvs, dh)),
        max_abs_err=err, pool_equal=True,
        tol=tol_text(dtype) + (f" + {row_tol:g}*rms(row)" if row_tol
                               else ""),
        ms=time_ms(lambda: CP.chunk_prefill_attention(
            q, k, v, pool, pt, kvpos, qpos, **kw), 20),
        plain_ms=time_ms(lambda: CP.plain(
            q, k, v, pool_ref, pt, kvpos, qpos, **kw), 3),
        library_ms=lib, bound_ms=bms, bound_by=by)


def case_flash(dtype, S=4096, window=0, Hq=32, kvs=8, dh=128,
               causal=True):
    """Flash prefill over one S-token sequence; ``causal=False`` is the
    bidirectional branch an encoder runs (every key visible, the last
    key tile ragged where 64 does not divide S: its keys past S are
    masked by position alone), held against SDPA with
    ``is_causal=False``."""
    from repro_torch.kernels import flash_attention as FA
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, S, Hq, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((1, S, kvs, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((1, S, kvs, dh), generator=g, device=dev).to(dtype)
    kw = dict(window=window, causal=causal)
    out = FA.flash_attention(q, k, v, **kw)
    want = FA.plain(q, k, v, **kw)
    row_tol = FA.BF16_ROW_TOL if dtype == torch.bfloat16 else 0.0
    err = max_err("flash", out, want, dtype, row_tol=row_tol)
    rep = Hq // kvs
    kd, vd, qd = expand_kv(k, rep), expand_kv(v, rep), q.transpose(1, 2)
    pos = torch.arange(S, device=dev)
    if window:
        mask = ((pos[None] <= pos[:, None])
                & (pos[None] > pos[:, None] - window))
        lib = time_ms(lambda: torch.nn.functional.
                      scaled_dot_product_attention(qd, kd, vd,
                                                   attn_mask=mask), 20)
    else:
        lib = time_ms(lambda: torch.nn.functional.
                      scaled_dot_product_attention(qd, kd, vd,
                                                   is_causal=causal), 20)
    pos = pos[None]
    pairs = visible_pairs(pos, pos, window, causal)
    bms, by = bound_ms(nbytes(q, k, v, out), 4 * pairs * Hq * dh, dtype)
    return dict(
        kernel="flash_attention",
        case=f"S={S} window={window}" + ("" if causal else " bidirectional")
        + heads_text(Hq, kvs, dh),
        max_abs_err=err,
        tol=tol_text(dtype) + (f" + {row_tol:g}*rms(row)" if row_tol
                               else ""),
        ms=time_ms(lambda: FA.flash_attention(q, k, v, **kw), 20),
        plain_ms=time_ms(lambda: FA.plain(q, k, v, **kw), 3),
        library_ms=lib, bound_ms=bms, bound_by=by)


def case_migrate(dtype, slots=4, cap=8192, W=2, kvs=8, P=64, dh=128):
    """One layer of a TP1xW <-> TPW migration of a ``slots``-slot pool of
    ``cap`` tokens a slot: worker 0's scale-up send buffer (gather) and
    its scale-down placement (copy).  Pure copies: bit-equal, bound by
    the bytes read and written.  ``library_ms``: the same move by one
    advanced-indexing call (never on the path)."""
    from repro_torch.kernels import page_migrate as PM
    from repro_torch.kernels import ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    NP = slots * cap // P // W                 # a worker's local pages
    hps = kvs // W
    pool = torch.randn((NP, kvs, 2, P, dh), generator=g, device=dev
                       ).to(dtype)
    pages, hblk = PM.scale_up_send_index(NP, W, dev)
    send = PM.gather_page_slices(pool, pages, hblk, heads_per_slice=hps)
    assert torch.equal(send, ref.gather_page_slices_ref(pool, pages, hblk,
                                                        hps)), "gather"
    view = pool.view(NP, W, hps, 2, P, dh)
    ids = torch.arange(W * NP, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(ids)
    dst = torch.zeros_like(pool)
    PM.copy_page_slices(send, dst, ids, zeros, pages, hblk,
                        heads_per_slice=hps)
    want = ref.copy_page_slices_ref(send, torch.zeros_like(pool), ids,
                                    zeros, pages, hblk, hps)
    assert torch.equal(dst, want) and torch.equal(dst, pool), "copy"
    move = 2 * nbytes(pool)                    # each byte read + written
    idx = nbytes(pages, hblk)
    case = f"{slots} slots x {cap} tokens, W={W}, kvs={kvs}, P={P}"
    pl, hl = pages.long(), hblk.long()
    dview = dst.view(NP, W, hps, 2, P, dh)
    gather = dict(
        kernel="gather_page_slices", case=case + ": scale-up send buffer",
        max_abs_err=0.0, bit_equal=True,
        ms=time_ms(lambda: PM.gather_page_slices(
            pool, pages, hblk, heads_per_slice=hps), 50),
        plain_ms=time_ms(lambda: ref.gather_page_slices_ref(
            pool, pages, hblk, hps), 20),
        library_ms=time_ms(lambda: view[pl, hl], 20),
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(move + idx, 0, dtype))))
    copy = dict(
        kernel="copy_page_slices", case=case + ": scale-down placement",
        max_abs_err=0.0, bit_equal=True,
        ms=time_ms(lambda: PM.copy_page_slices(
            send, dst, ids, zeros, pages, hblk, heads_per_slice=hps), 50),
        plain_ms=time_ms(lambda: ref.copy_page_slices_ref(
            send, dst, ids, zeros, pages, hblk, hps), 20),
        library_ms=time_ms(lambda: dview.index_put_(
            (pl, hl), send), 20),
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(move + 2 * idx, 0, dtype))))
    return [gather, copy]


def case_slot_move(dtype, slots=4, cap=4096, cap_to=8192, kvs=8, P=64,
                   dh=128, slot=1, to_slot=2):
    """One layer of a merge's slot move at cluster-serve's shapes: slot
    ``slot`` of a one-worker donor (``slots`` x ``cap`` tokens, every kv
    head) exported by ``kv_transform.export_slot`` (the gather kernel,
    all heads as one slice) and landed by ``import_slot`` in slot
    ``to_slot`` of the grown target's pool (``slots`` x ``cap_to``; the
    copy kernel).  Each wrapper is held bit-equal to its plain version
    on the same inputs; the landed pages equal the donor's own and every
    other page of the target keeps its bytes.  Kernel and library times
    are taken with L2 evicted (``time_ms_cold``), ``*_warm_l2`` back to
    back.  ``library_ms``: the same move by one indexing call (never on
    the path)."""
    from repro_torch.core import kv_transform as KT
    from repro_torch.kernels import page_migrate as PM
    from repro_torch.kernels import ref
    from repro_torch.paged import pool as pp
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(8)
    mps, mps_to = cap // P, cap_to // P
    donor = pp.make_state(slots * mps, kvs, P, dh, slots, mps, dtype=dtype,
                          device=dev)
    target = pp.make_state(slots * mps_to, kvs, P, dh, slots, mps_to,
                           dtype=dtype, device=dev)
    for st in (donor, target):
        st.pool.copy_(torch.randn(st.pool.shape, generator=g, device=dev))
    own = donor.pool[slot * mps:(slot + 1) * mps].clone()
    ids = torch.arange(slot * mps, (slot + 1) * mps, dtype=torch.int32,
                       device=dev)
    zeros = torch.zeros_like(ids)
    sub = KT.export_slot(donor, slot)
    assert torch.equal(sub.pool, ref.gather_page_slices_ref(
        donor.pool, ids, zeros, kvs)) and torch.equal(sub.pool, own), "export"
    src = torch.arange(mps, dtype=torch.int32, device=dev)
    dst = src + to_slot * mps_to
    want = ref.copy_page_slices_ref(sub.pool, target.pool.clone(), src,
                                    zeros, dst, zeros, kvs)
    KT.import_slot(target, sub, to_slot)
    assert torch.equal(target.pool, want), "import"
    assert torch.equal(target.pool[dst.long()], own), "landed pages"
    move = 2 * nbytes(own)                      # each byte read + written
    il, dl = ids.long(), dst.long()
    # a slot (16 MiB in bf16) fits the 50 MB L2: calls back to back would
    # read it from there, so ``ms`` evicts it first, as a merge finds it
    timing = "L2 evicted before every call (a 64 MiB buffer read)"

    def gather_k():
        return PM.gather_page_slices(donor.pool, ids, zeros,
                                     heads_per_slice=kvs)

    def copy_k():
        return PM.copy_page_slices(sub.pool, target.pool, src, zeros, dst,
                                   zeros, heads_per_slice=kvs)

    def gather_l():
        return donor.pool.index_select(0, il)

    def copy_l():
        return target.pool.index_copy_(0, dl, sub.pool)

    case = (f"one slot of {cap} tokens, {slots} x {cap} -> {slots} x "
            f"{cap_to} pool, kvs={kvs}, P={P}")
    gather = dict(
        kernel="gather_page_slices",
        case=case + f": merge export of slot {slot}",
        max_abs_err=0.0, bit_equal=True,
        ms=time_ms_cold(gather_k, 50), ms_warm_l2=time_ms(gather_k, 50),
        plain_ms=time_ms(lambda: ref.gather_page_slices_ref(
            donor.pool, ids, zeros, kvs), 20),
        library_ms=time_ms_cold(gather_l, 20),
        library_ms_warm_l2=time_ms(gather_l, 20), timing=timing,
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(move + nbytes(ids, zeros), 0, dtype))))
    copy = dict(
        kernel="copy_page_slices",
        case=case + f": merge import into slot {to_slot}",
        max_abs_err=0.0, bit_equal=True,
        ms=time_ms_cold(copy_k, 50), ms_warm_l2=time_ms(copy_k, 50),
        plain_ms=time_ms(lambda: ref.copy_page_slices_ref(
            sub.pool, target.pool, src, zeros, dst, zeros, kvs), 20),
        library_ms=time_ms_cold(copy_l, 20),
        library_ms_warm_l2=time_ms(copy_l, 20), timing=timing,
        **dict(zip(("bound_ms", "bound_by"),
                   bound_ms(move + nbytes(src, zeros, dst, zeros), 0,
                            dtype))))
    return [gather, copy]


def row_term(out, want, dtype) -> float:
    """The largest share of its row's RMS that an element of ``out``
    needed beyond one bf16 ulp: what the FFN check's FFN_ROW_TOL term
    covers (0: one ulp was enough)."""
    atol, rtol = TOL[dtype]
    w = want.float()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    beyond = ((out.float() - w).abs() - atol - rtol * w.abs()).clamp(min=0)
    return (beyond / rms).max().item()


def case_ffn(dtype, T=4, tp=2, ff_full=14336, d=4096, W=2, ffp=None,
             model="llama3-8b", iters=20, ff=None, what=None,
             activation="swiglu"):
    """The MLP of a worker engine: the full replica (``tp`` shards of the
    Eq. 2 layout, TP1xW) or one TP shard (``tp=1`` over ff_full / W
    columns).  ``ffp`` > ff pads each shard's ``ff/tp`` real columns with
    a zero tail, as ``make_plan(cfg, W, mode="page")`` does for
    stablelm-12b and minicpm-2b.  ``ff`` (with ``what`` naming it) sets
    the real columns of ``tp`` shards directly; ``activation`` is the
    gate's (gemma-2b's geglu).  ``library_ms``: ``dense_mlp`` on
    cuBLAS over the unpadded weights, two ``torch.matmul`` and the
    activation.  ``row_term_used``: the largest share of its output
    row's RMS that an element's error needed beyond one bf16 ulp (the
    bf16 check allows FFN_ROW_TOL = 2^-8)."""
    from repro_torch.kernels import padded_ffn as PF
    from repro_torch.kernels import ref
    from repro_torch.models import layers as Lyr
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    ff = ff or (ff_full if tp > 1 else ff_full // W)
    ffp = ffp or ff
    x = torch.randn((T, d), generator=g, device=dev).to(dtype)
    wi_c = (torch.randn((d, 2 * ff), generator=g, device=dev) / d ** 0.5
            ).to(dtype)
    wo_c = (torch.randn((ff, d), generator=g, device=dev) / ff ** 0.5
            ).to(dtype)
    if ffp == ff:
        wi, wo = wi_c, wo_c
    else:   # each shard's real columns, then a zero tail
        cols = ref.real_ff_index(ff, ffp, tp, dev)
        wi = torch.zeros((d, 2 * ffp), dtype=dtype, device=dev)
        wi[:, cols], wi[:, ffp + cols] = wi_c[:, :ff], wi_c[:, ff:]
        wo = torch.zeros((ffp, d), dtype=dtype, device=dev)
        wo[cols] = wo_c
    out = PF.padded_ffn(x, wi, wo, tp=tp, ff=ff, activation=activation)
    want = PF.plain(x, wi, wo, tp, ff, activation)
    row_tol = FFN_ROW_TOL if dtype == torch.bfloat16 else 0.0
    err = max_err("padded_ffn", out, want, dtype, row_tol=row_tol)
    flops = 2 * T * d * ff * 3
    byt = nbytes(x, wi_c, wo_c, out)     # the real weights, read once
    bms, by = bound_ms(byt, flops, dtype)
    what = what or ("full replica" if tp > 1 and ffp == ff else
                    "one TP2 shard" if tp == 1 else f"{model} W={tp} plan")
    return dict(
        kernel="padded_ffn",
        case=f"T={T} {what} (d={d}, ff={ff}, ffp={ffp}, tp={tp}, "
             f"{activation})",
        max_abs_err=err, row_term_used=row_term(out, want, dtype),
        tol=tol_text(dtype) + (f" + {row_tol:g}*rms(row)" if row_tol
                               else ""),
        ms=time_ms(lambda: PF.padded_ffn(x, wi, wo, tp=tp, ff=ff,
                                         activation=activation), iters),
        plain_ms=time_ms(lambda: PF.plain(x, wi, wo, tp, ff, activation),
                         5),
        library_ms=time_ms(lambda: Lyr.dense_mlp(x, wi_c, wo_c,
                                                 activation), iters),
        library="dense_mlp on cuBLAS (2 matmuls + activation)",
        bound_ms=bms, bound_by=by)


def padded_ffn_cases():
    """The two configs whose W = 4 page plan pads d_ff (stablelm-12b:
    3456 real of 4096 a shard; minicpm-2b: 1440 of 1536, a shard width
    64 does not divide) at T = 1 and just above the decode/prefill
    switch."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.kernels import padded_ffn as PF
    out = []
    for name in ("stablelm-12b", "minicpm-2b"):
        cfg = get_config(name)
        ffp = make_plan(cfg, 4, mode="page").d_ff_padded
        assert ffp > cfg.d_ff, (name, "its W=4 plan must pad d_ff")
        for T in (1, PF.DECODE_MAX_T + 1):
            out.append((case_ffn, dict(T=T, tp=4, ff_full=cfg.d_ff,
                                       d=cfg.d_model, ffp=ffp, model=name,
                                       iters=10)))
    return out


def ffn_tilings():
    """The bf16 FFN of llama3-8b, the full replica at TP1x2 (tp 2) and
    one TP2 shard (tp 1), under both tilings (``decode`` forced) at
    token counts around the switch and at the worker engine's own
    prefill chunks (128 tokens and remainders such as 44, 68 and 112):
    each call held against the plain version at FFN_ROW_TOL.  The full
    replica's times are what ``DECODE_MAX_T`` in ``kernels/padded_ffn.py``
    rests on.  Then ``row_term_used`` of the plan's own tiling over four
    more weight seeds at T = 4, 128 and 512, the margin of the whole-K
    fp32 accumulator."""
    from repro_torch.kernels import padded_ffn as PF
    dev, d, bf = "cuda", 4096, torch.bfloat16

    def weights(ff, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        wi = (torch.randn((d, 2 * ff), generator=g, device=dev) / d ** 0.5
              ).to(bf)
        wo = (torch.randn((ff, d), generator=g, device=dev) / ff ** 0.5
              ).to(bf)
        return g, wi, wo

    def check(x, wi, wo, tp, ff, what, decode=None):
        out = PF.padded_ffn(x, wi, wo, tp=tp, ff=ff, decode=decode)
        want = PF.plain(x, wi, wo, tp, ff)
        err = max_err(f"padded_ffn {what}", out, want, bf,
                      row_tol=FFN_ROW_TOL)
        return err, row_term(out, want, bf)

    rows = []
    for tp in (2, 1):
        ff = 14336 // (3 - tp)
        g, wi, wo = weights(ff, 6)
        for T in (1, 4, 16, 32, 33, 40, 44, 48, 56, 64, 68, 96, 112, 128,
                  256, 512):
            x = torch.randn((T, d), generator=g, device=dev).to(bf)
            row = {"T": T, "tp": tp}
            for tiling, dec in (("decode", True), ("prefill", False)):
                row[f"{tiling}_err"], row[f"{tiling}_row_term"] = check(
                    x, wi, wo, tp, ff, f"{tiling} tiling T={T} tp={tp}", dec)
                if tp == 2:
                    row[f"{tiling}_ms"] = time_ms(
                        lambda dec=dec: PF.padded_ffn(x, wi, wo, tp=tp,
                                                      ff=ff, decode=dec), 20)
            rows.append(row)
    emit(phase="kernels", what="ffn-tilings", dtype="bfloat16",
         case=f"d={d} ff=14336, tp 2 and 1", decode_max_t=PF.DECODE_MAX_T,
         tol=tol_text(bf) + f" + {FFN_ROW_TOL:g}*rms(row)", rows=rows)
    seeds = []
    for seed in (7, 8, 9, 10):
        for tp in (2, 1):
            ff = 14336 // (3 - tp)
            g, wi, wo = weights(ff, seed)
            for T in (4, 128, 512):
                x = torch.randn((T, d), generator=g, device=dev).to(bf)
                err, term = check(x, wi, wo, tp, ff,
                                  f"seed {seed} T={T} tp={tp}")
                seeds.append({"seed": seed, "tp": tp, "T": T,
                              "max_abs_err": err, "row_term_used": term})
    emit(phase="kernels", what="ffn-seeds", dtype="bfloat16",
         row_tol=FFN_ROW_TOL,
         max_row_term_used=max(r["row_term_used"] for r in seeds),
         rows=seeds)


def decode_walk():
    """The bf16 decode kernel's own range code (``walk_ranges`` on the
    card) against its host model (``live_pages`` cut by
    ``split_pages``, which the CPU tests hold against the JAX
    reference): every 7th query position from -1 to past twice the
    capacity, with and without a window, at several split counts, on
    whole rows and on sp shards (pages [page0, page0 + n) of n_total)."""
    from repro_torch.kernels import paged_attention as PA
    q = torch.arange(-1, 2 * 8192 + 100, 7, dtype=torch.int32)
    # n, P, window, splits, page0, n_total (0: n)
    layouts = ((128, 64, 0, 9, 0, 0), (128, 64, 0, 16, 0, 0),
               (512, 16, 0, 8, 0, 0), (16, 64, 1024, 4, 0, 0),
               (64, 16, 333, 5, 0, 0), (48, 64, 0, 16, 48, 96),
               (48, 64, 0, 16, 0, 96), (32, 64, 0, 8, 64, 128))
    for n, P, window, splits, page0, n_total in layouts:
        got = PA.walk_ranges(q.cuda(), n, P, window, splits, page0,
                             n_total).cpu()
        want = PA.walk_ranges(q, n, P, window, splits, page0, n_total)
        bad = int((got != want).any(dim=-1).sum())
        assert bad == 0, ("decode walk", n, P, window, splits, page0,
                          bad)
    emit(phase="kernels", what="decode-walk", positions=q.numel(),
         layouts=[list(x) for x in layouts], tol="bit-equal")


#: the models the serve-shapes phase serves at full width
SERVE_SHAPES = ("qwen2.5-32b", "stablelm-12b", "gemma-2b")


def head_shape_cases():
    """The three attention kernels at every other registered head shape
    (``configs/registry.py``): (model, case function, keywords).  Models
    the serve-shapes phase serves get the llama3-8b rows' cases (flash
    at S=4096, a 4096-token first chunk, chunk 512 over 3584, decode at
    the serve shape: 4 rows, 2048 live in 8192-token slots); the rest a
    flash and a decode
    case, recurrentgemma-9b's on its 2048-token window (decode on the
    wrapped ring)."""
    from repro_torch.configs import get_config
    out = []
    for name in ("qwen2.5-32b", "stablelm-12b", "gemma-2b",
                 "phi-3-vision-4.2b", "granite-moe-3b-a800m",
                 "recurrentgemma-9b"):
        cfg = get_config(name)
        heads = dict(Hq=cfg.num_heads, kvs=cfg.num_kv_heads,
                     dh=cfg.resolved_head_dim)
        if name == "recurrentgemma-9b":
            w = cfg.window
            out += [(name, case_flash, dict(window=w, **heads)),
                    (name, case_decode, dict(q_pos=[2500, 3000, 4100, 5000],
                                             cap=w, window=w, **heads))]
            continue
        out += [(name, case_flash, heads),
                (name, case_decode, dict(B=4, ctx=2048, cap=8192, **heads))]
        if name in SERVE_SHAPES:   # a prompt's first chunk, then a later one
            out += [(name, case_chunk, dict(S=4096, done=0, cap=8192,
                                            attend_prefix=False, **heads)),
                    (name, case_chunk, heads)]
    return out


def phase_kernels():
    """Every case in fp32 and bf16; returns the bf16 main-path cases by
    kernel name (the serve phases run bf16)."""
    main = {}
    t0 = time.monotonic()
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(case_decode, {}),
                 # the serve phase's decode: 4 slots of 8192 tokens, 2048 live
                 (case_decode, dict(B=4, ctx=2048, cap=8192)),
                 # ragged live lengths in 8192-token slots; 16-token pages
                 (case_decode, dict(q_pos=[99, 699, 2047, 5999], cap=8192)),
                 (case_decode, dict(B=4, ctx=2048, cap=8192, P=16)),
                 # a wrapped window ring: every row past its capacity
                 (case_decode, dict(q_pos=[1500, 3000, 1100, 5000],
                                    cap=1024, window=1024)),
                 (case_chunk, {}),
                 (case_chunk, dict(S=200, done=1536, cap=1024, window=1024,
                                   pad=8)),
                 # the serve phase's 6000-token request: its two chunks
                 (case_chunk, dict(S=4096, done=0, cap=8192,
                                   attend_prefix=False)),
                 (case_chunk, dict(S=1904, done=4096, cap=8192)),
                 # the engine's default 16-token pages
                 (case_chunk, dict(P=16)),
                 (case_flash, {}), (case_flash, dict(S=1000)),
                 (case_flash, dict(S=600)),   # a ragged whole prompt
                 (case_migrate, {}),
                 # cluster-serve's merge: a donor slot's export and import
                 (case_slot_move, dict(slot=1, to_slot=2)),
                 (case_ffn, {}), (case_ffn, dict(T=512)),
                 (case_ffn, dict(tp=1)), (case_ffn, dict(T=512, tp=1)),
                 # the worker engine's prefill chunk and a remainder
                 (case_ffn, dict(T=128)), (case_ffn, dict(T=128, tp=1)),
                 (case_ffn, dict(T=44)), (case_ffn, dict(T=44, tp=1)),
                 *padded_ffn_cases()]
        cases = [("llama3-8b", fn, kw) for fn, kw in cases]
        # slice 7's shapes: its engines' degrees and KV migrations; slice
        # 8's: the partial entries and the combine at its shard shapes
        cases += (slice7_cases() + slice8_cases() + moe_cases()
                  + rg_cases() + enc_cases())
        for model, fn, kw in cases + head_shape_cases():
            got = fn(dtype, **kw)
            for r in got if isinstance(got, list) else [got]:
                r["dtype"] = str(dtype).replace("torch.", "")
                r.setdefault("tol", "bit-equal" if r.get("bit_equal")
                             else tol_text(dtype))
                r.setdefault("model", model)
                emit(phase="kernels", **r)
                if (dtype == torch.bfloat16 and not kw
                        and model == "llama3-8b"):
                    main[r["kernel"]] = r
                if (dtype == torch.bfloat16 and fn in (case_decode_sp,
                                                       case_chunk_sp)):
                    main.setdefault(r["kernel"] + "@sp", r)
    ffn_tilings()
    decode_walk()
    emit(phase="kernels", seconds=time.monotonic() - t0)
    return main


# ---------------------------------------------------------------------------
def _prompts(gen, lens, vocab):
    return [torch.randint(0, vocab, (n,), generator=gen).tolist()
            for n in lens]


def phase_parity():
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.core.scheduler import PrefillPolicy
    from repro_torch.models.model import build
    from repro_torch.serving import Engine, ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                              dtype="float32")
    plan = make_plan(cfg, 1)
    t0 = time.monotonic()
    cpu_model = build(cfg, plan, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    prompts = _prompts(torch.Generator().manual_seed(5), (60, 150, 250),
                       cfg.vocab_size)
    streams, logits = {}, {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = Engine(cfg, params=model, max_batch=4, max_seq=512,
                     page_tokens=64, device=dev,
                     prefill_policy=PrefillPolicy(token_budget=128,
                                                  mode="mixed"))
        reqs = [ServeRequest(p, max_new_tokens=16) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        streams[dev] = [r.generated for r in reqs]
        # first-token logits: the whole-prompt path (flash) for the short
        # prompt, the 128-token chunk path (chunk kernel) for the long one
        with torch.no_grad():
            short = torch.tensor(prompts[0], device=dev)[None]
            caches = model.init_decode_caches(1, 512, 64)
            lw = model.prefill(short, caches)
            long_ = torch.tensor(prompts[2], device=dev)[None]
            caches = model.init_decode_caches(1, 512, 64)
            for s0 in range(0, long_.shape[1], 128):
                lc = model.prefill_chunk(
                    long_[:, s0:s0 + 128],
                    torch.tensor([s0], dtype=torch.int32, device=dev),
                    caches, first_chunk=s0 == 0)
        logits[dev] = (lw.float().cpu(), lc.float().cpu())
    err = max((a - b).abs().max().item()
              for a, b in zip(logits["cuda"], logits["cpu"]))
    assert streams["cuda"] == streams["cpu"], streams
    assert err <= 1e-3, ("first-token logits", err)
    emit(phase="parity", layers=cfg.num_layers, d_model=cfg.d_model,
         prompts=[len(p) for p in prompts], streams_equal=True,
         first_token_logit_max_abs_err=err, tol=1e-3,
         seconds=time.monotonic() - t0)


def phase_serve(smi: str):
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.kernels import chunk_prefill as CP
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.model import build
    from repro_torch.serving import Engine, ServeRequest

    cfg = get_config("llama3-8b")
    plan = make_plan(cfg, 1)
    t0 = time.monotonic()
    model = build(cfg, plan, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    eng = Engine(cfg, params=model, max_batch=4, max_seq=8192,
                 page_tokens=64, device="cuda")
    gen = torch.Generator().manual_seed(7)
    # warm-up: one short request (library handles, allocator)
    warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                        max_new_tokens=2)
    eng.submit(warm)
    eng.run_until_done()
    lens = (100, 350, 600, 6000)
    reqs = [ServeRequest(p, max_new_tokens=32)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    mods = (PA, CP, FA)
    for m in mods:
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"paged_attention": PA.launches, "chunk_prefill": CP.launches,
                "flash_attention": FA.launches}
    for r in reqs:
        assert len(r.generated) == 32, (len(r.prompt), len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert all(n > 0 for n in launches.values()), launches
    ttft = [r.ttft for r in reqs]
    tpot = [r.tpot for r in reqs]
    decode_tps = serve_decode_tps(eng, cfg, gen)
    profiles = (decode_profile(eng, cfg, gen),
                prefill_profile(eng, cfg, gen))
    # the calibrate phase's throughput constants: the decode rate of a
    # batch of its own, and the prefill rate of the 6000-token request
    # alone on the engine (in the timed run above its TTFT also holds
    # the other prompts' prefill and decode steps)
    rates = {"decode_tps": decode_tps,
             "prefill_tps": lens[-1] / profiles[1]["ttft_s"],
             "long_ttft_s": profiles[1]["ttft_s"],
             "long_ttft_with_others_s": reqs[-1].ttft}
    host_us = wrapper_host_us()
    # host time of this run's prefill wrapper calls, at the measured cost
    # of one call (the tensor-map encoding is the bf16 - fp32 part)
    prefill_host_ms = sum(launches[k] * host_us[k]["bfloat16"]
                          for k in host_us) / 1e3
    emit(phase="serve", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, prompts=list(lens), new_tokens=32,
         weights_init_s=t_init, wall_s=wall,
         ttft_s=ttft, tpot_s=tpot,
         tokens_per_s=sum(len(r.generated) for r in reqs) / wall,
         decode_tps_4x2048=rates["decode_tps"],
         launches=launches, prefill_wrapper_host_us=host_us,
         prefill_wrapper_host_ms=prefill_host_ms,
         decode_wrapper_host_us=decode_wrapper_host_us(),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    for p in profiles:
        emit(phase="profile", gpu=smi, **p)
    return launches, rates


def bare(fn):
    """A kernel wrapper without the shape census's recorder."""
    return getattr(fn, "__wrapped__", fn)


def wrapper_host_us(calls: int = 200) -> dict:
    """Host microseconds a prefill wrapper call takes to enqueue its
    launches (no synchronise inside the window), at a tiny shape so the
    card never holds the host back.  The bf16 calls encode their TMA
    tensor maps on the host (3 for flash, 4 for chunk), the fp32 calls
    none: the difference is the encoding's cost."""
    from repro_torch.kernels import chunk_prefill as CP
    from repro_torch.kernels import flash_attention as FA
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 64, 32, 128), device="cuda").to(dtype)
        k = torch.randn((1, 64, 8, 128), device="cuda").to(dtype)
        pool = torch.zeros((2, 8, 2, 64, 128), device="cuda", dtype=dtype)
        pt = torch.arange(2, dtype=torch.int32, device="cuda")[None]
        kvpos = torch.full((1, 128), -1, dtype=torch.int32, device="cuda")
        qpos = torch.arange(64, dtype=torch.int32, device="cuda")[None]
        # the wrappers themselves, without the shape census around them
        fa, cp = bare(FA.flash_attention), bare(CP.chunk_prefill_attention)
        calls_of = {
            "flash_attention": lambda: fa(q, k, k),
            "chunk_prefill": lambda: cp(q, k, k, pool, pt, kvpos, qpos)}
        for name, fn in calls_of.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            out.setdefault(name, {})[str(dtype).replace("torch.", "")] = (
                (t1 - t0) / calls * 1e6)
    return out


def decode_wrapper_host_us(calls: int = 200) -> dict:
    """Host microseconds a ``paged_decode`` call takes to enqueue its two
    launches, at a tiny shape (the card never holds the host back), in
    bf16 and fp32; and what the per-call work that the wrapper now does
    once per device and stream would cost on its own: reading the SM
    count from ``get_device_properties`` and allocating the three
    split-scratch tensors."""
    from repro_torch.kernels import paged_attention as PA
    dev = "cuda"
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 32, 128), device=dev).to(dtype)
        pool = torch.zeros((2, 8, 2, 64, 128), device=dev, dtype=dtype)
        pt = torch.arange(2, dtype=torch.int32, device=dev)[None]
        qpos = torch.full((1,), 100, dtype=torch.int32, device=dev)
        kvpos = stored_positions(qpos, 128)
        decode = bare(PA.paged_decode)
        fn = lambda: decode(q, pool, pt, kvpos, qpos)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[str(dtype).replace("torch.", "")] = (t1 - t0) / calls * 1e6

    def removed():
        torch.cuda.get_device_properties(dev).multi_processor_count
        f32 = dict(dtype=torch.float32, device=dev)
        torch.empty((4, 8, 8, 4), **f32)
        torch.empty((4, 8, 8, 4), **f32)
        torch.empty((4, 8, 8, 4, 128), **f32)

    removed()
    t0 = time.perf_counter()
    for _ in range(calls):
        removed()
    out["removed_per_call_work"] = (time.perf_counter() - t0) / calls * 1e6
    return out


def free_card():
    """Drop what earlier phases left on the card."""
    gc.collect()
    torch.cuda.empty_cache()


def _worker_engine(cfg, W=2, **kw):
    from repro_torch.serving import Engine
    return Engine(cfg, devices=["cuda"] * W, seed=0, **kw)


def _drive(eng, reqs, before=0, plan=()):
    """Submit, step ``before`` times, then transform through each degree
    of ``plan`` (stepping until the session lands), then run to done."""
    for r in reqs:
        eng.submit(r)
    for _ in range(before):
        eng.step()
    for tp in plan:
        eng.transform(tp)
        while eng.transforming:
            eng.step()
            eng.check_capacity_invariant()
    eng.run_until_done()
    return [r.generated for r in reqs]


def phase_transform_parity():
    """Full width, 2 layers, fp32, two workers on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import PrefillPolicy
    from repro_torch.serving import ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                              dtype="float32")
    t0 = time.monotonic()
    prompts = _prompts(torch.Generator().manual_seed(9), (60, 150, 250, 90),
                       cfg.vocab_size)
    kw = dict(max_batch=4, max_seq=512, page_tokens=64,
              prefill_policy=PrefillPolicy(token_budget=128, mode="mixed"))

    def reqs():
        return [ServeRequest(p, max_new_tokens=16) for p in prompts]

    streams = {}
    for name, before, plan in (("tp2", 0, None), ("mid", 6, (2,)),
                               ("round_trip", 6, (2, 1)),
                               ("untransformed", 0, ())):
        eng = _worker_engine(cfg, **kw)
        if plan is None:               # started at TP2
            eng.transform(2)
            while eng.transforming:
                eng.step()
            plan = ()
        streams[name] = _drive(eng, reqs(), before, plan)
        del eng
        free_card()
    assert streams["mid"] == streams["tp2"], streams
    assert streams["round_trip"] == streams["untransformed"], streams
    eng = _worker_engine(cfg, **kw)
    for r in reqs():
        eng.submit(r)
    for _ in range(6):
        eng.step()
    before = [(c.pool.clone(), c.page_table.clone(), c.seq_lens.clone(),
               c.positions.clone()) for c in eng.global_caches()]
    eng.transform(2)
    while not eng._session.done:
        eng._session.step()
    eng._finish_transform()
    after = [(c.pool, c.page_table, c.seq_lens, c.positions)
             for c in eng.global_caches()]
    assert all(torch.equal(a, b) for x, y in zip(before, after)
               for a, b in zip(x, y)), "cache bytes changed in migration"
    del eng, before, after
    free_card()
    emit(phase="transform-parity", layers=cfg.num_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, workers=2,
         prompts=[len(p) for p in prompts],
         mid_decode_equals_tp2=True, round_trip_equals_untransformed=True,
         tp2_equals_untransformed=streams["tp2"] == streams["untransformed"],
         cache_bytes_equal_across_migration=True,
         seconds=time.monotonic() - t0)


def phase_transform_w4():
    """Four workers on the card: full width, 8 layers, fp32.  A TP1x4 ->
    TP4 -> TP1x4 round trip mid-decode gives the stream of an
    untransformed engine."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=8,
                              dtype="float32")
    t0 = time.monotonic()
    prompts = _prompts(torch.Generator().manual_seed(13),
                       (70, 200, 130, 260), cfg.vocab_size)
    streams = {}
    for name, before, plan in (("untransformed", 0, ()),
                               ("round_trip", 5, (4, 1))):
        eng = _worker_engine(cfg, W=4, max_batch=4, max_seq=1024,
                             page_tokens=64)
        streams[name] = _drive(
            eng, [ServeRequest(p, max_new_tokens=16) for p in prompts],
            before, plan)
        del eng
        free_card()
    assert streams["round_trip"] == streams["untransformed"], streams
    emit(phase="transform-w4", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, workers=4, prompts=[len(p) for p in prompts],
         round_trip_equals_untransformed=True,
         seconds=time.monotonic() - t0)


def sync(dev: str) -> None:
    if dev == "cuda":
        torch.cuda.synchronize()


def mem_gb(dev: str):
    return torch.cuda.memory_allocated() / 1e9 if dev == "cuda" else None


def slot_pages(eng, layer, slot: int, n=None):
    """The first ``n`` (default: all) pages of ``slot`` in ``layer``'s
    cache, on the worker that holds the slot."""
    w, local = eng._holder(layer, slot)
    st = layer.cache[w]
    mps = st.page_table.shape[-1]
    return st.pool[local * mps:local * mps + (n or mps)]


class ExportLog:
    """Keeps a host copy of every merge donor's slot pages (each layer's,
    taken from the donor's own pool before it exports them) by wrapping
    ``Engine.export_active`` until ``close``."""

    def __init__(self):
        from repro_torch.serving.engine import Engine
        self.Engine, self.orig, self.seen = Engine, Engine.export_active, []
        log = self

        def export_active(eng):
            log.seen.extend(
                (r.rid, [slot_pages(eng, layer, slot).to("cpu", copy=True)
                         for layer in eng.layers])
                for slot, r in enumerate(eng.slots) if r is not None)
            return log.orig(eng)

        Engine.export_active = export_active

    def close(self):
        self.Engine.export_active = self.orig


def cluster_actions(cl) -> list:
    """[kind, iid, tp_to, donors, reason] a transform; [kind, iid,
    host, overflow tokens, reason] a spill."""
    return [[type(a).__name__, a.iid, a.tp_to,
             list(getattr(a, "donor_iids", ())), a.reason]
            if hasattr(a, "tp_to") else
            [type(a).__name__, a.iid, a.host_iid, a.tokens, a.reason]
            for a in cl.actions]


def check_merge_bytes(cl, seen) -> int:
    """The slot pages the merge target imported equal, byte for byte,
    the donor's own pages from before the export; returns the bytes
    compared."""
    merge = cl.merge_log[0]
    target = cl._engine(merge["iid"])
    slot_of = dict(merge["slots"])
    assert seen and {rid for rid, _ in seen} == set(slot_of), seen
    n = 0
    for rid, pages in seen:
        for layer, own in zip(target.layers, pages):
            got = slot_pages(target, layer, slot_of[rid], own.shape[0])
            assert torch.equal(got.cpu(), own), ("imported KV", rid)
            n += own.numel() * own.element_size()
    return n


def revived_serves(cl, donor_iid: int, prompt, new: int, first_rid=None):
    """On an idle cluster after a split: one request per engine through
    the router (``cl.submit``), which must place one on the revived
    donor.  Returns the requests."""
    from repro_torch.serving import ServeRequest
    assert cl.idle and not any(e.parked for e in cl.engines)
    posts = [ServeRequest(prompt, max_new_tokens=new,
                          **({} if first_rid is None
                             else {"rid": first_rid + k}))
             for k in range(len(cl.engines))]
    for p in posts:
        cl.submit(p)
    placed = {cl.placements.get(p.rid) for p in posts}
    assert donor_iid in placed and placed <= {
        e.iid for e in cl.engines}, (placed, donor_iid)
    return posts


def phase_cluster_parity(dev: str = "cuda", cfg=None, max_seq: int = 512,
                         lens=(60, 150, 90), long_len: int = 700,
                         page_tokens: int = 64):
    """Full width, 2 layers, fp32: a ClusterEngine of 2 instances x 1
    worker and of 2 x 2 on the card merges for a request only the merged
    engine holds; streams equal an engine started at the merged width."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.core.weight_transform import relayout_mlp_for_tp
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, ServeRequest
    from repro_torch.serving.cluster import ClusterEngine
    from repro_torch.serving.metrics import METRIC_KEYS

    cfg = cfg or dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                                     dtype="float32")
    t0 = time.monotonic()
    gen = torch.Generator().manual_seed(17)
    prompts = _prompts(gen, tuple(lens) + (long_len,), cfg.vocab_size)
    post_prompt = _prompts(gen, (min(lens),), cfg.vocab_size)[0]
    out = []
    for per in (1, 2):
        ndev = 2 * per
        plan = make_plan(cfg, ndev, mode="page")
        model = M.build(cfg, plan, seed=0, device=dev)
        for blk in model.layers:
            blk.mlp["wi"].data, blk.mlp["wo"].data = relayout_mlp_for_tp(
                blk.mlp["wi"].data, blk.mlp["wo"].data, cfg.d_ff, ndev)
        log = ExportLog()
        try:
            cl = ClusterEngine(cfg, [dev] * ndev, n_instances=2,
                               max_batch=4, max_seq=max_seq,
                               page_tokens=page_tokens, params=model,
                               dwell_steps=4)
            reqs = [ServeRequest(p, max_new_tokens=16, rid=i)
                    for i, p in enumerate(prompts)]
            for r in reqs[:-1]:
                cl.submit(r)
            while any(not r.generated for r in reqs[:-1]):
                cl.step()
            assert all(any(s is not None for s in e.slots)
                       for e in cl.engines), "both instances decode"
            cl.submit(reqs[-1])
            merges = [a for a in cl.actions if getattr(a, "donor_iids", ())]
            assert merges and merges[0].tp_to == ndev, cl.actions
            nbytes = check_merge_bytes(cl, log.seen)
        finally:
            log.close()
        cl.run(max_steps=20000)
        acts = cluster_actions(cl)
        assert [a[0] for a in acts] == ["ScaleUp", "ScaleDown"], acts
        assert cl.stall_steps == 0 and cl.tokens_during_session > 0
        cl.partition.check_invariants()
        assert not cl.partition.loans_to(merges[0].iid)
        assert not any(e.parked for e in cl.engines)
        # the revived donor is routed to again and serves
        posts = revived_serves(cl, merges[0].donor_iids[0], post_prompt, 8,
                               first_rid=len(reqs))
        cl.run(max_steps=20000)
        assert all(len(p.generated) == 8 for p in posts)
        assert list(cl.metrics()) == list(METRIC_KEYS)
        streams = [r.generated for r in reqs]
        del cl
        free_card() if dev == "cuda" else None
        # each request alone on an engine started at the merged width
        eng = Engine(cfg, params=model, devices=[dev] * ndev, max_batch=4,
                     max_seq=2 * max_seq, page_tokens=page_tokens,
                     plan=plan)
        eng.transform(ndev)
        while eng.transforming:
            eng.step()
        for r, got in zip(prompts, streams):
            want = ServeRequest(r, max_new_tokens=16)
            eng.submit(want)
            eng.run_until_done()
            assert want.generated == got, ("merged stream", ndev)
        del eng, model
        free_card() if dev == "cuda" else None
        out.append({"instances": 2, "workers_each": per, "actions": acts,
                    "imported_kv_bytes_equal": nbytes,
                    "stall_steps": 0, "streams_equal_tp%d" % ndev: True,
                    "donor_revived_serves": True})
    emit(phase="cluster-parity", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, prompts=list(lens) + [long_len], cases=out,
         seconds=time.monotonic() - t0)


def phase_cluster_serve(smi: str, dev: str = "cuda", cfg=None,
                        max_seq: int = 4096, lens=(300, 1200, 3500),
                        long_len: int = 6000, new: int = 128,
                        long_new: int = 32, page_tokens: int = 64,
                        post_len: int = 500, label: str = "cluster-serve",
                        kernels=None):
    """Full-size llama3-8b in bf16, 2 instances x 1 worker of the card:
    a live merge for a 6000-token request while both decode, its chunked
    prefill on the merged TP2 engine, the Alg-2 split after the dwell
    and the donor's revive, then a request for each engine through the
    router.  Returns the six kernels' launches on this path, each of
    which (or of ``kernels``, the path's own: a MoE model runs no padded
    FFN) must launch; the line is ``label``'s."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, ServeRequest
    from repro_torch.serving.cluster import ClusterEngine
    from repro_torch.serving.metrics import METRIC_KEYS

    cfg = cfg or get_config("llama3-8b")
    t0 = time.monotonic()
    cl = ClusterEngine(cfg, [dev] * 2, n_instances=2, max_batch=4,
                       max_seq=max_seq, page_tokens=page_tokens, seed=0)
    sync(dev)
    t_init = time.monotonic() - t0
    gen = torch.Generator().manual_seed(23)
    for e in cl.engines:        # warm-up: library handles, allocator
        warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                            max_new_tokens=2)
        e.submit(warm)
        e.run_until_done()
    mem = {}
    orig_park, orig_revive = Engine.park, Engine.revive

    def park(eng):
        out = orig_park(eng)
        mem["after_park"] = mem_gb(dev)
        return out

    def revive(eng, workers, params):
        mem["after_split"] = mem_gb(dev)
        orig_revive(eng, workers, params)
        mem["after_revive"] = mem_gb(dev)

    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    long_ = ServeRequest(_prompts(gen, (long_len,), cfg.vocab_size)[0],
                         max_new_tokens=long_new)
    post_prompt = _prompts(gen, (post_len,), cfg.vocab_size)[0]
    posts = []
    steps = []   # (where, wall s, decode tokens, prefill work this step?)

    def where():
        e = cl._engine(cl.merge_log[0]["iid"]) if cl.merge_log else None
        if e is None:
            return "TP1 x2 instances"
        if e.transforming:
            return ("merge session" if e.tp_pending > 1
                    else "split session")
        return f"TP{e.tp} merged" if e.tp > 1 else "TP1 after split"

    def progress():
        return (sum(len(e.waiting) for e in cl.engines) + len(cl.waiting),
                sum(p["done"] for e in cl.engines
                    for p in e._prefilling.values()))

    def step():
        before, w = progress(), where()
        sync(dev)
        t = time.monotonic()
        live = reqs + [long_] + posts
        decoding = {id(r): len(r.generated) for r in live}
        cl.step()
        sync(dev)
        wall = time.monotonic() - t
        dec = sum(len(r.generated) - decoding[id(r)] for r in live
                  if decoding[id(r)] > 0)
        steps.append((w, wall, dec, before != progress()))

    Engine.park, Engine.revive = park, revive
    log = ExportLog()
    try:
        reset_launch_counts()
        t_run = time.monotonic()
        for r in reqs:
            cl.submit(r)
        while any(not r.generated for r in reqs):
            step()
        for _ in range(8):             # both instances decode
            step()
        assert sorted(set(cl.placements.values())) == [0, 1], cl.placements
        mem["before_merge"] = mem_gb(dev)
        cl.submit(long_)
        merge = cl.merge_log[0] if cl.merge_log else None
        assert merge and merge["donors"], cl.actions
        mem["after_merge_submit"] = mem_gb(dev)
        target = cl._engine(merge["iid"])
        donor = cl._engine(merge["donors"][0])
        assert donor.parked and target.transforming and target.W == 2
        merge_kv_bytes = check_merge_bytes(cl, log.seen)
        log.close()
        while not long_.done:
            step()
        while target.transforming or cl._releasing or any(
                e.parked for e in cl.engines):
            step()
            assert len(steps) < 20000
        while not cl.idle:
            step()
            assert len(steps) < 20000
        posts += revived_serves(cl, donor.iid, post_prompt, 16)
        while not cl.idle:
            step()
        wall = time.monotonic() - t_run
        launches = launch_counts()
    finally:
        Engine.park, Engine.revive = orig_park, orig_revive
        log.close()
    acts = cluster_actions(cl)
    assert [a[0] for a in acts] == ["ScaleUp", "ScaleDown"], acts
    assert acts[0][3] == [donor.iid], acts
    assert cl.stall_steps == 0 and cl.tokens_during_session > 0
    for r in reqs + [long_] + posts:
        assert r.done and all(0 <= t < cfg.vocab_size for t in r.generated)
    assert len(long_.generated) == long_new
    assert all(len(p.generated) == 16 for p in posts)
    # every kernel of the path launched (only CUDA calls count)
    assert dev != "cuda" or all(launches[k] > 0
                                for k in kernels or launches), launches
    cl.partition.check_invariants()
    m = cl.metrics()
    assert list(m) == list(METRIC_KEYS)
    sessions = []
    for log in target.transform_log:
        sessions.append({k: log[k] for k in (
            "tp_from", "tp_to", "cross", "steps", "wall_s", "measured_s",
            "exposed_s", "modeled_s", "kv_bytes", "weight_bytes")})
    emit(phase=label, model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, instances=2, workers_each=1,
         prompts=list(lens), new_tokens=new, long_prompt=long_len,
         actions=acts, weights_init_s=t_init, wall_s=wall,
         sessions=sessions, stall_steps=cl.stall_steps,
         session_steps=cl.session_steps,
         tokens_during_session=cl.tokens_during_session,
         steps_by_phase=step_summary(steps),
         imported_kv_bytes_equal=merge_kv_bytes,
         ttft_s=[r.ttft for r in reqs + [long_] + posts],
         tpot_s=[r.tpot for r in reqs + [long_] + posts],
         tokens_per_s=sum(len(r.generated) for r in reqs + [long_] + posts)
         / wall, metrics={k: None if v != v else v for k, v in m.items()},
         memory_allocated_gb=mem, launches=launches,
         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None), gpu=smi)
    del cl, target, donor
    if dev == "cuda":
        free_card()
    return launches


#: the serve CLI on the paper's own model: published widths and depth in
#: bf16, one instance of one worker of the card
QWEN_CLI = ("--arch", "qwen2.5-32b", "--no-smoke", "--instances", "1",
            "--workers", "1", "--max-seq", "8192", "--requests", "4",
            "--long-every", "2")


def phase_serve_cli(args=()):
    """The port's entry point as a subprocess, its [serve] lines echoed:
    with its defaults (reduced llama3-8b, fp32, 8 workers of the card:
    2 instances of 4, its 4 kv heads copied twice),
    or serving full-size qwen2.5-32b (``QWEN_CLI``, which needs the card
    nearly to itself: this process's own tensors are freed first and
    its allocation printed), granite-moe-3b-a800m (``MOE_CLI``) or
    recurrentgemma-9b (``RG_CLI``)."""
    free_card()
    parent_gb = torch.cuda.memory_allocated() / 1e9
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    lines = [l for l in out.stdout.splitlines() if l.startswith("[serve]")]
    assert out.returncode == 0, out.stderr[-4000:]
    if args:
        assert any("finished=4, total=4" in l for l in lines), lines
    else:
        assert any(" -> TP4 " in l for l in lines), lines
        assert "[serve] final TPs: [1, 1]" in lines, lines
    emit(phase="serve-cli", args=list(args), lines=lines,
         parent_allocated_gb=parent_gb, seconds=time.monotonic() - t0)


# ---------------------------------------------------------------------------
# slice 6: the registered head shapes end to end, and KV spill

def phase_serve_shapes(smi: str, dev: str = "cuda", names=SERVE_SHAPES,
                       cfg_of=None, lens=(100, 1000, 6000), new: int = 16,
                       max_seq: int = 8192, page_tokens: int = 64) -> dict:
    """Each model of ``names`` at full width and depth in bf16 with random
    weights (``cfg_of`` may cut it for a dry run on the CPU), served
    through ``Engine``: prompts of 100, 1000 and 6000 tokens (the last
    chunks at 4096), ``new`` greedy tokens each.  qwen2.5-32b (62.3 GB of
    weights) takes 2 slots of 8192 tokens (a 4 GiB pool), the others 4.
    Prints TTFT, TPOT, tokens/s, peak memory and the attention kernels'
    launches; the card is freed between models.  Returns each model's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.models.model import build
    from repro_torch.serving import Engine, ServeRequest

    out = {}
    for name in names:
        cfg = cfg_of(name) if cfg_of else get_config(name)
        t0 = time.monotonic()
        model = build(cfg, make_plan(cfg, 1), seed=0, device=dev)
        sync(dev)
        t_init = time.monotonic() - t0
        weights_gb = sum(t.numel() * t.element_size()
                         for t in model.state_dict().values()) / 1e9
        batch = 2 if name == "qwen2.5-32b" else 4
        eng = Engine(cfg, params=model, max_batch=batch, max_seq=max_seq,
                     page_tokens=page_tokens, device=dev)
        gen = torch.Generator().manual_seed(29)
        warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                            max_new_tokens=2)
        eng.submit(warm)
        eng.run_until_done()
        reqs = [ServeRequest(p, max_new_tokens=new)
                for p in _prompts(gen, lens, cfg.vocab_size)]
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        sync(dev)
        t0 = time.monotonic()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        sync(dev)
        wall = time.monotonic() - t0
        counts = {k: v for k, v in launch_counts().items()
                  if k in ("paged_attention", "chunk_prefill",
                           "flash_attention")}
        for r in reqs:
            assert len(r.generated) == new, (name, len(r.prompt))
            assert all(0 <= t < cfg.vocab_size for t in r.generated)
        assert dev != "cuda" or all(n > 0 for n in counts.values()), (
            name, counts)
        # prefill materialises the last position's logits only, as the
        # reference's does (a 6000 x 152064 fp32 block would be 3.6 GB)
        with torch.no_grad():
            logits = model.prefill(
                torch.tensor(reqs[0].prompt[:64], device=dev)[None],
                model.init_decode_caches(1, 64, page_tokens))
        assert tuple(logits.shape[:2]) == (1, 1), tuple(logits.shape)
        emit(phase="serve-shapes", model=name, layers=cfg.num_layers,
             d_model=cfg.d_model, heads=[cfg.num_heads, cfg.num_kv_heads,
                                         cfg.resolved_head_dim],
             dtype=cfg.dtype, max_batch=batch, max_seq=max_seq,
             weights_gb=weights_gb, weights_init_s=t_init,
             prompts=list(lens), new_tokens=new, wall_s=wall,
             ttft_s=[r.ttft for r in reqs], tpot_s=[r.tpot for r in reqs],
             # TTFT less the wait for a slot: the prefill alone
             prefill_s=[r.t_first_token - r.t_prefill_start for r in reqs],
             tokens_per_s=sum(len(r.generated) for r in reqs) / wall,
             peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                          if dev == "cuda" else None),
             prefill_logits_rows=1, launches=counts, gpu=smi)
        out[name] = counts
        del eng, model
        if dev == "cuda":
            free_card()
    return out


class SpillCheck:
    """Wraps ``Engine.spill_slot`` until ``close``: after every write-back
    it records whether, in every layer, the host's reserved slot holds
    the overflow pages (and their positions) of the guest's extended
    view bit for bit, and the bytes of the extended view's pools."""

    def __init__(self):
        from repro_torch.serving.engine import Engine
        self.Engine, self.orig = Engine, Engine.spill_slot
        self.equal, self.ext_bytes = [], []
        chk = self

        def spill_slot(eng, slot, ext):
            chk.orig(eng, slot, ext)
            sp = eng._spills[slot]
            host, j = sp["host"], sp["hosting"]["slots"][0]
            n_local = eng._local_page_cap() // eng.page_tokens
            P = eng.page_tokens
            same = []
            for view, hosted in zip(ext, host._slot_caches(j)):
                over = view.pool[n_local:]
                same.append(
                    torch.equal(hosted.pool[:over.shape[0]], over)
                    and torch.equal(hosted.positions[0, :over.shape[0] * P],
                                    view.positions[0, n_local * P:]))
            chk.equal.append(all(same))
            chk.ext_bytes.append(nbytes(*(v.pool for v in ext)))

        Engine.spill_slot = spill_slot

    def close(self):
        self.Engine.spill_slot = self.orig


def _spill_scheduler(**kw):
    from repro_torch.core.scheduler import GygesScheduler, SchedulerConfig
    return GygesScheduler(SchedulerConfig(spill=True, spill_slack=2.0, **kw))


def phase_spill_parity(dev: str = "cuda", cfg=None, max_seq: int = 512,
                       lens=(60, 150, 90), long_len: int = 700,
                       new: int = 16, page_tokens: int = 64):
    """Full width, 2 layers, fp32: a ClusterEngine of 2 instances x 1
    worker under ``SchedulerConfig(spill=True, spill_slack=2.0)``; shorts
    on both instances, then a request above one instance's ceiling that
    spills into the neighbour.  Every stream equals that of one engine
    whose own pool holds the request whole, and after every write-back
    the host's hosted pages equal the overflow of the guest's extended
    view bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.core.scheduler import Spill
    from repro_torch.core.weight_transform import relayout_mlp_for_tp
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, ServeRequest
    from repro_torch.serving.cluster import ClusterEngine

    cfg = cfg or dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                                     dtype="float32")
    t0 = time.monotonic()
    gen = torch.Generator().manual_seed(31)
    prompts = _prompts(gen, tuple(lens) + (long_len,), cfg.vocab_size)
    plan = make_plan(cfg, 2, mode="page")
    model = M.build(cfg, plan, seed=0, device=dev)
    for blk in model.layers:
        blk.mlp["wi"].data, blk.mlp["wo"].data = relayout_mlp_for_tp(
            blk.mlp["wi"].data, blk.mlp["wo"].data, cfg.d_ff, 2)
    cl = ClusterEngine(cfg, [dev] * 2, n_instances=2, max_batch=4,
                       max_seq=max_seq, page_tokens=page_tokens,
                       params=model, scheduler=_spill_scheduler(),
                       dwell_steps=4)
    reqs = [ServeRequest(p, max_new_tokens=new, rid=i)
            for i, p in enumerate(prompts)]
    check = SpillCheck()
    try:
        for r in reqs[:-1]:
            cl.submit(r)
        while any(not r.generated for r in reqs[:-1]):
            cl.step()
        assert all(any(s is not None for s in e.slots)
                   for e in cl.engines), "both instances decode"
        cl.submit(reqs[-1])
        acts = cluster_actions(cl)
        assert [a[0] for a in acts] == ["Spill"], acts
        assert isinstance(cl.actions[0], Spill)
        cl.run(max_steps=20000)
    finally:
        check.close()
    assert check.equal and all(check.equal), check.equal
    assert cl.metrics()["spill_pages"] > 0 and not cl.partition.spills()
    assert cluster_actions(cl) == acts, "a spill needs no transformation"
    streams = [r.generated for r in reqs]
    spill_pages = cl.metrics()["spill_pages"]
    del cl
    if dev == "cuda":
        free_card()
    alone = Engine(cfg, params=model, devices=[dev], max_batch=4,
                   max_seq=2 * max_seq, page_tokens=page_tokens, plan=plan)
    for p, got in zip(prompts, streams):
        want = ServeRequest(p, max_new_tokens=new)
        alone.submit(want)
        alone.run_until_done()
        assert want.generated == got, ("spilled cluster stream", len(p))
    emit(phase="spill-parity", layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.dtype, instances=2, workers_each=1, max_seq=max_seq,
         prompts=list(lens) + [long_len], actions=acts,
         spill_pages=spill_pages, write_backs_checked=len(check.equal),
         hosted_pages_equal=True, streams_equal_unspilled_engine=True,
         seconds=time.monotonic() - t0)
    del alone, model
    if dev == "cuda":
        free_card()


def phase_cluster_spill(smi: str, dev: str = "cuda", cfg=None,
                        max_seq: int = 4096, lens=(300, 1200, 300, 1200),
                        new: int = 128, long_len: int = 6000,
                        long_new: int = 32, page_tokens: int = 64,
                        label: str = "cluster-spill") -> dict:
    """Full-size llama3-8b in bf16 (or ``cfg``, emitted as ``label``),
    2 instances x 1 worker of the card (4096 tokens a worker),
    ``SchedulerConfig(spill=True,
    spill_slack=2.0)``: prompts of 300 and 1200 tokens on both
    instances, then a 6000-token request whose 31 overflow pages spill
    into one reserved slot of the neighbour; no transformation.  Prints
    the actions, the spilled request's TTFT, the mean wall of a decode
    step with and without the spilled slot, the spill log's bytes and
    wall a step against what each write-back's copies move, memory
    allocated before, during and after, and the launches of kernels 1,
    2 and 5 on this path.  Returns the path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeRequest
    from repro_torch.serving.cluster import ClusterEngine
    from repro_torch.serving.request import State

    cfg = cfg or get_config("llama3-8b")
    t0 = time.monotonic()
    cl = ClusterEngine(cfg, [dev] * 2, n_instances=2, max_batch=4,
                       max_seq=max_seq, page_tokens=page_tokens, seed=0,
                       scheduler=_spill_scheduler())
    sync(dev)
    t_init = time.monotonic() - t0
    gen = torch.Generator().manual_seed(37)
    for e in cl.engines:        # warm-up: library handles, allocator
        warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                            max_new_tokens=2)
        e.submit(warm)
        e.run_until_done()
    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    long_ = ServeRequest(_prompts(gen, (long_len,), cfg.vocab_size)[0],
                         max_new_tokens=long_new)
    mem = {}
    steps = []   # (long decoding this step?, wall s, decode tokens, prefill?)

    def prefill_work():
        return (sum(len(e.waiting) for e in cl.engines) + len(cl.waiting),
                sum(p["done"] for e in cl.engines
                    for p in e._prefilling.values()))

    def step():
        before = prefill_work()
        spilled = long_.state == State.DECODE
        sync(dev)
        t = time.monotonic()
        live = reqs + [long_]
        had = {id(r): len(r.generated) for r in live}
        cl.step()
        sync(dev)
        wall = time.monotonic() - t
        dec = sum(len(r.generated) - had[id(r)] for r in live
                  if had[id(r)] > 0)
        steps.append((spilled, wall, dec, before != prefill_work()))

    check = SpillCheck()
    try:
        reset_launch_counts()
        t_run = time.monotonic()
        for r in reqs:
            cl.submit(r)
        while any(not r.generated for r in reqs):
            step()
        for _ in range(8):             # both instances decode
            step()
        assert sorted(set(cl.placements.values())) == [0, 1], cl.placements
        mem["before"] = mem_gb(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cl.submit(long_)
        acts = cluster_actions(cl)
        assert [a[0] for a in acts] == ["Spill"], acts
        guest = cl._engine(cl.actions[0].iid)
        while not long_.done:
            step()
            assert len(steps) < 20000
        long_done = len(steps)
        # the extended view and the saved slots live only inside a step:
        # the peak while the request ran shows them
        mem["peak_while_spilled"] = (torch.cuda.max_memory_allocated() / 1e9
                                     if dev == "cuda" else None)
        mem["after_spilled_request"] = mem_gb(dev)
        while not cl.idle:
            step()
            assert len(steps) < 20000
        wall = time.monotonic() - t_run
        launches = launch_counts()
    finally:
        check.close()
    mem["after"] = mem_gb(dev)
    assert cluster_actions(cl) == acts, "no merge for the spilled request"
    assert check.equal and all(check.equal), check.equal
    assert len(long_.generated) == long_new
    for r in reqs:
        assert r.done and len(r.generated) == new
    path = {k: launches[k] for k in ("paged_attention", "chunk_prefill",
                                     "copy_page_slices")}
    assert dev != "cuda" or all(n > 0 for n in path.values()), launches
    assert not cl.partition.spills()
    cl.partition.check_invariants()
    log = guest.spill_log

    def mean_ms(sel):
        got = [s[1] for s in sel]
        return sum(got) / len(got) * 1e3 if got else None

    dec_only = [s for s in steps[:long_done] if not s[3] and s[2] > 0]
    emit(phase=label, model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, instances=2, workers_each=1, max_seq=max_seq,
         prompts=list(lens), new_tokens=new, long_prompt=long_len,
         long_new_tokens=long_new, actions=acts, weights_init_s=t_init,
         spilled_ttft_s=long_.ttft, spilled_tpot_s=long_.tpot,
         short_ttft_s=[r.ttft for r in reqs],
         short_tpot_s=[r.tpot for r in reqs],
         decode_step_ms_with_spilled=mean_ms(
             [s for s in dec_only if s[0]]),
         decode_step_ms_without_spilled=mean_ms(
             [s for s in dec_only if not s[0]]),
         decode_steps_with_spilled=sum(1 for s in dec_only if s[0]),
         decode_steps_without_spilled=sum(1 for s in dec_only
                                          if not s[0]),
         spill_log_entries=len(log),
         spill_log_bytes_per_step=log[0]["bytes"] if log else None,
         spill_log_pages_per_step=log[0]["pages"] if log else None,
         spill_log_wall_ms_mean=(sum(x["wall_s"] for x in log) / len(log)
                                 * 1e3 if log else None),
         # every extended step assembles the view (reads the local and
         # hosted slots, writes the copy) and writes it back (reads the
         # copy, writes both slots): twice the view's bytes each
         extended_view_bytes=(check.ext_bytes[0] if check.ext_bytes
                              else None),
         assemble_bytes_moved_per_step=(2 * check.ext_bytes[0]
                                        if check.ext_bytes else None),
         write_back_bytes_moved_per_step=(2 * check.ext_bytes[0]
                                          if check.ext_bytes else None),
         write_backs_checked=len(check.equal), hosted_pages_equal=True,
         tokens_per_s=sum(len(r.generated) for r in reqs + [long_]) / wall,
         wall_s=wall, memory_allocated_gb=mem, launches=path,
         spill_pages=cl.metrics()["spill_pages"],
         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None), gpu=smi)
    del cl, guest
    if dev == "cuda":
        free_card()
    return launches


# ---------------------------------------------------------------------------
# Slice 7: partial TP degrees, replicated kv heads, partial merges
# ---------------------------------------------------------------------------

#: slice 7's engines as its phases build them: (model, workers, padding
#: plan width S, the degrees the engine runs at, slots)
SLICE7_ENGINES = (
    ("llama3-8b", 4, 4, (1, 2, 4), 4),     # ladder-serve
    ("gemma-2b", 4, 4, (1, 2, 4), 4),      # replicated-serve
    ("gemma-2b", 2, 8, (1,), 2),           # cluster-partial: an instance
    ("gemma-2b", 1, 8, (1,), 2),           # a donor that shed a worker
    ("gemma-2b", 4, 8, (4,), 2))           # the merged target

#: and their KV migrations: (model, S, (ta, workers), (tb, workers after))
SLICE7_MOVES = (
    ("llama3-8b", 4, (1, 4), (2, 4)), ("llama3-8b", 4, (2, 4), (4, 4)),
    ("llama3-8b", 4, (4, 4), (2, 4)), ("llama3-8b", 4, (2, 4), (1, 4)),
    ("gemma-2b", 4, (1, 4), (2, 4)), ("gemma-2b", 4, (2, 4), (4, 4)),
    ("gemma-2b", 4, (4, 4), (1, 4)),
    ("gemma-2b", 8, (1, 2), (1, 1)), ("gemma-2b", 8, (1, 1), (1, 2)),
    ("gemma-2b", 8, (1, 2), (4, 4)), ("gemma-2b", 8, (4, 4), (1, 2)),
    # slice 9's calibrate phase: TP1 x W <-> TPW at llama3-8b's KV (its
    # TP1 x 4 -> TP4 is SLICE8_MOVES' first)
    ("llama3-8b", 4, (1, 2), (2, 2)), ("llama3-8b", 4, (2, 2), (1, 2)),
    ("llama3-8b", 4, (4, 4), (1, 4)))


def slice7_cases():
    """(model, case function, keywords) for every kernel shape slice 7's
    engines give the kernels, from the port's own layout functions: at
    each degree t of an engine, a worker's padded FFN (``mlp_shards(t,
    S, d_ff)`` with its padded columns; T = 1 and just above the
    decode/prefill switch), its paged decode (the plan's q heads and kv
    slots over t, one row per slot its group holds), its chunk prefill
    (a prompt's first chunk and a later one) and flash prefill; then
    each KV migration of those engines at the model's kv slots and head
    dimension."""
    from repro_torch.configs import get_config
    from repro_torch.core import instance as I
    from repro_torch.core.padding import make_plan
    from repro_torch.kernels import padded_ffn as PF
    out, seen = [], set()

    def add(model, fn, kw):
        key = (fn.__name__, tuple(sorted(kw.items())))
        if key not in seen:
            seen.add(key)
            out.append((model, fn, kw))

    for name, W, S, degrees, slots in SLICE7_ENGINES:
        cfg = get_config(name)
        plan = make_plan(cfg, S, mode="page")
        dh = cfg.resolved_head_dim
        for t in degrees:
            tp, ff = I.mlp_shards(t, S, cfg.d_ff)
            ffp = (plan.d_ff_padded or cfg.d_ff) // t
            heads = dict(Hq=plan.q_heads_padded // t, kvs=plan.kv_slots // t,
                         dh=dh)
            what = f"TP{t} x{W // t} of a plan of {S}"
            for T in (1, PF.DECODE_MAX_T + 1):
                add(name, case_ffn, dict(
                    T=T, tp=tp, ff=ff, ffp=ffp, d=cfg.d_model, model=name,
                    what=what, activation=cfg.activation, iters=10))
            add(name, case_decode, dict(B=slots // (W // t), ctx=2048,
                                        cap=4096, **heads))
            add(name, case_chunk, dict(S=512, done=0, cap=4096,
                                       attend_prefix=False, **heads))
            add(name, case_chunk, heads)
            add(name, case_flash, dict(S=1024, **heads))
    for name, S, (ta, W), (tb, W2) in SLICE7_MOVES:
        cfg = get_config(name)
        add(name, case_reshard, dict(
            ta=ta, tb=tb, W=W, W2=W2, kvs=make_plan(cfg, S,
                                                    mode="page").kv_slots,
            dh=cfg.resolved_head_dim))
    return out


@contextlib.contextmanager
def captured_calls(mod, names):
    """Record ``(name, args, kwargs)`` of every call of the functions
    ``names`` of module ``mod`` inside the block (they still run)."""
    calls, orig = [], {n: getattr(mod, n) for n in names}

    def recorder(name):
        def call(*a, **kw):
            calls.append((name, a, kw))
            return orig[name](*a, **kw)
        return call

    for n in names:
        setattr(mod, n, recorder(n))
    try:
        yield calls
    finally:
        for n, f in orig.items():
            setattr(mod, n, f)


def case_reshard(dtype, ta=1, tb=2, W=4, W2=None, slots=4, cap=6144,
                 kvs=8, P=64, dh=128):
    """One layer's pools moved from layout ``ta`` on W workers to ``tb``
    on W2 (a TP degree, or an (sp, tp) pair; ``kv_transform.
    migrate_sharded``: a worker in both assemblies
    copies what it keeps pool to pool, every source gathers the rest,
    the exchange, the scatter kernel where arrivals are not runs of
    whole pages): every destination pool bit-equal to the same move on
    CPU copies (the plain versions).  Then the first call of each kind
    (gather; copy kept or arrived) that the move made on worker 0's side,
    held bit-equal to its plain version on the same inputs and timed
    against one advanced-indexing call with L2 evicted first (a move
    reads pools that decode steps have pushed out of L2; ``*_warm_l2``
    back to back); each is bound by the bytes it must read and write."""
    from repro_torch.core import kv_transform as KT
    from repro_torch.kernels import page_migrate as PM
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import InstanceMesh, Layout
    W2 = W if W2 is None else W2
    la, lb = (Layout(*t) if isinstance(t, tuple) else Layout.of(t)
              for t in (ta, tb))
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(17)
    mps = cap // P
    NP, H = slots // (W // la.degree) * (mps // la.sp), kvs // la.tp
    pools = [torch.randn((NP, H, 2, P, dh), generator=g, device=dev
                         ).to(dtype) for _ in range(W)]
    src, dst = InstanceMesh([dev] * W, la), InstanceMesh([dev] * W2, lb)
    with captured_calls(PM, ("gather_page_slices", "copy_page_slices")
                        ) as calls:
        out, moved = KT.migrate_sharded(pools, src, la, dst, lb, mps)
    cpu = [p.cpu() for p in pools]
    want, _ = KT.migrate_sharded(cpu, InstanceMesh(["cpu"] * W, la), la,
                                 InstanceMesh(["cpu"] * W2, lb), lb, mps)
    assert all(torch.equal(o.cpu(), w) for o, w in zip(out, want)), (
        "migrate_sharded", str(la), str(lb))
    case = (f"{la} x{W // la.degree} -> {lb} x{W2 // lb.degree}: {slots} "
            f"slots x {cap} tokens, kvs={kvs}, P={P}, dh={dh}")
    rows, kinds = [], set()
    for name, a, kw in calls:
        h = kw["heads_per_slice"]
        kind = ("gather" if name == "gather_page_slices" else
                "kept" if any(a[0] is p for p in pools) else "arrived")
        if kind in kinds:
            continue
        kinds.add(kind)
        if kind == "gather":
            pool, pages, blocks = a
            what = "a source's send lists"
            send = PM.gather_page_slices(pool, pages, blocks,
                                         heads_per_slice=h)
            assert torch.equal(send, ref.gather_page_slices_ref(
                pool, pages, blocks, h)), "gather"
            view = pool.view(pool.shape[0], pool.shape[1] // h, h,
                             *pool.shape[2:])
            pl, bl = pages.long(), blocks.long()
            seg, idx = nbytes(send), nbytes(pages, blocks)
            run = (lambda: PM.gather_page_slices(
                pool, pages, blocks, heads_per_slice=h))
            plain = (lambda: ref.gather_page_slices_ref(pool, pages,
                                                        blocks, h))
            lib = (lambda: view[pl, bl])
        else:
            s_, d_, sp, sb, dp, db = a
            what = ("a worker's kept slice, pool to pool" if kind == "kept"
                    else "a destination's arrivals")
            d0 = torch.zeros_like(d_)
            PM.copy_page_slices(s_, d0, sp, sb, dp, db, heads_per_slice=h)
            assert torch.equal(d0, ref.copy_page_slices_ref(
                s_, torch.zeros_like(d_), sp, sb, dp, db, h)), "copy"
            sview = s_.view(s_.shape[0], s_.shape[1] // h, h, *s_.shape[2:])
            dview = d0.view(d0.shape[0], d0.shape[1] // h, h, *d0.shape[2:])
            spl, sbl, dpl, dbl = (t.long() for t in (sp, sb, dp, db))
            seg, idx = sp.numel() * nbytes(s_[:1, :h]), nbytes(sp, sb, dp, db)
            run = (lambda: PM.copy_page_slices(
                s_, d0, sp, sb, dp, db, heads_per_slice=h))
            plain = (lambda: ref.copy_page_slices_ref(
                s_, d0, sp, sb, dp, db, h))
            lib = (lambda: dview.index_put_((dpl, dbl), sview[spl, sbl]))
        rows.append(dict(
            kernel=name, case=f"{case}: {what} (h={h})",
            max_abs_err=0.0, bit_equal=True, bytes_moved_by_move=moved,
            ms=time_ms_cold(run, 50), ms_warm_l2=time_ms(run, 50),
            plain_ms=time_ms(plain, 20), library_ms=time_ms_cold(lib, 20),
            library_ms_warm_l2=time_ms(lib, 20),
            timing="L2 evicted before every call (a 64 MiB buffer read)",
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(2 * seg + idx, 0, dtype)))))
    return rows


def _landed_equal(eng, before, tp) -> int:
    """Every worker's cache after a landing equals the layout an engine
    at TP``tp`` holds for the pre-transform bytes (``split_cache`` of
    the global cache, resized to the landed pool); returns the bytes
    compared."""
    from repro_torch.core import instance as I
    from repro_torch.core import kv_transform as KT
    n = 0
    mps = I.pages_per_slot(eng.layers[0])
    devs = [w.device for w in eng.devices]
    for layer, glob in zip(eng.layers, before):
        want = I.split_cache(KT.resize_slot_capacity(glob, mps,
                                                     eng.max_batch),
                             tp, devs)
        for got, exp in zip(layer.cache, want):
            for f in ("pool", "page_table", "seq_lens", "positions"):
                a, b = getattr(got, f), getattr(exp, f)
                assert torch.equal(a, b), ("landed cache", tp, f)
                n += a.numel() * a.element_size()
    return n


def phase_ladder_parity(dev: str = "cuda", cycle=(2, 4, 1, 2)):
    """Reduced llama3-8b, fp32, 4 workers: the reference test's degree
    cycle mid-decode on workers of the card equals the same run on CPU
    workers and an engine started at each degree; after each landing of
    the cycle with no decode between steps, every worker's pool is
    bit-equal to the layout an engine at that degree holds."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    t0 = time.monotonic()
    kw = dict(max_batch=4, max_seq=64, page_tokens=16)
    prompts = _prompts(torch.Generator().manual_seed(29), (6, 9, 5, 7),
                       cfg.vocab_size)
    model = M.build(cfg, make_plan(cfg, 4, mode="page"), seed=7,
                    device="cpu")

    def engine(where):
        return Engine(cfg, params=copy.deepcopy(model).to(where),
                      devices=[where] * 4, **kw)

    def run(where, before, plan, start=None):
        eng = engine(where)
        if start is not None:
            eng.transform(start)
            while eng.transforming:
                eng.step()
        reqs = [ServeRequest(p, max_new_tokens=8) for p in prompts]
        allocs = []
        for r in reqs:
            eng.submit(r)
        for _ in range(before):
            eng.step()
        for tp in plan:
            eng.transform(tp)
            while eng.transforming:
                eng.step()
                eng.check_capacity_invariant()
            allocs.append(eng.max_seq_alloc == eng.seq_quantum * tp)
        eng.run_until_done()
        return [r.generated for r in reqs], allocs

    card, allocs = run(dev, 2, cycle)
    host, _ = run("cpu", 2, cycle)
    assert card == host, (card, host)
    assert all(allocs), allocs
    started = {t: run(dev, 0, (), start=t)[0] for t in (1, 2, 4)}
    assert all(s == card for s in started.values()), started
    eng = engine(dev)
    for p in prompts:
        eng.submit(ServeRequest(p, max_new_tokens=8))
    for _ in range(5):
        eng.step()
    compared = 0
    for tp in cycle:
        before = eng.global_caches()
        eng.transform(tp)
        while not eng._session.done:
            eng._session.step()
        eng._finish_transform()
        compared += _landed_equal(eng, before, tp)
    del eng
    if dev == "cuda":
        free_card()
    emit(phase="ladder-parity", model=cfg.name, dtype=cfg.dtype, workers=4,
         cycle=list(cycle), prompts=[len(p) for p in prompts],
         streams_equal_cpu_workers=True,
         streams_equal_engines_started_at=[1, 2, 4],
         alloc_is_quantum_times_tp=True, landed_bytes_compared=compared,
         seconds=time.monotonic() - t0)


def _stepper(eng, steps, sync_dev):
    """One engine step, recorded as (where, wall s, decode tokens,
    prefill work this step?, active decoders before) for step summaries
    and stall counts."""
    def progress():
        return (len(eng.waiting),
                sum(p["done"] for p in eng._prefilling.values()))

    def step():
        decoding = sum(1 for r in eng.slots
                       if r is not None and r.state.name == "DECODE")
        before = progress()
        sync(sync_dev)
        t = time.monotonic()
        where = (f"{eng.par_layout}x{eng.W // eng.tp}"
                 if not eng.transforming
                 else f"{eng.par_layout}->{eng._session.target_layout}")
        out = eng.step()
        sync(sync_dev)
        prefill = (out["emitted"] > out["decode_emitted"]
                   or before != progress())
        steps.append((where, time.monotonic() - t, out["decode_emitted"],
                      prefill, decoding))
    return step


def _stalls(steps) -> int:
    """Session steps with decoders active and no decode token."""
    return sum(1 for w, _, n, _, dec in steps if "->" in w and dec and not n)


def ladder_sessions(eng, reports_from: int = 0) -> list:
    """Each session of ``eng.transform_log``: wall, steps, exposed
    against modeled seconds, the bytes its kernels and exchange moved,
    the weight bytes that crossed, and the least a KV migration must
    move (the (k-1)/k foreign head slices of every page, k = max/min
    degree, read once and written once) over the card's memory rate."""
    out, reps = [], eng.transform_reports[reports_from:]
    for log in eng.transform_log:
        mine, reps = reps[:log["steps"]], reps[log["steps"]:]
        k = max(log["tp_from"], log["tp_to"]) // min(log["tp_from"],
                                                     log["tp_to"])
        pool = sum(r.kv_pool_bytes for r in mine)
        bound = 2 * pool * (k - 1) // k
        out.append({
            "from": log["layout_from"], "to": log["layout_to"],
            "tp_from": log["tp_from"], "tp_to": log["tp_to"],
            "cross": log["cross"], "steps": log["steps"],
            "wall_s": log["wall_s"], "measured_s": log["measured_s"],
            "exposed_s": log["exposed_s"], "modeled_s": log["modeled_s"],
            "kv_bytes": log["kv_bytes"], "weight_bytes": log["weight_bytes"],
            "kv_pool_bytes": pool, "kv_bytes_bound": bound,
            "kv_bound_ms": bound / HBM_BPS * 1e3})
    return out


#: the depth of ladder-serve's and layout-serve's llama3-8b and of
#: replicated-serve's gemma-2b: a quarter of llama3-8b's 32 layers and 5
#: of gemma-2b's 18, to keep the whole script inside its time limit
#: (half of each until the train phases came); their layers are alike,
#: so each kernel shape is the same
LLAMA_LAYERS = 8
REPLICATED_LAYERS = 5


def phase_ladder_serve(smi: str, dev: str = "cuda", cfg=None,
                       quantum: int = 1536, lens=(300, 600, 900, 1200),
                       new: int = 128, long_len: int = 6000,
                       long_new: int = 32, page_tokens: int = 64):
    """llama3-8b at full width and ``LLAMA_LAYERS`` of its 32 layers,
    bf16, 4 workers of the card (four replicas): TP1x4 -> TP2x2 -> TP4
    mid-decode, a
    6000-token request only TP4 holds, then TP4 -> TP2x2 -> TP1x4
    mid-decode of a second batch.  Returns the six kernels' launches on
    this path."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, ServeRequest

    cfg = cfg or dataclasses.replace(get_config("llama3-8b"),
                                     num_layers=LLAMA_LAYERS)
    t0 = time.monotonic()
    eng = Engine(cfg, devices=[dev] * 4, seed=0, max_batch=4,
                 max_seq=4 * quantum, page_tokens=page_tokens)
    sync(dev)
    t_init = time.monotonic() - t0
    gen = torch.Generator().manual_seed(31)
    warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                        max_new_tokens=2)
    eng.submit(warm)
    eng.run_until_done()
    reset_launch_counts()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = []
    step = _stepper(eng, steps, dev)
    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    long_prompt = _prompts(gen, (long_len,), cfg.vocab_size)[0]
    t_run = time.monotonic()
    for r in reqs:
        eng.submit(r)
    while any(not r.generated for r in reqs):
        step()
    for tp in (2, 4):
        eng.transform(tp)
        while eng.transforming:
            step()
        assert eng.tp == tp and eng.max_seq_alloc == quantum * tp
    mem_tp4 = mem_gb(dev)
    long_ = ServeRequest(long_prompt, max_new_tokens=long_new)
    assert eng.max_seq_at(2) < long_.total_tokens <= eng.max_seq_at(4)
    eng.submit(long_)
    while not long_.done:
        step()
    # a second batch decodes through the way down
    back = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    for r in back:
        eng.submit(r)
    while any(not r.generated for r in back):
        step()
    for tp in (2, 1):
        eng.transform(tp)
        while eng.transforming:
            step()
    while any(not r.done for r in reqs + back):
        step()
    wall = time.monotonic() - t_run
    launches = launch_counts()
    assert eng.tp == 1 and eng.max_seq_alloc == quantum
    for r in reqs + back + [long_]:
        assert r.done and all(0 <= t < cfg.vocab_size for t in r.generated)
    assert len(long_.generated) == long_new
    if dev == "cuda":
        assert all(launches[k] > 0 for k in launches), launches
    sessions = ladder_sessions(eng)
    stalls = _stalls(steps)
    assert stalls == 0, stalls
    emit(phase="ladder-serve", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, workers=4, quantum=quantum, prompts=list(lens),
         long_prompt=long_len, weights_init_s=t_init, wall_s=wall,
         sessions=sessions, stall_steps=stalls,
         steps_by_layout=step_summary([s[:4] for s in steps]),
         long_ttft_s=long_.ttft, long_tpot_s=long_.tpot,
         ttft_s=[r.ttft for r in reqs + back],
         tpot_s=[r.tpot for r in reqs + back],
         mem_gb_at_tp4=mem_tp4, launches=launches,
         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None), gpu=smi)
    del eng
    if dev == "cuda":
        free_card()
    return launches


def phase_replicated_serve(smi: str, dev: str = "cuda", cfg=None,
                           quantum: int = 512, lens=(100, 250, 400, 180),
                           new: int = 128, before: int = 4):
    """gemma-2b at full width and ``REPLICATED_LAYERS`` of its 18 layers
    (one kv head copied into four kv slots, dh 256, geglu), fp32, 4
    workers of the card: TP1x4 -> TP2x2
    -> TP4 -> TP1x4 mid-decode gives the streams of a TP1x4 engine that
    never transformed (fp32: the stream check is exact).  Returns the
    kernels' launches on the transforming run."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, ServeRequest

    cfg = cfg or dataclasses.replace(get_config("gemma-2b"),
                                     dtype="float32",
                                     num_layers=REPLICATED_LAYERS)
    t0 = time.monotonic()
    prompts = _prompts(torch.Generator().manual_seed(37), lens,
                       cfg.vocab_size)

    def run(plan):
        eng = Engine(cfg, devices=[dev] * 4, seed=0, max_batch=4,
                     max_seq=4 * quantum, page_tokens=64)
        assert eng.plan.kv_replication == 4
        reqs = [ServeRequest(p, max_new_tokens=new) for p in prompts]
        reset_launch_counts()
        steps = []
        step = _stepper(eng, steps, dev)
        for r in reqs:
            eng.submit(r)
        for _ in range(before):
            step()
        for tp in plan:
            eng.transform(tp)
            while eng.transforming:
                step()
            assert eng.tp == tp
        while any(not r.done for r in reqs):
            step()
        out = ([r.generated for r in reqs], launch_counts(),
               ladder_sessions(eng), _stalls(steps), mem_gb(dev))
        del eng
        if dev == "cuda":
            free_card()
        return out

    plain, _, _, _, _ = run(())
    got, launches, sessions, stalls, mem = run((2, 4, 1))
    assert got == plain, "replicated kv heads: streams differ"
    assert stalls == 0, stalls
    emit(phase="replicated-serve", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, workers=4, kv_replication=4, cycle=[2, 4, 1],
         prompts=list(lens), new_tokens=new,
         streams_equal_untransformed=True, stall_steps=stalls,
         sessions=sessions, launches=launches, mem_gb_after=mem,
         seconds=time.monotonic() - t0, gpu=smi)
    return launches


def phase_cluster_partial(smi: str, dev: str = "cuda", cfg=None,
                          quantum: int = 2048, lens=(300, 600, 900, 1200),
                          new: int = 64, long_len: int = 6000,
                          long_new: int = 32, page_tokens: int = 64,
                          budget: int = 2048):
    """gemma-2b at full width and depth, bf16, 4 instances x 2 workers
    of the card (kv head copied into 8 kv slots) under
    ``SchedulerConfig(partial_merge=True, target_tp=4)``: one short
    request on every instance, then a request only TP4 holds.  One
    ``ScaleUp`` with ``donor_devices``: the donors shed a worker in
    place and keep serving, the target widens to TP4; the split returns
    the loans and the donors widen back.  Returns the six kernels'
    launches on this path."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import (GygesScheduler, PrefillPolicy,
                                            ScaleUp, SchedulerConfig)
    from repro_torch.serving import ServeRequest
    from repro_torch.serving.cluster import ClusterEngine

    cfg = cfg or get_config("gemma-2b")
    t0 = time.monotonic()
    sched = GygesScheduler(SchedulerConfig(
        long_threshold=quantum, target_tp=4, partial_merge=True))
    cl = ClusterEngine(cfg, [dev] * 8, n_instances=4, max_batch=2,
                       max_seq=2 * quantum, page_tokens=page_tokens,
                       scheduler=sched, dwell_steps=4, seed=0,
                       prefill_policy=PrefillPolicy(token_budget=budget,
                                                    mode="mixed"))
    assert cl.plan.kv_replication == 8
    sync(dev)
    t_init = time.monotonic() - t0
    gen = torch.Generator().manual_seed(41)
    for e in cl.engines:
        warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                            max_new_tokens=2)
        e.submit(warm)
        e.run_until_done()
    reset_launch_counts()
    mem = {"before": mem_gb(dev)}
    shorts = [ServeRequest(p, max_new_tokens=new)
              for p in _prompts(gen, lens, cfg.vocab_size)]
    long_ = ServeRequest(_prompts(gen, (long_len,), cfg.vocab_size)[0],
                         max_new_tokens=long_new)
    t_run = time.monotonic()
    for r in shorts:
        cl.submit(r)
    assert sorted(cl.placements[r.rid] for r in shorts) == [0, 1, 2, 3]
    while any(not r.generated for r in shorts):
        cl.step()
    cl.submit(long_)
    partial = [a for a in cl.actions
               if isinstance(a, ScaleUp) and a.donor_devices]
    assert len(partial) == 1 and partial[0].tp_to == 4, cl.actions
    act = partial[0]
    donors = [cl._engine(i) for i in act.donor_iids]
    shed = [(d.iid, d.W, d.tp, d.parked) for d in donors]
    assert all(W == 1 and not parked for _, W, _, parked in shed), shed
    move_bytes = sum(m["kv_bytes"] for d in donors for m in d.move_log)
    target = cl._engine(act.iid)
    for _ in range(20000):
        if long_.done and cl.idle and all(e.W == 2 for e in cl.engines):
            break
        cl.step()
        if target.tp == 4 and "during" not in mem:
            mem["during"] = mem_gb(dev)
    else:
        raise RuntimeError("cluster-partial did not drain and split")
    wall = time.monotonic() - t_run
    mem["after"] = mem_gb(dev)
    launches = launch_counts()
    assert cl.stall_steps == 0, cl.stall_steps
    assert not cl.partition._loans
    cl.partition.check_invariants()
    assert all(not e.parked and e.W == 2 and e.tp == 1
               for e in cl.engines)
    assert cl.metrics()["partial_merges"] == 1
    for r in shorts + [long_]:
        assert r.done and all(0 <= t < cfg.vocab_size for t in r.generated)
    if dev == "cuda":
        assert all(launches[k] > 0 for k in launches), launches
    moves = [m for d in donors for m in d.move_log]
    emit(phase="cluster-partial", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, workers=8, instances=4, kv_replication=8,
         quantum=quantum, prompts=list(lens), long_prompt=long_len,
         weights_init_s=t_init, wall_s=wall, actions=cluster_actions(cl),
         donor_devices=list(act.donor_devices), donors_after_shed=shed,
         partial_merges=cl.metrics()["partial_merges"],
         donor_moves=[{k: m[k] for k in ("layout_from", "layout_to",
                                         "wall_s", "kv_bytes", "bytes")}
                      for m in moves],
         donor_move_kv_bytes=move_bytes,
         target_sessions=ladder_sessions(target),
         stall_steps=cl.stall_steps, long_ttft_s=long_.ttft,
         long_tpot_s=long_.tpot, ttft_s=[r.ttft for r in shorts],
         mem_gb=mem, launches=launches, gpu=smi)
    del cl, target, donors
    if dev == "cuda":
        free_card()
    return launches


# ---------------------------------------------------------------------------
# Slice 8: sequence-parallel layouts, kernels 1 and 2 as softmax partials
# ---------------------------------------------------------------------------

#: a shard's partial state against its plain walk, on the (row, head)
#: pairs that see a key: m (scores are O(1-10)) within 1e-3, l within
#: 1e-3 of itself (both are fp32 sums of the same exponentials in other
#: orders; the bf16 kernels take exp2 on the score's fp32 value), and
#: acc / l within the dtype's TOL (plus the bf16 prefill tile's row
#: term); rows with no visible key differ by design (the kernels give
#: (NEG_INF, 0, 0), the plain walks the reference's finite arithmetic),
#: and the combine weighs them as nothing
PART_M_TOL, PART_L_TOL = 1e-3, 1e-3


def hold_partials(what, buf, g, want, dtype, row_tol=0.0) -> dict:
    """The kernel's partial state ``buf`` (``g``: its rows, kvs, splits,
    rep, dh; the splits merged in fp32 here) against the plain walk's
    ``want`` = (m, l, acc) of shape (rows, kvs, rep[, dh]) up to a
    reshape; returns the max errors of m, l (relative) and acc / l."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers as Lyr
    m, l, acc = ref.unpack_partials(buf, g["rows"], g["kvs"], g["splits"],
                                    g["rep"], g["dh"])
    m, l, acc = Lyr.combine_softmax_partials(
        m.transpose(2, 3), l.transpose(2, 3), acc.transpose(2, 3), axis=3)
    shape = (g["rows"], g["kvs"], g["rep"])
    wm, wl = want[0].reshape(shape), want[1].reshape(shape)
    wacc = want[2].reshape(*shape, g["dh"])
    live = wm > Lyr.NEG_INF / 2
    if not live.any():          # a shard that sees no key of these rows
        return {"m": 0.0, "l_rel": 0.0, "acc_over_l": 0.0, "live": 0}
    em = (m - wm).abs()[live].max().item()
    el = ((l - wl).abs() / wl)[live].max().item()
    assert em <= PART_M_TOL and el <= PART_L_TOL, (what, str(dtype),
                                                   "m", em, "l", el)
    eo = max_err(what + " acc/l", acc / l[..., None],
                 wacc / wl[..., None], dtype, rows=live, row_tol=row_tol)
    return {"m": em, "l_rel": el, "acc_over_l": eo,
            "live": int(live.sum())}


def _shard_cache(pool, kvpos, n, sp, s, P):
    """Shard s of sp of identity-paged rows of ``n`` pages: its pages (a
    compact pool), identity page table and global positions."""
    B = kvpos.shape[0]
    ns = n // sp
    part = pool.view(B, n, *pool.shape[1:])[:, s * ns:(s + 1) * ns]
    pt = (torch.arange(B, device=pool.device)[:, None] * ns
          + torch.arange(ns, device=pool.device)[None]).to(torch.int32)
    return (part.reshape(B * ns, *pool.shape[1:]).clone(), pt,
            kvpos[:, s * ns * P:(s + 1) * ns * P].contiguous())


def case_decode_sp(dtype, q_pos=(6050, 420, 730, 1050), cap=6144, sp=2,
                   Hq=16, kvs=4, dh=128, P=64, what=""):
    """An sp group's decode: each of ``sp`` shards holds its slice of
    every row's pages (identity-paged, global positions) and runs the
    partial entry into its row of the group's buffer; each shard's
    partials against its plain walk, the combine of the gathered buffer
    against the plain decode of the whole rows.  Times: all shards'
    partial calls (L2 evicted before each group), the combine, and SDPA
    over each shard's keys (the library yardstick); bound: the visible
    K/V bytes, the queries and the partial states written."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(43)
    B, n, rep = len(q_pos), cap // P, Hq // kvs
    pool = torch.randn((B * n, kvs, 2, P, dh), generator=g, device=dev
                       ).to(dtype)
    qpos = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    kvpos = stored_positions(qpos, cap)
    q = torch.randn((B, Hq, dh), generator=g, device=dev).to(dtype)
    shards = [_shard_cache(pool, kvpos, n, sp, s, P) for s in range(sp)]
    splits = PA.partial_splits(B, kvs, n // sp, q.device)
    geo = dict(rows=B, kvs=kvs, splits=splits, rep=rep, dh=dh)
    buf = torch.empty((sp, ref.partials_numel(**geo)), device=dev)

    def group():
        for s, (sp_pool, pt, kp) in enumerate(shards):
            PA.paged_decode_partials(q, sp_pool, pt, kp, qpos, buf[s],
                                     shard=(s, sp))

    group()
    errs = [hold_partials(f"decode partials shard {s}", buf[s], geo,
                          ref.paged_decode_partials_ref(q, sp_pool, pt, kp,
                                                        qpos), dtype)
            for s, (sp_pool, pt, kp) in enumerate(shards)]
    out = PA.softmax_combine(buf, B, kvs, splits, rep, dh, dtype)
    gpt = (torch.arange(B, device=dev)[:, None] * n
           + torch.arange(n, device=dev)[None]).to(torch.int32)
    err = max_err("combined decode", out, PA.plain(q, pool, gpt, kvpos,
                                                   qpos), dtype)
    plain_buf = torch.empty((sp, ref.partials_numel(B, kvs, 1, rep, dh)),
                            device=dev)

    def plain():
        for s, (sp_pool, pt, kp) in enumerate(shards):
            ref.pack_partials(*ref.paged_decode_partials_ref(
                q, sp_pool, pt, kp, qpos), plain_buf[s])

    libs = []
    for sp_pool, pt, kp in shards:
        pages = sp_pool[pt.long()]
        kd, vd = (pages[:, :, :, i].permute(0, 2, 1, 3, 4).reshape(
            B, kvs, -1, dh).repeat_interleave(rep, dim=1).contiguous()
            for i in (0, 1))
        mask = ((kp >= 0) & (kp <= qpos[:, None]))[:, None, None, :]
        libs.append((kd, vd, mask))
    q4 = q[:, :, None, :].contiguous()

    def lib():
        for kd, vd, mask in libs:
            torch.nn.functional.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask)

    pairs = visible_pairs(qpos[:, None], kvpos, 0)
    byt = (pairs * kvs * 2 * dh * pool.element_size()
           + sp * nbytes(q, qpos, shards[0][1]) + nbytes(kvpos, buf))
    bms, by = bound_ms(byt, 4 * pairs * Hq * dh, dtype)
    # the combine reads the gathered buffer once and writes the output
    cbms, cby = bound_ms(nbytes(buf, out), 0, dtype)
    case = (f"{what}q_pos={list(q_pos)} cap={cap} P={P} over {sp} shards"
            + heads_text(Hq, kvs, dh))
    return [dict(kernel="paged_decode_partials", case=case,
                 max_abs_err=max(e["acc_over_l"] for e in errs),
                 partial_errors=errs, splits=splits,
                 ms=time_ms_cold(group, 30), ms_warm_l2=time_ms(group, 30),
                 plain_ms=time_ms(plain, 3), library_ms=time_ms_cold(lib, 20),
                 timing="every shard's call; L2 evicted before each group",
                 bound_ms=bms, bound_by=by),
            dict(kernel="softmax_combine", case=case + f", {splits} splits "
                 "a shard", max_abs_err=err,
                 ms=time_ms(lambda: PA.softmax_combine(
                     buf, B, kvs, splits, rep, dh, dtype), 50),
                 plain_ms=time_ms(lambda: ref.softmax_combine_ref(
                     buf, B, kvs, splits, rep, dh, dtype), 5),
                 library_ms=None, bound_ms=cbms, bound_by=cby)]


def case_chunk_sp(dtype, S=512, done=3584, cap=4096, sp=2, Hq=32, kvs=8,
                  dh=128, P=64, what=""):
    """A chunk of S tokens at position ``done`` on an sp group: each
    shard holds its slice of the slot's pages; a later chunk runs the
    partial entry a shard (shard 0 also over the chunk's own keys) and
    the combine, held shard by shard against the plain walks and, merged,
    against the plain one-shard chunk attention; a first chunk (``done
    = 0``) runs the whole attention on every shard.  Each shard's pool
    bytes equal the plain scatter's and the one-shard ``write_chunk``'s
    slice.  Times: all shards' calls, SDPA over each shard's keys; bound:
    the operations on this run's visible pairs."""
    from repro_torch.kernels import chunk_prefill as CP
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    from repro_torch.paged import pool as pp
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(47)
    n, rep = cap // P, Hq // kvs
    pool0 = torch.randn((n, kvs, 2, P, dh), generator=g, device=dev
                        ).to(dtype)
    kvpos = torch.full((1, cap), -1, dtype=torch.int32, device=dev)
    kvpos[0, :done] = torch.arange(done, dtype=torch.int32, device=dev)
    qpos = torch.arange(done, done + S, dtype=torch.int32, device=dev)[None]
    q = torch.randn((1, S, Hq, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((1, S, kvs, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((1, S, kvs, dh), generator=g, device=dev).to(dtype)
    first = done == 0
    row_tol = CP.BF16_ROW_TOL if dtype == torch.bfloat16 else 0.0
    shards = [_shard_cache(pool0, kvpos, n, sp, s, P) for s in range(sp)]
    gpt = torch.arange(n, dtype=torch.int32, device=dev)[None]
    one = pp.PagedState(pool0.clone(), gpt, torch.zeros(
        1, dtype=torch.int32, device=dev), kvpos.clone())
    want = CP.plain(q, k, v, one.pool, gpt, kvpos, qpos,
                    attend_prefix=not first)
    geo = dict(rows=S, kvs=kvs, splits=1, rep=rep, dh=dh)
    buf = torch.empty((sp, ref.partials_numel(**geo)), device=dev)
    pools = [c[0].clone() for c in shards]

    def group(pl):
        outs = []
        for s, (_, pt, kp) in enumerate(shards):
            if first:
                outs.append(CP.chunk_prefill_attention(
                    q, k, v, pl[s], pt, kp, qpos, attend_prefix=False,
                    shard=(s, sp)))
            else:
                CP.chunk_prefill_partials(q, k, v, pl[s], pt, kp, qpos,
                                          buf[s], attend_self=s == 0,
                                          shard=(s, sp))
        return outs

    outs = group(pools)
    errs = []
    for s, (p0, pt, kp) in enumerate(shards):
        plain_pool = p0.clone()
        if first:
            errs.append({"out": max_err(f"first chunk shard {s}", outs[s],
                                        want, dtype, row_tol=row_tol)})
            CP.plain(q, k, v, plain_pool, pt, kp, qpos, attend_prefix=False,
                     shard=(s, sp))
        else:
            errs.append(hold_partials(
                f"chunk partials shard {s}", buf[s], geo,
                ref.chunk_prefill_partials_ref(
                    q, k, v, plain_pool, pt, kp, qpos, attend_self=s == 0,
                    shard=(s, sp)), dtype, row_tol=row_tol))
        assert torch.equal(pools[s], plain_pool), ("chunk pool", s)
        assert torch.equal(pools[s], _shard_cache(one.pool, kvpos, n, sp, s,
                                                  P)[0]), ("write_chunk", s)
    rows = []
    if not first:
        out = PA.softmax_combine(buf, S, kvs, 1, rep, dh, dtype)
        err = max_err("combined chunk", out.view(1, S, Hq, dh), want,
                      dtype, row_tol=row_tol)
        cbms, cby = bound_ms(nbytes(buf, out), 0, dtype)
    libs, pairs, byt = [], 0, 0
    for s, (p0, pt, kp) in enumerate(shards):
        self_ = first or s == 0
        kk = p0[:, :, 0].permute(0, 2, 1, 3).reshape(1, -1, kvs, dh)
        vv = p0[:, :, 1].permute(0, 2, 1, 3).reshape(1, -1, kvs, dh)
        kpos = kp
        if first:
            kk, vv, kpos = k, v, qpos
        elif self_:
            kk, vv = torch.cat([kk, k], 1), torch.cat([vv, v], 1)
            kpos = torch.cat([kp, qpos], 1)
        mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
        libs.append((expand_kv(kk, rep), expand_kv(vv, rep), mask[:, None]))
        pairs += visible_pairs(qpos, kpos, 0)
        live = 0 if first else int((kp >= 0).sum())
        byt += ((live + (S if self_ else 0)) * kvs * 2 * dh
                * pool0.element_size())
    qd = q.transpose(1, 2)

    def lib():
        for kd, vd, mask in libs:
            torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask)

    byt += sp * nbytes(q) + (nbytes(buf) if not first else sp * nbytes(q))
    bms, by = bound_ms(byt, 4 * pairs * Hq * dh, dtype)
    case = (f"{what}S={S} prefix={done} cap={cap} P={P} over {sp} shards"
            + (", first chunk" if first else "") + heads_text(Hq, kvs, dh))
    plain_pools = [c[0].clone() for c in shards]

    def plain():
        for s, (_, pt, kp) in enumerate(shards):
            if first:
                CP.plain(q, k, v, plain_pools[s], pt, kp, qpos,
                         attend_prefix=False, shard=(s, sp))
            else:
                ref.chunk_prefill_partials_ref(
                    q, k, v, plain_pools[s], pt, kp, qpos,
                    attend_self=s == 0, shard=(s, sp))

    rows.append(dict(
        kernel="chunk_prefill" if first else "chunk_prefill_partials",
        case=case, pool_equal=True, partial_errors=errs,
        max_abs_err=max(max(v for k, v in e.items() if k != "live")
                        for e in errs),
        tol=tol_text(dtype) + (f" + {row_tol:g}*rms(row)" if row_tol
                               else ""),
        ms=time_ms(lambda: group(pools), 20), plain_ms=time_ms(plain, 2),
        library_ms=time_ms(lib, 20), timing="every shard's call",
        bound_ms=bms, bound_by=by))
    if not first:
        rows.append(dict(
            kernel="softmax_combine", case=case, max_abs_err=err,
            tol=rows[0]["tol"],
            ms=time_ms(lambda: PA.softmax_combine(buf, S, kvs, 1, rep, dh,
                                                  dtype), 50),
            plain_ms=time_ms(lambda: ref.softmax_combine_ref(
                buf, S, kvs, 1, rep, dh, dtype), 5),
            library_ms=None, bound_ms=cbms, bound_by=cby))
    return rows


#: slice 8's engines: (model, workers, plan width, layouts (sp, tp),
#: slots, slot tokens): cluster-layout's merged engine on 2 workers (its
#: launches are the kernels line's: its bf16 rows come first), then
#: layout-serve's llama3-8b on 4.  Their padded FFN and flash shapes are
#: those of pure-TP layouts of the same tp (slice 7's cases and the
#: cluster cases hold them).
SLICE8_ENGINES = (("llama3-8b", 2, 2, ((2, 1),), 4, 8192),
                  ("llama3-8b", 4, 4, ((2, 2),), 4, 6144))
#: and their KV migrations: (model, workers, layout from, layout to, slot
#: tokens), a layout an (sp, tp) pair
SLICE8_MOVES = (("llama3-8b", 4, (1, 1), (1, 4), 6144),   # TP1x4 -> TP4
                ("llama3-8b", 4, (1, 4), (2, 2), 6144),
                ("llama3-8b", 4, (2, 2), (1, 4), 6144),
                ("llama3-8b", 2, (1, 2), (2, 1), 8192),
                ("llama3-8b", 2, (2, 1), (1, 2), 8192))
#: the prompt cluster-layout prefills in chunks at SP2xTP1 (its
#: ``long2_len``), and the page size of its engines
SP_CHUNKED_PROMPT, SP_PAGE_TOKENS = 4500, 64


def slice8_cases():
    """(model, case function, keywords): the partial entries and the
    combine at the shard shapes slice 8's engines give them, each in the
    engine's own slots: decode at the engine's rows, the chunks the
    default prefill policy cuts ``SP_CHUNKED_PROMPT`` into (a first chunk
    written over the shards, then the rest at their positions), a later
    chunk of 512 over 3584 and one straddling the shards' boundary; then
    their layout changes' KV migrations (pages moving between sp
    shards)."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.core.scheduler import PrefillPolicy
    out = []
    sizes = PrefillPolicy().chunk_sizes(SP_CHUNKED_PROMPT, SP_PAGE_TOKENS)
    for name, W, S, layouts, slots, cap in SLICE8_ENGINES:
        cfg = get_config(name)
        plan = make_plan(cfg, S, mode="page")
        for sp, tp in layouts:
            kw = dict(cap=cap, sp=sp, Hq=plan.q_heads_padded // tp,
                      kvs=plan.kv_slots // tp, dh=cfg.resolved_head_dim,
                      what=f"SP{sp}xTP{tp} x{W // (sp * tp)} of {W}: ")
            out.append((name, case_decode_sp, dict(
                q_pos=(cap - 94, 420, 730, 1050)[:slots], **kw)))
            for i in range(1, len(sizes)):
                out.append((name, case_chunk_sp, dict(
                    S=sizes[i], done=sum(sizes[:i]), **kw)))
            straddling = dict(kw, what=kw["what"] + "straddling ")
            out += [(name, case_chunk_sp, dict(S=512, done=3584, **kw)),
                    (name, case_chunk_sp, dict(
                        S=512, done=cap // sp - 256, **straddling)),
                    (name, case_chunk_sp, dict(S=sizes[0], done=0, **kw))]
    for name, W, la, lb, cap in SLICE8_MOVES:
        cfg = get_config(name)
        out.append((name, case_reshard, dict(
            ta=la, tb=lb, W=W, cap=cap,
            kvs=make_plan(cfg, W, mode="page").kv_slots,
            dh=cfg.resolved_head_dim)))
    return out


#: the layout-parity engines: (start stages, live (stage, steps before
#: it) pairs, page tokens, prefill token budget); a stage is (degree,
#: (sp, tp) or None for pure TP)
LAYOUT_PLANS = {
    "tp4": ([(4, None)], [], 16, None),
    "sp2tp2": ([(4, (2, 2))], [], 16, None),
    "sp4tp1": ([(4, (4, 1))], [], 16, None),
    "round_trip": ([(4, None)], [((4, (2, 2)), 4), ((4, (1, 4)), 3)], 16,
                   None),
    "tp2x2_cycle": ([(2, None)], [((4, (2, 2)), 4), ((2, None), 3)], 16,
                    None),
    # 8-token pages, a 24-token budget: the second chunk of the 40-token
    # prompt straddles the shards' boundary at 32
    "sp_chunks": ([(4, (2, 2))], [], 8, 24),
}


#: a decode row may pick another greedy token than the run it is held
#: against only where that run's token lies within this of the row's top
#: logit: a tie that fp32 sums in another order break either way.  Ten
#: times the largest gap read at such a parting on the card (8.3e-7,
#: PERF.md)
TIE_GAP = 1e-5


def _forced_run(eng, reqs, drive, want=None):
    """Run ``drive()`` (which steps ``eng``), recording for every decode
    token of ``reqs`` (``rid`` = index) the top-2 logit gap of the row
    that chose it.  With ``want`` (the streams of the run held as the
    reference, by rid), every decode row is held against it: where the
    row's greedy token differs, the reference's token must lie within
    ``TIE_GAP`` of the row's top logit, and the row takes it (teacher
    forcing), so the whole stream goes on being compared on the
    reference's tokens.  Returns ({rid: {token index: gap}}, partings
    [rid, token index, the row's deficit])."""
    from repro_torch.serving import State
    orig = eng._decode
    gaps = {r.rid: {} for r in reqs}
    parts = []

    def decode(tokens, positions):
        logits = orig(tokens, positions)
        for r in reqs:
            if r.state != State.DECODE or eng.slots[r.slot] is not r:
                continue
            i = len(r.generated)
            row = logits[r.slot].float()
            top = row.topk(2).values
            gaps[r.rid][i] = float(top[0] - top[1])
            if want is None or i >= len(want[r.rid]):
                continue
            tok = want[r.rid][i]
            if int(row.argmax()) != tok:
                deficit = float(top[0] - row[tok])
                assert deficit < TIE_GAP, (
                    "a decode token parts from the reference's at no tie",
                    r.rid, i, deficit)
                parts.append([r.rid, i, deficit])
                logits = logits.clone()
                logits[r.slot, tok] = top[0] + 1.0
        return logits

    eng._decode = decode
    try:
        drive()
    finally:
        eng._decode = orig
    return gaps, parts


def phase_layout_parity(dev: str = "cuda"):
    """Reduced llama3-8b, fp32, 4 workers: TP4 -> SP2xTP2 -> TP4 and
    TP2x2 -> SP2xTP2 -> TP2x2 mid-decode, engines started at TP4,
    SP2xTP2 and SP4xTP1, and a chunked prefill at SP2xTP2 whose chunk
    straddles the shards' boundary: every CPU engine's streams equal the
    CPU TP4 engine's, and the card's equal the same runs on CPU workers,
    token by token (``_forced_run``: a row may pick another token only
    at a tie under ``TIE_GAP``, and then goes on from the reference's
    token; the line lists each parting); the layout cycle
    with no decode between steps leaves every worker's cache equal to
    ``split_cache`` at each layout.  The TP2x2 <-> SP2xTP2 sessions move
    KV only (0 weight bytes)."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.core.scheduler import PrefillPolicy
    from repro_torch.launch.mesh import Layout
    from repro_torch.models import model as M
    from repro_torch.serving import Engine, ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    t0 = time.monotonic()
    model = M.build(cfg, make_plan(cfg, 4, mode="page"), seed=9,
                    device="cpu")
    gen = torch.Generator().manual_seed(53)
    short = _prompts(gen, (16, 17, 18), cfg.vocab_size)
    chunked = _prompts(gen, (40, 20), cfg.vocab_size)

    def run(where, name, want=None):
        start, live, page, budget = LAYOUT_PLANS[name]
        policy = (None if budget is None else
                  PrefillPolicy(token_budget=budget, mode="mixed"))
        eng = Engine(cfg, params=copy.deepcopy(model).to(where),
                     devices=[where] * 4, max_batch=4, max_seq=64,
                     page_tokens=page, prefill_policy=policy)
        prompts = chunked if name == "sp_chunks" else short
        reqs = [ServeRequest(p, max_new_tokens=24, rid=k)
                for k, p in enumerate(prompts)]

        def goto(stage):
            tp, lay = stage
            eng.transform(tp, layout=None if lay is None else Layout(*lay))
            while eng.transforming:
                eng.step()
                eng.check_capacity_invariant()

        def drive():
            for stage in start:
                goto(stage)
            for r in reqs:
                eng.submit(r)
            for stage, before in live:
                for _ in range(before):
                    eng.step()
                goto(stage)
            eng.run_until_done()

        gaps, parts = _forced_run(eng, reqs, drive, want)
        out = ([r.generated for r in reqs], str(eng.par_layout),
               [(x["layout_from"], x["layout_to"], x["weight_bytes"])
                for x in eng.transform_log], gaps, parts)
        del eng
        return out

    # the CPU TP4 engine is the reference of the four engines on the same
    # prompts; each card engine is held against its CPU twin
    host = {n: run("cpu", n) for n in ("tp4", "sp_chunks")}
    for n in ("sp2tp2", "sp4tp1", "round_trip", "tp2x2_cycle"):
        host[n] = run("cpu", n, host["tp4"][0])
    card = {n: run(dev, n, host[n][0]) for n in LAYOUT_PLANS}
    partings = {}
    for n in LAYOUT_PLANS:
        assert card[n][1] == host[n][1], (n, card[n][1], host[n][1])
        assert card[n][0] == host[n][0], (n, card[n][0], host[n][0])
        partings[f"{n}: card vs cpu"] = [
            p + [host[n][3][p[0]][p[1]]] for p in card[n][4]]
        if n not in ("tp4", "sp_chunks"):
            assert host[n][0] == host["tp4"][0], n
            partings[f"{n} vs tp4 (cpu)"] = [
                p + [host["tp4"][3][p[0]][p[1]]] for p in host[n][4]]
    assert [x[:2] for x in card["round_trip"][2][1:]] == [
        ("TP4", "SP2xTP2"), ("SP2xTP2", "TP4")], card["round_trip"][2]
    kv_only = card["tp2x2_cycle"][2][1:]
    assert [x[2] for x in kv_only] == [0, 0], kv_only
    eng = Engine(cfg, params=copy.deepcopy(model).to(dev),
                 devices=[dev] * 4, max_batch=4, max_seq=64, page_tokens=16)
    for p in short + chunked[1:]:
        eng.submit(ServeRequest(p, max_new_tokens=24))
    for _ in range(6):
        eng.step()
    compared = 0
    for tp, lay in ((4, None), (4, (2, 2)), (2, None), (4, (2, 2)),
                    (4, (4, 1)), (4, None), (1, None)):
        before = eng.global_caches()
        eng.transform(tp, layout=None if lay is None else Layout(*lay))
        while not eng._session.done:
            eng._session.step()
        eng._finish_transform()
        compared += _landed_equal(eng, before, eng.par_layout)
    del eng
    if dev == "cuda":
        free_card()
    emit(phase="layout-parity", model=cfg.name, dtype=cfg.dtype, workers=4,
         engines={n: {"layout": card[n][1], "sessions": card[n][2]}
                  for n in LAYOUT_PLANS},
         streams_equal_cpu_workers_and_tp4_engine=True,
         partings_request_token_deficit_reference_gap=partings,
         tie_gap=TIE_GAP,
         largest_deficit=max((p[2] for v in partings.values() for p in v),
                             default=0.0), landed_bytes_compared=compared,
         seconds=time.monotonic() - t0)


def sp_launch_counts() -> dict:
    """Launches of slice 8's entries: the decode and chunk kernels'
    partial entries and the combine."""
    from repro_torch.kernels import chunk_prefill as CP
    from repro_torch.kernels import paged_attention as PA
    return {"paged_decode_partials": PA.partial_launches,
            "chunk_prefill_partials": CP.partial_launches,
            "softmax_combine": PA.combine_launches}


def layout_sessions(eng, W: int = 0) -> list:
    """``ladder_sessions``, with each session on one assembly of ``W``
    workers (default the engine's) bound from its layouts instead
    (``kv_transform.layout_migration_stats``: the bytes of every box
    intersection that leaves its worker, read once and written once), and
    its KV bytes also as multiples of the pools' bytes."""
    from repro_torch.core import kv_transform as KT
    out = ladder_sessions(eng)
    W = W or eng.W
    pool = eng.layers[0].cache[0].pool
    eb, P, dh = pool.element_size(), eng.page_tokens, pool.shape[-1]
    kvs, layers = eng.plan.kv_slots, len(eng.layers)
    for s in out:
        if not s["cross"]:
            mps = s["kv_pool_bytes"] // (layers * eng.max_batch * kvs * 2
                                         * P * dh * eb)
            st = KT.layout_migration_stats(
                W, _layout_of(s["from"]), W, _layout_of(s["to"]),
                eng.max_batch, mps, kvs, P, dh, dtype_bytes=eb)
            bound = 2 * st.bytes_moved * layers
            s.update(kv_bytes_bound=bound, kv_bound_ms=bound / HBM_BPS * 1e3)
        s.update(kv_bytes_over_pools=s["kv_bytes"] / s["kv_pool_bytes"],
                 bound_over_pools=s["kv_bytes_bound"] / s["kv_pool_bytes"])
    return out


def _layout_of(text: str):
    """``Layout`` from its string ("TP4", "SP2xTP2")."""
    from repro_torch.launch.mesh import Layout
    if text.startswith("SP"):
        sp, tp = text[2:].split("xTP")
        return Layout(int(sp), int(tp))
    return Layout(1, int(text[2:]))


def phase_layout_serve(smi: str, dev: str = "cuda", cfg=None,
                       quantum: int = 1536, lens=(300, 600, 900),
                       new: int = 160, long_len: int = 6000,
                       long_new: int = 96, page_tokens: int = 64,
                       dwell: int = 12):
    """llama3-8b at full width and ``LLAMA_LAYERS`` of its 32 layers,
    bf16, 4 workers of the card, brought to TP4 with no request in
    flight; three prompts and the
    6000-token request, then, with the long request decoding, TP4 ->
    SP2xTP2 -> TP4 mid-decode (``dwell`` decode steps at each layout).
    Returns the launches on this path (the six kernels and slice 8's
    entries)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Layout
    from repro_torch.serving import Engine, ServeRequest

    cfg = cfg or dataclasses.replace(get_config("llama3-8b"),
                                     num_layers=LLAMA_LAYERS)
    t0 = time.monotonic()
    eng = Engine(cfg, devices=[dev] * 4, seed=0, max_batch=4,
                 max_seq=4 * quantum, page_tokens=page_tokens)
    eng.transform(4)
    while eng.transforming:
        eng.step()
    sync(dev)
    t_init = time.monotonic() - t0
    gen = torch.Generator().manual_seed(59)
    warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                        max_new_tokens=2)
    eng.submit(warm)
    eng.run_until_done()
    reset_launch_counts()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = []
    step = _stepper(eng, steps, dev)
    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    long_ = ServeRequest(_prompts(gen, (long_len,), cfg.vocab_size)[0],
                         max_new_tokens=long_new)
    assert eng.max_seq_at(2) < long_.total_tokens <= eng.max_seq_at(4)
    t_run = time.monotonic()
    for r in reqs + [long_]:
        eng.submit(r)
    while any(not r.generated for r in reqs + [long_]):
        step()
    for _ in range(dwell):
        step()
    mem = {"TP4": mem_gb(dev)}
    reports = len(eng.transform_log)
    for lay in (Layout(2, 2), Layout(1, 4)):
        assert not long_.done and all(not r.done for r in reqs)
        eng.transform(4, layout=lay)
        while eng.transforming:
            step()
        assert eng.par_layout == lay
        mem[str(lay)] = mem_gb(dev)
        for _ in range(dwell):
            step()
    while any(not r.done for r in reqs + [long_]):
        step()
    wall = time.monotonic() - t_run
    launches = {**launch_counts(), **sp_launch_counts()}
    for r in reqs + [long_]:
        assert r.done and all(0 <= t < cfg.vocab_size for t in r.generated)
    if dev == "cuda":
        assert all(launches[k] > 0 for k in (
            "paged_decode_partials", "softmax_combine", "paged_attention",
            "padded_ffn", "copy_page_slices", "gather_page_slices")), launches
    sessions = layout_sessions(eng)[reports:]
    stalls = _stalls(steps)
    assert stalls == 0, stalls
    by = step_summary([s[:4] for s in steps])
    emit(phase="layout-serve", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, workers=4, quantum=quantum, prompts=list(lens),
         long_prompt=long_len, weights_init_s=t_init, wall_s=wall,
         sessions=sessions, stall_steps=stalls, steps_by_layout=by,
         tpot_s_by_layout={w: v["decode_only_step_ms_mean"]
                           for w, v in by.items() if "->" not in w},
         long_ttft_s=long_.ttft, long_tpot_s=long_.tpot,
         ttft_s=[r.ttft for r in reqs], tpot_s=[r.tpot for r in reqs],
         mem_gb=mem, launches=launches,
         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None), gpu=smi)
    del eng
    if dev == "cuda":
        free_card()
    return launches


def phase_cluster_layout(smi: str, dev: str = "cuda", cfg=None,
                         max_seq: int = 4096, lens=(300, 1200, 2500),
                         long_len: int = 6000, new: int = 96,
                         long_new: int = 48,
                         page_tokens: int = SP_PAGE_TOKENS,
                         long2_len: int = SP_CHUNKED_PROMPT,
                         long2_new: int = 16):
    """cluster-serve's configuration and trace (full-size llama3-8b,
    bf16, 2 instances x 1 worker) under ``SchedulerConfig(layouts=True)``:
    the merged TP2 engine holding the 6000-token request takes a
    ``ScaleUp(layout=SP2xTP1)``; a second long request (``long2_len``
    tokens) arrives once it is there and prefills in chunks at SP2xTP1
    (the chunk kernel's partial entry); once the long work is done the
    engine leaves the sp layout (to pure TP, or straight into the split)
    and the split returns the loan.  Returns the launches on this
    path."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import (GygesScheduler, ScaleUp,
                                            SchedulerConfig)
    from repro_torch.serving import ServeRequest
    from repro_torch.serving.cluster import ClusterEngine

    cfg = cfg or get_config("llama3-8b")
    t0 = time.monotonic()
    sched = GygesScheduler(SchedulerConfig(
        long_threshold=max_seq, target_tp=1, page_tokens=page_tokens,
        layouts=True))
    cl = ClusterEngine(cfg, [dev] * 2, n_instances=2, max_batch=4,
                       max_seq=max_seq, page_tokens=page_tokens, seed=0,
                       scheduler=sched)
    sync(dev)
    t_init = time.monotonic() - t0
    gen = torch.Generator().manual_seed(61)
    for e in cl.engines:
        warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                            max_new_tokens=2)
        e.submit(warm)
        e.run_until_done()
    reset_launch_counts()
    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    long_ = ServeRequest(_prompts(gen, (long_len,), cfg.vocab_size)[0],
                         max_new_tokens=long_new)
    long2 = ServeRequest(_prompts(gen, (long2_len,), cfg.vocab_size)[0],
                         max_new_tokens=long2_new)
    mem, steps = {}, []

    def where():
        e = cl._engine(cl.merge_log[0]["iid"]) if cl.merge_log else None
        if e is None:
            return "TP1 x2 instances"
        if e.transforming:
            return f"{e.par_layout}->{e._session.target_layout}"
        return str(e.par_layout) if e.tp > 1 else "TP1 after split"

    def step():
        w = where()
        live = reqs + [long_, long2]
        before = {id(r): len(r.generated) for r in live}
        sync(dev)
        t = time.monotonic()
        cl.step()
        sync(dev)
        dec = sum(len(r.generated) - before[id(r)] for r in live
                  if before[id(r)] > 0)
        steps.append((w, time.monotonic() - t, dec, False))
        if cl.merge_log and w not in mem:
            mem[w] = mem_gb(dev)

    t_run = time.monotonic()
    for r in reqs:
        cl.submit(r)
    while any(not r.generated for r in reqs):
        step()
    for _ in range(4):
        step()
    mem["before_merge"] = mem_gb(dev)
    cl.submit(long_)
    assert cl.merge_log and cl.merge_log[0]["donors"], cl.actions
    target = cl._engine(cl.merge_log[0]["iid"])
    sp_seen = False
    for _ in range(20000):
        if long2.done and cl.idle and not any(e.parked
                                              for e in cl.engines):
            break
        step()
        at_sp = (str(target.par_layout) == "SP2xTP1"
                 and not target.transforming)
        if at_sp and not sp_seen:
            cl.submit(long2)      # prefills in chunks at SP2xTP1
            assert cl.placements[long2.rid] == target.iid
            mem["at SP2xTP1"] = mem_gb(dev)
        sp_seen |= at_sp
    else:
        raise RuntimeError("cluster-layout did not drain and split")
    wall = time.monotonic() - t_run
    launches = {**launch_counts(), **sp_launch_counts()}
    acts = [a + [str(getattr(x, "layout", None))]
            for a, x in zip(cluster_actions(cl), cl.actions)]
    assert acts[0][0] == "ScaleUp" and acts[0][3], acts
    lay_acts = [a for a in cl.actions if isinstance(a, ScaleUp)
                and str(getattr(a, "layout", None)) == "SP2xTP1"]
    assert lay_acts and sp_seen, acts
    assert acts[-1][0] == "ScaleDown", acts
    assert cl.stall_steps == 0, cl.stall_steps
    assert not cl.partition._loans
    cl.partition.check_invariants()
    assert all(e.tp == 1 and not e.parked for e in cl.engines)
    for r in reqs + [long_, long2]:
        assert r.done and all(0 <= t < cfg.vocab_size for t in r.generated)
    if dev == "cuda":
        assert all(launches[k] > 0 for k in launches), launches
    by = step_summary(steps)
    emit(phase="cluster-layout", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, instances=2, workers_each=1, prompts=list(lens),
         long_prompt=long_len, actions=acts, weights_init_s=t_init,
         wall_s=wall, sessions=layout_sessions(target, W=2),
         stall_steps=cl.stall_steps, session_steps=cl.session_steps,
         tokens_during_session=cl.tokens_during_session,
         steps_by_layout=by,
         tpot_s_by_layout={w: v["decode_only_step_ms_mean"]
                           for w, v in by.items() if "->" not in w},
         long_ttft_s=long_.ttft, long_tpot_s=long_.tpot,
         long2_prompt=long2_len, long2_ttft_s=long2.ttft,
         long2_tpot_s=long2.tpot,
         ttft_s=[r.ttft for r in reqs], tpot_s=[r.tpot for r in reqs],
         memory_allocated_gb=mem, launches=launches,
         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None), gpu=smi)
    del cl, target
    if dev == "cuda":
        free_card()
    return launches


# ---------------------------------------------------------------------------
# Slice 9: the cost model, the simulator and calibration on the card
# ---------------------------------------------------------------------------

def layer_weight_bytes(cfg, dtype_bytes: int = 2) -> int:
    """One decoder layer's weights (q, k, v, o, the gated FFN's three
    matrices and two norms) in bytes: what a transform session moves a
    layer at most."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    n = (2 * d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh
         + 3 * d * cfg.d_ff + 2 * d)
    return n * dtype_bytes


def cal_sizes(cfg, dtype=torch.bfloat16, pages=(32, 128, 512),
              spill=(16, 64), page_tokens=64, mib=(16, 128),
              compute_dim=4096):
    """``calibrate``'s micro geometry at ``cfg``'s KV (its kv heads,
    ``page_tokens``-token pages, its head dimension) in ``dtype``: pools
    of ``pages`` pages a worker (512 x 64 tokens is one layer of
    cluster-serve's 4 x 8192-token pool, 128 MiB in bf16), weight puts
    of half a layer and a whole one, spill copies of ``spill`` pages,
    overlap pairs at ``mib`` MiB against a ``compute_dim``-wide chain."""
    from repro_torch.core.calibrate import MicroSizes
    layer = layer_weight_bytes(cfg)
    return MicroSizes(pages_per_worker=tuple(pages),
                      kv_slots=cfg.num_kv_heads, page_tokens=page_tokens,
                      head_dim=cfg.resolved_head_dim, dtype=dtype,
                      layer_bytes=(layer // 2, layer),
                      spill_pages=tuple(spill),
                      transfer_bytes=tuple(m << 20 for m in mib),
                      compute_dim=compute_dim, compute_iters=8)


def serve_decode_tps(eng, cfg, gen, steps: int = 16) -> float:
    """``calibrate.measure_decode_tps`` on the serve engine with a batch
    of its own: 4 rows of 2048-token prompts, every row decoding through
    the ``steps`` measured steps."""
    from repro_torch.core.calibrate import measure_decode_tps
    from repro_torch.serving import ServeRequest
    reqs = [ServeRequest(p, max_new_tokens=steps + 4)
            for p in _prompts(gen, (2048,) * 4, cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    while any(len(r.generated) == 0 for r in reqs):
        eng.step()
    tps = measure_decode_tps(eng, steps)
    eng.run_until_done()
    return tps


def phase_calibrate(smi: str, rates: dict, dev: str = "cuda", cfg=None,
                    widths=(2, 4), sizes=None, repeats: int = 5) -> dict:
    """``core.calibrate.calibrate`` on W = 2 and W = 4 workers of the
    card at llama3-8b's KV geometry in bf16 (``cal_sizes``).  One line a
    measurement: the reference's accounted bytes, the bytes the port
    really read and wrote, the span, and the least time the card could
    take (the accounted bytes read and written once over HBM rate; the
    copied bytes over it).  Then the fitted ``LinkModel`` beside
    ``LinkModel()``, the drift fractions, the overlap pairs and
    ``fit_hardware``'s result: the decode rate is the serve engine's
    (``rates``: 4 rows at 2048), the prefill rate the serve phase's
    6000-token TTFT (the request alone on the engine), ``mem_bytes`` the
    card's memory (the H20 prior's
    beside it); alpha, beta and ``kv_effectiveness`` keep the paper's
    Table-1 fit.  Returns the W = 4 fit's link, the fitted hardware and
    the launches of kernels 5-6 on this path."""
    from repro_torch.configs import get_config
    from repro_torch.core import calibrate as K
    from repro_torch.core.costmodel import H20
    from repro_torch.core.kv_transform import (LinkModel,
                                               layout_migration_stats)

    cfg = cfg or get_config("llama3-8b")
    sizes = sizes or cal_sizes(cfg)
    mem = (torch.cuda.get_device_properties(0).total_memory
           if dev == "cuda" else H20.mem_bytes)
    hw = K.fit_hardware(dataclasses.replace(H20, mem_bytes=float(mem)),
                        decode_tps=rates["decode_tps"],
                        prefill_tps=rates["prefill_tps"])
    esize = torch.empty((), dtype=sizes.dtype).element_size()
    prior = LinkModel()
    reset_launch_counts()
    t0 = time.monotonic()
    out = {}
    for W in widths:
        rep = K.calibrate(cfg, hw=hw, devices=[dev] * W, n_workers=W,
                          repeats=repeats, sizes=sizes)
        n_kv = 0
        for m, drift in zip(rep.measurements, rep.drift_fracs):
            extra = {}
            if m.kind.startswith("kv_migrate"):
                npw = sizes.pages_per_worker[n_kv // 2]
                n_kv += 1
                extra = {"pages_per_worker": npw,
                         "pool_bytes": W * npw * sizes.kv_slots * 2
                         * sizes.page_tokens * sizes.head_dim * esize,
                         "layout_bytes": layout_migration_stats(
                             W, m.tp_from, W, m.tp_to, W * npw, 1,
                             sizes.kv_slots, sizes.page_tokens,
                             sizes.head_dim, esize).bytes_moved}
            emit(phase="calibrate", workers=W, kind=m.kind,
                 tp_from=m.tp_from, tp_to=m.tp_to,
                 bytes_accounted=m.bytes_moved, segments=m.segments,
                 bytes_copied=m.copied_bytes, wall_s=m.wall_s,
                 bound_s=2 * m.bytes_moved / HBM_BPS,
                 copied_bound_s=m.copied_bytes / HBM_BPS,
                 prior_s=K.predicted_time(m, prior),
                 fitted_s=K.predicted_time(m, rep.link), drift_frac=drift,
                 gpu=smi, **extra)
        emit(phase="calibrate", workers=W, what="fit",
             link_fitted=dataclasses.asdict(rep.link),
             link_prior=dataclasses.asdict(prior),
             kv_migration_drift_frac=rep.kv_migration_drift_frac,
             drift_frac=rep.drift_frac, drift_fracs=rep.drift_fracs,
             overlap_pairs=[dict(dataclasses.asdict(p),
                                 overlap_frac=p.overlap_frac)
                            for p in rep.overlap_pairs],
             overlap_fitted=rep.overlap_frac,
             overlap_prior=rep.overlap_prior,
             overlap_drift_frac=rep.overlap_drift_frac, gpu=smi)
        assert all(m.wall_s > 0 for m in rep.measurements)
        assert rep.link.bandwidth > 0 and rep.link.segment_overhead >= 0
        out[W] = rep
    launches = launch_counts()
    if dev == "cuda":
        assert launches["copy_page_slices"] > 0 \
            and launches["gather_page_slices"] > 0, launches
    fit = {k: getattr(hw, k) for k in ("mem_bytes", "base_tps",
                                       "prefill_tps", "alpha", "beta",
                                       "kv_effectiveness")}
    emit(phase="calibrate", what="hardware", fitted=fit,
         h20=dataclasses.asdict(H20), decode_tps_source=(
             "serve engine, 4 rows at 2048-token prompts, "
             "measure_decode_tps"),
         prefill_tps_source=("serve phase: 6000 / the TTFT of the "
                             "6000-token request alone (its prefill "
                             "profile line)"),
         serve_rates=rates, seconds=time.monotonic() - t0,
         launches=launches, gpu=smi)
    return {"link": out[max(widths)].link, "hw": hw, "launches": launches}


#: the reference's ``LADDER_TRACE`` (``tests/test_sim_live_parity.py``)
#: at a 2048-token quantum on width-2 engines: two shorts, one request
#: on the spill rung (total 4097-6144) and one on the partial-merge rung
#: (6145-8192); (rid, prompt, new tokens)
CAL_TRACE = ((0, 1100, 32), (1, 4400, 48), (2, 6500, 48), (3, 900, 32))


def _cal_act_key(a):
    """The reference ladder harness's ``act_key``."""
    return (type(a).__name__, a.iid, getattr(a, "tp_to", None),
            tuple(sorted(getattr(a, "donor_iids", ()) or ())),
            tuple(getattr(a, "donor_devices", ()) or ()),
            getattr(a, "host_iid", None))


def _action_cost(cm, a, tp_from: int, page_tokens: int) -> float:
    """What ``cm`` prices action ``a`` at: ``_rung_cost``'s shapes (a
    spill's overflow pages; a transform at its real degree pair, a
    partial merge at the loaned fraction)."""
    from repro_torch.core.scheduler import Spill
    if isinstance(a, Spill):
        return cm.spill_time(a.tokens, page_tokens=page_tokens)
    t = cm.transform_time("gyges", tp_from=tp_from, tp_to=a.tp_to)
    if getattr(a, "donor_devices", ()) and sum(a.donor_devices) < a.tp_to:
        t *= sum(a.donor_devices) / a.tp_to
    return t


def _ewma_of(cm, a, tp_from: int, cfg):
    from repro_torch.core.costmodel import kv_bytes_per_token
    from repro_torch.core.scheduler import Spill
    if isinstance(a, Spill):
        est = cm.measured.estimate("spill", 0, 0,
                                   kv_bytes_per_token(cfg) * a.tokens)
    else:
        est = cm.measured.estimate("transform", tp_from, a.tp_to)
    return "cold" if est is None else est


def phase_cluster_calibrated(smi: str, cal: dict, dev: str = "cuda",
                             cfg=None, quantum: int = 2048,
                             page_tokens: int = 64, trace=CAL_TRACE):
    """cluster-partial's configuration (gemma-2b at full width and depth,
    bf16, 4 instances x 2 workers, quantum ``quantum``) under the
    capacity ladder (``SchedulerConfig(long_threshold=quantum,
    target_tp=4, spill=True, partial_merge=True, spill_slack=2.0)``)
    with a ``CalibratedCostModel`` of ``cal``'s fitted link and hardware
    attached.  ``trace`` runs as the reference harness runs it: submit,
    drain the cluster and its Alg-2 quiet window, next.  Then the port's
    ``Cluster`` replays it at the same geometry with its own
    ``CalibratedCostModel`` over the same fit; actions and placements
    must be equal (the harness's ``act_key``), stalls 0.  Prints each
    executed action's cost under the prior, under the fit and the
    EWMA's estimate at the decision, beside the measured ``wall_s`` and
    ``exposed_s``; each long request's three rung costs under the prior
    and the fit; memory; the launches, all six of which must rise.
    Returns them."""
    from repro_torch.configs import get_config
    from repro_torch.core.calibrate import CalibratedCostModel
    from repro_torch.core.cluster_sim import Cluster
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.scheduler import (GygesScheduler, PrefillPolicy,
                                            ScaleDown, ScaleUp,
                                            SchedulerConfig, Spill)
    from repro_torch.serving import ServeRequest
    from repro_torch.serving.cluster import ClusterEngine
    from repro_torch.serving.request import Request

    cfg = cfg or get_config("gemma-2b")
    link, hw = cal["link"], cal["hw"]

    def scheduler():
        s = GygesScheduler(SchedulerConfig(
            long_threshold=quantum, target_tp=4, spill=True,
            partial_merge=True, spill_slack=2.0))
        s.attach_cost(CalibratedCostModel(cfg, hw, link=link))
        return s

    def policy():
        return PrefillPolicy(token_budget=quantum, mode="mixed",
                             long_threshold=quantum, order="sjf")

    t0 = time.monotonic()
    cl = ClusterEngine(cfg, [dev] * 8, n_instances=4, max_batch=2,
                       max_seq=2 * quantum, page_tokens=page_tokens,
                       scheduler=scheduler(), dwell_steps=4, seed=0,
                       prefill_policy=policy())
    sync(dev)
    t_init = time.monotonic() - t0
    gen = torch.Generator().manual_seed(43)
    for e in cl.engines:
        warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                            max_new_tokens=2)
        e.submit(warm)
        e.run_until_done()
    reset_launch_counts()
    mem = {"before": mem_gb(dev)}
    live_cm = cl.scheduler.cost_model
    prior = CostModel(cfg)
    fitted = CostModel(cfg, hw, link=link)
    rows, rungs, reqs = [], [], []

    def note(tp_of):
        for a in cl.actions[len(rows):]:
            tpf = tp_of.get(a.iid, 1) if isinstance(a, ScaleDown) else (
                0 if isinstance(a, Spill) else 1)
            rows.append({
                "action": cluster_actions(cl)[len(rows)],
                "prior_s": _action_cost(prior, a, tpf, page_tokens),
                "fitted_s": _action_cost(fitted, a, tpf, page_tokens),
                "ewma_s": _ewma_of(live_cm, a, tpf, cfg)})

    t_run = time.monotonic()
    drain = cl.dwell_steps + 2
    for rid, n, new in trace:
        total = n + new
        if total > 2 * quantum:
            # the three rungs as the scheduler sees them at this submit
            insts, s = cl._transformable(), cl.scheduler
            cands = [(name, act) for name, act in (
                ("spill", s.decide_spill(insts, total)),
                ("partial", s.decide_partial_merge(insts, total)),
                ("full", s.decide_merge(insts, total))) if act is not None]
            by = {name: {"prior_s": _action_cost(prior, act, 1,
                                                 page_tokens),
                         "fitted_s": _action_cost(fitted, act, 1,
                                                  page_tokens),
                         "live_s": s._rung_cost(act, i)[0]}
                  for i, (name, act) in enumerate(cands)}
            order = {k: sorted(by, key=lambda nm: by[nm][k])
                     for k in ("prior_s", "fitted_s", "live_s")}
            rungs.append({"rid": rid, "total": total, "rungs": by,
                          "order_prior": order["prior_s"],
                          "order_fitted": order["fitted_s"],
                          "order_live": order["live_s"],
                          "order_differs": order["prior_s"]
                          != order["fitted_s"]})
        r = ServeRequest(rid=rid, prompt=_prompts(gen, (n,),
                                                  cfg.vocab_size)[0],
                         max_new_tokens=new)
        reqs.append(r)
        tp_of = {e.iid: e.tp for e in cl.engines}
        cl.submit(r)
        note(tp_of)
        quiet = 0
        for _ in range(20000):
            if cl.idle:
                if quiet >= drain:
                    break
                quiet += 1
            else:
                quiet = 0
            tp_of = {e.iid: e.tp for e in cl.engines}
            cl.step()
            note(tp_of)
            if any(e.tp == 4 for e in cl.engines) and "during" not in mem:
                mem["during"] = mem_gb(dev)
            if cl.partition.spills() and "spilled" not in mem:
                mem["spilled"] = mem_gb(dev)
        else:
            raise RuntimeError(f"cluster-calibrated did not drain {rid}")
        assert all(e.tp == 1 and not e.parked for e in cl.engines), rid
        assert not cl.partition.spills(), rid
    wall = time.monotonic() - t_run
    mem["after"] = mem_gb(dev)
    launches = launch_counts()
    cl.partition.check_invariants()
    assert cl.stall_steps == 0, cl.stall_steps
    for r in reqs:
        assert r.done and all(0 <= t < cfg.vocab_size for t in r.generated)
    if dev == "cuda":
        assert all(launches[k] > 0 for k in launches), launches
    # the measured side of each executed action, in order per engine
    seen = {}
    for row, a in zip(rows, cl.actions):
        e = cl._engine(a.iid)
        if isinstance(a, Spill):
            log = e.spill_log
            row.update(measured="spill_log of the guest", records=len(log),
                       wall_s=sum(x["wall_s"] for x in log),
                       exposed_s=sum(x["wall_s"] for x in log),
                       pages=sum(x["pages"] for x in log))
            continue
        k = seen.get(a.iid, 0)
        seen[a.iid] = k + 1
        rec = e.transform_log[k]
        row.update({f: rec[f] for f in ("tp_from", "tp_to", "layout_from",
                                        "layout_to", "steps", "wall_s",
                                        "exposed_s", "modeled_s",
                                        "kv_bytes", "weight_bytes")})
    # the simulator: the same trace, geometry, policy and fit
    sim = Cluster(cfg, n_hosts=1, gpus_per_host=8, scheduler=scheduler(),
                  target_tp=4, prefill_policy=policy(), seq_quantum=quantum,
                  max_batch=2, widths=[2, 2, 2, 2], page_tokens=page_tokens,
                  cost_model=CalibratedCostModel(cfg, hw, link=link))
    sim.scale_down_dwell = 5.0
    now, dt = 0.0, 0.25
    for rid, n, new in trace:
        sim.submit(Request(rid, now, n, new), now)
        for _ in range(20000):
            sim.advance(now, dt)
            now += dt
            if (all(q.tokens_done >= q.out_len
                    for q in sim._req_by_rid.values())
                    and all(i.tp == 1 for i in sim.instances)
                    and not sim.waiting and not sim.partition.spills()):
                break
        else:
            raise RuntimeError(f"sim did not drain request {rid}")
    live_keys = [_cal_act_key(a) for a in cl.actions]
    sim_keys = [_cal_act_key(a) for a in sim.actions]
    live_pl = {r.rid: cl.placements[r.rid] for r in reqs}
    assert live_keys == sim_keys, (live_keys, sim_keys)
    assert live_pl == sim.placements, (live_pl, sim.placements)
    assert any(isinstance(a, Spill) for a in cl.actions), live_keys
    assert any(isinstance(a, ScaleUp) and a.donor_devices
               for a in cl.actions), live_keys
    emit(phase="cluster-calibrated", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, workers=8, instances=4, quantum=quantum,
         trace=[list(t) for t in trace], weights_init_s=t_init, wall_s=wall,
         link=dataclasses.asdict(link),
         hardware={k: getattr(hw, k) for k in ("mem_bytes", "base_tps",
                                               "prefill_tps")},
         actions=rows, rungs=rungs, live_actions=live_keys,
         sim_actions=sim_keys, placements=live_pl,
         sim_placements=sim.placements, actions_equal=True,
         stall_steps=cl.stall_steps,
         ewma={"|".join(map(str, k)): [v, live_cm.measured._count[k]]
               for k, v in live_cm.measured._ewma.items()},
         ttft_s=[r.ttft for r in reqs], tpot_s=[r.tpot for r in reqs],
         sim_transform_log=sim.transform_log, mem_gb=mem,
         launches=launches, gpu=smi)
    del cl
    if dev == "cuda":
        free_card()
    return launches


# ---------------------------------------------------------------------------
# Slice 10: MoE blocks (granite-moe-3b-a800m; llama4-maverick reduced)
# ---------------------------------------------------------------------------

MOE_MODEL = "granite-moe-3b-a800m"
#: the kernels every MoE path runs (granite has no dense MLP: the padded
#: FFN runs only for maverick's shared expert, in moe-parity)
MOE_KERNELS = ("paged_attention", "chunk_prefill", "flash_attention",
               "copy_page_slices", "gather_page_slices")
#: moe-transform's and moe-cluster's KV migrations: (ta, workers) ->
#: (tb, workers after)
MOE_MOVES = (((1, 2), (2, 2)), ((2, 2), (1, 2)),    # TP1x2 <-> TP2
             ((1, 1), (2, 2)), ((2, 2), (1, 1)))    # a merge, a split
#: whole-model logits of the card against the CPU in fp32, as the CPU
#: tests hold the port against the reference
MOE_TOL = 1e-4
#: bf16 on the card: the least share of decode rows (teacher forced)
#: whose greedy token equals an engine's started at TP2, at each stage
#: of a TP1x2 -> TP2 change.  bf16 sums in other orders flip router
#: choices, and at 4 rows a decode has one buffer slot an expert (cap
#: 1), so one row's flip moves other rows' drops: the rows part more
#: than a dense model's would (0.81-0.88 measured on an H100, PERF.md).
#: Correctness is held in fp32 (equal streams); this bounds the drift.
MOE_BF16_AGREE = 0.5


def moe_cases():
    """(model, case function, keywords) for granite's kernel shapes on
    the MoE phases, from its padding plan of 2 shards (moe-transform's
    engine and moe-cluster's pool): a prompt's first chunk and a later
    one at TP1 and TP2, decode and flash at TP2 (TP1's are
    ``head_shape_cases``' granite rows), each KV migration of
    ``MOE_MOVES`` and the merge's slot export and import."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    cfg = get_config(MOE_MODEL)
    plan = make_plan(cfg, 2, mode="page")
    dh = cfg.resolved_head_dim
    out = []
    for t in (1, 2):
        heads = dict(Hq=plan.q_heads_padded // t, kvs=plan.kv_slots // t,
                     dh=dh)
        out += [(MOE_MODEL, case_chunk, dict(S=4096, done=0, cap=8192,
                                             attend_prefix=False, **heads)),
                (MOE_MODEL, case_chunk, heads)]
        if t == 2:
            out += [(MOE_MODEL, case_decode, dict(B=4, ctx=2048, cap=8192,
                                                  **heads)),
                    (MOE_MODEL, case_flash, heads)]
    for (ta, W), (tb, W2) in MOE_MOVES:
        out.append((MOE_MODEL, case_reshard, dict(
            ta=ta, tb=tb, W=W, W2=W2, kvs=plan.kv_slots, dh=dh)))
    out.append((MOE_MODEL, case_slot_move, dict(
        slot=1, to_slot=2, kvs=plan.kv_slots, dh=dh)))
    return out


def _moe_model(cfg, plan, seed: int, dev: str, on: str = "cpu"):
    """Random weights built on ``on`` from ``seed`` (on the CPU: the
    same for every device), the MLPs re-laid for ``plan``'s shards, on
    ``dev``."""
    from repro_torch.core.weight_transform import relayout_block_mlp
    from repro_torch.models.model import build
    model = build(cfg, plan, seed=seed, device=on)
    for blk in model.layers:
        relayout_block_mlp(blk.mlp, cfg.d_ff, plan.max_tp, cfg.activation)
    return model.to(dev)


def phase_moe_parity(dev: str = "cuda"):
    """Reduced granite-moe and llama4-maverick (``(ATTN, MOE)``, a shared
    expert) in fp32, the same weights and requests on ``dev`` and on the
    CPU (the kernels' plain versions): one device with budgeted chunked
    prefill, and two workers at TP1x2 whose decode overflows capacity
    across the replicas (capacity factor 0.5), transformed TP1x2 ->
    TP2 -> TP1x2 mid-decode (maverick's shared expert on the padded
    FFN).  Greedy streams equal; first-token logits of a whole prompt
    and of a chunked one within ``MOE_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.core.scheduler import PrefillPolicy
    from repro_torch.serving import Engine, ServeRequest

    t0 = time.monotonic()
    rows = []
    for name in (MOE_MODEL, "llama4-maverick-400b-a17b"):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  dtype="float32")
        over = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
        prompts = _prompts(torch.Generator().manual_seed(29),
                           (9, 23, 41, 14), cfg.vocab_size)
        streams, logits = {}, {}
        for d in (dev, "cpu"):
            model = _moe_model(cfg, make_plan(cfg, 1), 0, d)
            eng = Engine(cfg, params=model, max_batch=4, max_seq=64,
                         page_tokens=16, device=d,
                         prefill_policy=PrefillPolicy(token_budget=16,
                                                      mode="mixed"))
            streams[d, "one device"] = _drive(
                eng, [ServeRequest(p, max_new_tokens=12) for p in prompts])
            with torch.no_grad():
                whole = model.prefill(
                    torch.tensor(prompts[1], device=d)[None],
                    model.init_decode_caches(1, 64, 16))
                caches = model.init_decode_caches(1, 64, 16)
                long_ = torch.tensor(prompts[2], device=d)[None]
                for s0 in range(0, long_.shape[1], 16):
                    chunked = model.prefill_chunk(
                        long_[:, s0:s0 + 16],
                        torch.tensor([s0], dtype=torch.int32, device=d),
                        caches, first_chunk=s0 == 0)
            logits[d] = (whole.float().cpu(), chunked.float().cpu())
            m2 = _moe_model(over, make_plan(over, 2, mode="page"), 1, d)
            eng = Engine(over, params=m2, devices=[d] * 2, max_batch=4,
                         max_seq=64, page_tokens=16)
            streams[d, "TP1x2 -> TP2 -> TP1x2"] = _drive(
                eng, [ServeRequest(p, max_new_tokens=12) for p in prompts],
                before=5, plan=(2, 1))
            del model, m2, eng
        for k in ("one device", "TP1x2 -> TP2 -> TP1x2"):
            assert streams[dev, k] == streams["cpu", k], (name, k, streams)
        err = max((a - b).abs().max().item()
                  for a, b in zip(logits[dev], logits["cpu"]))
        assert err <= MOE_TOL, (name, "first-token logits", err)
        rows.append({"model": cfg.name, "pattern": list(cfg.pattern),
                     "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
                     "shared_expert": cfg.moe.shared_expert,
                     "first_token_logit_max_abs_err": err})
    if dev == "cuda":
        free_card()
    emit(phase="moe-parity", dtype="float32", prompts=[9, 23, 41, 14],
         models=rows, streams_equal=True, tol=MOE_TOL,
         overflow_capacity_factor=0.5, seconds=time.monotonic() - t0)


def moe_split(p, cfg, plan, tokens: int, dev: str) -> dict:
    """Device time of one MoE MLP's parts at ``tokens`` tokens routed
    together, on layer weights ``p``: the routing (router product,
    softmax, top-k, positions), the two expert ``bmm`` over the
    ``(Ep, cap, d)`` buffer alone, and the rest of ``moe_experts`` (the
    dispatch scatter, the activation, the weighted combine).  The
    ``bmm`` bound reads every expert's weights once (all ``Ep`` experts
    are read on each call) and the buffers once, and writes the outputs
    once."""
    from repro_torch.models import blocks as B
    dt = p["wi"].dtype
    g = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn((tokens, cfg.d_model), generator=g, device=dev).to(dt)
    Ep, d, ncol = p["wi"].shape
    ffp = p["wo"].shape[1]

    def route():
        topv, topi = B.moe_route(p["router"], x, cfg, plan)
        cap = B.moe_capacity(tokens, cfg)
        return (topv, topi, *B.moe_positions(topi, Ep, cap), cap)

    topv, topi, pos, keep, cap = route()
    buf = torch.randn((Ep, cap, d), generator=g, device=dev).to(dt)
    h = torch.randn((Ep, cap, ffp), generator=g, device=dev).to(dt)
    iters = 20
    # the routing and the experts are a dozen small launches each: hold
    # the card long enough that the events time its work, not the host's
    t_route = time_ms(route, iters, hold=20)
    t_experts = time_ms(lambda: B.moe_experts(
        p, x, topv, topi, pos, keep, cap, cfg.activation), iters, hold=20)
    t_bmm = time_ms(lambda: (torch.bmm(buf, p["wi"]),
                             torch.bmm(h, p["wo"])), iters)
    nb = (nbytes(p["wi"], p["wo"], buf, h)
          + Ep * cap * (ncol + d) * buf.element_size())
    flops = 2 * Ep * cap * d * ncol + 2 * Ep * cap * ffp * d
    b_ms, b_by = bound_ms(nb, flops, dt)
    return {"tokens": tokens, "cap": cap, "experts_padded": Ep,
            "kept_choices": int(keep.sum()), "choices": keep.numel(),
            "route_ms": t_route, "experts_ms": t_experts,
            "expert_bmm_ms": t_bmm,
            "dispatch_act_combine_ms": t_experts - t_bmm,
            "expert_bmm_bytes": nb, "expert_bmm_flops": flops,
            "expert_bmm_bound_ms": b_ms, "expert_bmm_bound_by": b_by}


def phase_moe_serve(smi: str, dev: str = "cuda", cfg=None,
                    lens=(300, 1200, 2500, 5000), new: int = 32,
                    max_seq: int = 8192, page_tokens: int = 64):
    """Full-size granite-moe-3b-a800m (32 layers, 40 experts, top-8) in
    bf16 with random weights on one device through ``Engine.step``:
    whole prompts and a 5000-token one that chunks (4096 + 904).  Every
    launch counter of kernels 1-3 must rise.  Prints TTFT, TPOT,
    tokens/s, memory; then a profiled decode step of 4 rows at 2048
    tokens (busy against wall) and the MoE MLP's split at that step's
    4 tokens and at a 4096-token chunk (``moe_split``), with the
    attention kernel's share of the step from the profile."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.models.model import build
    from repro_torch.serving import Engine, ServeRequest

    cfg = cfg or get_config(MOE_MODEL)
    plan = make_plan(cfg, 1)
    t0 = time.monotonic()
    model = build(cfg, plan, seed=0, device=dev)
    sync(dev)
    t_init = time.monotonic() - t0
    eng = Engine(cfg, params=model, max_batch=4, max_seq=max_seq,
                 page_tokens=page_tokens, device=dev)
    gen = torch.Generator().manual_seed(31)
    warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                        max_new_tokens=2)
    eng.submit(warm)
    eng.run_until_done()
    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    sync(dev)
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    sync(dev)
    wall = time.monotonic() - t0
    launches = launch_counts()
    for r in reqs:
        assert len(r.generated) == new, (len(r.prompt), len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert dev != "cuda" or all(launches[k] > 0 for k in (
        "paged_attention", "chunk_prefill", "flash_attention")), launches
    chunked = [n for n in lens
               if len(eng.prefill_policy.chunk_sizes(n, page_tokens)) > 1]
    assert chunked, "no prompt chunked"
    out = {"phase": "moe-serve", "model": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
           "prompts": list(lens), "chunked_prompts": chunked,
           "new_tokens": new, "weights_init_s": t_init, "wall_s": wall,
           "ttft_s": [r.ttft for r in reqs], "tpot_s": [r.tpot for r in reqs],
           "tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
           "launches": launches, "gpu": smi}
    if dev == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        prof = decode_profile(eng, cfg, gen)
        p0 = eng.model.layers[0].mlp
        step = moe_split(p0, cfg, plan, 4, dev)
        chunk = moe_split(p0, cfg, plan, 4096, dev)
        n_moe = sum(1 for k in cfg.pattern if k == "moe")
        attn = prof["kinds_ms"].get("paged decode (port)", 0.0)
        per_step = {k: step[k] * n_moe for k in (
            "route_ms", "expert_bmm_ms", "dispatch_act_combine_ms")}
        out.update(decode_step={
            "rows": 4, "context": 2048,
            "unprofiled_wall_ms": prof["unprofiled_wall_ms"],
            "profiled_wall_ms": prof["wall_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "attention_kernel_ms": attn,
            **{"moe_" + k: v for k, v in per_step.items()},
            "shares_of_busy": {
                "attention_kernel": attn / prof["device_busy_ms"],
                **{"moe_" + k[:-3]: v / prof["device_busy_ms"]
                   for k, v in per_step.items()}}},
            moe_split_per_layer={"decode": step, "prefill_chunk": chunk})
        emit(phase="profile", gpu=smi, model=cfg.name, **prof)
    emit(**out)
    del eng, model
    if dev == "cuda":
        free_card()
    return launches


def _moe_worker_engine(cfg, dev, W=2, seed=0, **kw):
    """An engine on W workers of ``dev``, its weights generated there
    from ``seed``."""
    from repro_torch.core.padding import make_plan
    from repro_torch.serving import Engine
    plan = make_plan(cfg, W, mode="page")
    return Engine(cfg, params=_moe_model(cfg, plan, seed, dev, on=dev),
                  devices=[dev] * W, **kw)


def stage_of(eng) -> str:
    """Where a worker engine stands in a TP1x2 -> TP2 -> TP1x2 run:
    ``TP1x2`` before its first change, ``session``, ``TP2``, and
    ``TP1x2 again`` once it has changed back."""
    if eng.transforming:
        return "session"
    if eng.tp != 1:
        return f"TP{eng.tp}"
    return "TP1x2 again" if eng.transform_log else "TP1x2"


def record_rows(eng, reqs, keep, force=None, where=None):
    """Wrap ``eng._decode``: record each request's logits row (on the
    host) by token index, with where the engine stood (``TP1x2``,
    ``session``, ``TP2``; ``where(eng)`` when given); with ``force``,
    each row takes the recorded run's token (teacher forcing)."""
    from repro_torch.serving import State
    orig = eng._decode

    def decode(tokens, positions):
        at = (where(eng) if where is not None else
              "session" if eng.transforming
              else "TP1x2" if eng.tp == 1 else f"TP{eng.tp}")
        logits = orig(tokens, positions)
        for i, r in enumerate(reqs):
            if r.state != State.DECODE or eng.slots[r.slot] is not r:
                continue
            j = len(r.generated)
            keep[i, j] = (logits[r.slot].float().cpu(), at)
            if force is not None and (i, j) in force:
                logits = logits.clone()
                logits[r.slot] = -1e30
                logits[r.slot, int(force[i, j][0].argmax())] = 0.0
        return logits

    eng._decode = decode


def held_rows(got: dict, want: dict, vocab: int) -> dict:
    """Each recorded row of a teacher-forced run beside the reference
    run's row on the same tokens, by where it ran: rows, the largest
    logit difference (absolute, and over the row's logit RMS), and the
    share whose greedy token agrees."""
    held = {}
    for (i, j), (row, where) in got.items():
        if (i, j) not in want:
            continue
        ref_row = want[i, j][0]
        h = held.setdefault(where, {"rows": 0, "logit_max_abs_diff": 0.0,
                                    "over_logit_rms": 0.0,
                                    "argmax_flips": 0})
        diff = float((row - ref_row).abs().max())
        rms = float(ref_row[:vocab].pow(2).mean().sqrt())
        h["rows"] += 1
        h["logit_max_abs_diff"] = max(h["logit_max_abs_diff"], diff)
        h["over_logit_rms"] = max(h["over_logit_rms"], diff / rms)
        h["argmax_flips"] += int(row.argmax()) != int(ref_row.argmax())
    for h in held.values():
        h["argmax_agree"] = 1 - h["argmax_flips"] / h["rows"]
    return held


#: moe-transform's bf16 depth: half of granite's 32 layers since the
#: train phases came, to keep the script inside its time limit
MOE_TRANSFORM_LAYERS = 16


def phase_moe_transform(smi: str, dev: str = "cuda", cfg=None,
                        parity_layers: int = 4, max_seq: int = 8192,
                        lens=(300, 1200, 2500, 3500), long_len: int = 6000,
                        new: int = 48, page_tokens: int = 64,
                        layers_per_step: int = 4):
    """granite-moe on two workers of the card.  In fp32 at full width
    and ``parity_layers`` layers: TP1x2 -> TP2 mid-decode gives the
    streams of an engine started at TP2, a round trip TP1x2 -> TP2 ->
    TP1x2 those of an engine that never transformed.  In bf16 at full
    width and ``MOE_TRANSFORM_LAYERS`` layers: the same prompts decode
    at TP1x2, the engine
    transforms to TP2 mid-decode, serves a 6000-token request only TP2
    holds, and transforms back (``layers_per_step`` layers a schedule
    step); every decode row of the short prompts is held against an
    engine started at TP2 (teacher forced: the row's logits beside the
    reference's, by where the row ran), the bf16 tolerance the card
    gives.  Prints each session's steps, walls and the KV and weight
    bytes it moved; kernels 1-3 and 5-6 must launch."""
    from repro_torch.configs import get_config
    from repro_torch.core import weight_transform as WT
    from repro_torch.core.scheduler import PrefillPolicy
    from repro_torch.serving import ServeRequest

    base = cfg or dataclasses.replace(get_config(MOE_MODEL),
                                      num_layers=MOE_TRANSFORM_LAYERS)
    t0 = time.monotonic()
    c32 = dataclasses.replace(base, num_layers=parity_layers,
                              dtype="float32")
    prompts = _prompts(torch.Generator().manual_seed(37),
                       (60, 150, 250, 90), c32.vocab_size)
    kw = dict(max_batch=4, max_seq=512, page_tokens=page_tokens,
              prefill_policy=PrefillPolicy(token_budget=128, mode="mixed"))
    streams = {}
    for name, before, plan in (("tp2", 0, None), ("mid", 6, (2,)),
                               ("round_trip", 6, (2, 1)),
                               ("untransformed", 0, ())):
        eng = _moe_worker_engine(c32, dev, **kw)
        if plan is None:
            eng.transform(2)
            while eng.transforming:
                eng.step()
            plan = ()
        streams[name] = _drive(
            eng, [ServeRequest(p, max_new_tokens=16) for p in prompts],
            before, plan)
        del eng
    assert streams["mid"] == streams["tp2"], streams
    assert streams["round_trip"] == streams["untransformed"], streams
    t_parity = time.monotonic() - t0

    gen = torch.Generator().manual_seed(43)
    shorts = _prompts(gen, lens, base.vocab_size)
    long_prompt = _prompts(gen, (long_len,), base.vocab_size)[0]
    kw = dict(max_batch=4, max_seq=max_seq, page_tokens=page_tokens)

    want = {}
    ref = _moe_worker_engine(base, dev, **kw)
    ref.transform(2, layers_per_step=base.num_layers)
    while ref.transforming:
        ref.step()
    ref_reqs = [ServeRequest(p, max_new_tokens=new) for p in shorts]
    record_rows(ref, ref_reqs, want)
    _drive(ref, ref_reqs)
    del ref
    if dev == "cuda":
        free_card()

    eng = _moe_worker_engine(base, dev, **kw)
    warm = ServeRequest(_prompts(gen, (70,), base.vocab_size)[0],
                        max_new_tokens=2)
    eng.submit(warm)
    eng.run_until_done()
    reset_launch_counts()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reqs = [ServeRequest(p, max_new_tokens=new) for p in shorts]
    got = {}
    record_rows(eng, reqs, got, force=want)
    t_run = time.monotonic()
    for r in reqs:
        eng.submit(r)
    while any(len(r.generated) < new // 3 for r in reqs):
        eng.step()
    assert eng.tp == 1 and all(r.slot is not None for r in reqs)
    n_up = eng.transform(2, layers_per_step=layers_per_step)
    while eng.transforming:
        eng.step()
    assert eng.tp == 2 and eng.max_seq() == max_seq
    long_ = ServeRequest(long_prompt, max_new_tokens=16)
    assert eng.max_seq_at(1) < long_.total_tokens <= eng.max_seq()
    eng.submit(long_)
    while eng.waiting or any(s is not None for s in eng.slots):
        eng.step()
    n_down = eng.transform(1, layers_per_step=layers_per_step)
    while eng.transforming:
        eng.step()
    sync(dev)
    wall = time.monotonic() - t_run
    launches = launch_counts()
    assert eng.tp == 1
    for r in reqs + [long_]:
        assert r.done and all(0 <= t < base.vocab_size for t in r.generated)
    assert dev != "cuda" or all(launches[k] > 0
                                for k in MOE_KERNELS), launches
    # the bf16 tolerance: every decode row of the transformed run against
    # the engine started at TP2, on the same tokens, by where it ran
    held = held_rows(got, want, base.vocab_size)
    assert held.get("TP2", {}).get("rows"), held
    for where, h in held.items():
        assert h["argmax_agree"] >= MOE_BF16_AGREE, (where, held)
    ups, downs = (eng.transform_reports[:n_up],
                  eng.transform_reports[n_up:])
    assert len(downs) == n_down
    # the MLP bytes each session wrote (every worker's shard is a fresh
    # tensor at a new degree; the router stays): TP2's shards are one
    # replica in all, TP1x2 a replica a worker; beside them the
    # reference's accounting (the swap path: granite's plan is not
    # page-aligned)
    replica = sum(t.numel() * t.element_size() for layer in eng.layers
                  for k, t in layer.mlp[0].items() if k != "router")
    sessions = []
    for log, reps in zip(eng.transform_log, (ups, downs)):
        st = WT.account_regroup(base, eng.plan, log["tp_from"],
                                log["tp_to"], "padded")
        sessions.append(dict(
            session_summary(log, reps, eng.W), kv_bytes=log["kv_bytes"],
            weight_bytes_across_workers=log["weight_bytes"],
            mlp_bytes_written=replica * (eng.W if log["tp_to"] == 1 else 1),
            mlp_bytes_accounted=base.num_layers * (st.bytes_copied
                                                   + st.bytes_transferred)))
    emit(phase="moe-transform", model=base.name, dtype=base.dtype,
         layers=base.num_layers, workers=eng.W, prompts=list(lens),
         long_prompt=long_len, parity_layers=parity_layers,
         parity_mid_equals_tp2=True,
         parity_round_trip_equals_untransformed=True,
         parity_seconds=t_parity, wall_s=wall, sessions=sessions,
         bf16_held_against_tp2=held,
         ttft_s=[r.ttft for r in reqs + [long_]],
         tpot_s=[r.tpot for r in reqs + [long_]], launches=launches,
         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None), gpu=smi)
    del eng
    if dev == "cuda":
        free_card()
    return launches


#: the serve CLI on a MoE model: granite-moe-3b-a800m at published
#: widths and depth in bf16, one instance of one worker of the card
MOE_CLI = ("--arch", MOE_MODEL, "--no-smoke", "--instances", "1",
           "--workers", "1", "--max-seq", "8192", "--requests", "4",
           "--long-every", "2")


def phase_moe_cluster(smi: str, dev: str = "cuda", cfg=None, **kw):
    """``phase_cluster_serve`` on full-size granite-moe in bf16: 2
    instances x 1 worker of the card, prompts of 300-2500 tokens, a
    6000-token request only the merged TP2 holds (a live merge under
    ``GygesScheduler``), the split after the dwell, the revived donor
    serving.  Kernels 1-3 and 5-6 must launch."""
    from repro_torch.configs import get_config
    kw = dict(dict(lens=(300, 1200, 2500), new=32, long_new=16), **kw)
    return phase_cluster_serve(smi, dev, cfg or get_config(MOE_MODEL),
                               label="moe-cluster", kernels=MOE_KERNELS,
                               **kw)


# ---------------------------------------------------------------------------
# Slice 11: recurrentgemma-9b (RG-LRU blocks), and KV spill of a MoE engine
# ---------------------------------------------------------------------------

RG_MODEL = "recurrentgemma-9b"
#: the kernels every recurrentgemma path runs: its sliding layers'
#: attention (one device runs its MLPs as plain matmuls, two workers on
#: the padded FFN; the state and mixer move without a page kernel)
RG_KERNELS = ("paged_attention", "chunk_prefill", "flash_attention")
RG_WORKER_KERNELS = RG_KERNELS + ("padded_ffn", "copy_page_slices",
                                  "gather_page_slices")
#: whole-model logits of the card against the CPU in fp32
RG_TOL = 1e-4
#: bf16 on the card: the least share of teacher-forced decode rows of a
#: TP1x2 -> TP2 -> TP1x2 run whose greedy token equals that of an engine
#: at the same degree throughout, at each stage: rows at TP1x2 against
#: an engine that stays at TP1x2 (before the first change they are the
#: same sums, so every row agrees), rows at TP2 and mid-session against
#: an engine started at TP2.  The same run in fp32 (``RG_FP32_LAYERS``
#: layers at full width) must agree on every row, so what is left is
#: bf16 rounding in other sum orders (the TP2 all-reduce of bf16
#: partials after ``w_out``, ``wo`` and the MLP), carried forward in the
#: recurrent state and read through a 256000-word random head whose top
#: two logits lie close.  Stated before the first card run, which held
#: every row against the TP2 engine and read 0.798 on the TP1x2 rows:
#: the gap between two degrees, not a fault of the change (PERF.md).
RG_BF16_AGREE = 0.8
#: rg-transform's fp32 run: layers at full width (an fp32 replica of all
#: 38 would not fit twice on the card), and its logits' tolerance
RG_FP32_LAYERS = 12
RG_FP32_TOL = 1e-3
#: the fp32 MoE rows (ROADMAP queue 3 item 1): every teacher-forced row
#: of granite at full depth at TP1x2, mid-session and at TP2 takes the
#: greedy token of an engine started at TP2, with logits within this
#: absolute difference (32 layers of fp32 sums in other orders)
MOE_FP32_TOL = 1e-3


def rg_cases():
    """(model, case function, keywords) for recurrentgemma-9b's kernel
    shapes on the slice-11 phases: on one device or worker (its plan of
    1: 16 q heads over 1 kv slot) and at each degree of rg-transform's
    two workers (a plan of 2: the kv head copied into 2 slots; TP1x2 16
    q heads over 2, TP2 8 over 1): chunk prefill on the 2048-token
    window ring (a prompt's first chunk, a chunk over a full ring, a
    904-token tail over a wrapped one), decode on the wrapped ring,
    windowed flash prefill, and the padded FFN's geglu shards (d 4096,
    ff 12288) at both tilings and a 512-token chunk's; then the two KV
    migrations TP1x2 <-> TP2 of its ring pools."""
    from repro_torch.configs import get_config
    from repro_torch.core import instance as I
    from repro_torch.core.padding import make_plan
    from repro_torch.kernels import padded_ffn as PF
    cfg = get_config(RG_MODEL)
    w, dh = cfg.window, cfg.resolved_head_dim
    out = []
    for W, t in ((1, 1), (2, 1), (2, 2)):
        plan = (make_plan(cfg, 1) if W == 1
                else make_plan(cfg, W, mode="page"))
        heads = dict(Hq=plan.q_heads_padded // t, kvs=plan.kv_slots // t,
                     dh=dh)
        ring = dict(cap=w, window=w, **heads)
        out += [(RG_MODEL, case_chunk, dict(S=w, done=0,
                                            attend_prefix=False, **ring)),
                (RG_MODEL, case_chunk, dict(S=w, done=w, **ring)),
                (RG_MODEL, case_chunk, dict(S=904, done=2 * w, **ring)),
                (RG_MODEL, case_decode, dict(q_pos=[2500, 3000, 4100, 5000],
                                             **ring)),
                (RG_MODEL, case_flash, dict(S=w, window=w, **heads))]
        # the MLP of an engine with workers: the serve CLI's one worker
        # (a plan of 1) and rg-transform's two
        tp, ff = I.mlp_shards(t, plan.max_tp, cfg.d_ff)
        for T in (1, PF.DECODE_MAX_T + 1, 512):
            out.append((RG_MODEL, case_ffn, dict(
                T=T, tp=tp, ff=ff, ffp=plan.d_ff_padded // t, d=cfg.d_model,
                model=RG_MODEL, what=f"TP{t} x{W // t} of a plan of {W}",
                activation=cfg.activation, iters=10)))
    kvs = make_plan(cfg, 2, mode="page").kv_slots
    for ta, tb in ((1, 2), (2, 1)):
        out.append((RG_MODEL, case_reshard, dict(ta=ta, tb=tb, W=2, W2=2,
                                                 kvs=kvs, dh=dh, cap=w)))
    return out


def ring_whole_vs_chunked(model, prompt, max_seq: int, page_tokens: int,
                          chunk: int, steps: int) -> dict:
    """A whole prompt longer than the sliding layers' window against the
    same prompt in chunks of ``chunk`` tokens, on one model: every ring
    holds the same positions, each kept key at slot p % capacity, and
    pools within ``RG_TOL``; then ``steps`` greedy decode steps on both
    (each appends over the ring's oldest key) take the same tokens with
    logits within ``RG_TOL``.  Returns the largest differences."""
    d, S = prompt.device, prompt.shape[1]
    whole = model.init_decode_caches(1, max_seq, page_tokens)
    chunked = model.init_decode_caches(1, max_seq, page_tokens)
    with torch.no_grad():
        lw = model.prefill(prompt, whole)
        for s0 in range(0, S, chunk):
            lc = model.prefill_chunk(
                prompt[:, s0:s0 + chunk],
                torch.tensor([s0], dtype=torch.int32, device=d), chunked,
                first_chunk=s0 == 0)
        errs = [float((lw - lc).abs().max())]
        pool_err, rings = 0.0, 0
        for w, c in zip(whole, chunked):
            if w.recurrent:
                continue
            rings += 1
            assert w.capacity < S, (w.capacity, S)
            assert torch.equal(w.positions, c.positions), "ring positions"
            assert bool((w.positions % w.capacity == torch.arange(
                w.capacity, device=d)).all()), "ring slots"
            pool_err = max(pool_err, float((w.pool - c.pool).abs().max()))
        assert rings and pool_err <= RG_TOL, (rings, pool_err)
        tok = lc[:, -1].argmax(-1)
        for i in range(steps):
            pos = torch.tensor([S + i], dtype=torch.int32, device=d)
            lw = model.decode_step(whole, tok, pos)
            lc = model.decode_step(chunked, tok, pos)
            errs.append(float((lw - lc).abs().max()))
            assert torch.equal(lw.argmax(-1), lc.argmax(-1)), i
            tok = lc.argmax(-1)
    assert max(errs) <= RG_TOL, errs
    return {"prompt": S, "chunk": chunk, "decode_steps": steps,
            "logit_max_abs_diff": max(errs), "pool_max_abs_diff": pool_err}


def phase_rg_parity(dev: str = "cuda", cfg=None, layers: int = 3,
                    lens=(40, 150, 90), new: int = 8, max_seq: int = 512,
                    page_tokens: int = 64, budget: int = 64,
                    long_len: int = 2500):
    """recurrentgemma-9b at full width, ``layers`` layers of its pattern
    (RGLRU, RGLRU, SLIDING), fp32: the same weights and prompts on
    ``dev`` and on the CPU (the kernels' plain versions).  One device
    with budgeted chunked prefill (the recurrent carry from chunk to
    chunk, restored over the decode filler), and two workers at TP1x2
    changed to TP2 while a prompt is mid-chunk and others decode.
    Greedy streams equal; a whole prompt's and a chunked prompt's
    first-token logits within ``RG_TOL``.  On ``dev`` also a
    ``long_len``-token prompt, longer than the window, whole against
    chunked (``ring_whole_vs_chunked``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.core.scheduler import PrefillPolicy
    from repro_torch.serving import Engine, ServeRequest

    from repro_torch.core.weight_transform import relayout_block_mlp
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    c = dataclasses.replace(cfg or get_config(RG_MODEL), num_layers=layers,
                            dtype="float32")
    prompts = _prompts(torch.Generator().manual_seed(47), lens,
                       c.vocab_size)
    kw = dict(max_batch=4, max_seq=max_seq, page_tokens=page_tokens,
              prefill_policy=PrefillPolicy(token_budget=budget,
                                           mode="mixed"))
    # one set of weights, generated on ``dev`` and copied to the CPU, for
    # the one-device plan and the two workers' (their MLP re-laid)
    plans = (make_plan(c, 1), make_plan(c, 2, mode="page"))
    src = _moe_model(c, plans[0], 0, dev, on=dev).state_dict()

    def model_of(plan, d):
        m = Model.empty(c, plan, device=d)
        m.load_state_dict(src)
        for blk in m.layers:
            relayout_block_mlp(blk.mlp, c.d_ff, plan.max_tp, c.activation)
        return m

    streams, logits, bits = {}, {}, {}
    for d in (dev, "cpu"):
        model = model_of(plans[0], d)
        eng = Engine(c, params=model, device=d, **kw)
        streams[d, "one device, chunked"] = _drive(
            eng, [ServeRequest(p, max_new_tokens=new) for p in prompts])
        with torch.no_grad():
            long_ = torch.tensor(prompts[1], device=d)[None]
            whole = model.prefill(long_, model.init_decode_caches(
                1, max_seq, page_tokens))
            caches = model.init_decode_caches(1, max_seq, page_tokens)
            for s0 in range(0, long_.shape[1], page_tokens):
                chunked = model.prefill_chunk(
                    long_[:, s0:s0 + page_tokens],
                    torch.tensor([s0], dtype=torch.int32, device=d),
                    caches, first_chunk=s0 == 0)
        logits[d] = (whole.float().cpu(), chunked.float().cpu())
        bits[d] = bool(torch.equal(whole, chunked))
        if d == dev:
            over = _prompts(torch.Generator().manual_seed(48), (long_len,),
                            c.vocab_size)[0]
            ring = ring_whole_vs_chunked(
                model, torch.tensor(over, device=d)[None],
                long_len + page_tokens, page_tokens, min(512, c.window), new)
        del model, eng
        m2 = model_of(plans[1], d)
        eng = Engine(c, params=m2, devices=[d] * 2, **kw)
        streams[d, "TP1x2 -> TP2"] = _drive(
            eng, [ServeRequest(p, max_new_tokens=new) for p in prompts],
            before=3, plan=(2,))
        assert eng.tp == 2
        del m2, eng
    del src
    for k in ("one device, chunked", "TP1x2 -> TP2"):
        assert streams[dev, k] == streams["cpu", k], (k, streams)
    err = max((a - b).abs().max().item()
              for a, b in zip(logits[dev], logits["cpu"]))
    assert err <= RG_TOL, ("first-token logits", err)
    if dev == "cuda":
        free_card()
    emit(phase="rg-parity", model=c.name, layers=layers,
         pattern=list(c.pattern), d_model=c.d_model, dtype="float32",
         prompts=list(lens), new_tokens=new, chunk_budget=budget,
         streams_equal=True, first_token_logit_max_abs_err=err, tol=RG_TOL,
         chunked_equals_whole_bits=bits, over_window=ring,
         seconds=time.monotonic() - t0)


def rec_split(p, rows: int, tokens: int, dev: str) -> dict:
    """Device time of one recurrent mixer's parts on layer weights ``p``
    at ``rows`` rows of ``tokens`` tokens (1: a decode step): the causal
    conv, the two gate products, the scan (``rglru_step`` at one token,
    else the blocked ``rglru`` over 64-token blocks), and the whole
    mixer after its input product (``rglru_mix``: those, the gelu gate
    and ``w_out``).  The gates' bound reads their two weights and the
    input once and writes both outputs once."""
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.paged.recurrent import make_rec_state
    d = p["w_out"].shape[0]
    dt = p["w_in"].dtype
    g = torch.Generator(device=dev).manual_seed(53)
    u = torch.randn((rows, tokens, 2 * d), generator=g, device=dev).to(dt)
    st = make_rec_state(rows, d, dt, 64, device=dev)
    xb = u[..., :d].contiguous()
    xc, _ = L.causal_conv1d(xb, p["conv_w"], p["conv_b"], st.conv)
    gx, ga = xc @ p["w_gx"], xc @ p["w_ga"]

    def scan():
        if tokens == 1:
            return L.rglru_step(xc[:, 0], gx[:, 0], ga[:, 0], p["a_param"],
                                st.h)
        return L.rglru(xc, gx, ga, p["a_param"], h0=st.h, block=64)

    mode = "decode" if tokens == 1 else "chunk"
    iters = 20
    out = {"rows": rows, "tokens": tokens,
           "conv_ms": time_ms(lambda: L.causal_conv1d(
               xb, p["conv_w"], p["conv_b"], st.conv), iters, hold=20),
           "gates_ms": time_ms(lambda: (xc @ p["w_gx"], xc @ p["w_ga"]),
                               iters, hold=20),
           "scan_ms": time_ms(scan, iters, hold=20),
           "mixer_ms": time_ms(lambda: B.rglru_mix(p, u, st.clone(), mode),
                               iters, hold=20)}
    nb = nbytes(p["w_gx"], p["w_ga"], xc) + 2 * nbytes(xc)
    b_ms, b_by = bound_ms(nb, 4 * rows * tokens * d * d, dt)
    out.update(gates_bound_ms=b_ms, gates_bound_by=b_by)
    return out


def phase_rg_serve(smi: str, dev: str = "cuda", cfg=None,
                   lens=(300, 1200, 2500, 5000), new: int = 32,
                   max_seq: int = 8192, page_tokens: int = 64):
    """Full-size recurrentgemma-9b (38 layers: 26 RG-LRU, 12 local
    attention on a 2048-token ring) in bf16 with random weights on one
    device through ``Engine.step``: 4 slots of ``max_seq`` tokens,
    prompts of 300-5000 tokens (5000 chunks: the 4096-token threshold,
    then the ring's 2048).  Kernels 1-3 must launch.  Prints weights,
    TTFT, TPOT, tokens/s and peak memory, then a profiled decode step of
    4 rows at 2048 tokens (busy against wall) and the recurrent mixer's
    parts at that step's rows and at a 2048-token chunk
    (``rec_split``), times its 26 layers."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.models.model import build
    from repro_torch.serving import Engine, ServeRequest

    cfg = cfg or get_config(RG_MODEL)
    plan = make_plan(cfg, 1)
    t0 = time.monotonic()
    model = build(cfg, plan, seed=0, device=dev)
    sync(dev)
    t_init = time.monotonic() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in model.parameters()) / 1e9
    eng = Engine(cfg, params=model, max_batch=4, max_seq=max_seq,
                 page_tokens=page_tokens, device=dev)
    gen = torch.Generator().manual_seed(59)
    warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                        max_new_tokens=2)
    eng.submit(warm)
    eng.run_until_done()
    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    sync(dev)
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    sync(dev)
    wall = time.monotonic() - t0
    launches = launch_counts()
    for r in reqs:
        assert len(r.generated) == new, (len(r.prompt), len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert dev != "cuda" or all(launches[k] > 0 for k in RG_KERNELS), \
        launches
    chunked = [n for n in lens
               if len(eng.prefill_policy.chunk_sizes(n, page_tokens)) > 1]
    assert chunked, "no prompt chunked"
    n_rec = sum(1 for k in cfg.pattern if k == "rglru")
    out = {"phase": "rg-serve", "model": cfg.name, "layers": cfg.num_layers,
           "rglru_layers": n_rec, "dtype": cfg.dtype, "window": cfg.window,
           "prompts": list(lens), "chunked_prompts": chunked,
           "new_tokens": new, "weights_gb": weights_gb,
           "weights_init_s": t_init, "wall_s": wall,
           "ttft_s": [r.ttft for r in reqs], "tpot_s": [r.tpot for r in reqs],
           "tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
           "launches": launches, "gpu": smi}
    if dev == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        prof = decode_profile(eng, cfg, gen)
        p0 = eng.model.layers[0].rec
        step = rec_split(p0, 4, 1, dev)
        chunk = rec_split(p0, 1, cfg.window, dev)
        per_step = {k: step[k] * n_rec
                    for k in ("conv_ms", "gates_ms", "scan_ms", "mixer_ms")}
        busy = prof["device_busy_ms"]
        out.update(decode_step={
            "rows": 4, "context": 2048,
            "unprofiled_wall_ms": prof["unprofiled_wall_ms"],
            "profiled_wall_ms": prof["wall_ms"], "device_busy_ms": busy,
            "device_idle_share": prof["device_idle_share"],
            "attention_kernel_ms": prof["kinds_ms"].get(
                "paged decode (port)", 0.0),
            **{"rglru_" + k: v for k, v in per_step.items()},
            "shares_of_busy": {"rglru_" + k[:-3]: v / busy
                               for k, v in per_step.items()}},
            rec_split_per_layer={"decode": step, "prefill_chunk": chunk})
        emit(phase="profile", gpu=smi, model=cfg.name, **prof)
    emit(**out)
    del eng, model
    if dev == "cuda":
        free_card()
    return launches


def teacher_forced_change(base, dev: str, shorts, new: int, kw: dict,
                          layers_per_step: int, back: bool = True,
                          at_tp2: int = 6, same_degree: bool = False,
                          where=stage_of, floor=None):
    """An engine started at TP2 on two workers of ``dev`` decodes the
    prompts ``shorts`` (its rows recorded); then another at TP1x2 decodes
    them teacher forced by those rows, changes to TP2 once each request
    has a third of its ``new`` tokens, decodes ``at_tp2`` steps there
    and, with ``back``, changes to TP1x2.  Its rows are held against the
    TP2 engine's; with ``same_degree`` a third engine stays at TP1x2
    throughout, forced by the same rows, and the rows decoded at TP1x2
    (``TP1x2``, ``TP1x2 again``) are held against that engine's.
    ``where(engine)`` names the stage of each decode (``stage_of``);
    ``floor``, a dict, receives the TP1x2 engine's rows held against the
    TP2 engine's (two engines that never change).  The engines are built
    one after another.  Returns (engine, requests,
    rows held by where they ran, session reports up and down, wall s,
    launches)."""
    from repro_torch.serving import ServeRequest

    def warm(e):
        e.submit(ServeRequest(shorts[0][:70], max_new_tokens=2))
        e.run_until_done()

    want, same = {}, {}
    ref = _moe_worker_engine(base, dev, **kw)
    ref.transform(2, layers_per_step=base.num_layers)
    while ref.transforming:
        ref.step()
    ref_reqs = [ServeRequest(p, max_new_tokens=new) for p in shorts]
    record_rows(ref, ref_reqs, want)
    _drive(ref, ref_reqs)
    del ref
    if dev == "cuda":
        free_card()
    if same_degree:
        ref = _moe_worker_engine(base, dev, **kw)
        warm(ref)
        ref_reqs = [ServeRequest(p, max_new_tokens=new) for p in shorts]
        record_rows(ref, ref_reqs, same, force=want)
        _drive(ref, ref_reqs)
        assert ref.tp == 1 and not ref.transform_log
        if floor is not None:
            floor.update(held_rows(same, want, base.vocab_size)["TP1x2"])
        del ref
        if dev == "cuda":
            free_card()
    eng = _moe_worker_engine(base, dev, **kw)
    warm(eng)
    reset_launch_counts()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reqs = [ServeRequest(p, max_new_tokens=new) for p in shorts]
    got = {}
    record_rows(eng, reqs, got, force=want, where=where)
    t_run = time.monotonic()
    for r in reqs:
        eng.submit(r)
    while any(len(r.generated) < new // 3 for r in reqs):
        eng.step()
    n = []
    for tp in (2, 1)[:2 if back else 1]:
        assert all(r.slot is not None for r in reqs), "decoding throughout"
        n.append(eng.transform(tp, layers_per_step=layers_per_step))
        while eng.transforming:
            eng.step()
        assert eng.tp == tp
        for _ in range(at_tp2 if tp == 2 else 0):
            eng.step()
    eng.run_until_done()
    sync(dev)
    wall = time.monotonic() - t_run
    at1 = {k: v for k, v in got.items()
           if same_degree and v[1].startswith("TP1x2")}
    held = held_rows({k: v for k, v in got.items() if k not in at1}, want,
                     base.vocab_size)
    for h in held.values():
        h["against"] = "TP2"
    for where, h in held_rows(at1, same, base.vocab_size).items():
        held[where] = dict(h, against="TP1x2")
    assert held.get("TP2", {}).get("rows"), held
    reps = eng.transform_reports
    return (eng, reqs, held, [reps[:n[0]], reps[n[0]:]], wall,
            launch_counts())


#: rg-transform's bf16 depth: 20 of recurrentgemma's 38 layers (six
#: units and the two remainder layers, as the full model ends) since the
#: train phases came, to keep the script inside its time limit
RG_TRANSFORM_LAYERS = 20


def phase_rg_transform(smi: str, dev: str = "cuda", cfg=None,
                       max_seq: int = 8192, lens=(300, 1200, 2500, 3500),
                       new: int = 48, page_tokens: int = 64,
                       layers_per_step: int = 8, budget: int = 1024,
                       fp32_layers: int = RG_FP32_LAYERS):
    """recurrentgemma-9b at full width and ``RG_TRANSFORM_LAYERS`` layers
    in bf16 on two workers of the card,
    prompts prefilled in chunks of ``budget`` tokens: TP1x2 -> TP2 ->
    TP1x2 mid-decode (``layers_per_step`` layers a schedule step),
    every decode row held teacher forced against an engine at the same
    degree throughout (``teacher_forced_change``, ``RG_BF16_AGREE``; the
    rows before the first change take every token of the engine that
    stays at TP1x2), after the same run in fp32 at ``fp32_layers``
    layers, where every row must agree (within ``RG_FP32_TOL``).  Prints each session's
    steps, walls and exposed time, the KV-and-state bytes its kv ops
    copied, the state and pool bytes the layers hold, the weight bytes
    that crossed workers and the MLP bytes the reference accounts.
    Kernels 1-6 must launch (5-6 on the ring pools' migrations)."""
    from repro_torch.configs import get_config
    from repro_torch.core import instance as I
    from repro_torch.core import weight_transform as WT
    from repro_torch.core.scheduler import PrefillPolicy

    base = cfg or dataclasses.replace(get_config(RG_MODEL),
                                      num_layers=RG_TRANSFORM_LAYERS)
    gen = torch.Generator().manual_seed(61)
    shorts = _prompts(gen, lens, base.vocab_size)
    # a prefill budget: the longer prompts chunk on the workers
    kw = dict(max_batch=4, max_seq=max_seq, page_tokens=page_tokens,
              prefill_policy=PrefillPolicy(token_budget=budget,
                                           mode="mixed"))
    # fp32 first, at full width: every row agrees
    c32 = dataclasses.replace(base, dtype="float32",
                              num_layers=min(fp32_layers, base.num_layers))
    eng, _, held32, _, _, _ = teacher_forced_change(
        c32, dev, shorts, new, kw, layers_per_step, same_degree=True)
    del eng
    if dev == "cuda":
        free_card()
    for where, h in held32.items():
        assert h["argmax_flips"] == 0, ("fp32 rows part", where, held32)
        assert h["logit_max_abs_diff"] <= RG_FP32_TOL, (where, held32)
    eng, reqs, held, (ups, downs), wall, launches = teacher_forced_change(
        base, dev, shorts, new, kw, layers_per_step, same_degree=True)
    assert set(held) == {"TP1x2", "session", "TP2", "TP1x2 again"}, held
    assert held["TP1x2"]["argmax_flips"] == 0, held
    for where, h in held.items():
        assert h["argmax_agree"] >= RG_BF16_AGREE, (where, held)
    for r in reqs:
        assert r.done and all(0 <= t < base.vocab_size for t in r.generated)
    assert dev != "cuda" or all(launches[k] > 0
                                for k in RG_WORKER_KERNELS), launches
    state_b = sum(c.nbytes for layer in eng.layers
                  for c in layer.cache if c.recurrent)
    pool_b = sum(c.nbytes for layer in eng.layers
                 for c in layer.cache if not c.recurrent)
    sessions = []
    for log, reps in zip(eng.transform_log, (ups, downs)):
        st = WT.account_regroup(base, eng.plan, log["tp_from"],
                                log["tp_to"], "padded")
        sessions.append(dict(
            session_summary(log, reps, eng.W),
            kv_and_state_bytes=log["kv_bytes"],
            weight_bytes_across_workers=log["weight_bytes"],
            mlp_bytes_accounted=base.num_layers * (st.bytes_copied
                                                   + st.bytes_transferred),
            modeled_s=log["modeled_s"]))
    emit(phase="rg-transform", model=base.name, dtype=base.dtype,
         layers=base.num_layers, workers=eng.W, prompts=list(lens),
         new_tokens=new, layers_per_step=layers_per_step, wall_s=wall,
         sessions=sessions, state_bytes_held=state_b,
         ring_pool_bytes_held=pool_b, bf16_held=held,
         agree_bound=RG_BF16_AGREE, fp32_layers=c32.num_layers,
         fp32_held=held32, fp32_tol=RG_FP32_TOL,
         ttft_s=[r.ttft for r in reqs], tpot_s=[r.tpot for r in reqs],
         launches=launches,
         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None), gpu=smi)
    del eng
    if dev == "cuda":
        free_card()
    return launches


def phase_moe_rows_fp32(smi: str, dev: str = "cuda", cfg=None,
                        max_seq: int = 8192, lens=(300, 1200, 2500, 3500),
                        new: int = 24, page_tokens: int = 64,
                        layers_per_step: int = 8):
    """ROADMAP queue 3 item 1: moe-transform's teacher-forced row check
    in fp32 at full depth (granite-moe-3b-a800m, 32 layers, cap 1 at 4
    decode rows): TP1x2 -> TP2 mid-decode on two workers of the card,
    every row against an engine started at TP2, built first and freed
    before the other (an fp32 replica is 13.6 GB).  Every row must take
    the reference's greedy token, logits within ``MOE_FP32_TOL``; a
    failure names the stage it parted at."""
    from repro_torch.configs import get_config

    base = dataclasses.replace(cfg or get_config(MOE_MODEL),
                               dtype="float32")
    gen = torch.Generator().manual_seed(67)
    shorts = _prompts(gen, lens, base.vocab_size)
    kw = dict(max_batch=4, max_seq=max_seq, page_tokens=page_tokens)
    eng, reqs, held, (ups, _), wall, launches = teacher_forced_change(
        base, dev, shorts, new, kw, layers_per_step, back=False)
    emit(phase="moe-rows-fp32", model=base.name, dtype=base.dtype,
         layers=base.num_layers, workers=eng.W, prompts=list(lens),
         new_tokens=new, held_against_tp2=held, tol=MOE_FP32_TOL,
         session=session_summary(eng.transform_log[0], ups, eng.W),
         wall_s=wall, gpu=smi)
    for where, h in held.items():
        assert h["argmax_flips"] == 0, ("fp32 rows part", where, held)
        assert h["logit_max_abs_diff"] <= MOE_FP32_TOL, (where, held)
    del eng
    if dev == "cuda":
        free_card()


def phase_moe_spill(smi: str, dev: str = "cuda", cfg=None, **kw) -> dict:
    """``phase_cluster_spill`` on full-size granite-moe-3b-a800m in bf16:
    2 instances x 1 worker of the card (4096 tokens a worker), prompts of
    300 and 1200 tokens on both, then a 6000-token request that spills
    into the neighbour; its extended calls route their own rows.  Prints
    a decode step's wall with and without the spilled slot."""
    from repro_torch.configs import get_config
    kw = dict(dict(new=64, long_new=16), **kw)
    return phase_cluster_spill(smi, dev, cfg or get_config(MOE_MODEL),
                               label="moe-spill", **kw)


#: the serve CLI on the hybrid model: recurrentgemma-9b at published
#: widths and depth in bf16, one instance of one worker of the card
RG_CLI = ("--arch", RG_MODEL, "--no-smoke", "--instances", "1",
          "--workers", "1", "--max-seq", "8192", "--requests", "4",
          "--long-every", "2")


# ---------------------------------------------------------------------------
# slice 12: xlstm-1.3b (mLSTM and sLSTM blocks, no MLP)
# ---------------------------------------------------------------------------

XL_MODEL = "xlstm-1.3b"
#: whole-model logits and state leaves of the card against the CPU in
#: fp32 (full width, a hand-cut 3-layer depth), and a whole prompt's
#: against the same prompt chunked by pages on one device (at full width
#: the GEMMs of calls of other row counts round apart)
XL_TOL = 1e-4
#: No share of bf16 decode rows is held after a change: with random
#: weights at full depth, two bf16 engines that never change (TP1x2 and
#: TP2, the same teacher-forced tokens) agree on a few percent of their
#: greedy tokens, and one device's whole and page-chunked prefills of
#: one prompt take other first tokens: the recurrence carries each
#: rounding difference and 48 layers amplify it.  A TP change is held
#: where it is exact instead: bf16 rows at TP1x2 before the change equal
#: the TP1x2 engine's bit for bit, a session run with no decode between
#: its steps leaves every worker's state bit-equal to ``split_cache`` of
#: the global state, the TP2 pair's copies stay bit-equal, and in fp32
#: (``XL_FP32_LAYERS``) every row takes the greedy token of the engine
#: at its degree.  The bf16 rows' agreement is printed beside that of
#: the two engines that never change (``floor``).
#: xlstm-transform's fp32 run: layers at full width (two 7:1 units) and
#: the logits' tolerance against the engine at each degree
XL_FP32_LAYERS = 16
XL_FP32_TOL = 1e-3
#: xlstm-serve's and xlstm-transform's bf16 depth: 24 of xlstm-1.3b's 48
#: layers (three 7:1 units) since the train phases came, to keep
#: the script inside its time limit
XL_LAYERS = 24


def _xl_cfg(base=None, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(base or get_config(XL_MODEL), **kw)


def _leaves_err(a, b) -> float:
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(a.leaves.values(), b.leaves.values()))


def xl_whole_vs_chunked(model, prompt, page_tokens: int, steps: int) -> dict:
    """One prompt prefilled whole against the same prompt in chunks of
    one page, on one model: the first token's logits and greedy token,
    every state leaf, then ``steps`` greedy decode steps on both (each
    fed the chunked run's token).  Returns the largest differences and
    whether every greedy token agreed; the caller holds them."""
    d, S = prompt.device, prompt.shape[1]
    whole = model.init_decode_caches(1, S + steps, page_tokens)
    chunked = model.init_decode_caches(1, S + steps, page_tokens)
    with torch.no_grad():
        lw = model.prefill(prompt, whole)[:, -1]
        for s0 in range(0, S, page_tokens):
            lc = model.prefill_chunk(
                prompt[:, s0:s0 + page_tokens],
                torch.tensor([s0], dtype=torch.int32, device=d), chunked,
                first_chunk=s0 == 0)[:, -1]
        out = {"prompt": S, "chunk": page_tokens, "decode_steps": steps,
               "first_logit_max_abs_diff": float((lw - lc).abs().max()),
               "logit_rms": float(lw.float().pow(2).mean().sqrt()),
               "state_max_abs_diff": max(_leaves_err(w, c) for w, c
                                         in zip(whole, chunked))}
        errs, same = [out["first_logit_max_abs_diff"]], []
        for i in range(steps + 1):
            same.append(torch.equal(lw.argmax(-1), lc.argmax(-1)))
            if i == steps:
                break
            tok = lc.argmax(-1)
            pos = torch.tensor([S + i], dtype=torch.int32, device=d)
            lw = model.decode_step(whole, tok, pos)
            lc = model.decode_step(chunked, tok, pos)
            errs.append(float((lw - lc).abs().max()))
    return dict(out, logit_max_abs_diff=max(errs), same_tokens=all(same),
                same_first_token=same[0])


def phase_xl_parity(dev: str = "cuda", cfg=None, lens=(40, 300, 150),
                    new: int = 8, max_seq: int = 512, page_tokens: int = 64,
                    budget: int = 128):
    """xlstm-1.3b at full width, a hand-cut depth of 3 layers ``(MLSTM,
    MLSTM, SLSTM)``, fp32: the same weights and prompts on ``dev`` and
    on the CPU.  One device with budgeted chunked prefill (the carry from
    chunk to chunk, restored over the decode filler; the 300-token prompt
    runs in chunks of 128 + 128 + 44), and two workers changed TP1x2 ->
    TP2 while a prompt is mid-chunk and others decode: greedy streams
    equal.  Then on each device the 300-token prompt whole (one call:
    the reference's ``mlstm_chunkwise`` refuses it) against the same
    prompt in chunks of one page (``xl_whole_vs_chunked``: the same
    tokens, logits and state within ``XL_TOL``), whose first-token
    logits must also agree across the devices within ``XL_TOL``."""
    from repro_torch.configs.base import MLSTM, SLSTM
    from repro_torch.core.padding import make_plan
    from repro_torch.core.scheduler import PrefillPolicy
    from repro_torch.models.model import Model
    from repro_torch.serving import Engine, ServeRequest

    t0 = time.monotonic()
    c = _xl_cfg(cfg, num_layers=3, layer_pattern=(MLSTM, MLSTM, SLSTM),
                dtype="float32")
    prompts = _prompts(torch.Generator().manual_seed(71), lens,
                       c.vocab_size)
    kw = dict(max_batch=4, max_seq=max_seq, page_tokens=page_tokens,
              prefill_policy=PrefillPolicy(token_budget=budget,
                                           mode="mixed"))
    # one set of weights a plan (a plan of 2 pads the vocabulary),
    # generated on ``dev`` and copied to the CPU
    plans = (make_plan(c, 1), make_plan(c, 2, mode="page"))
    src = [_moe_model(c, p, 0, dev, on=dev).state_dict() for p in plans]

    def model_of(i, d):
        m = Model.empty(c, plans[i], device=d)
        m.load_state_dict(src[i])
        return m

    streams, firsts, wvc = {}, {}, {}
    for d in (dev, "cpu"):
        model = model_of(0, d)
        eng = Engine(c, params=model, device=d, **kw)
        streams[d, "one device, chunked"] = _drive(
            eng, [ServeRequest(p, max_new_tokens=new) for p in prompts])
        long_ = torch.tensor(prompts[1], device=d)[None]
        with torch.no_grad():
            firsts[d] = model.prefill(long_, model.init_decode_caches(
                1, max_seq, page_tokens)).float().cpu()
        wvc[d] = xl_whole_vs_chunked(model, long_, page_tokens, new)
        assert wvc[d]["same_tokens"], wvc
        assert wvc[d]["logit_max_abs_diff"] <= XL_TOL, wvc
        assert wvc[d]["state_max_abs_diff"] <= XL_TOL, wvc
        del model, eng
        eng = Engine(c, params=model_of(1, d), devices=[d] * 2, **kw)
        streams[d, "TP1x2 -> TP2"] = _drive(
            eng, [ServeRequest(p, max_new_tokens=new) for p in prompts],
            before=3, plan=(2,))
        assert eng.tp == 2
        del eng
    del src
    for k in ("one device, chunked", "TP1x2 -> TP2"):
        assert streams[dev, k] == streams["cpu", k], (k, streams)
    err = float((firsts[dev] - firsts["cpu"]).abs().max())
    assert err <= XL_TOL, ("whole 300-token prompt's logits", err)
    if dev == "cuda":
        free_card()
    emit(phase="xlstm-parity", model=c.name, layers=c.num_layers,
         pattern=list(c.pattern), d_model=c.d_model, dtype="float32",
         prompts=list(lens), new_tokens=new, chunk_budget=budget,
         streams_equal=True, whole_300_logit_max_abs_err=err, tol=XL_TOL,
         whole_vs_chunked={str(k): v for k, v in wvc.items()},
         seconds=time.monotonic() - t0)


def xl_split(pm, ps, rows: int, tokens: int, dev: str) -> dict:
    """Device time (CUDA events, the card held ahead of the host) of the
    xLSTM mixers' parts on layer weights ``pm`` (an MLSTM layer's) and
    ``ps`` (an SLSTM layer's), at ``rows`` rows of one token (a decode
    step: ``mlstm_step`` updating ``C`` and ``n`` in place,
    ``slstm_step``, and each whole mixer after the norm) or one row of
    ``tokens`` tokens (a prefill chunk: ``mlstm_chunkwise`` in 64-token
    blocks from a carried state, the ``slstm_seq`` scan).  The sLSTM
    scan's host wall a call is beside its device time.  The mLSTM parts'
    bound reads and writes the state once, and reads q, k, v and writes
    h once; a chunk's also counts its fp32 products."""
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.paged.recurrent import (make_mlstm_state,
                                             make_slstm_state)
    H = pm["w_if"].shape[1] // 2
    up, d = pm["wq"].shape[1], ps["w_out"].shape[0]
    dh = up // H
    dt = pm["wq"].dtype
    g = torch.Generator(device=dev).manual_seed(73)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    decode = tokens == 1
    R, S = (rows, 1) if decode else (1, tokens)
    h = rnd(R, S, d) * 0.5
    mst = make_mlstm_state(R, H, dh, 64, device=dev)
    sst = make_slstm_state(R, d, 64, device=dev)
    u = B.rec_project("mlstm", pm, h)
    q, k, v = (u[..., j, :].reshape(R, S, H, dh).contiguous()
               for j in range(3))
    gif = h @ pm["w_if"]
    ig, fg = gif[..., :H].contiguous(), gif[..., H:].contiguous()
    zifo = (h @ ps["w_zifo"]).reshape(R, S, 4, d)
    leaves = (mst.C, mst.n, mst.m)
    if decode:
        mcell = (lambda: L.mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                      fg[:, 0], leaves, out=leaves))
        zs, r = zifo[:, 0].float(), ps["r_diag"].float()
        st = tuple(sst.leaves[n] for n in "cnmh")
        scell = lambda: L.slstm_step(zs, r, st)
        mode = "decode"
    else:
        mcell = (lambda: L.mlstm_chunkwise(q, k, v, ig, fg, state=leaves,
                                           block=64))
        scell = lambda: L.slstm_seq(zifo, ps["r_diag"], state=tuple(
            sst.leaves[n] for n in "cnmh"))
        mode = "chunk"
    scell()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    scell()
    torch.cuda.synchronize()
    s_host = time.monotonic() - t0
    iters = 10 if decode else 3
    # the card held three times as long as the host takes to enqueue
    hold = max(20, int(s_host * 3e4) + 1)
    out = {"rows": R, "tokens": S,
           "mlstm_cell_ms": time_ms(mcell, iters, hold=20),
           "slstm_cell_ms": time_ms(scell, iters, hold=hold),
           "slstm_cell_host_ms": s_host * 1e3,
           "mlstm_mixer_ms": time_ms(lambda: B.rec_mix(
               "mlstm", pm, B.rec_project("mlstm", pm, h), h, mst, mode),
               iters, hold=20),
           "slstm_mixer_ms": time_ms(lambda: B.rec_mix(
               "slstm", ps, B.rec_project("slstm", ps, h), h, sst, mode),
               iters, hold=hold)}
    state_b = nbytes(mst.C, mst.n, mst.m)
    flops = 0 if decode else 4 * H * S * dh * dh + 4 * H * S * 64 * dh
    b_ms, b_by = bound_ms(2 * state_b + nbytes(q, k, v) + nbytes(q), flops,
                          torch.float32)
    out.update(mlstm_cell_bound_ms=b_ms, mlstm_cell_bound_by=b_by,
               mlstm_state_bytes=state_b)
    return out


def phase_xl_serve(smi: str, dev: str = "cuda", cfg=None,
                   lens=(256, 600, 1300, 2500), new: int = 32,
                   max_seq: int = 4096, page_tokens: int = 64,
                   budget: int = 1024):
    """xlstm-1.3b at full width and ``XL_LAYERS`` layers (of 48: 42
    mLSTM, 6 sLSTM, no MLP) in bf16 with random weights on one device
    through ``Engine.step``: 4
    slots, prompts of 256-2500 tokens (600, 1300 and 2500 are not
    multiples of 256), prefilled in chunks of ``budget`` tokens.  It
    runs none of kernels 1-6 (no attention, no MLP; the mixers are plain
    PyTorch, as the reference's are plain ``jnp``): their launches stay
    0.  Prints weights, state bytes, TTFT, TPOT, tokens/s and peak
    memory, a profiled decode step of 4 rows (busy against wall) and
    the mixers' parts a layer at that step and at a ``budget``-token
    chunk (``xl_split``), times the layers of each kind."""
    from repro_torch.core.padding import make_plan
    from repro_torch.core.scheduler import PrefillPolicy
    from repro_torch.models.model import build
    from repro_torch.serving import Engine, ServeRequest

    cfg = cfg or _xl_cfg(num_layers=XL_LAYERS)
    plan = make_plan(cfg, 1)
    t0 = time.monotonic()
    model = build(cfg, plan, seed=0, device=dev)
    sync(dev)
    t_init = time.monotonic() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in model.parameters()) / 1e9
    eng = Engine(cfg, params=model, max_batch=4, max_seq=max_seq,
                 page_tokens=page_tokens, device=dev,
                 prefill_policy=PrefillPolicy(token_budget=budget,
                                              mode="mixed"))
    state_gb = sum(c.nbytes for c in eng.caches) / 1e9
    gen = torch.Generator().manual_seed(79)
    warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                        max_new_tokens=2)
    eng.submit(warm)
    eng.run_until_done()
    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    sync(dev)
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    sync(dev)
    wall = time.monotonic() - t0
    launches = launch_counts()
    for r in reqs:
        assert len(r.generated) == new, (len(r.prompt), len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    assert not any(launches.values()), launches
    chunked = [n for n in lens
               if len(eng.prefill_policy.chunk_sizes(n, page_tokens)) > 1]
    assert chunked, "no prompt chunked"
    n_m = sum(1 for k in cfg.pattern if k == "mlstm")
    n_s = cfg.num_layers - n_m
    out = {"phase": "xlstm-serve", "model": cfg.name,
           "layers": cfg.num_layers, "mlstm_layers": n_m,
           "slstm_layers": n_s, "dtype": cfg.dtype,
           "prompts": list(lens), "chunk": budget,
           "chunked_prompts": chunked, "new_tokens": new,
           "weights_gb": weights_gb, "state_gb_4_slots": state_gb,
           "weights_init_s": t_init, "wall_s": wall,
           "ttft_s": [r.ttft for r in reqs], "tpot_s": [r.tpot for r in reqs],
           "tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
           "launches": launches, "gpu": smi}
    if dev == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # the state is O(1) a slot: a short context decodes as a long one
        prof_reqs = [ServeRequest(p, max_new_tokens=24)
                     for p in _prompts(gen, (64,) * 4, cfg.vocab_size)]
        for r in prof_reqs:
            eng.submit(r)
        while any(len(r.generated) == 0 for r in prof_reqs):
            eng.step()
        prof = profile_steps(eng, 8)
        eng.run_until_done()
        pm = eng.model.layers[0].rec
        ps = eng.model.layers[cfg.pattern.index("slstm")].rec
        step = xl_split(pm, ps, 4, 1, dev)
        chunk = xl_split(pm, ps, 1, budget, dev)
        # two correct bf16 computations of one prompt at full depth:
        # printed, not held (the note above ``XL_FP32_LAYERS``)
        out["bf16_whole_vs_chunked"] = xl_whole_vs_chunked(
            eng.model, torch.tensor(_prompts(gen, (budget,),
                                             cfg.vocab_size)[0],
                                    device=dev)[None], page_tokens, 0)
        per_step = {"mlstm_mixer_ms": step["mlstm_mixer_ms"] * n_m,
                    "mlstm_cell_ms": step["mlstm_cell_ms"] * n_m,
                    "slstm_mixer_ms": step["slstm_mixer_ms"] * n_s,
                    "mlstm_cell_bound_ms": step["mlstm_cell_bound_ms"] * n_m}
        busy = prof["device_busy_ms"]
        out.update(decode_step={
            "rows": 4, "unprofiled_wall_ms": prof["unprofiled_wall_ms"],
            "profiled_wall_ms": prof["wall_ms"], "device_busy_ms": busy,
            "device_idle_share": prof["device_idle_share"],
            **per_step, "shares_of_busy": {
                k[:-3]: v / busy for k, v in per_step.items()}},
            split_per_layer={"decode": step, "prefill_chunk": chunk})
        emit(phase="profile", gpu=smi, model=cfg.name, what="decode step",
             batch=4, **prof)
    emit(**out)
    del eng, model
    if dev == "cuda":
        free_card()
    return launches


def _state_rows_bytes(eng) -> list:
    """Recurrent state bytes each worker holds."""
    return [sum(layer.cache[w].nbytes for layer in eng.layers)
            for w in range(eng.W)]


def _mixer_bytes(eng) -> list:
    """Mixer weight bytes each worker holds."""
    return [sum(t.numel() * t.element_size() for layer in eng.layers
                for t in layer.attn[w].values()) for w in range(eng.W)]


def xl_exact_moves(eng, gen, vocab: int, new: int = 8) -> dict:
    """TP1x2 -> TP2 -> TP1x2 on a worker engine whose four slots hold
    decoding requests, each session run step by step with no decode
    between its steps: after each, every worker's state equals
    ``split_cache`` of the global state taken before it, bit for bit (at
    TP2 both workers hold every row).  Returns the sessions' state bytes
    copied."""
    from repro_torch.core import instance as I
    from repro_torch.launch.mesh import Layout
    from repro_torch.serving import ServeRequest
    reqs = [ServeRequest(p, max_new_tokens=new)
            for p in _prompts(gen, (64, 96, 128, 80), vocab)]
    for r in reqs:
        eng.submit(r)
    while any(len(r.generated) < 2 for r in reqs):
        eng.step()
    moved = []
    for tp in (2, 1):
        before = eng.global_caches()
        eng.transform(tp, layers_per_step=eng.cfg.num_layers)
        while not eng._session.done:
            eng._session.step()
        eng._finish_transform()
        moved.append(eng.transform_log[-1]["kv_bytes"])
        for layer, g in zip(eng.layers, before):
            want = I.split_cache(g, Layout(1, tp), layer.mesh.devices)
            for got, w in zip(layer.cache, want):
                for k in got.leaves:
                    assert torch.equal(got.leaves[k], w.leaves[k]), (
                        "moved state", tp, layer.kind, k)
    eng.run_until_done()
    return {"sessions": ["TP1x2 -> TP2", "TP2 -> TP1x2"],
            "state_bytes_copied": moved, "bit_equal": True}


def phase_xl_transform(smi: str, dev: str = "cuda", cfg=None,
                       max_seq: int = 4096, lens=(256, 600, 1300, 2500),
                       new: int = 48, page_tokens: int = 64,
                       layers_per_step: int = 8, budget: int = 1024,
                       fp32_layers: int = XL_FP32_LAYERS):
    """xlstm-1.3b at full width and ``XL_LAYERS`` layers in bf16 on two
    workers of the card, prompts
    prefilled in chunks of ``budget`` tokens: TP1x2 -> TP2 -> TP1x2
    mid-decode (``layers_per_step`` layers a schedule step: the
    reference's schedule, whose MLP steps move nothing here), every
    decode row recorded teacher forced beside an engine at the same
    degree throughout (``teacher_forced_change``): the rows before the
    first change take every token of the engine that stays at TP1x2
    with the same logits, bit for bit; the rest are printed beside the
    agreement of two engines that never change (see the note above
    ``XL_FP32_LAYERS``).  Before it, the same run in fp32 at
    ``fp32_layers`` layers, where every row must agree (within
    ``XL_FP32_TOL``).  At TP2 the state is replicated over the pair, as
    the reference places it, and the two copies must be the same bits;
    after the run, ``xl_exact_moves``.  Prints each session's steps,
    walls and blocked time, the state bytes its kv ops copied against
    the least (each worker's missing rows read and written once), the
    state and mixer-weight bytes each worker holds at each degree.
    Kernels 1-6 stay at 0 launches."""
    from repro_torch.core.scheduler import PrefillPolicy

    base = cfg or _xl_cfg(num_layers=XL_LAYERS)
    gen = torch.Generator().manual_seed(83)
    shorts = _prompts(gen, lens, base.vocab_size)
    kw = dict(max_batch=4, max_seq=max_seq, page_tokens=page_tokens,
              prefill_policy=PrefillPolicy(token_budget=budget,
                                           mode="mixed"))
    c32 = dataclasses.replace(base, dtype="float32",
                              num_layers=min(fp32_layers, base.num_layers))
    eng, _, held32, _, _, _ = teacher_forced_change(
        c32, dev, shorts, new, kw, layers_per_step, same_degree=True)
    del eng
    if dev == "cuda":
        free_card()
    for where, h in held32.items():
        assert h["argmax_flips"] == 0, ("fp32 rows part", where, held32)
        assert h["logit_max_abs_diff"] <= XL_FP32_TOL, (where, held32)
    held_at = {}

    def watch(e):
        # the bytes each worker holds at each degree, and the TP2 pair's
        # state copies, read once the engine lands at TP2
        if e.tp == 2 and not e.transforming and "TP2" not in held_at:
            held_at["TP2"] = {"state": _state_rows_bytes(e),
                              "mixer": _mixer_bytes(e)}
            for layer in e.layers:
                a, b = layer.cache
                for k in a.leaves:
                    assert torch.equal(a.leaves[k], b.leaves[k]), (
                        "replicated state parts", layer.kind, k)
        return stage_of(e)

    floor = {}
    eng, reqs, held, (ups, downs), wall, launches = teacher_forced_change(
        base, dev, shorts, new, kw, layers_per_step, same_degree=True,
        where=watch, floor=floor)
    assert set(held) == {"TP1x2", "session", "TP2", "TP1x2 again"}, held
    assert held["TP1x2"]["argmax_flips"] == 0, held
    assert held["TP1x2"]["logit_max_abs_diff"] == 0.0, held
    for r in reqs:
        assert r.done and all(0 <= t < base.vocab_size for t in r.generated)
    assert not any(launches.values()), launches
    assert "TP2" in held_at, "no decode step at TP2"
    held_at["TP1x2"] = {"state": _state_rows_bytes(eng),
                        "mixer": _mixer_bytes(eng)}
    exact = xl_exact_moves(eng, gen, base.vocab_size)
    global_state = sum(held_at["TP1x2"]["state"])
    sessions = []
    for log, reps in zip(eng.transform_log, (ups, downs)):
        up = log["tp_to"] > log["tp_from"]
        sessions.append({
            "tp_from": log["tp_from"], "tp_to": log["tp_to"],
            "steps": log["steps"],
            "mlp_steps": sum(1 for r in reps if r.ops[0].component == "mlp"
                             and len({o.component for o in r.ops}) == 1),
            "wall_s": log["wall_s"], "sum_seconds": log["measured_s"],
            "sum_blocked_s": log["exposed_s"],
            "sum_modeled_s": log["modeled_s"],
            "state_bytes_copied": log["kv_bytes"],
            # a scale-up: each of the two workers reads and writes the
            # half of the state it lacks; a scale-down keeps a slice of
            # its own
            "state_bytes_least": 2 * global_state if up else 0,
            "weight_bytes_across_workers": log["weight_bytes"],
            "step_seconds_max": max(r.seconds for r in reps),
            "step_blocked_s_max": max(r.blocked_s for r in reps)})
    emit(phase="xlstm-transform", model=base.name, dtype=base.dtype,
         layers=base.num_layers, workers=eng.W, prompts=list(lens),
         chunk=budget, new_tokens=new, layers_per_step=layers_per_step,
         wall_s=wall, sessions=sessions, bytes_held_per_worker=held_at,
         bf16_held=held, bf16_floor=floor,
         exact_moves=exact,
         fp32_layers=c32.num_layers, fp32_held=held32, fp32_tol=XL_FP32_TOL,
         ttft_s=[r.ttft for r in reqs], tpot_s=[r.tpot for r in reqs],
         launches=launches,
         peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                      if dev == "cuda" else None), gpu=smi)
    del eng
    if dev == "cuda":
        free_card()
    return launches


#: the serve CLI on xLSTM: xlstm-1.3b at published widths and depth in
#: bf16, one instance of one worker of the card
XL_CLI = ("--model", XL_MODEL, "--no-smoke", "--instances", "1",
          "--workers", "1", "--max-seq", "2048", "--requests", "4",
          "--long-every", "2")


# ---------------------------------------------------------------------------
# Slice 13: whisper-tiny (encoder, cross-attention), phi-3-vision (patches)
# ---------------------------------------------------------------------------

ENC_MODEL = "whisper-tiny"
VLM_MODEL = "phi-3-vision-4.2b"
#: first-token logits of the card against the CPU in fp32 (full width)
ENC_TOL = 1e-4
#: whisper's decoder holds 448 positions (its text context)
WHISPER_CTX = 448


def enc_cases():
    """The kernel shapes of slice 13's phases: whisper's encoder (the
    flash kernel's bidirectional branch over 1500 frames, Hq 6, kvs 6,
    dh 64: 1500 = 23 * 64 + 28, so the last key tile is ragged), its
    decoder's causal flash at the longest whisper-serve prompt and its
    paged decode at whisper-serve's shape.  phi-3-vision's (dh 96) are
    ``head_shape_cases``' flash and decode."""
    h = dict(Hq=6, kvs=6, dh=64)
    return [(ENC_MODEL, case_flash, dict(S=1500, causal=False, **h)),
            (ENC_MODEL, case_flash, dict(S=224, **h)),
            (ENC_MODEL, case_decode, dict(B=4, ctx=288, cap=WHISPER_CTX,
                                          **h))]


def _front_requests(cfg, gen, lens, new):
    """Requests of ``lens`` tokens with their stub inputs (float32 host
    tensors from ``gen``): every whisper request its frames (F, d),
    every other phi-3-vision request (from the first) its patches (P,
    d), the rest text only."""
    from repro_torch.serving import ServeRequest
    reqs = []
    for i, p in enumerate(_prompts(gen, lens, cfg.vocab_size)):
        kw = {}
        if cfg.encoder is not None:
            kw["frames"] = torch.randn((cfg.encoder.num_frames, cfg.d_model),
                                       generator=gen)
        if cfg.vision is not None and i % 2 == 0:
            kw["patches"] = torch.randn((cfg.vision.num_patches,
                                         cfg.d_model), generator=gen)
        reqs.append(ServeRequest(p, max_new_tokens=new, **kw))
    return reqs


def _first_logits(model, req, max_seq: int, page_tokens: int):
    """The first token's logits of one request, prefilled whole on a
    fresh batch-1 cache of ``model``'s device."""
    d = model.device
    with torch.no_grad():
        return model.prefill(
            torch.tensor(req.prompt, device=d)[None],
            model.init_decode_caches(1, max_seq, page_tokens),
            frames=None if req.frames is None else req.frames.to(d)[None],
            patches=None if req.patches is None
            else req.patches.to(d)[None],
            cross=model.init_cross_cache(1)).float().cpu()


def _enc_models(c, plan, dev: str):
    """One set of weights from seed 0, built on ``dev`` (the card) and
    copied to the CPU: (model on dev, model on the CPU)."""
    from repro_torch.models.model import Model, build
    m = build(c, plan, seed=0, device=dev)
    cpu = Model.empty(c, plan, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    return m, cpu


def phase_enc_parity(dev: str = "cuda", cfgs=None, lens=(4, 60, 200),
                     new: int = 16, vlm_layers: int = 3,
                     page_tokens: int = 64):
    """whisper-tiny at full width and depth (4 encoder and 4 decoder
    layers, 1500 frames) and phi-3-vision-4.2b at full width and
    ``vlm_layers`` layers (or ``cfgs``), fp32, the same weights and
    requests on ``dev`` and on the CPU through ``Engine``: 3 requests of
    ``lens`` tokens, each whisper request with its own frames, the first
    and third phi-3-vision requests with 576 patches and the second text
    only; ``new`` greedy tokens each.  Streams must be equal and every
    request's first-token logits within ``ENC_TOL``."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.serving import Engine

    t0 = time.monotonic()
    out = {}
    cfgs = cfgs or (get_config(ENC_MODEL), dataclasses.replace(
        get_config(VLM_MODEL), num_layers=vlm_layers))
    for c in cfgs:
        c, name = dataclasses.replace(c, dtype="float32"), c.name
        plan = make_plan(c, 1)
        max_seq = WHISPER_CTX if c.encoder is not None else 1024
        models = dict(zip((dev, "cpu"), _enc_models(c, plan, dev)))
        reqs = {d: _front_requests(c, torch.Generator().manual_seed(83),
                                   lens, new) for d in (dev, "cpu")}
        streams, firsts = {}, {}
        for d, model in models.items():
            eng = Engine(c, params=model, max_batch=4, max_seq=max_seq,
                         page_tokens=page_tokens, device=d)
            streams[d] = _drive(eng, reqs[d])
            firsts[d] = [_first_logits(model, r, max_seq, page_tokens)
                         for r in reqs[d]]
            del eng
        assert streams[dev] == streams["cpu"], (name, streams)
        err = max(float((a - b).abs().max())
                  for a, b in zip(firsts[dev], firsts["cpu"]))
        assert err <= ENC_TOL, (name, "first-token logits", err)
        out[name] = {"layers": c.num_layers, "d_model": c.d_model,
                     "patches": [r.n_patches for r in reqs[dev]],
                     "frames": (None if c.encoder is None
                                else c.encoder.num_frames),
                     "streams_equal": True,
                     "first_token_logit_max_abs_err": err}
        del models
        if dev == "cuda":
            free_card()
    emit(phase="enc-parity", dtype="float32", prompts=list(lens),
         new_tokens=new, tol=ENC_TOL, models=out,
         seconds=time.monotonic() - t0)


def encoder_cost(cfg, plan) -> tuple:
    """(bytes, FLOPs) of encoding one request: the frontend, the
    encoder's weights and the cross K/V weights read once, the frames
    read and every group's K/V written once; the products of
    ``frame_proj``, each layer's q/k/v/o, bidirectional attention over
    every frame pair and MLP, and the cross K/V."""
    F, d, ff = cfg.encoder.num_frames, cfg.d_model, plan.d_ff_padded
    Hq, kvs, dh = plan.q_heads_padded, plan.kv_slots, cfg.resolved_head_dim
    L, G = cfg.encoder.num_layers, cfg.num_layers
    layer_w = d * (Hq + 2 * kvs) * dh + Hq * dh * d + 2 * d * ff
    weights = d * d + L * layer_w + G * 2 * d * kvs * dh
    flops = (2 * F * d * d + L * (2 * F * layer_w + 4 * F * F * Hq * dh)
             + G * 2 * F * d * 2 * kvs * dh)
    el = 2 if cfg.dtype == "bfloat16" else 4
    byt = weights * el + F * d * 4 + G * 2 * F * kvs * dh * el
    return byt, flops


def held_ms(fn, iters: int = 2) -> tuple:
    """(device ms, host ms) of a call of ``fn``, a chain of a hundred or
    more small launches: the host time of one call is measured first,
    and the card is held (``hold_card``) well past the host's time to
    enqueue ``iters`` calls, so the events time the card's own work.
    ``iters`` stays small: CUDA queues about a thousand launches ahead
    of the card and then makes the host wait, so longer chains would
    time the host's launch rate again."""
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    host_ms = (time.monotonic() - t0) * 1e3
    torch.cuda.synchronize()
    # hold_card(n) sleeps about 0.11 ms a unit on an H100's clock
    return time_ms(fn, iters, hold=int(30 * host_ms) + 1), host_ms


def enc_split(model, frames, rows: int, dev: str) -> dict:
    """Device time (CUDA events, the card held ahead of the host:
    ``held_ms``) and host time of one request's encoding
    (``run_encoder`` and ``encode_cross_kv``) beside its bound, and of
    every group's cross-attention at a decode step of ``rows`` rows
    (plain PyTorch: no TPU kernel computes it)."""
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    cfg, plan = model.cfg, model.plan
    st = model.static()
    f = frames.to(dev)[None]

    def encode():
        return M.encode_cross_kv(st["cross"], cfg, plan,
                                 M.run_encoder(st["encoder"], cfg, plan, f))

    cross = model.init_cross_cache(rows)
    x = torch.randn((rows, 1, cfg.d_model), device=dev).to(model.embed.dtype)

    def cross_step():
        for g, p in enumerate(st["cross"]):
            B.cross_attention(p, x, cfg, plan, cross.k[g], cross.v[g])

    with torch.no_grad():
        ms, host = held_ms(encode)
        cross_ms, cross_host = held_ms(cross_step)
    byt, flops = encoder_cost(cfg, plan)
    bms, by = bound_ms(byt, flops, model.embed.dtype)
    return {"encoder_ms_a_request": ms, "encoder_host_ms": host,
            "encoder_bound_ms": bms, "encoder_bound_by": by,
            "encoder_gflop": flops / 1e9,
            "cross_attention_ms_a_decode_step": cross_ms,
            "cross_attention_host_ms": cross_host,
            "cross_attention_rows": rows}


def enc_launch_counts() -> dict:
    """``launch_counts`` and, of the flash launches, the bidirectional
    branch's (an encoder's)."""
    from repro_torch.kernels import flash_attention as FA
    return {**launch_counts(),
            "flash_attention_bidirectional": FA.bidirectional_launches}


def _serve_run(eng, reqs, dev: str) -> float:
    """Submit ``reqs``, run the engine until it drains; the wall."""
    reset_launch_counts()
    sync(dev)
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    sync(dev)
    return time.monotonic() - t0


def _front_profile(eng, cfg, gen, lens, steps: int = 8) -> dict:
    """``profile_steps`` over a full batch (one request a slot, with
    its stub inputs), decoding after every prompt's first token."""
    reqs = _front_requests(cfg, gen, lens, 2 * steps + 4)
    for r in reqs:
        eng.submit(r)
    while any(len(r.generated) == 0 for r in reqs):
        eng.step()
    out = profile_steps(eng, steps)
    eng.run_until_done()
    return out


def _front_serve(smi: str, dev: str, cfg, phase: str, lens, new: int,
                 max_seq: int, page_tokens: int, seed: int, prof_len: int,
                 check, fields) -> dict:
    """One frontend model at full size in bf16 with random weights on
    one device through ``Engine.step``: 4 slots of ``max_seq`` tokens,
    a warm-up request, then one request a prompt length of ``lens``
    (whole prompts with their stub inputs; more requests than slots, so
    slots are reused), ``new`` greedy tokens each.  On the card
    ``check(launches)`` holds the launches, and a profiled decode step
    of 4 rows (prompts of ``prof_len``) is printed beside its bound (the
    weights read once).  ``fields(eng, model, reqs)`` adds the model's
    own numbers.  Prints weights, TTFT, TPOT, tokens/s, peak memory and
    the launches; returns the launches."""
    from repro_torch.core.padding import make_plan
    from repro_torch.models.model import build
    from repro_torch.serving import Engine

    plan = make_plan(cfg, 1)
    t0 = time.monotonic()
    model = build(cfg, plan, seed=0, device=dev)
    sync(dev)
    t_init = time.monotonic() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in model.parameters()) / 1e9
    eng = Engine(cfg, params=model, max_batch=4, max_seq=max_seq,
                 page_tokens=page_tokens, device=dev)
    gen = torch.Generator().manual_seed(seed)
    eng.submit(_front_requests(cfg, gen, (16,), 2)[0])
    eng.run_until_done()
    reqs = _front_requests(cfg, gen, lens, new)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    wall = _serve_run(eng, reqs, dev)
    launches = enc_launch_counts()
    for r in reqs:
        assert len(r.generated) == new, (len(r.prompt), len(r.generated))
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    if dev == "cuda":
        check(launches)
    out = {"phase": phase, "model": cfg.name, "dtype": cfg.dtype,
           "prompts": list(lens), "new_tokens": new,
           "slots": eng.max_batch, "max_seq": max_seq,
           "weights_gb": weights_gb, "weights_init_s": t_init,
           "wall_s": wall,
           "ttft_s": [r.ttft for r in reqs], "tpot_s": [r.tpot for r in reqs],
           "tokens_per_s": sum(len(r.generated) for r in reqs) / wall,
           "launches": launches, "gpu": smi}
    if dev == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        prof = _front_profile(eng, cfg, gen, (prof_len,) * 4)
        out["decode_step"] = {
            "rows": 4, "unprofiled_wall_ms": prof["unprofiled_wall_ms"],
            "profiled_wall_ms": prof["wall_ms"],
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "weights_read_bound_ms": weights_gb * 1e9 / HBM_BPS * 1e3}
        emit(phase="profile", gpu=smi, model=cfg.name, what="decode step",
             batch=4, **prof)
    out.update(fields(eng, model, reqs))
    emit(**out)
    del eng, model
    if dev == "cuda":
        free_card()
    return launches


def phase_whisper_serve(smi: str, dev: str = "cuda", cfg=None,
                        lens=(4, 32, 64, 96, 128, 160, 192, 224),
                        new: int = 64, page_tokens: int = 64):
    """Full-size whisper-tiny (4 encoder and 4 decoder layers, d 384,
    vocab 51865) through ``_front_serve``: slots of ``WHISPER_CTX``
    tokens, 8 requests with 1500 frames each and prompts of 4-224
    tokens.  Each request's encoder runs the flash kernel's
    bidirectional branch, its decoder prefill the causal one and its
    decode the paged decode kernel: those launches must rise.  Adds
    cross K/V bytes a slot and, on the card, one request's encoding
    against its bound and a decode step's cross-attention
    (``enc_split``)."""
    from repro_torch.configs import get_config

    cfg = cfg or get_config(ENC_MODEL)
    L = cfg.encoder.num_layers

    def check(launches):
        assert launches["flash_attention_bidirectional"] == L * len(lens), (
            launches)
        assert launches["flash_attention"] == (L + cfg.num_layers) * len(
            lens), launches
        assert launches["paged_attention"] > 0, launches

    def fields(eng, model, reqs):
        out = {"encoder_layers": L, "decoder_layers": cfg.num_layers,
               "frames": cfg.encoder.num_frames,
               "cross_kv_bytes_a_slot": eng.cross.nbytes // eng.max_batch}
        if dev == "cuda":
            out["split"] = enc_split(model, reqs[0].frames, 4, dev)
        return out

    return _front_serve(smi, dev, cfg, "whisper-serve", lens, new,
                        WHISPER_CTX, page_tokens, 89, 64, check, fields)


def phase_vlm_serve(smi: str, dev: str = "cuda", cfg=None,
                    lens=(64, 2048, 512, 1024, 1536, 256, 768, 128),
                    new: int = 64, max_seq: int = 4096,
                    page_tokens: int = 64):
    """Full-size phi-3-vision-4.2b (32 layers, d 3072, 32 heads of 96,
    vocab 32064, an untied head) through ``_front_serve``: slots of
    ``max_seq`` tokens, 8 requests of 64-2048 tokens, the first, third,
    fifth and seventh with 576 patches before their prompt, the rest
    text only (the reference's engine never chunks such a model).
    Kernels 1 and 3 must launch, the bidirectional branch never.  Adds
    KV bytes a token and the pools' bytes."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import kv_bytes_per_token

    cfg = cfg or get_config(VLM_MODEL)

    def check(launches):
        assert launches["flash_attention"] == cfg.num_layers * len(lens), (
            launches)
        assert launches["paged_attention"] > 0, launches
        assert launches["flash_attention_bidirectional"] == 0, launches

    def fields(eng, model, reqs):
        return {"layers": cfg.num_layers,
                "patches": [r.n_patches for r in reqs],
                "kv_bytes_a_token": kv_bytes_per_token(cfg),
                "kv_gb_4_slots": sum(c.nbytes for c in eng.caches) / 1e9}

    return _front_serve(smi, dev, cfg, "vlm-serve", lens, new, max_seq,
                        page_tokens, 97, 512, check, fields)


def phase_enc_workers(dev: str = "cuda", cfgs=None, lens=(4, 60, 200),
                      new: int = 8, layers: int = 2, page_tokens: int = 64):
    """Both models on two workers at TP1x2 (each worker its own slots,
    the encoder, cross-attention weights and ``vision_proj`` whole on
    both, each worker's cross memory its own slots'), fp32 at full width
    and ``layers`` layers (whisper also ``layers`` encoder layers): the
    streams of the card's worker engine equal the CPU's worker engine
    and the card's one-device engine on the same weights, and
    ``transform(2)`` raises ``NotImplementedError`` (the reference has
    no per-layer path for these models).  ``cfgs``: other configs (a dry
    run)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import EncoderConfig
    from repro_torch.core.padding import make_plan
    from repro_torch.serving import Engine

    t0 = time.monotonic()
    out = {}
    for base in cfgs or (get_config(ENC_MODEL), get_config(VLM_MODEL)):
        name = base.name
        over = dict(num_layers=layers, dtype="float32")
        if base.encoder is not None:
            over["encoder"] = EncoderConfig(layers, base.encoder.num_frames)
        c = dataclasses.replace(base, **over)
        plan = make_plan(c, 2, mode="page")
        # no d_ff padding at 2 shards: the weights' MLP layout is the
        # padded FFN's and the one device's alike
        assert plan.d_ff_padded == c.d_ff, plan
        max_seq = WHISPER_CTX + 64 if c.encoder is not None else 1024
        models = dict(zip((dev, "cpu"), _enc_models(c, plan, dev)))
        streams = {}
        for where, d, kw in (("TP1x2", dev, dict(devices=[dev] * 2)),
                             ("TP1x2", "cpu", dict(devices=["cpu"] * 2)),
                             ("one device", dev, dict(device=dev))):
            eng = Engine(c, params=models[d], max_batch=4, max_seq=max_seq,
                         page_tokens=page_tokens, plan=plan, **kw)
            streams[where, d] = _drive(eng, _front_requests(
                c, torch.Generator().manual_seed(101), lens, new))
            if where == "TP1x2":
                try:
                    eng.transform(2)
                except NotImplementedError as e:
                    refusal = str(e)
                else:
                    raise AssertionError(f"{name}: transform(2) ran")
            del eng
        want = streams["TP1x2", "cpu"]
        assert all(s == want for s in streams.values()), (name, streams)
        out[name] = {"layers": c.num_layers, "d_model": c.d_model,
                     "streams_equal": sorted(f"{w} on {d}"
                                             for w, d in streams),
                     "transform_refused": refusal}
        del models
        if dev == "cuda":
            free_card()
    emit(phase="enc-workers", dtype="float32", prompts=list(lens),
         new_tokens=new, models=out, seconds=time.monotonic() - t0)


# ---------------------------------------------------------------------------
# slice 14: training (plain PyTorch autograd: none of the six kernels)

TRAIN_MODEL = "llama3-8b"
#: llama3-8b's layers the train phase keeps: 2.80 B parameters, whose
#: bf16 weights and gradients and fp32 moments (12 B a parameter, 33.5
#: GB) and fp32 logits (8 x 1024 x 128256) fit the card; 16 layers are
#: at its edge and 32 (96 GB) do not fit the reference's scheme
TRAIN_LAYERS = 8
TRAIN_LOSS_TOL = 1e-4       # train-parity: the loss, relative
TRAIN_GRAD_TOL = 1e-3       # train-parity: a gradient leaf, relative norm
TRAIN_CLI_TOL = 1e-6        # train-cli: resumed against unbroken losses
#: train-parity's families: the reduced configs in fp32, recurrentgemma
#: cut by hand to RG-LRU + a sliding layer and xlstm to mLSTM + sLSTM
#: (``reduced()`` keeps the first two kinds of a pattern only)
TRAIN_FAMILIES = {
    "llama3-8b": {},
    "granite-moe-3b-a800m": {},
    "recurrentgemma-9b": {"num_layers": 3,
                          "layer_pattern": ("rglru", "rglru", "sliding")},
    "xlstm-1.3b": {"num_layers": 3, "layer_pattern": ("mlstm", "slstm")},
}


def _train_cfg(name: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name).reduced(), dtype="float32",
                               **TRAIN_FAMILIES[name])


def _grad_step(model, batch):
    """One loss and backward of ``training.train_step.loss_fn``: (loss,
    {name: gradient})."""
    from repro_torch.training.train_step import loss_fn
    for p in model.parameters():
        p.grad = None
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in
                                  model.named_parameters()}


def phase_train_parity(dev: str = "cuda", names=tuple(TRAIN_FAMILIES),
                       batch: int = 4, seq: int = 128):
    """One train step of each family on ``dev`` and on the CPU, from the
    same weights (built on the CPU from seed 0) and the same batch of
    the synthetic stream, fp32 with TF32 off: the loss within
    ``TRAIN_LOSS_TOL``, each gradient leaf within ``TRAIN_GRAD_TOL`` in
    norm, and every weight with a nonzero gradient on the CPU has one on
    the card (an attention run through a kernel, which has no backward,
    would leave ``wq`` / ``wk`` / ``wv`` without).  Then the AdamW
    update on both, its parameters' distance printed.  None of the six
    kernels may launch."""
    from repro_torch.core.padding import make_plan
    from repro_torch.launch.train import batch_on
    from repro_torch.models.model import build
    from repro_torch.training import DataConfig, SyntheticStream, adamw
    t0 = time.monotonic()
    reset_launch_counts()
    out = {}
    for name in names:
        cfg = _train_cfg(name)
        cpu = build(cfg, make_plan(cfg, 1), 0, device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        data = SyntheticStream(DataConfig(cfg.vocab_size, seq, batch))
        runs = {}
        for where, model in (("cpu", cpu), (dev, card)):
            model.requires_grad_(True)
            loss, grads = _grad_step(model, batch_on(data, 0, where))
            init, update = adamw(3e-4)
            params = dict(model.named_parameters())
            update(grads, init(params), params)
            runs[where] = (loss, {k: g.detach().cpu() for k, g in
                                  grads.items()}, params)
        (lc, gc_, pc), (ld, gd, pd) = runs["cpu"], runs[dev]
        rel = {k: float((gd[k] - g).norm() / max(float(g.norm()), 1e-30))
               for k, g in gc_.items()}
        lost = sorted(k for k, g in gc_.items()
                      if bool(g.any()) and not bool(gd[k].any()))
        upd = max(float((pd[k].detach().cpu() - p.detach()).norm()
                        / max(float(p.detach().norm()), 1e-30))
                  for k, p in pc.items())
        worst = max(rel, key=rel.get)
        out[name] = {"layers": list(cfg.pattern), "loss_cpu": lc,
                     "loss_card": ld, "loss_rel": abs(ld - lc) / abs(lc),
                     "grad_leaves": len(rel), "worst_grad_leaf": worst,
                     "worst_grad_rel": rel[worst], "lost_grads": lost,
                     "param_rel_after_update": upd}
        assert abs(ld - lc) <= TRAIN_LOSS_TOL * abs(lc), out[name]
        assert rel[worst] <= TRAIN_GRAD_TOL, out[name]
        assert not lost, out[name]
        del cpu, card, runs
    launched = launch_counts()
    assert not any(launched.values()), launched
    emit(phase="train-parity", dtype="float32", batch=batch, seq=seq,
         families=out, loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL,
         launches=launched, seconds=time.monotonic() - t0)
    return launched


def train_flops(cfg, plan, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward and backward, no
    recomputation): 6 per weight of a matrix product per token (q, k,
    v, o, the gated MLP, the head over the real vocabulary) and 12 per
    head dimension per causal (query, key) pair per head."""
    d, dh, L = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    Hq, kv = cfg.num_heads, cfg.num_kv_heads
    per_layer = d * (Hq + 2 * kv) * dh + Hq * dh * d + 3 * d * cfg.d_ff
    matmul = L * per_layer + d * cfg.vocab_size
    pairs = seq * (seq + 1) // 2
    return (6.0 * batch * seq * matmul
            + 12.0 * batch * L * Hq * dh * pairs)


def train_profile(cfg, batch: int, seq: int, dev: str = "cuda") -> dict:
    """Where a train step's time goes: the train phase's model (built
    anew from the same seed) and its first batch, one step to warm up,
    then one step under ``torch.profiler`` (``device_activity``: the
    card's own events, busy against the unprofiled wall of the warm
    step)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.padding import make_plan
    from repro_torch.launch.train import batch_on
    from repro_torch.models.model import build
    from repro_torch.training import (DataConfig, SyntheticStream, adamw,
                                      make_train_step)
    model = build(cfg, make_plan(cfg, 1), 0, device=dev)
    model.requires_grad_(True)
    init, update = adamw(3e-4)
    state = init(dict(model.named_parameters()))
    step = make_train_step(model, update)
    b = batch_on(SyntheticStream(DataConfig(cfg.vocab_size, seq, batch)),
                 0, dev)
    walls = []
    for _ in range(2):
        sync(dev)
        t0 = time.monotonic()
        state, m = step(state, b)
        float(m["loss"])
        walls.append(time.monotonic() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, m = step(state, b)
        float(m["loss"])
        wall = time.monotonic() - t0
    out = {"unprofiled_wall_ms": walls[-1] * 1e3,
           **device_activity(prof, wall, 1)}
    del model, state, step, prof
    free_card()
    return out


def phase_train(smi: str, record=None, dev: str = "cuda", cfg=None,
                layers: int = TRAIN_LAYERS, batch: int = 8, seq: int = 1024,
                steps: int = 16):
    """``launch.train.train`` (the CLI's body) on llama3-8b at full
    width, ``layers`` of its 32, bf16, random weights from seed 0:
    ``steps`` steps of ``batch`` x ``seq`` tokens of the synthetic
    stream under the CLI's WSD schedule at 3e-4.  Every loss must be
    finite and the last below the first.  Prints each step's loss and
    wall (host clock to the loss, which syncs), the median wall after
    the first step, tokens/s, the peak allocated memory and the model
    FLOP/s against the card's dense bf16 peak; then, on the card, one
    profiled step of the same model (``train_profile``).  None of the
    six kernels may launch.  ``record`` (a dict) receives the losses,
    which mesh-train holds its own against."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.launch.train import train
    t0 = time.monotonic()
    if cfg is None:
        cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                                  num_layers=layers)
    free_card()
    sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lines = []
    steps_out = train(cfg, steps=steps, batch=batch, seq=seq, lr=3e-4,
                      log_every=1, device=dev, log=lines.append)
    launched = launch_counts()
    losses = [l for l, _ in steps_out]
    if record is not None:
        record["losses"] = losses
    walls = sorted(w for _, w in steps_out[1:])
    med = walls[len(walls) // 2]
    flops = train_flops(cfg, make_plan(cfg, 1), batch, seq)
    peak = PEAK_FLOPS[torch.bfloat16]
    res = {"model": cfg.name, "layers": cfg.num_layers,
           "params": cfg.param_count(), "dtype": cfg.dtype,
           "batch": batch, "seq": seq, "steps": steps, "losses": losses,
           "step_walls_s": [w for _, w in steps_out],
           "median_step_s": med, "tokens_per_s": batch * seq / med,
           "max_memory_allocated_gb": (
               torch.cuda.max_memory_allocated() / 1e9
               if dev == "cuda" else None),
           "model_flops_per_step": flops,
           "model_flops_per_s": flops / med,
           "mfu_vs_dense_bf16_peak": flops / med / peak,
           "gpu": smi, "launches": launched, "lines": lines}
    free_card()
    if dev == "cuda":
        res["profile"] = train_profile(cfg, batch, seq, dev)
    emit(phase="train", **res, seconds=time.monotonic() - t0)
    assert all(math.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0], losses
    assert not any(launched.values()), launched
    return launched


TRAIN_CLI = ("--smoke", "--steps", "5", "--batch", "8", "--seq", "128",
             "--log-every", "1")


def _cli_losses(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        f = line.split()
        if len(f) >= 4 and f[0] == "step" and f[2] == "loss":
            out[int(f[1])] = float(f[3])
    return out


def phase_train_cli(dev: str = "cuda", args=TRAIN_CLI):
    """The train CLI on ``dev`` (the reduced llama3-8b in bf16): ``python
    -m repro_torch.launch.train`` cut after step 3 with its checkpoint,
    while the same CLI (``launch.train.main``) runs 5 steps unbroken in
    this process; then ``main`` resumes from that checkpoint (a model
    built anew, every weight, moment and the step read from disk) to
    step 5.  The cut run's losses and the resumed run's must equal the
    unbroken run's within ``TRAIN_CLI_TOL``, relative."""
    import io
    import shutil
    from repro_torch.launch.train import main as train_main
    t0 = time.monotonic()
    ck = os.path.join(ROOT, "build", "train_cli_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    argv = [*args, "--device", dev]

    def in_process(*extra) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_main([*argv, *extra])
        return buf.getvalue()

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cut = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--stop-after", "3", "--ckpt-dir", ck], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    whole = in_process()
    out, err_text = cut.communicate(timeout=600)
    assert cut.returncode == 0, err_text[-4000:]
    resumed = in_process("--ckpt-dir", ck)
    lw, lc, lr = (_cli_losses(t) for t in (whole, out, resumed))
    assert "[train] resumed from step 3" in resumed, resumed
    assert sorted(lw) == [0, 1, 2, 3, 4] and sorted(lc) == [0, 1, 2] \
        and sorted(lr) == [3, 4], (lw, lc, lr)
    got = {**lc, **lr}
    err = max(abs(got[i] - lw[i]) / abs(lw[i]) for i in lw)
    emit(phase="train-cli", args=argv, unbroken=lw, cut=lc, resumed=lr,
         max_rel_diff=err, tol=TRAIN_CLI_TOL,
         lines=[l for l in resumed.splitlines() if l.startswith("[train]")],
         seconds=time.monotonic() - t0)
    assert err <= TRAIN_CLI_TOL, (lw, got)


# ---------------------------------------------------------------------------
# slice 15: training over a grid of workers (FSDP x TP; plain PyTorch
# autograd: none of the six kernels)

MESH = (2, 2)
MESH_LOSS_TOL = 1e-4        # mesh-train-parity: the loss, relative
MESH_GRAD_TOL = 1e-3        # mesh-train-parity: a gradient leaf, relative
MESH_PARAM_TOL = 1e-3       # mesh-train-parity: a parameter after AdamW
MESH_OPT_TOL = 1e-6         # the sharded AdamW against one device's, on
                            # the same gradients
MESH_LR = 3e-4              # mesh-train-parity's AdamW step
MESH_ADAM_EPS = 1e-8        # its eps (``training.adamw``'s default)
#: mesh-train: each step's loss against the train phase's same step,
#: relative (bf16: the grid sums its partial products in another order)
MESH_TRAIN_TOL = 1e-2
#: mesh-train-parity's families: train-parity's, granite at the
#: reference's capacity factor 1.25 (the reduced config's 8 drops none)
MESH_FAMILIES = {name: ({"capacity_factor": 1.25}
                        if name == "granite-moe-3b-a800m" else {})
                 for name in TRAIN_FAMILIES}


def _rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _storage_distinct(parts) -> bool:
    return len({t.untyped_storage().data_ptr() for t in parts}) == len(parts)


def phase_mesh_train_parity(dev: str = "cuda", names=tuple(MESH_FAMILIES),
                            batch: int = 4, seq: int = 128, shape=MESH):
    """One train step of each family at mesh ``shape`` on ``shape[0] *
    shape[1]`` workers on ``dev``, held against the single-device port
    step on ``dev`` under the same lane plan, from the same weights
    (built on the CPU from seed 0, MLPs in the plan's per-shard layout)
    and batch, fp32 with TF32 off: the loss within ``MESH_LOSS_TOL``,
    each gradient leaf within ``MESH_GRAD_TOL`` in norm, each parameter
    after the AdamW update within ``MESH_PARAM_TOL`` in norm; a leaf
    that starts at zero is held element by element instead (Adam's first
    step moves each element by up to the learning rate, lr * g / (|g| +
    eps), so a gradient element near zero may move either way): every
    element that the two steps move apart by more than ``MESH_PARAM_TOL``
    * lr must have a gradient |g| below e + sqrt(eps' * e /
    MESH_PARAM_TOL), e the leaf's largest gradient difference and eps'
    Adam's eps over the clip's scale, the least |g| above which a
    gradient difference of e cannot move an update by that much.  The
    sharded AdamW on the sharded gradients must be within
    ``MESH_OPT_TOL`` of the single-device AdamW on those same
    gradients.  No worker's
    weight, moment or gradient aliases another's; a replicated leaf's
    copies are bit-equal after the update.  Granite runs at capacity
    factor 1.25 and must drop choices.  None of the six kernels may
    launch."""
    from repro_torch.core.padding import make_plan
    from repro_torch.core.weight_transform import relayout_block_mlp
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.train import batch_on
    from repro_torch.models import blocks as Bk
    from repro_torch.models.model import build
    from repro_torch.training import DataConfig, SyntheticStream, adamw
    from repro_torch.training import sharded as TS
    from repro_torch.training.train_step import loss_fn
    t0 = time.monotonic()
    reset_launch_counts()
    out = {}
    kept = []
    positions = Bk.moe_positions

    def record(*a):
        got = positions(*a)
        kept.append((int(got[1].sum()), got[1].numel()))
        return got
    Bk.moe_positions = record
    try:
        for name in names:
            cfg = _train_cfg(name)
            if MESH_FAMILIES[name]:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, **MESH_FAMILIES[name]))
            plan = make_plan(cfg, shape[1], mode="lane")
            cpu = build(cfg, plan, 0, device="cpu")
            for blk in cpu.layers:
                relayout_block_mlp(blk.mlp, cfg.d_ff, plan.max_tp,
                                   cfg.activation)
            single = copy.deepcopy(cpu).to(dev).requires_grad_(True)
            b = batch_on(SyntheticStream(DataConfig(cfg.vocab_size, seq,
                                                    batch)), 0, dev)
            kept.clear()
            step = TS.ShardedStep.from_model(
                cpu.to(dev), Grid([dev] * (shape[0] * shape[1]), shape))
            del cpu
            loss, _ = step.loss(TS.split_batch(b, step.grid))
            loss.backward()
            ls = float(loss.detach())
            dropped = sum(n - k for k, n in kept)
            grads = step.reduce_grads()
            gm = SH.gather(grads, step.specs, step.grid)
            l1, _ = loss_fn(single, b)
            l1.backward()
            l1 = float(l1.detach())
            params = dict(single.named_parameters())
            rel = {k: _rel(gm[k], p.grad) for k, p in params.items()}
            before = {k: p.detach().clone() for k, p in params.items()}
            gnorm = float(torch.sqrt(sum(torch.sum(torch.square(p.grad))
                                         for p in params.values())))
            # Adam's eps against the clipped gradient (clip at 1.0)
            eps = MESH_ADAM_EPS / min(1.0, 1.0 / max(gnorm, 1e-9))
            init, update = adamw(MESH_LR, eps=MESH_ADAM_EPS, grad_clip=1.0)
            update({k: p.grad for k, p in params.items()}, init(params),
                   params)
            state = TS.opt_init_sharded(step.shards)
            state = step.apply(update, state, grads)
            got = SH.gather(step.shards, step.specs, step.grid)
            # the sharded AdamW against one device's, on the same gradients
            same = {k: p.detach().clone() for k, p in before.items()}
            update(gm, init(same), same)
            opt_rel = max(_rel(got[k], v) for k, v in same.items())
            prel = {k: _rel(got[k], p.detach()) for k, p in params.items()}
            held = {k: v for k, v in prel.items()
                    if bool(before[k].any())}
            # leaves that start at zero: (elements moved apart, of those
            # with a gradient too large to explain it)
            zero_start = {}
            for k in prel.keys() - held.keys():
                gs = params[k].grad
                e = float((gm[k].to(gs) - gs).abs().max())
                least = e + math.sqrt(eps * e / MESH_PARAM_TOL)
                apart = ((got[k].to(gs) - params[k].detach()).abs()
                         > MESH_PARAM_TOL * MESH_LR)
                zero_start[k] = (int(apart.sum()),
                                 int((apart & (gs.abs() >= least)).sum()))
            unexplained = sum(b for _, b in zero_start.values())
            unaliased = all(
                _storage_distinct(tree[k]) for tree in
                (step.shards, state.mu, state.nu, grads) for k in tree)
            g = step.grid
            copies_equal = True
            for k, parts in step.shards.items():
                named = {a for e in step.specs[k] for a in
                         (e if isinstance(e, tuple) else (e,)) if a}
                rep = tuple(a for a in g.axis_names if a not in named)
                for grp in g.groups(rep):
                    copies_equal &= all(torch.equal(parts[grp[0]], parts[w])
                                        for w in grp[1:])
            worst = max(rel, key=rel.get)
            wp = max(held, key=held.get)
            out[name] = {"layers": list(cfg.pattern), "loss_mesh": ls,
                         "loss_single": l1, "loss_rel": abs(ls - l1) / abs(l1),
                         "worst_grad_leaf": worst, "worst_grad_rel": rel[worst],
                         "worst_param_leaf": wp, "worst_param_rel": held[wp],
                         "param_rel_all_leaves": max(prel.values()),
                         "zero_start_moved_apart": sum(
                             a for a, _ in zero_start.values()),
                         "zero_start_unexplained": unexplained,
                         "opt_rel_same_grads": opt_rel,
                         "unaliased": unaliased,
                         "replicated_copies_bit_equal": copies_equal,
                         "moe_choices_dropped": dropped,
                         "workers": g.W}
            assert abs(ls - l1) <= MESH_LOSS_TOL * abs(l1), out[name]
            assert rel[worst] <= MESH_GRAD_TOL, out[name]
            assert held[wp] <= MESH_PARAM_TOL, out[name]
            assert unexplained == 0, (out[name], zero_start)
            assert opt_rel <= MESH_OPT_TOL, out[name]
            assert unaliased and copies_equal, out[name]
            if cfg.moe is not None:
                assert dropped > 0, out[name]
            del single, step, state, grads, gm, got, same, params, before
            free_card()
    finally:
        Bk.moe_positions = positions
    launched = launch_counts()
    assert not any(launched.values()), launched
    emit(phase="mesh-train-parity", dtype="float32", mesh=list(shape),
         batch=batch, seq=seq, families=out, loss_tol=MESH_LOSS_TOL,
         grad_tol=MESH_GRAD_TOL, param_tol=MESH_PARAM_TOL,
         opt_tol=MESH_OPT_TOL, launches=launched,
         seconds=time.monotonic() - t0)
    return launched


def phase_mesh_train(smi: str, train_losses, dev: str = "cuda", cfg=None,
                     layers: int = TRAIN_LAYERS, batch: int = 8,
                     seq: int = 1024, steps: int = 16, shape=MESH):
    """``launch.train.train(..., mesh=shape)`` on the train phase's model,
    depth, batch, seed, schedule and steps (llama3-8b at full width,
    ``layers`` of 32, bf16, batch 8 x 1024, 16 steps at 3e-4) over
    ``shape[0] * shape[1]`` workers on ``dev``: each step's loss within
    ``MESH_TRAIN_TOL`` of the train phase's same step
    (``train_losses``), the last below the first.  The lane plan of the
    model axis pads nothing the single-device plan does not (held).
    Prints the median step wall after the first, tokens/s, the peak
    allocated memory and model FLOP/s against the dense bf16 peak, and
    the tally's bytes a step by kind beside the analytic count
    (``training.sharded.analytic_bytes``: FSDP gathers in the forward
    and the recompute, a reduce-scatter a leaf, the TP all-reduces, the
    gated ``wi``'s re-lay, the vocabulary's exchanges), which must be
    equal.  None of the six kernels may launch."""
    from repro_torch.configs import get_config
    from repro_torch.core.padding import make_plan
    from repro_torch.launch.comm_analysis import counting
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.train import train
    from repro_torch.models.model import Model
    from repro_torch.training import sharded as TS
    t0 = time.monotonic()
    if cfg is None:
        cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                                  num_layers=layers)
    one, lane = make_plan(cfg, 1), make_plan(cfg, shape[1], mode="lane")
    keys = ("d_ff_padded", "q_heads_padded", "kv_padded", "kv_slots",
            "vocab_padded", "experts_padded")
    pads = {k: (getattr(one, k), getattr(lane, k)) for k in keys}
    assert all(a == b for a, b in pads.values()), pads
    free_card()
    sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    lines = []
    with counting() as tally:
        steps_out = train(cfg, steps=steps, batch=batch, seq=seq, lr=3e-4,
                          log_every=1, device=dev, log=lines.append,
                          mesh=shape)
    launched = launch_counts()
    per_step = {k: v // steps for k, v in tally.collective_bytes().items()}
    # the analytic count from the placements on meta workers
    analytic = TS.analytic_bytes(
        TS.ShardedStep.from_model(Model.empty(cfg, lane, device="meta"),
                                  Grid(["meta"] * (shape[0] * shape[1]),
                                       shape)),
        batch // shape[0], seq)
    losses = [l for l, _ in steps_out]
    walls = sorted(w for _, w in steps_out[1:])
    med = walls[len(walls) // 2]
    flops = train_flops(cfg, one, batch, seq)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train_losses)]
    res = {"model": cfg.name, "layers": cfg.num_layers, "mesh": list(shape),
           "workers": shape[0] * shape[1], "params": cfg.param_count(),
           "dtype": cfg.dtype, "batch": batch, "seq": seq, "steps": steps,
           "plan_pads": pads, "losses": losses,
           "train_phase_losses": list(train_losses),
           "loss_rel_to_train_phase": rel, "tol": MESH_TRAIN_TOL,
           "step_walls_s": [w for _, w in steps_out],
           "median_step_s": med, "tokens_per_s": batch * seq / med,
           "max_memory_allocated_gb": (torch.cuda.max_memory_allocated()
                                       / 1e9 if dev == "cuda" else None),
           "model_flops_per_step": flops, "model_flops_per_s": flops / med,
           "mfu_vs_dense_bf16_peak": flops / med / PEAK_FLOPS[torch.bfloat16],
           "tally_bytes_per_step": per_step,
           "analytic_bytes_per_step": analytic,
           "gpu": smi, "launches": launched, "lines": lines}
    free_card()
    emit(phase="mesh-train", **res, seconds=time.monotonic() - t0)
    assert all(math.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0], losses
    assert len(rel) == steps and max(rel) <= MESH_TRAIN_TOL, rel
    assert {k: per_step[k] for k in analytic} == analytic, (per_step,
                                                             analytic)
    assert not any(launched.values()), launched
    return launched


MESH_TRAIN_CLI = (*TRAIN_CLI, "--mesh", ",".join(map(str, MESH)))


def phase_mesh_train_cli(dev: str = "cuda", args=MESH_TRAIN_CLI):
    """The train CLI with ``--mesh 2,2`` on ``dev`` (the reduced
    llama3-8b in bf16): ``python -m repro_torch.launch.train`` cut after
    step 3 with its checkpoint, while the same CLI runs 5 steps unbroken
    in this process; then ``main`` resumes from that checkpoint (a grid
    built anew, every shard and moment placed from the gathered leaves
    on disk) to step 5.  The cut and resumed runs' losses must equal the
    unbroken run's exactly (as printed)."""
    import io
    import shutil
    from repro_torch.launch.train import main as train_main
    t0 = time.monotonic()
    reset_launch_counts()
    ck = os.path.join(ROOT, "build", "mesh_train_cli_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    argv = [*args, "--device", dev]

    def in_process(*extra) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_main([*argv, *extra])
        return buf.getvalue()

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cut = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--stop-after", "3", "--ckpt-dir", ck], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    whole = in_process()
    out, err_text = cut.communicate(timeout=600)
    assert cut.returncode == 0, err_text[-4000:]
    resumed = in_process("--ckpt-dir", ck)
    launched = launch_counts()
    lw, lc, lr = (_cli_losses(t) for t in (whole, out, resumed))
    assert "[train] resumed from step 3" in resumed, resumed
    assert "mesh=2x2" in whole, whole
    assert sorted(lw) == [0, 1, 2, 3, 4] and sorted(lc) == [0, 1, 2] \
        and sorted(lr) == [3, 4], (lw, lc, lr)
    got = {**lc, **lr}
    emit(phase="mesh-train-cli", args=argv, unbroken=lw, cut=lc, resumed=lr,
         equal=got == lw, launches=launched,
         lines=[l for l in resumed.splitlines() if l.startswith("[train]")],
         seconds=time.monotonic() - t0)
    assert got == lw, (lw, got)
    assert not any(launched.values()), launched
    return launched


# ---------------------------------------------------------------------------
# Shape census: every kernel shape the phases launch was held against its
# plain version
# ---------------------------------------------------------------------------

def _decode_key(q, pool, page_table, kv_positions, q_positions, window=0):
    return (("Hq", q.shape[1]), ("kvs", pool.shape[1]), ("dh", q.shape[2]),
            ("P", pool.shape[3]), ("windowed", window > 0))


def _chunk_key(q, k_new, v_new, pool, page_table, kv_positions,
               q_positions, *, window=0, attend_prefix=True, shard=(0, 1)):
    return (("Hq", q.shape[2]), ("kvs", pool.shape[1]), ("dh", q.shape[3]),
            ("P", pool.shape[3]), ("windowed", window > 0),
            ("attend_prefix", attend_prefix), ("sp", shard[1]))


def _decode_partials_key(q, pool, page_table, kv_positions, q_positions,
                         out, window=0, shard=(0, 1)):
    return _decode_key(q, pool, page_table, kv_positions, q_positions,
                       window) + (("sp", shard[1]),)


def _chunk_partials_key(q, k_new, v_new, pool, page_table, kv_positions,
                        q_positions, out, *, window=0, attend_prefix=True,
                        attend_self=True, shard=(0, 1)):
    return _chunk_key(q, k_new, v_new, pool, page_table, kv_positions,
                      q_positions, window=window, attend_prefix=attend_prefix,
                      shard=shard) + (("attend_self", attend_self),
                                      ("pages a shard", page_table.shape[1]))


def _combine_key(parts, rows, kvs, splits, rep, dh, dtype):
    return (("kvs", kvs), ("rep", rep), ("dh", dh),
            ("out", str(dtype).replace("torch.", "")))


def _flash_key(q, k, v, causal=True, window=0):
    return (("Hq", q.shape[2]), ("kvs", k.shape[2]), ("dh", q.shape[3]),
            ("windowed", window > 0), ("causal", bool(causal)))


def _ffn_key(x, wi, wo, *, tp, ff, activation="swiglu", decode=None):
    from repro_torch.kernels import padded_ffn as PF
    tiling = None
    if x.dtype == torch.bfloat16:
        dec = x.shape[0] <= PF.DECODE_MAX_T if decode is None else decode
        tiling = "decode" if dec else "prefill"
    return (("d", x.shape[1]), ("ffp", wi.shape[1] // 2), ("tp", tp),
            ("ff", ff), ("activation", activation), ("tiling", tiling))


def _gather_key(pool, pages, hblocks, *, heads_per_slice):
    return (("H", pool.shape[1]), ("h", heads_per_slice),
            ("P", pool.shape[3]), ("dh", pool.shape[4]))


def _copy_key(src, dst, sp, sb, dp, db, *, heads_per_slice):
    return (("H_src", src.shape[1]), ("H_dst", dst.shape[1]),
            ("h", heads_per_slice), ("P", dst.shape[3]),
            ("dh", dst.shape[4]))


#: (kernel, module of ``repro_torch.kernels``, wrapper, its shape key):
#: the key holds what picks the kernel's code and tiling, not the sizes
#: (rows, tokens, pages) it loops over
CENSUS = (("paged_attention", "paged_attention", "paged_decode", _decode_key),
          ("chunk_prefill", "chunk_prefill", "chunk_prefill_attention",
           _chunk_key),
          ("flash_attention", "flash_attention", "flash_attention",
           _flash_key),
          ("padded_ffn", "padded_ffn", "padded_ffn", _ffn_key),
          ("gather_page_slices", "page_migrate", "gather_page_slices",
           _gather_key),
          ("copy_page_slices", "page_migrate", "copy_page_slices",
           _copy_key),
          ("paged_decode_partials", "paged_attention",
           "paged_decode_partials", _decode_partials_key),
          ("chunk_prefill_partials", "chunk_prefill",
           "chunk_prefill_partials", _chunk_partials_key),
          ("softmax_combine", "paged_attention", "softmax_combine",
           _combine_key))

#: phases that hold the card's engines against CPU engines (the plain
#: versions) on the same weights and prompts: the shapes they launch are
#: checked there, the rest only by the kernels phase
PARITY_PHASES = ("parity", "transform-parity", "cluster-parity",
                 "spill-parity", "ladder-parity", "layout-parity",
                 "moe-parity", "rg-parity", "xlstm-parity", "enc-parity",
                 "enc-workers")


class ShapeCensus:
    """The shape key (``CENSUS``) and dtype of every kernel wrapper call
    on CUDA tensors, by the phase that made it (``into``; None records
    nothing).  Installed over the six wrappers' module attributes, which
    every call site reads at call time.  The kernels phase and the
    parity phases check what they launch; ``report`` fails on a shape
    another phase launched that no check launched."""

    def __init__(self):
        self.into = None
        self.seen = {}

    def install(self) -> None:
        import importlib
        for kernel, mod, attr, key in CENSUS:
            m = importlib.import_module(f"repro_torch.kernels.{mod}")
            setattr(m, attr, self._watch(kernel, getattr(m, attr), key))

    def _watch(self, kernel, fn, key):
        def call(*a, **kw):
            if self.into is not None and a[0].is_cuda:
                k = (kernel, str(a[0].dtype).replace("torch.", ""),
                     key(*a, **kw))
                self.seen.setdefault(k, set()).add(self.into)
            return fn(*a, **kw)
        call.__wrapped__ = fn
        return call

    def report(self) -> None:
        checks = {"kernels", *PARITY_PHASES}
        rows, bad = [], []
        for (kernel, dtype, key), phases in sorted(
                self.seen.items(), key=lambda kv: repr(kv[0])):
            row = {"kernel": kernel, "dtype": dtype, **dict(key),
                   "checked_by": sorted(phases & checks),
                   "launched_by": sorted(phases - checks)}
            rows.append(row)
            if row["launched_by"] and not row["checked_by"]:
                bad.append(row)
        emit(phase="shape-census", shapes=len(rows), unchecked=bad,
             rows=rows)
        emit(phase="shape-census-unchecked", unchecked=bad)
        assert not bad, f"{len(bad)} kernel shapes launched unchecked"


def launch_counts() -> dict:
    from repro_torch.kernels import chunk_prefill as CP
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import padded_ffn as PF
    from repro_torch.kernels import page_migrate as PM
    from repro_torch.kernels import paged_attention as PA
    return {"paged_attention": PA.launches, "chunk_prefill": CP.launches,
            "flash_attention": FA.launches, "padded_ffn": PF.launches,
            "copy_page_slices": PM.copy_launches,
            "gather_page_slices": PM.gather_launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels import chunk_prefill as CP
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import padded_ffn as PF
    from repro_torch.kernels import page_migrate as PM
    from repro_torch.kernels import paged_attention as PA
    PA.launches = CP.launches = FA.launches = PF.launches = 0
    FA.bidirectional_launches = 0
    PM.copy_launches = PM.gather_launches = 0
    PA.partial_launches = CP.partial_launches = PA.combine_launches = 0


def session_summary(log: dict, reports, W: int) -> dict:
    """One session's steps and times against the model, and the bytes
    its KV steps moved against the least a migration must move: the
    (W-1)/W foreign head slices of every page, each read once and
    written once (``kv_transform.sharded_migration_stats``), over the
    card's memory rate."""
    kv = [r for r in reports if r.kv_pool_bytes]
    mlp = [r for r in reports if not r.kv_pool_bytes]
    bound_b = 2 * kv[0].kv_pool_bytes * (W - 1) // W
    return {
        "tp_from": log["tp_from"], "tp_to": log["tp_to"],
        "steps": log["steps"], "wall_s": log["wall_s"],
        "sum_seconds": log["measured_s"], "sum_blocked_s": log["exposed_s"],
        "sum_modeled_s": log["modeled_s"],
        "kv_steps": len(kv),
        "kv_step_seconds_mean": sum(r.seconds for r in kv) / len(kv),
        "kv_step_blocked_s_mean": sum(r.blocked_s for r in kv) / len(kv),
        "kv_step_modeled_s": kv[0].modeled_s,
        "kv_step_pool_bytes": kv[0].kv_pool_bytes,
        "kv_step_bytes_moved": kv[0].kv_bytes,
        "kv_step_bytes_bound": bound_b,
        "kv_step_bound_ms": bound_b / HBM_BPS * 1e3,
        "mlp_step_seconds_mean": (sum(r.seconds for r in mlp) / len(mlp)
                                  if mlp else None),
    }


def step_summary(steps) -> dict:
    """Engine steps by where they ran (a layout, or a session): all of
    them, and the decode-only ones (no prefill work) with their mean
    wall, the figure an exposed transform cost is read against."""
    out = {}
    for where in dict.fromkeys(w for w, _, _, _ in steps):
        mine = [s for s in steps if s[0] == where]
        dec = [s for s in mine if not s[3] and s[2] > 0]
        out[where] = {
            "steps": len(mine), "wall_s": sum(s[1] for s in mine),
            "decode_tokens": sum(s[2] for s in mine),
            "decode_only_steps": len(dec),
            "decode_only_step_ms_mean": (
                sum(s[1] for s in dec) / len(dec) * 1e3 if dec else None),
            "decode_only_batch_mean": (
                sum(s[2] for s in dec) / len(dec) if dec else None)}
    return out


#: transform-serve's depth: half of llama3-8b's 32 layers since the
#: train phases came, to keep the script inside its time limit
TRANSFORM_SERVE_LAYERS = 16


def phase_transform_serve(smi: str):
    """llama3-8b at full width and ``TRANSFORM_SERVE_LAYERS`` layers,
    bf16, two workers on the card: TP1x2 -> TP2 mid-decode, a request
    only TP2 can hold, TP2 -> TP1x2."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeRequest

    cfg = dataclasses.replace(get_config("llama3-8b"),
                              num_layers=TRANSFORM_SERVE_LAYERS)
    t0 = time.monotonic()
    eng = _worker_engine(cfg, max_batch=4, max_seq=8192, page_tokens=64)
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    gen = torch.Generator().manual_seed(11)
    warm = ServeRequest(_prompts(gen, (70,), cfg.vocab_size)[0],
                        max_new_tokens=2)
    eng.submit(warm)
    eng.run_until_done()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps = []   # (where, wall s, decode tokens, prefill work this step?)

    def step():
        before = (len(eng.waiting),
                  sum(p["done"] for p in eng._prefilling.values()))
        torch.cuda.synchronize()
        t = time.monotonic()
        where = (f"TP{eng.tp}" if not eng.transforming
                 else f"TP{eng.tp}->TP{eng.tp_pending}")
        out = eng.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
        prefill = (out["emitted"] > out["decode_emitted"] or before != (
            len(eng.waiting),
            sum(p["done"] for p in eng._prefilling.values())))
        steps.append((where, wall, out["decode_emitted"], prefill))

    lens = (300, 1200, 2500, 3500)
    reqs = [ServeRequest(p, max_new_tokens=128)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    t_run = time.monotonic()
    for r in reqs:
        eng.submit(r)
    while any(not r.generated for r in reqs):
        step()
    for _ in range(16):        # the TP1x2 decode baseline, full batch
        step()
    assert eng.tp == 1 and all(r.slot is not None for r in reqs)
    n_up = eng.transform(2)
    while eng.transforming:
        step()
    assert eng.tp == 2 and eng.max_seq() == 8192
    long_ = ServeRequest(_prompts(gen, (6000,), cfg.vocab_size)[0],
                         max_new_tokens=32)
    assert eng.max_seq_at(1) < long_.total_tokens <= eng.max_seq(), (
        "the long request must fit TP2 only")
    eng.submit(long_)
    while eng.waiting or any(s is not None for s in eng.slots):
        step()
        assert eng.tp == 2
    n_down = eng.transform(1)
    while eng.transforming:
        step()
    wall = time.monotonic() - t_run
    assert eng.tp == 1 and eng.max_seq_alloc == 4096
    launches = launch_counts()
    for r in reqs + [long_]:
        assert r.done and all(0 <= t < cfg.vocab_size for t in r.generated)
    assert len(long_.generated) == 32
    assert all(launches[k] > 0 for k in ("padded_ffn", "copy_page_slices",
                                          "gather_page_slices")), launches
    up_reps = eng.transform_reports[:n_up]
    down_reps = eng.transform_reports[n_up:]
    assert len(down_reps) == n_down
    sessions = [session_summary(eng.transform_log[0], up_reps, eng.W),
                session_summary(eng.transform_log[1], down_reps, eng.W)]
    assert all(r.kernel_plane for r in eng.transform_reports
               if any(o.component == "kv" for o in r.ops))
    emit(phase="transform-serve", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, workers=eng.W, prompts=list(lens),
         long_prompt=6000, weights_init_s=t_init, wall_s=wall,
         sessions=sessions, steps_by_layout=step_summary(steps),
         tokens_per_s_in_session=(
             sum(n for w, _, n, _ in steps if "->" in w)
             / sum(t for w, t, _, _ in steps if "->" in w)),
         tokens_per_s_outside=(
             sum(n for w, _, n, _ in steps if "->" not in w)
             / sum(t for w, t, _, _ in steps if "->" not in w)),
         ttft_s=[r.ttft for r in reqs + [long_]],
         tpot_s=[r.tpot for r in reqs + [long_]],
         launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    for p in transform_profiles(eng, cfg, gen, lens):
        emit(phase="profile", workers=eng.W, gpu=smi, **p)
    del eng
    free_card()
    return launches


def transform_profiles(eng, cfg, gen, lens, steps: int = 4):
    """Decode steps of a full batch at TP1x2 and at TP2 under
    ``profile_steps``, on a batch of its own after the timed run (a
    profiled step takes about twice a plain one's wall): the prompts of
    the timed run, decoded to 16 tokens at TP1x2, then TP1x2 -> TP2."""
    from repro_torch.serving import ServeRequest
    reqs = [ServeRequest(p, max_new_tokens=128)
            for p in _prompts(gen, lens, cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    while any(len(r.generated) < 16 for r in reqs):
        eng.step()
    assert eng.tp == 1
    out = [{"what": "decode step, TP1x2", "batch": len(reqs),
            **profile_steps(eng, steps)}]
    eng.transform(2)
    while eng.transforming:
        eng.step()
    assert eng.tp == 2 and all(r.slot is not None for r in reqs)
    out.append({"what": "decode step, TP2", "batch": len(reqs),
                **profile_steps(eng, steps)})
    return out


def device_activity(prof, wall_s: float, per: int) -> dict:
    """The card's own events of a ``torch.profiler`` window: kernels and
    copies only, never the CPU ops that launched them (whose device time
    would count each kernel twice).  Busy time is the union of their
    intervals; ``per`` divides every time (steps, requests)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end)
                         for e in evs):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    assert busy_us > 0, "the profile holds no device events"
    by_name, by_kind = {}, {}
    for e in evs:
        us = e.time_range.elapsed_us()
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + us, n + 1)
        kind = next((k for k, keys in KINDS if any(x in e.name
                                                   for x in keys)),
                    "other (elementwise, norms, RoPE, indexing)")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    total = sum(by_kind.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": wall_s / per * 1e3,
            "device_busy_ms": busy_us / per / 1e3,
            "device_idle_share": 1 - busy_us / 1e6 / wall_s,
            "kinds_ms": {k: t / per / 1e3 for k, t in by_kind.items()},
            "kinds_share_of_device_time": {k: t / total
                                           for k, t in by_kind.items()},
            "top_kernels_ms": [[name[:60], t / per / 1e3, n / per]
                               for name, (t, n) in top]}


# kernel-name fragments by kind, for the profiles' breakdown
KINDS = (("paged decode (port)", ("paged_decode", "bulk::combine")),
         ("padded FFN (port)", ("ffn_wgmma", "ffn_reduce", "ffn_tile")),
         ("page migration (port)", ("copy_segments",)),
         ("prefill attention (port)", ("attn_tile_kernel",
                                       "attn_wgmma_kernel",
                                       "chunk_scatter")),
         ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
         ("copies", ("Memcpy", "Memset")))


def profile_steps(eng, steps: int) -> dict:
    """``steps`` engine steps unprofiled, then ``steps`` more under
    ``torch.profiler`` (which adds host time per op): the unprofiled wall
    a step beside the card's busy time and kinds of work a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return {"steps": steps, "unprofiled_wall_ms": plain_wall / steps * 1e3,
            **device_activity(prof, wall, steps)}


def decode_profile(eng, cfg, gen, steps: int = 8):
    """Where a decode step's time goes: a full batch (4 slots at
    2048-token contexts), ``profile_steps``."""
    from repro_torch.serving import ServeRequest
    reqs = [ServeRequest(p, max_new_tokens=2 * steps + 4)
            for p in _prompts(gen, (2048,) * 4, cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    while any(len(r.generated) == 0 for r in reqs):
        eng.step()
    out = profile_steps(eng, steps)
    eng.run_until_done()
    return {"what": "decode step", "batch": len(reqs), "context": 2048,
            **out}


def prefill_profile(eng, cfg, gen, prompt: int = 6000):
    """Where one long request's prefill goes: a ``prompt``-token request
    (chunked, since it is longer than the whole-prompt limit) with one
    new token, alone on the engine, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import ServeRequest
    r = ServeRequest(_prompts(gen, (prompt,), cfg.vocab_size)[0],
                     max_new_tokens=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.submit(r)
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    assert len(r.generated) == 1
    return {"what": "prefill", "prompt": prompt, "ttft_s": r.ttft,
            **device_activity(prof, wall, 1)}


KERNEL_META = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:90"),
    "chunk_prefill": ("src/repro_torch/kernels/csrc/chunk_prefill.cu",
                      "src/repro/kernels/chunk_prefill.py:168"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:83"),
    "padded_ffn": ("src/repro_torch/kernels/csrc/padded_ffn.cu",
                   "src/repro/kernels/padded_ffn.py:54"),
    "copy_page_slices": ("src/repro_torch/kernels/csrc/page_migrate.cu",
                         "src/repro/kernels/page_migrate.py:61"),
    "gather_page_slices": ("src/repro_torch/kernels/csrc/page_migrate.cu",
                           "src/repro/kernels/page_migrate.py:107"),
    # slice 8: kernels 1 and 2 as softmax partials, and their combine
    "paged_decode_partials": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:90"),
    "chunk_prefill_partials": (
        "src/repro_torch/kernels/csrc/chunk_prefill.cu",
        "src/repro/kernels/chunk_prefill.py:168"),
    "softmax_combine": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:90"),
}
#: slice 8's entries: their launches are counted on cluster-layout's path
SP_KERNELS = ("paged_decode_partials", "chunk_prefill_partials",
              "softmax_combine")


def main():
    if os.path.exists(LOG_PATH):
        os.remove(LOG_PATH)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         gpu=smi)
    phase_build()
    census = ShapeCensus()
    census.install()

    seconds = {}

    def run(label, fn, *a):
        census.into = label
        t0 = time.monotonic()
        try:
            return fn(*a)
        finally:
            census.into = None
            seconds[label] = time.monotonic() - t0

    main_cases = run("kernels", phase_kernels)
    run("parity", phase_parity)
    launches, rates = run("serve", phase_serve, smi)
    free_card()
    # slice 9: the cost model fitted to the card's own spans
    cal = run("calibrate", phase_calibrate, smi, rates)
    # every registered head shape the port builds, end to end
    shapes = run("serve-shapes", phase_serve_shapes, smi)
    # a subprocess: its launches are not in the census (serve-shapes
    # launches qwen2.5-32b's shapes in this process)
    phase_serve_cli(QWEN_CLI)
    run("transform-parity", phase_transform_parity)
    # kernels 1-3 count on the single-engine serve path (phase 4), the
    # padded FFN and the page migration on the transform path (phase 6)
    launches.update({k: v for k, v in run(
        "transform-serve", phase_transform_serve, smi).items()
        if k not in launches})
    run("transform-w4", phase_transform_w4)
    run("cluster-parity", phase_cluster_parity)
    # this slice's path: every kernel launches on it (phase 9)
    cluster = run("cluster-serve", phase_cluster_serve, smi)
    run("spill-parity", phase_spill_parity)
    spill = run("cluster-spill", phase_cluster_spill, smi)
    phase_serve_cli()
    # slice 7: partial degrees, replicated kv heads, partial merges
    run("ladder-parity", phase_ladder_parity)
    ladder = run("ladder-serve", phase_ladder_serve, smi)
    replicated = run("replicated-serve", phase_replicated_serve, smi)
    partial = run("cluster-partial", phase_cluster_partial, smi)
    calibrated = run("cluster-calibrated", phase_cluster_calibrated, smi,
                     cal)
    # slice 8: sequence-parallel layouts
    run("layout-parity", phase_layout_parity)
    layout = run("layout-serve", phase_layout_serve, smi)
    clayout = run("cluster-layout", phase_cluster_layout, smi)
    assert all(clayout[k] > 0 for k in SP_KERNELS), clayout
    # slice 10: MoE blocks
    run("moe-parity", phase_moe_parity)
    moe = {"moe-serve": run("moe-serve", phase_moe_serve, smi),
           "moe-transform": run("moe-transform", phase_moe_transform, smi),
           "moe-cluster": run("moe-cluster", phase_moe_cluster, smi)}
    phase_serve_cli(MOE_CLI)
    run("moe-rows-fp32", phase_moe_rows_fp32, smi)
    moe["moe-spill"] = run("moe-spill", phase_moe_spill, smi)
    # slice 11: recurrentgemma-9b
    run("rg-parity", phase_rg_parity)
    rg = {"rg-serve": run("rg-serve", phase_rg_serve, smi),
          "rg-transform": run("rg-transform", phase_rg_transform, smi)}
    phase_serve_cli(RG_CLI)
    # slice 12: xlstm-1.3b (no attention, no MLP: no kernel launches)
    run("xlstm-parity", phase_xl_parity)
    xl = {"xlstm-serve": run("xlstm-serve", phase_xl_serve, smi),
          "xlstm-transform": run("xlstm-transform", phase_xl_transform,
                                 smi)}
    phase_serve_cli(XL_CLI)
    # slice 13: whisper-tiny (encoder, cross-attention), phi-3-vision
    run("enc-parity", phase_enc_parity)
    enc = {"whisper-serve": run("whisper-serve", phase_whisper_serve, smi),
           "vlm-serve": run("vlm-serve", phase_vlm_serve, smi)}
    run("enc-workers", phase_enc_workers)
    # slice 14: training (plain autograd: none of the six kernels)
    trained = {}
    train = {"train-parity": run("train-parity", phase_train_parity),
             "train": run("train", phase_train, smi, trained)}
    run("train-cli", phase_train_cli)
    # slice 15: training over a 2 x 2 grid of workers (FSDP x TP)
    train["mesh-train-parity"] = run("mesh-train-parity",
                                     phase_mesh_train_parity)
    train["mesh-train"] = run("mesh-train", phase_mesh_train, smi,
                              trained["losses"])
    train["mesh-train-cli"] = run("mesh-train-cli", phase_mesh_train_cli)
    emit(phase="phase-seconds", **seconds)
    census.report()
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        sp = name in SP_KERNELS
        r = main_cases[name + "@sp" if sp else name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": clayout[name] if sp else cluster[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"], "dtype": r["dtype"],
            "launches_by_path": {
                "serve / transform-serve": launches.get(name, 0),
                "cluster-serve": cluster.get(name, 0),
                "serve-shapes": {m: c.get(name, 0)
                                 for m, c in shapes.items()},
                "cluster-spill": spill.get(name, 0),
                "ladder-serve": ladder.get(name, 0),
                "replicated-serve": replicated.get(name, 0),
                "cluster-partial": partial.get(name, 0),
                "calibrate": cal["launches"].get(name, 0),
                "cluster-calibrated": calibrated.get(name, 0),
                "layout-serve": layout[name],
                "cluster-layout": clayout[name],
                **{k: v.get(name, 0) for k, v in moe.items()},
                **{k: v.get(name, 0) for k, v in rg.items()},
                **{k: v.get(name, 0) for k, v in xl.items()},
                **{k: v.get(name, 0) for k, v in enc.items()},
                **{k: v.get(name, 0) for k, v in train.items()}}})
        if name == "flash_attention":
            kernels[-1]["launches_by_path"]["whisper-serve, bidirectional"] \
                = enc["whisper-serve"]["flash_attention_bidirectional"]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
