#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing JSON lines; any mismatch raises and the script
exits non-zero:

1. build    — compile the CUDA kernels of ``src/repro_torch/kernels/csrc``
              (one nvcc per source, in parallel) into
              ``build/repro_torch_kernels/``.
2. kernels  — every kernel against its plain PyTorch version on the card
              at llama3-8b attention shapes (Hq=32, kvs=8, dh=128), fp32
              and bf16, each element within TOL: error, kernel / plain /
              one-PyTorch-call times, and the least time the card could
              take (bound).  Decode also runs at the serve phase's own
              shape; one chunk case carries padding tokens.
3. parity   — llama3-8b at full width, 2 layers, fp32, weights from one
              seed: the same requests through ``Engine(device="cuda")``
              and ``Engine(device="cpu")`` give equal greedy streams, and
              first-token logits agree within 1e-3.
4. serve    — llama3-8b at full width and depth in bf16 with random
              weights serves whole-prompt requests and one 6000-token
              request that must chunk; every kernel's launch counter
              must rise.  Prints TTFT, TPOT and tokens per second, then
              two ``torch.profiler`` breakdowns of device time: a decode
              step of a full batch and the 6000-token request's prefill.

Then the card's name and power limit, one ``kernels`` line, and the last
line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository around it, it fails before printing a result.
"""
import copy
import dataclasses
import json
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
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 2.0 ** -7)}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def max_err(what, out, want, dtype, rows=None):
    """Max abs error of ``out`` against ``want`` (over the bool mask
    ``rows`` of leading axes if given); raises unless every element is
    within ``TOL[dtype]``."""
    atol, rtol = TOL[dtype]
    o, w = out.float(), want.float()
    if rows is not None:
        o, w = o[rows], w[rows]
    diff = (o - w).abs()
    bad = int((diff > atol + rtol * w.abs()).sum())
    err = diff.max().item()
    assert bad == 0, (what, str(dtype), "max abs err", err, "elements "
                      "outside tolerance", bad)
    return err


def tol_text(dtype) -> str:
    atol, rtol = TOL[dtype]
    return f"{atol:g} + {rtol:g}*|want|"


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, flops: float, dtype):
    """The larger of bytes over HBM rate and FLOPs over the type's peak."""
    tb = nbytes / HBM_BPS * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def visible_pairs(qpos, kpos, window: int) -> int:
    """(query, key) pairs the mask lets through, from this run's
    positions: (B, Sq) and (B, Sk) int tensors."""
    q = qpos[:, :, None].long()
    k = kpos[:, None, :].long()
    ok = (k >= 0) & (k <= q)
    if window > 0:
        ok &= k > q - window
    return int(ok.sum())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def expand_kv(k, rep):
    """(B, S, kvs, dh) -> (B, kvs*rep, S, dh) for the library yardstick."""
    return k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous()


# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    logs = _build.build_all()
    secs = time.monotonic() - t0
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(_build.BUILD_DIR / "build.log", "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln][:12]
            for name, log in logs.items()}
    emit(phase="build", seconds=secs, built=sorted(logs),
         ptxas=regs)


def case_decode(dtype, B=8, ctx=4096, cap=None, Hq=32, kvs=8, dh=128,
                P=64):
    """``ctx`` live keys per row in slots of ``cap`` tokens (the rest
    empty, as in the engine's slots of max_seq tokens)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref
    dev = "cuda"
    cap = cap or ctx
    g = torch.Generator(device=dev).manual_seed(1)
    n = cap // P
    NP = B * n
    pool = torch.randn((NP, kvs, 2, P, dh), generator=g, device=dev
                       ).to(dtype)
    pt = torch.randperm(NP, generator=g, device=dev).to(torch.int32
                                                        ).reshape(B, n)
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    kvpos = torch.where(slots < ctx, slots, -1)[None].repeat(B, 1
                                                             ).contiguous()
    qpos = torch.full((B,), ctx - 1, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hq, dh), generator=g, device=dev).to(dtype)
    out = PA.paged_decode(q, pool, pt, kvpos, qpos)
    want = PA.plain(q, pool, pt, kvpos, qpos)
    err = max_err("paged decode", out, want, dtype)
    # the TPU kernel's signature: ragged seq_lens
    sl = torch.randint(1, ctx + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    err_sl = max_err("paged_attention(seq_lens)",
                     PA.paged_attention(q, pool, pt, sl),
                     ref.paged_attention_ref(q, pool, pt, sl), dtype)
    rep = Hq // kvs
    kd = pool[pt.long()][:, :, :, 0].permute(0, 2, 1, 3, 4).reshape(
        B, kvs, cap, dh)[:, :, :ctx].repeat_interleave(rep, dim=1
                                                       ).contiguous()
    vd = pool[pt.long()][:, :, :, 1].permute(0, 2, 1, 3, 4).reshape(
        B, kvs, cap, dh)[:, :, :ctx].repeat_interleave(rep, dim=1
                                                       ).contiguous()
    q4 = q[:, :, None, :].contiguous()
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, kd, vd), 20)
    pairs = visible_pairs(qpos[:, None], kvpos, 0)
    byt = pairs * kvs * 2 * dh * pool.element_size() + nbytes(
        q, out, kvpos, qpos, pt)
    bms, by = bound_ms(byt, 4 * pairs * Hq * dh, dtype)
    return dict(
        kernel="paged_attention", case=f"B={B} ctx={ctx} cap={cap} P={P}",
        max_abs_err=err, max_abs_err_seq_lens=err_sl,
        ms=time_ms(lambda: PA.paged_decode(q, pool, pt, kvpos, qpos), 50),
        plain_ms=time_ms(lambda: PA.plain(q, pool, pt, kvpos, qpos), 5),
        library_ms=lib, bound_ms=bms, bound_by=by)


def case_chunk(dtype, S=512, done=3584, cap=4096, window=0, pad=0, Hq=32,
               kvs=8, dh=128, P=64):
    """A chunk of S tokens at position ``done``; its last ``pad`` tokens
    are padding (position -1): no keys, no pool bytes, rows unread."""
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
    pool = pool0.clone()
    out = CP.chunk_prefill_attention(q, k, v, pool, pt, kvpos, qpos,
                                     window=window)
    pool_ref = pool0.clone()
    want = CP.plain(q, k, v, pool_ref, pt, kvpos, qpos, window=window)
    err = max_err("chunk prefill", out, want, dtype, rows=qpos >= 0)
    state = pp.PagedState(pool0.clone(), pt, torch.zeros(
        1, dtype=torch.int32, device=dev), kvpos.clone())
    pp.write_chunk(state, k, v, qpos)
    assert torch.equal(pool, state.pool), "chunk pool != write_chunk's"
    assert torch.equal(pool_ref, state.pool), "plain pool != write_chunk's"
    # yardstick: one SDPA call on the gathered prefix + chunk keys
    rep = Hq // kvs
    kk = torch.cat([pool0[:, :, 0].permute(0, 2, 1, 3).reshape(1, cap, kvs,
                                                               dh), k], 1)
    vv = torch.cat([pool0[:, :, 1].permute(0, 2, 1, 3).reshape(1, cap, kvs,
                                                               dh), v], 1)
    kpos = torch.cat([kvpos, qpos], 1)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    if window:
        mask &= kpos[:, None, :] > qpos[:, :, None] - window
    kd, vd, qd = expand_kv(kk, rep), expand_kv(vv, rep), q.transpose(1, 2)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask[:, None]), 20)
    pairs = visible_pairs(qpos, kpos, window)
    live_prefix = int((kvpos >= 0).sum())
    byt = (live_prefix * kvs * 2 * dh * pool.element_size()
           + nbytes(q, k, v, out, kvpos, qpos)
           + (S - pad) * kvs * 2 * dh * pool.element_size())  # scatter
    bms, by = bound_ms(byt, 4 * pairs * Hq * dh, dtype)
    return dict(
        kernel="chunk_prefill",
        case=(f"S={S} prefix={done} cap={cap} window={window} pad={pad} "
              f"P={P}"),
        max_abs_err=err, pool_equal=True,
        ms=time_ms(lambda: CP.chunk_prefill_attention(
            q, k, v, pool, pt, kvpos, qpos, window=window), 20),
        plain_ms=time_ms(lambda: CP.plain(
            q, k, v, pool_ref, pt, kvpos, qpos, window=window), 3),
        library_ms=lib, bound_ms=bms, bound_by=by)


def case_flash(dtype, S=4096, window=0, Hq=32, kvs=8, dh=128):
    from repro_torch.kernels import flash_attention as FA
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, S, Hq, dh), generator=g, device=dev).to(dtype)
    k = torch.randn((1, S, kvs, dh), generator=g, device=dev).to(dtype)
    v = torch.randn((1, S, kvs, dh), generator=g, device=dev).to(dtype)
    out = FA.flash_attention(q, k, v, window=window)
    want = FA.plain(q, k, v, window=window)
    err = max_err("flash", out, want, dtype)
    rep = Hq // kvs
    kd, vd, qd = expand_kv(k, rep), expand_kv(v, rep), q.transpose(1, 2)
    if window:
        lib = None
    else:
        lib = time_ms(lambda: torch.nn.functional.
                      scaled_dot_product_attention(qd, kd, vd,
                                                   is_causal=True), 20)
    pos = torch.arange(S, device=dev)[None]
    pairs = visible_pairs(pos, pos, window)
    bms, by = bound_ms(nbytes(q, k, v, out), 4 * pairs * Hq * dh, dtype)
    return dict(
        kernel="flash_attention", case=f"S={S} window={window}",
        max_abs_err=err,
        ms=time_ms(lambda: FA.flash_attention(q, k, v, window=window), 20),
        plain_ms=time_ms(lambda: FA.plain(q, k, v, window=window), 3),
        library_ms=lib, bound_ms=bms, bound_by=by)


def phase_kernels():
    """Every case in fp32 and bf16; returns the bf16 main-path cases by
    kernel name (the serve phase runs bf16)."""
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(case_decode, {}),
                 # the serve phase's decode: 4 slots of 8192 tokens, 2048 live
                 (case_decode, dict(B=4, ctx=2048, cap=8192)),
                 (case_chunk, {}),
                 (case_chunk, dict(S=200, done=1536, cap=1024, window=1024,
                                   pad=8)),
                 (case_flash, {}), (case_flash, dict(S=1000))]
        for fn, kw in cases:
            r = fn(dtype, **kw)
            r["dtype"] = str(dtype).replace("torch.", "")
            r["tol"] = tol_text(dtype)
            emit(phase="kernels", **r)
            if dtype == torch.bfloat16 and not kw:
                main[r["kernel"]] = r
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
    profiles = (decode_profile(eng, cfg, gen),
                prefill_profile(eng, cfg, gen))
    emit(phase="serve", model=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, prompts=list(lens), new_tokens=32,
         weights_init_s=t_init, wall_s=wall,
         ttft_s=ttft, tpot_s=tpot,
         tokens_per_s=sum(len(r.generated) for r in reqs) / wall,
         launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, gpu=smi)
    for p in profiles:
        emit(phase="profile", gpu=smi, **p)
    return launches


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
KINDS = (("paged decode (port)", ("paged_decode",)),
         ("prefill attention (port)", ("attn_tile_kernel",
                                       "chunk_scatter")),
         ("matmul (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
         ("copies", ("Memcpy", "Memset")))


def decode_profile(eng, cfg, gen, steps: int = 8):
    """Where a decode step's time goes: a full batch (4 slots at
    2048-token contexts) runs ``steps`` steps unprofiled, then ``steps``
    under ``torch.profiler`` (which adds host time per op)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import ServeRequest
    reqs = [ServeRequest(p, max_new_tokens=2 * steps + 4)
            for p in _prompts(gen, (2048,) * 4, cfg.vocab_size)]
    for r in reqs:
        eng.submit(r)
    while any(len(r.generated) == 0 for r in reqs):
        eng.step()
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
    eng.run_until_done()
    return {"what": "decode step", "steps": steps, "batch": len(reqs),
            "context": 2048,
            "unprofiled_wall_ms": plain_wall / steps * 1e3,
            **device_activity(prof, wall, steps)}


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
}


def main():
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
    main_cases = phase_kernels()
    phase_parity()
    launches = phase_serve(smi)
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = main_cases[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"], "dtype": r["dtype"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
