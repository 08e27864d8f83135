"""The plain reference of a dense decoder (Qwen2.5, the Phi-3 backbone),
in float32, a layer at a time.

Pre-norm blocks: ``x += attn(rms(x))``, ``x += mlp(rms(x))``.  RMS norm
``x / rms(x) * w`` with ``w = 1 + s`` (``weights``), rotary position
embedding on q and k by halves (``theta`` from the file), causal
attention with ``Hq / Hkv`` query heads to a key head (query head ``h``
reads key head ``h // rep``), SwiGLU ``w_down(silu(x w_gate) * x w_up)``,
a final norm and an untied head.  A vision request's patches are
projected by ``vision_proj`` and put before the prompt's tokens (the
patch prefix takes positions 0..P-1).  Published departures of the
configurations (no q/k/v bias, one projection matrix for the image
tower) are listed in the configuration files.

It imports only ``torch`` and the benchmark's own weights: nothing of
the program, and no JAX.  TF32 is off while it runs.

``modes`` selects what is computed alongside the fp32 forward:
``"fp8"`` is the control, the same forward with every linear layer's
operands rounded to float8 e4m3 (a per-tensor scale for a weight, a
per-row scale for an activation), the precision a later change might be
tempted to serve in.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch

from weights import dims, layer, static

ATTN_BLOCK = 1024     # query rows per attention block
ROW_BLOCK = 4096      # rows per MLP block
FP8_MAX = 448.0       # largest e4m3 value


@contextmanager
def exact_fp32():
    """TF32 off for matrix products and convolutions (restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8(t: torch.Tensor, per_row: bool) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude (of the tensor, or of each row) to 448, back in fp32."""
    amax = (t.abs().amax(dim=-1, keepdim=True) if per_row
            else t.abs().amax()).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
           low: bool) -> torch.Tensor:
    if low:
        return fp8(x, True) @ w[name + ".fp8"]
    return x @ w[name]


def rmsnorm(x: torch.Tensor, s: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + s)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, dh) at positions 0..S-1; angles in float64."""
    S, _, dh = x.shape
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = (f(ang).float()[:, None, :] for f in (torch.cos, torch.sin))
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal attention: q (S, Hq, dh), k and v (S, Hkv, dh); blocks of
    query rows, each against the keys up to its last row."""
    S, hq, dh = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    kt = k.permute(1, 2, 0)                     # (Hkv, dh, S)
    vv = v.permute(1, 0, 2)                     # (Hkv, S, dh)
    out = torch.empty_like(q)
    for a in range(0, S, ATTN_BLOCK):
        b = min(S, a + ATTN_BLOCK)
        n = b - a
        qb = (q[a:b].view(n, hkv, rep, dh).permute(1, 2, 0, 3)
              .reshape(hkv, rep * n, dh)) / math.sqrt(dh)
        s = (qb @ kt[:, :, :b]).view(hkv, rep, n, b)
        cols = torch.arange(b, device=q.device)
        rows = torch.arange(a, b, device=q.device)
        s.masked_fill_(cols[None, :] > rows[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1).view(hkv, rep * n, b)
        o = p @ vv[:, :b]                       # (Hkv, rep*n, dh)
        out[a:b] = o.view(hkv, rep, n, dh).permute(2, 0, 1, 3).reshape(
            n, hq, dh)
    return out


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], c: Dict,
          low: bool) -> torch.Tensor:
    d, hq, hkv, dh, _, _ = dims(c)
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    S = x.shape[0]
    h = rmsnorm(x, w["ln1"], eps)
    q = rope(linear(h, w, "wq", low).view(S, hq, dh), theta)
    k = rope(linear(h, w, "wk", low).view(S, hkv, dh), theta)
    v = linear(h, w, "wv", low).view(S, hkv, dh)
    x = x + linear(attention(q, k, v).reshape(S, hq * dh), w, "wo", low)
    out = torch.empty_like(x)
    for a in range(0, S, ROW_BLOCK):
        xb = x[a:a + ROW_BLOCK]
        hb = rmsnorm(xb, w["ln2"], eps)
        g = torch.nn.functional.silu(linear(hb, w, "w_gate", low))
        out[a:a + ROW_BLOCK] = xb + linear(g * linear(hb, w, "w_up", low),
                                           w, "w_down", low)
    return out


def _fp32(ws: Dict[str, torch.Tensor], low: bool) -> Dict[str, torch.Tensor]:
    out = {k: v.float() for k, v in ws.items()}
    if low:
        out.update({k + ".fp8": fp8(v, False) for k, v in out.items()
                    if v.dim() == 2 and k != "embed"})
    return out


def forward(c: Dict, seed: int, seqs: Sequence[Dict], device,
            modes: Sequence[str] = ("fp32",)
            ) -> Dict[str, List[torch.Tensor]]:
    """Logits (fp32, (n, vocab)) at the judged rows of each sequence, by
    mode.  A sequence is ``{"tokens": (S,) int64, "patches": (P, d) or
    None, "judge_from": row, "n": rows}``: rows ``judge_from ..
    judge_from + n - 1`` of the joined sequence (patches first)."""
    with exact_fp32(), torch.no_grad():
        st = _fp32(static(c, seed, device), "fp8" in modes)
        xs: Dict[str, List[torch.Tensor]] = {}
        for mode in modes:
            low = mode == "fp8"
            xs[mode] = []
            for s in seqs:
                x = st["embed"][s["tokens"].to(device)]
                if s.get("patches") is not None:
                    p = s["patches"].to(device).float()
                    pj = (fp8(p, True) @ st["vision_proj.fp8"] if low
                          else p @ st["vision_proj"])
                    x = torch.cat([pj, x])
                xs[mode].append(x)
        for i in range(c["num_hidden_layers"]):
            w = _fp32(layer(c, seed, i, device), "fp8" in modes)
            for mode in modes:
                xs[mode] = [block(x, w, c, mode == "fp8") for x in xs[mode]]
            del w
        out: Dict[str, List[torch.Tensor]] = {}
        for mode in modes:
            low = mode == "fp8"
            out[mode] = []
            for s, x in zip(seqs, xs[mode]):
                rows = x[s["judge_from"]:s["judge_from"] + s["n"]]
                h = rmsnorm(rows, st["final_ln"], c["rms_norm_eps"])
                out[mode].append(linear(h, st, "head", low))
        return out


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """By how much each token's reference logit lies below the
    reference's best at its row: ref (n, vocab), tokens (n,)."""
    return ref.max(dim=-1).values - ref.gather(
        1, tokens.to(ref.device)[:, None])[:, 0]


def judge(c: Dict, seed: int, seqs: Sequence[Dict], served: Sequence,
          device, control: bool = False) -> Dict[str, float]:
    """The widest gap of a served token below the reference's best, over
    every judged row (``served_gap``), and the mean gap; with
    ``control``, the same of the token that the fp8 forward puts first
    (``control_gap``, ``control_gap_mean``)."""
    modes = ("fp32", "fp8") if control else ("fp32",)
    lg = forward(c, seed, seqs, device, modes)
    g = torch.cat([gaps(r, torch.as_tensor(t))
                   for r, t in zip(lg["fp32"], served)])
    out = {"served_gap": float(g.max()), "served_gap_mean": float(g.mean())}
    if control:
        q = torch.cat([gaps(r, f.argmax(-1))
                       for r, f in zip(lg["fp32"], lg["fp8"])])
        out.update(control_gap=float(q.max()),
                   control_gap_mean=float(q.mean()))
    return out


def sequence(prompt: Sequence[int], served: Sequence[int], n_patches: int,
             patches: Optional[torch.Tensor] = None) -> Dict:
    """The joined sequence a served request is judged on: its prompt and
    every served token but the last, after its patches."""
    toks = torch.tensor(list(prompt) + list(served[:-1]), dtype=torch.long)
    return {"tokens": toks, "patches": patches,
            "judge_from": n_patches + len(prompt) - 1, "n": len(served)}
