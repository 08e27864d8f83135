"""The traced run's device record: a profile of a steady sub-window at the
end of the measured window, and the shapes of the kernel calls made in
it.

``Recorder`` wraps the three attention kernels' wrappers (the module
attributes the model calls) while the profile runs, and keeps what each
call's bound needs: shapes from the arguments, and the visible
query-key pairs counted on the device (no host sync).  ``summary``
reads the profile: the union of device activity (busy time), device time
by kernel name, the longest idle gaps labelled by the innermost host
span open at their middle, and the device time of each kernel family,
matched by the CUDA function names of the port's sources.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from roofline import counts as RC

#: CUDA function names of each kernel family (``csrc/*.cu``, ``*.cuh``)
FAMILIES = {"prefill": ("attn_wgmma_kernel", "attn_tile_kernel",
                        "chunk_scatter_kernel"),
            "decode": ("paged_decode", "combine_kernel", "walk_kernel")}


def live_keys(kv_positions: torch.Tensor) -> torch.Tensor:
    """Filled key slots (a device scalar)."""
    return (kv_positions >= 0).sum()


def visible_pairs(kv_positions: torch.Tensor, q_positions: torch.Tensor
                  ) -> torch.Tensor:
    """(row, key) pairs a decode row sees: filled, at or before the row's
    position (a device scalar)."""
    return ((kv_positions >= 0)
            & (kv_positions <= q_positions[:, None])).sum()


def warm(device) -> None:
    """Run the counting operations once, so that their kernels are loaded
    before a profile (CUDA loads a module at a kernel's first launch)."""
    kv = torch.zeros((2, 64), dtype=torch.int32, device=device)
    q = torch.zeros((2,), dtype=torch.int32, device=device)
    live_keys(kv).item()
    visible_pairs(kv, q).item()


class Recorder:
    """Records each wrapped kernel call's operation and byte counts."""

    def __init__(self, kernels: Dict[str, Tuple[object, str]]):
        self.kernels = kernels
        self.saved: Dict[str, Callable] = {}
        self.calls: Dict[str, List] = {"flash": [], "chunk": [],
                                       "decode": []}

    def __enter__(self):
        for key, (mod, attr) in self.kernels.items():
            orig = getattr(mod, attr)
            self.saved[key] = orig
            setattr(mod, attr, getattr(self, "_" + key)(orig))
        return self

    def __exit__(self, *exc):
        for key, (mod, attr) in self.kernels.items():
            setattr(mod, attr, self.saved[key])
        return False

    def _flash(self, orig):
        def wrapped(q, k, v, causal=True, window=0):
            B, S, hq, dh = q.shape
            self.calls["flash"].append(
                (q.dtype, RC.flash(B, S, hq, k.shape[2], dh,
                                   q.element_size()),
                 causal and not window))
            return orig(q, k, v, causal=causal, window=window)
        return wrapped

    def _chunk(self, orig):
        def wrapped(q, k_new, v_new, pool, page_table, kv_positions,
                    q_positions, **kw):
            B, S, hq, dh = q.shape
            live = live_keys(kv_positions)
            self.calls["chunk"].append(
                (q.dtype, (B, S, hq, k_new.shape[2], dh,
                           kw.get("attend_prefix", True),
                           kv_positions.shape[1], q.element_size()),
                 live, not kw.get("window", 0)))
            return orig(q, k_new, v_new, pool, page_table, kv_positions,
                        q_positions, **kw)
        return wrapped

    def _decode(self, orig):
        def wrapped(q, pool, page_table, kv_positions, q_positions,
                    window=0):
            B, hq, dh = q.shape
            pairs = visible_pairs(kv_positions, q_positions)
            self.calls["decode"].append(
                (q.dtype, (B, hq, pool.shape[1], dh, page_table.shape[1],
                           kv_positions.shape[1], q.element_size()),
                 pairs, not window))
            return orig(q, pool, page_table, kv_positions, q_positions,
                        window=window)
        return wrapped

    def bounds(self) -> Dict[str, float]:
        """Summed bound seconds by family (``prefill``: kernels 2-3,
        ``decode``: kernel 1), and whether every call is counted exactly
        (bf16, causal, no window: what the counts assume)."""
        out = {"prefill": 0.0, "decode": 0.0, "exact": True}
        for dt, cnt, plain in self.calls["flash"]:
            out["prefill"] += RC.bound_s(cnt["bytes"], cnt["flops"])
            out["exact"] &= plain and dt == torch.bfloat16
        for dt, (B, S, hq, hkv, dh, pre, nkv, elt), live, plain \
                in self.calls["chunk"]:
            cnt = RC.chunk(S, int(live) // B, hq, hkv, dh, pre, nkv, elt)
            out["prefill"] += B * RC.bound_s(cnt["bytes"], cnt["flops"])
            out["exact"] &= plain and dt == torch.bfloat16
        for dt, (B, hq, hkv, dh, n, nkv, elt), pairs, plain \
                in self.calls["decode"]:
            cnt = RC.decode(B, int(pairs), hq, hkv, dh, n, nkv, elt)
            out["decode"] += RC.bound_s(cnt["bytes"], cnt["flops"])
            out["exact"] &= plain and dt == torch.bfloat16
        return out


def _device_events(prof) -> List:
    """Kernels, copies and fills on the card; not the host's annotation
    spans, which the profiler also draws on the device's timeline."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("portbench.")]


def summary(prof, window_s: float, top: int = 10) -> Dict:
    """Busy seconds, device seconds by kernel family, the top device
    operations and the longest idle gaps of a finished profile."""
    dev = sorted(_device_events(prof), key=lambda e: e.time_range.start)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy, merged = 0.0, []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    by_name: Dict[str, float] = {}
    family = {"prefill": 0.0, "decode": 0.0}
    for e in dev:
        dur = (e.time_range.end - e.time_range.start) * 1e-6
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        for fam, names in FAMILIES.items():
            if any(n in e.name for n in names):
                family[fam] += dur
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:top]
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    idle = []
    for g, s, t in gaps:
        mid = (s + t) / 2
        inner = [e for e in cpu
                 if e.time_range.start <= mid <= e.time_range.end]
        label = (min(inner, key=lambda e: e.time_range.end
                     - e.time_range.start).name if inner else "no host span")
        idle.append([label, g * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": window_s, "family_s": family,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": idle}
