"""Measured-cost calibration: the scheduler's cost model answers to the
clock it schedules against.  The counterpart of ``repro.core.calibrate``.

The fitting and feedback half is the reference's arithmetic, pure
Python and numpy; the measuring half runs on the port's data plane:

1. **Isolated micro-measurements** (``measure_kv_migration`` /
   ``measure_weight_put`` / ``measure_spill_copy``): the sharded page
   migration (``core.kv_transform.migrate_sharded``: kernels 5-6 on
   CUDA workers), a weight copy onto another worker the way
   ``launch.mesh.InstanceMesh.replicate`` copies (``x.to(d,
   copy=True)``: a real copy even when both workers share one card),
   and the spill page copy (``core.kv_transform.migrate_slot_pages``:
   kernel 5), each timed ALONE on the workers' devices.  A span is the
   median host-clock time between ``torch.cuda.synchronize()`` calls on
   every device in use, after warm-up calls: a wall span, as the control
   plane's session ``wall_s`` is.  Each ``Measurement`` carries the
   reference's byte/segment accounting (``kv_transform.
   sharded_migration_stats``), which is what the scheduler prices, and
   beside it the bytes the port's kernels and exchange really read and
   wrote (``copied_bytes``).

2. **Fitting** (``fit_link_model`` / ``fit_hardware``): least squares
   of ``wall = bytes / bandwidth + segments * segment_overhead`` over
   the isolated kv-migration spans; ``overlap_fraction`` from PAIRED
   spans (``measure_overlap_pairs``: a transfer alone, a compute chain
   alone, the transfer issued then the chain run, as a session issues
   its copies on the current stream).  ``calibrate`` packages the fit as
   a ``CalibratedCostModel`` both planes can attach.

3. **Measured feedback** (``MeasuredCosts``): the control planes feed
   every realized transform/spill wall time from their ``transform_log``
   into a per-(action-kind, degree-pair, bytes-bucket) EWMA; the
   scheduler's ``_rung_cost`` and pressure horizon then consume the
   measured estimate once warm, with the modeled value as the
   cold-start prior.  The simulator attaches the SAME fitted constants,
   so sim/live parity extends to costs.

The reference's ``interpret`` argument has no counterpart: the port's
kernel wrappers dispatch by the tensors' device.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import (CostModel, H20, Hardware,
                                        kv_bytes_per_token)
from repro_torch.core.kv_transform import LinkModel, MigrationStats
from repro_torch.launch.mesh import InstanceMesh, Worker, workers_of

__all__ = ["Measurement", "OverlapPair", "CalibrationReport",
           "MeasuredCosts", "CalibratedCostModel", "MicroSizes",
           "measure_kv_migration", "measure_weight_put",
           "measure_spill_copy", "measure_overlap_pairs",
           "measure_decode_tps", "fit_link_model", "fit_overlap_fraction",
           "fit_hardware", "predicted_time", "calibrate"]


# ---------------------------------------------------------------------------
# Isolated micro-measurements
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Measurement:
    """One isolated span: ``wall_s`` to move ``bytes_moved`` in
    ``segments`` contiguous pieces, with nothing else running.
    ``bytes_moved`` and ``segments`` are the reference's accounting;
    ``copied_bytes`` what the port's kernels and copies read and wrote
    for it (0 where the caller built the record by hand)."""
    kind: str                  # kv_migrate_up | kv_migrate_down |
                               # weight_put | spill_copy
    bytes_moved: int
    segments: int
    wall_s: float
    tp_from: int = 1
    tp_to: int = 1
    copied_bytes: int = 0


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _sync(devices: Sequence[torch.device]) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _time_isolated(fn, devices: Sequence[torch.device], repeats: int = 5,
                   warmup: int = 1) -> float:
    """Median wall seconds of ``fn()`` after ``warmup`` untimed calls
    (the first builds the kernels), each span taken between
    synchronizations of every device in ``devices``."""
    for _ in range(max(warmup, 1)):
        fn()
    _sync(devices)
    spans = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        _sync(devices)
        spans.append(time.perf_counter() - t0)
    return _median(spans)


def _workers(devices, n: int, what: str) -> List[Worker]:
    """The first ``n`` workers of ``devices`` (default: ``n`` workers of
    the card, which raises without a GPU)."""
    ws = workers_of(list(devices) if devices is not None else ["cuda"] * n)
    if len(ws) < n:
        raise ValueError(f"{what} needs {n} workers, have {len(ws)}")
    return ws[:n]


def _randn(shape, dtype, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def measure_kv_migration(n_workers: int = 2,
                         pages_per_worker: Sequence[int] = (8, 32),
                         kv_slots: int = 4, page_tokens: int = 16,
                         head_dim: int = 32, dtype=None, devices=None,
                         repeats: int = 5) -> List[Measurement]:
    """Time the sharded page migration (``migrate_sharded``) in
    isolation on ``n_workers`` workers, one TP1 x W -> TPW span and one
    TPW -> TP1 x W span per pool size (``pages_per_worker`` pages a
    worker at TP1).  The accounting is ``sharded_migration_stats`` of
    the same geometry; ``copied_bytes`` is what ``migrate_sharded``
    reports its kernels and exchange read and wrote."""
    from repro_torch.core.kv_transform import (migrate_sharded,
                                               sharded_migration_stats)
    W = n_workers
    ws = _workers(devices, W, "kv-migration micro")
    dtype = torch.float32 if dtype is None else dtype
    dtype_bytes = torch.empty((), dtype=dtype).element_size()
    tp1, tpw = InstanceMesh(ws, 1), InstanceMesh(ws, W)
    devs = [w.device for w in ws]
    out: List[Measurement] = []
    for npw in pages_per_worker:
        stats = sharded_migration_stats(W, npw, kv_slots, page_tokens,
                                        head_dim, dtype_bytes=dtype_bytes)
        pools = [_randn((npw, kv_slots, 2, page_tokens, head_dim), dtype,
                        w.device, npw + i) for i, w in enumerate(ws)]
        _, up_bytes = migrate_sharded(pools, tp1, 1, tpw, W)
        up = _time_isolated(
            lambda p=pools: migrate_sharded(p, tp1, 1, tpw, W), devs,
            repeats=repeats)
        out.append(Measurement("kv_migrate_up", stats.bytes_moved,
                               stats.segments, up, 1, W, up_bytes))
        del pools
        merged = [_randn((W * npw, kv_slots // W, 2, page_tokens, head_dim),
                         dtype, w.device, npw + W + i)
                  for i, w in enumerate(ws)]
        _, down_bytes = migrate_sharded(merged, tpw, W, tp1, 1)
        down = _time_isolated(
            lambda p=merged: migrate_sharded(p, tpw, W, tp1, 1), devs,
            repeats=repeats)
        out.append(Measurement("kv_migrate_down", stats.bytes_moved,
                               stats.segments, down, W, 1, down_bytes))
        del merged
    return out


def measure_weight_put(layer_bytes: Sequence[int] = (1 << 18, 1 << 21),
                       devices=None, repeats: int = 5
                       ) -> List[Measurement]:
    """Time a per-layer weight copy in isolation, worker 0 -> worker 1,
    one span per layer size: ``InstanceMesh.replicate`` onto worker 1,
    the copy a transform session makes of each weight it moves
    (``x.to(d, copy=True)``: a real copy when both workers share a
    device, where a plain ``.to`` would return the same tensor)."""
    ws = _workers(devices, 2, "weight-put micro")
    dst = InstanceMesh(ws[1:], 1)
    devs = [w.device for w in ws]
    out: List[Measurement] = []
    for nb in layer_bytes:
        n = max(1, nb // 4)
        src = _randn((n,), torch.float32, ws[0].device, n % 97)
        wall = _time_isolated(lambda s=src: dst.replicate(s), devs,
                              repeats=repeats)
        out.append(Measurement("weight_put", n * 4, 1, wall,
                               copied_bytes=2 * n * 4))
        del src
    return out


def measure_spill_copy(n_pages: Sequence[int] = (4, 16),
                       kv_slots: int = 4, page_tokens: int = 16,
                       head_dim: int = 32, dtype=None, devices=None,
                       repeats: int = 5) -> List[Measurement]:
    """Time the spill page copy in isolation: ``migrate_slot_pages`` of
    a guest's page range on worker 0 into a host pool on worker 1 (the
    copy kernel on CUDA; a device copy first when the workers' devices
    differ), which the engine's spill path runs per spilled region."""
    from repro_torch.core.kv_transform import migrate_slot_pages
    ws = _workers(devices, 2, "spill-copy micro")
    dtype = torch.float32 if dtype is None else dtype
    esize = torch.empty((), dtype=dtype).element_size()
    page_nbytes = kv_slots * 2 * page_tokens * head_dim * esize
    devs = [w.device for w in ws]
    hops = 1 + (ws[0].device != ws[1].device)
    out: List[Measurement] = []
    for np_ in n_pages:
        src = _randn((np_, kv_slots, 2, page_tokens, head_dim), dtype,
                     ws[0].device, np_)
        dst = torch.zeros((2 * np_, kv_slots, 2, page_tokens, head_dim),
                          dtype=dtype, device=ws[1].device)
        wall = _time_isolated(
            lambda s=src, d=dst, n=np_: migrate_slot_pages(s, d, n, 0),
            devs, repeats=repeats)
        out.append(Measurement("spill_copy", np_ * page_nbytes, np_, wall,
                               copied_bytes=2 * hops * np_ * page_nbytes))
        del src, dst
    return out


@dataclass(frozen=True)
class OverlapPair:
    """Paired spans for one transfer geometry: the SAME transfer timed
    alone and issued before a compute chain.  The isolated micros above
    by construction hide nothing, so they carry no information about
    ``LinkModel.overlap_fraction``; these pairs do: the fraction of the
    isolated transfer time that vanished when compute ran after it."""
    bytes_moved: int
    transfer_s: float        # transfer alone
    compute_s: float         # compute alone
    both_s: float            # transfer issued, compute run, both
                             # synchronized

    @property
    def overlap_frac(self) -> float:
        """Hidden fraction of the transfer: (t_c + t_t - t_both) / t_t,
        clamped to [0, 1].  1.0 = the transfer fully disappeared behind
        compute; 0.0 = fully serialized (copies and compute on one
        stream)."""
        if self.transfer_s <= 0.0:
            return 0.0
        hidden = self.compute_s + self.transfer_s - self.both_s
        return min(max(hidden / self.transfer_s, 0.0), 1.0)


def measure_overlap_pairs(transfer_bytes: Sequence[int] = (1 << 20,
                                                           1 << 22),
                          compute_dim: int = 256,
                          compute_iters: int = 8, dtype=None,
                          devices=None, repeats: int = 5
                          ) -> List[OverlapPair]:
    """Time each transfer size three ways: the transfer alone (worker 0
    -> worker 1, ``InstanceMesh.replicate`` on the current stream, as a
    session's weight copies run), the reference's compute chain
    (``tanh(a @ a * scale)``, ``compute_iters`` times, ``compute_dim``
    wide in ``dtype``) alone on worker 1's device, and the transfer
    issued then the chain run, with one synchronization after both."""
    ws = _workers(devices, 2, "overlap micro")
    dst = InstanceMesh(ws[1:], 1)
    devs = [w.device for w in ws]
    dtype = torch.float32 if dtype is None else dtype
    scale = 1.0 / float(compute_dim) ** 0.5

    def burn(a):
        for _ in range(compute_iters):
            a = torch.tanh(a @ a * scale)
        return a

    out: List[OverlapPair] = []
    for nb in transfer_bytes:
        n = max(1, nb // 4)
        src = _randn((n,), torch.float32, ws[0].device, n % 89)
        x = _randn((compute_dim, compute_dim), dtype, ws[1].device, 7)
        tt = _time_isolated(lambda s=src: dst.replicate(s), devs,
                            repeats=repeats)
        tc = _time_isolated(lambda a=x: burn(a), devs, repeats=repeats)

        def both(s=src, a=x):
            moved = dst.replicate(s)     # issued first ...
            y = burn(a)                  # ... compute after it
            return moved, y

        tb = _time_isolated(both, devs, repeats=repeats)
        out.append(OverlapPair(n * 4, tt, tc, tb))
        del src, x
    return out


def measure_decode_tps(engine, steps: int = 8) -> float:
    """Decode tokens/second of a live engine with work resident (the
    caller primes it): ``engine.step()["emitted"]`` summed over one
    span, synchronized on the engine's devices at both ends.  Feeds
    ``fit_hardware``."""
    devs = ([w.device for w in engine.devices] if engine.devices
            else [engine.device])
    _sync(devs)
    emitted = 0
    t0 = time.perf_counter()
    for _ in range(max(steps, 1)):
        emitted += engine.step()["emitted"]
    _sync(devs)
    wall = time.perf_counter() - t0
    return emitted / max(wall, 1e-9)


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------

def predicted_time(m: Measurement, link: LinkModel) -> float:
    """What the accounting plane predicts for an ISOLATED (never
    overlapped) span of ``m``'s geometry under ``link``."""
    return MigrationStats(bytes_moved=m.bytes_moved,
                          segments=m.segments).time_s(link, overlap=False)


def fit_link_model(measurements: Sequence[Measurement],
                   prior: LinkModel = LinkModel(),
                   kinds: Optional[Sequence[str]] = None) -> LinkModel:
    """Least-squares fit of ``wall = bytes/bandwidth + segments *
    segment_overhead`` over the isolated spans.  ``kinds`` restricts
    the fit to the paths the link model actually prices (``calibrate``
    fits from the kv-migration spans: a weight copy and a spill copy
    have their own effective constants).  ``overlap_fraction`` keeps
    the prior: isolated micros hide nothing by construction.  Degenerate
    inputs (too few points, non-positive coefficients) fall back to a
    totals-ratio bandwidth with the prior's segment overhead — never a
    crash, never a negative constant."""
    import numpy as np

    if kinds is not None:
        pre = [m for m in measurements if m.kind in kinds]
        measurements = pre if pre else measurements
    ms = [m for m in measurements if m.wall_s > 0 and m.bytes_moved > 0]
    if not ms:
        return prior
    total_ratio = sum(m.bytes_moved for m in ms) / sum(m.wall_s
                                                       for m in ms)
    bandwidth = max(total_ratio, 1.0)
    seg_overhead = prior.segment_overhead
    if len(ms) >= 2:
        a = np.array([[m.bytes_moved, m.segments] for m in ms],
                     dtype=np.float64)
        b = np.array([m.wall_s for m in ms], dtype=np.float64)
        x, *_ = np.linalg.lstsq(a, b, rcond=None)
        if x[0] > 0.0:
            bandwidth = 1.0 / x[0]
            seg_overhead = max(float(x[1]), 0.0)
    return LinkModel(bandwidth=float(bandwidth),
                     segment_overhead=float(seg_overhead),
                     overlap_fraction=prior.overlap_fraction)


def fit_overlap_fraction(pairs: Sequence[OverlapPair],
                         prior: float = LinkModel().overlap_fraction
                         ) -> float:
    """Median hidden-fraction over the paired spans; the prior when no
    valid pair exists.  A backend whose copies serialize with compute
    fits 0.0, and the accounting plane then prices transform transfers
    at FULL cost even for the overlapped method, which is what that
    backend clocks."""
    vals = [p.overlap_frac for p in pairs
            if p.transfer_s > 0.0 and p.both_s > 0.0]
    return _median(vals) if vals else prior


def fit_hardware(prior: Hardware = H20,
                 decode_tps: Optional[float] = None,
                 prefill_tps: Optional[float] = None) -> Hardware:
    """Replace the throughput constants of ``prior`` with measured
    values where the caller supplies them (e.g. ``measure_decode_tps``
    on a live engine); the TP-efficiency curve (alpha/beta) keeps its
    Table-1 fit — one instance's micro cannot re-derive a curve."""
    kw = {}
    if decode_tps is not None and decode_tps > 0:
        kw["base_tps"] = float(decode_tps)
    if prefill_tps is not None and prefill_tps > 0:
        kw["prefill_tps"] = float(prefill_tps)
    return dataclasses.replace(prior, **kw) if kw else prior


# ---------------------------------------------------------------------------
# Measured feedback: the EWMA the decisions consume
# ---------------------------------------------------------------------------

class MeasuredCosts:
    """Per-(action-kind, degree-pair, bytes-bucket) EWMA of realized
    wall times, fed by both control planes from their ``transform_log``
    (and spill log).  ``estimate`` returns None until a key is WARM
    (``min_samples`` observations) — the caller then falls back to the
    modeled value, which is exactly the cold-start-prior rule the
    scheduler documents."""

    def __init__(self, alpha: float = 0.25, min_samples: int = 3):
        self.alpha = alpha
        self.min_samples = max(int(min_samples), 1)
        self._ewma: Dict[Tuple[str, int, int, int], float] = {}
        self._count: Dict[Tuple[str, int, int, int], int] = {}

    @staticmethod
    def bucket(nbytes: float) -> int:
        """log2 size bucket: transfers within 2x of each other share a
        key, so the EWMA tracks cost-per-shape, not a global blur."""
        n = int(max(nbytes, 0))
        return n.bit_length() if n else 0

    def observe(self, kind: str, tp_from: int, tp_to: int,
                wall_s: float, nbytes: float = 0.0) -> None:
        if wall_s < 0.0:
            return
        key = (kind, int(tp_from), int(tp_to), self.bucket(nbytes))
        prev = self._ewma.get(key)
        self._ewma[key] = (wall_s if prev is None
                           else (1 - self.alpha) * prev
                           + self.alpha * wall_s)
        self._count[key] = self._count.get(key, 0) + 1

    def observe_record(self, rec: Dict) -> None:
        """Ingest one control-plane log record (the shared
        ``transform_log`` schema; spill logs carry ``kind='spill'``).
        Same-degree LAYOUT changes (TP4 -> SP2xTP2: identical
        ``tp_from``/``tp_to`` but differing layout tags) file under
        their own ``'layout'`` kind — blurring them into the degree
        pair's EWMA would teach the model that a no-op migration costs
        a full re-partition."""
        kind = rec.get("kind", "transform")
        lf, lt = rec.get("layout_from"), rec.get("layout_to")
        if (kind == "transform" and lf is not None and lf != lt
                and rec.get("tp_from") == rec.get("tp_to")):
            kind = "layout"
        self.observe(kind,
                     rec.get("tp_from", 0), rec.get("tp_to", 0),
                     float(rec.get("wall_s", -1.0)),
                     float(rec.get("bytes", 0.0)))

    def _keys_for(self, kind: str, tp_from: int, tp_to: int):
        return [k for k in self._ewma
                if k[0] == kind and k[1] == int(tp_from)
                and k[2] == int(tp_to)]

    def warm(self, kind: str, tp_from: int = 0, tp_to: int = 0) -> bool:
        return sum(self._count[k]
                   for k in self._keys_for(kind, tp_from, tp_to)) \
            >= self.min_samples

    def estimate(self, kind: str, tp_from: int = 0, tp_to: int = 0,
                 nbytes: Optional[float] = None) -> Optional[float]:
        """Measured wall-time estimate for a degree pair, or None when
        cold.  With ``nbytes`` the matching size bucket wins when it is
        warm on its own; otherwise (and by default) the estimate is the
        observation-weighted mean across the pair's buckets."""
        keys = self._keys_for(kind, tp_from, tp_to)
        if not keys:
            return None
        if nbytes is not None:
            b = self.bucket(nbytes)
            key = (kind, int(tp_from), int(tp_to), b)
            if self._count.get(key, 0) >= self.min_samples:
                return self._ewma[key]
        total = sum(self._count[k] for k in keys)
        if total < self.min_samples:
            return None
        return sum(self._ewma[k] * self._count[k] for k in keys) / total


class CalibratedCostModel(CostModel):
    """A ``CostModel`` whose link constants are FITTED (not the paper's
    NVLink numbers) and whose transform/spill estimates come from the
    ``MeasuredCosts`` EWMA once warm, with the fitted model as the
    cold-start prior.  Attach to a scheduler with ``attach_cost`` and
    let the owning plane feed ``observe_transform``; both planes
    sharing one fitted link is what extends sim/live parity to costs."""

    def __init__(self, cfg: ModelConfig, hw: Hardware = H20,
                 link: Optional[LinkModel] = None,
                 measured: Optional[MeasuredCosts] = None):
        super().__init__(cfg, hw, link=link)
        self.measured = measured if measured is not None \
            else MeasuredCosts()

    def observe_transform(self, rec: Dict) -> None:
        """Control-plane feedback hook (``ClusterEngine.step`` /
        ``Cluster`` transform logging call it per new record)."""
        self.measured.observe_record(rec)

    def transform_time(self, method: str, n_layers: int | None = None,
                       tp_from: int = 1, tp_to: int | None = None,
                       layout_from=None, layout_to=None) -> float:
        from repro_torch.launch.mesh import Layout
        tt = 4 if tp_to is None else tp_to
        lay_from = Layout.of(layout_from if layout_from is not None
                             else max(tp_from, 1))
        lay_to = Layout.of(layout_to if layout_to is not None
                           else max(tt, 1))
        # same-degree re-factorizations have their own measured key
        # (see MeasuredCosts.observe_record) — a warm (4, 4) transform
        # EWMA of zero-cost migrations must not price a layout change
        kind = ("layout" if tp_from == tt and lay_from != lay_to
                else "transform")
        est = self.measured.estimate(kind, tp_from, tt)
        if est is not None:
            return est
        return super().transform_time(method, n_layers, tp_from, tp_to,
                                      layout_from=layout_from,
                                      layout_to=layout_to)

    def spill_time(self, tokens: int, page_tokens: int = 64,
                   pages: int | None = None) -> float:
        nbytes = kv_bytes_per_token(self.cfg) * max(tokens, 0)
        est = self.measured.estimate("spill", 0, 0, nbytes)
        if est is not None:
            return est
        return super().spill_time(tokens, page_tokens, pages)


# ---------------------------------------------------------------------------
# The calibration entry point
# ---------------------------------------------------------------------------

@dataclass
class CalibrationReport:
    """Everything a calibration run produced: the isolated spans, the
    fitted link, the per-measurement relative drift of the FITTED model
    against the isolated spans (the honest model error — no overlapped
    serving work in the denominator), and the ready-to-attach model."""
    link: LinkModel
    measurements: List[Measurement] = field(default_factory=list)
    drift_fracs: List[float] = field(default_factory=list)
    model: Optional[CalibratedCostModel] = None
    overlap_pairs: List[OverlapPair] = field(default_factory=list)
    # the overlap prior the fitted value replaced (drift denominator)
    overlap_prior: float = LinkModel().overlap_fraction

    @property
    def kv_migration_drift_frac(self) -> float:
        """Median |predicted - measured| / measured of the fitted model
        on the isolated KV-migration spans."""
        kv = [d for m, d in zip(self.measurements, self.drift_fracs)
              if m.kind.startswith("kv_migrate")]
        return _median(kv) if kv else float("nan")

    @property
    def drift_frac(self) -> float:
        return _median(self.drift_fracs) if self.drift_fracs \
            else float("nan")

    @property
    def overlap_frac(self) -> float:
        """The FITTED overlap fraction (what ``link`` now carries)."""
        return self.link.overlap_fraction

    @property
    def overlap_drift_frac(self) -> float:
        """|fitted - prior| / prior for the overlap fraction — how far
        this backend's measured transfer-hiding sits from the paper's
        §4.1 constant."""
        if not self.overlap_pairs:
            return float("nan")
        return abs(self.link.overlap_fraction - self.overlap_prior) \
            / max(self.overlap_prior, 1e-12)


@dataclass(frozen=True)
class MicroSizes:
    """The geometry of ``calibrate``'s micro-measurements; the defaults
    are the reference's (its measure functions' defaults, fp32)."""
    pages_per_worker: Tuple[int, ...] = (8, 32)
    kv_slots: int = 4
    page_tokens: int = 16
    head_dim: int = 32
    dtype: torch.dtype = torch.float32
    layer_bytes: Tuple[int, ...] = (1 << 18, 1 << 21)
    spill_pages: Tuple[int, ...] = (4, 16)
    transfer_bytes: Tuple[int, ...] = (1 << 20, 1 << 22)
    compute_dim: int = 256
    compute_iters: int = 8


def calibrate(cfg: ModelConfig, hw: Hardware = H20, devices=None,
              n_workers: int = 2, repeats: int = 5,
              measured: Optional[MeasuredCosts] = None,
              sizes: MicroSizes = MicroSizes()) -> CalibrationReport:
    """Run every isolated micro on ``devices`` (default: ``n_workers``
    workers of the card; it raises without a GPU unless the caller
    passes CPU devices), fit the link, and package a
    ``CalibratedCostModel``.  The kv migration runs on the first
    ``n_workers`` workers, the weight, spill and overlap micros between
    the first two."""
    devs = list(devices) if devices is not None else ["cuda"] * n_workers
    s = sizes
    ms: List[Measurement] = []
    ms += measure_kv_migration(n_workers=n_workers,
                               pages_per_worker=s.pages_per_worker,
                               kv_slots=s.kv_slots,
                               page_tokens=s.page_tokens,
                               head_dim=s.head_dim, dtype=s.dtype,
                               devices=devs, repeats=repeats)
    ms += measure_weight_put(layer_bytes=s.layer_bytes, devices=devs,
                             repeats=repeats)
    ms += measure_spill_copy(n_pages=s.spill_pages, kv_slots=s.kv_slots,
                             page_tokens=s.page_tokens,
                             head_dim=s.head_dim, dtype=s.dtype,
                             devices=devs, repeats=repeats)
    link = fit_link_model(ms, kinds=("kv_migrate_up",
                                     "kv_migrate_down"))
    # the isolated spans cannot see hiding; the paired overlap micro
    # replaces the §4.1 prior with what this backend's copies hide
    pairs = measure_overlap_pairs(transfer_bytes=s.transfer_bytes,
                                  compute_dim=s.compute_dim,
                                  compute_iters=s.compute_iters,
                                  dtype=s.dtype, devices=devs,
                                  repeats=repeats)
    prior_overlap = link.overlap_fraction
    link = dataclasses.replace(
        link, overlap_fraction=fit_overlap_fraction(pairs,
                                                    prior_overlap))
    drifts = [abs(predicted_time(m, link) - m.wall_s)
              / max(m.wall_s, 1e-12) for m in ms]
    model = CalibratedCostModel(cfg, hw, link=link, measured=measured)
    return CalibrationReport(link=link, measurements=ms,
                             drift_fracs=drifts, model=model,
                             overlap_pairs=pairs,
                             overlap_prior=prior_overlap)
