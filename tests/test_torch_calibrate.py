"""Measured-cost calibration in the port (``repro_torch.core.calibrate``)
against the reference (``repro.core.calibrate``).

* The reference's pure-Python cases (``tests/test_calibrate.py``): the
  degree-pair cost order, the zero-horizon guard, page-size threading,
  ``MeasuredCosts`` cold, warm and bucket selection, the rung cost
  consuming the EWMA, and the link fit on synthetic, degenerate and
  kind-scoped spans.  Each runs on both packages with the same inputs
  (``pkg``), and the port's fits equal the reference's: ``LinkModel``
  fields within 1e-9 relative, the overlap fraction and ``Hardware``
  exactly.
* ``calibrate`` on two CPU workers: every ``Measurement``'s bytes and
  segments equal the reference's accounting of the same geometry, the
  bytes the port really copied are counted, and the fitted constants
  are positive and finite.  Nothing is asserted of a CPU time beyond
  "positive and finite".
"""
import dataclasses
import math
import types
import warnings

import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import calibrate as RK
from repro.core import costmodel as RC
from repro.core import events as RE
from repro.core import kv_transform as RKT
from repro.core import scheduler as RS
from repro_torch.configs import get_config
from repro_torch.core import calibrate as TK
from repro_torch.core import costmodel as TC
from repro_torch.core import events as TE
from repro_torch.core import kv_transform as TKT
from repro_torch.core import scheduler as TS

REL = 1e-9


def _ns(k, c, e, kt, s, cfg_of):
    return types.SimpleNamespace(
        CostModel=c.CostModel, CalibratedCostModel=k.CalibratedCostModel,
        MeasuredCosts=k.MeasuredCosts, Measurement=k.Measurement,
        OverlapPair=k.OverlapPair, fit_link_model=k.fit_link_model,
        fit_overlap_fraction=k.fit_overlap_fraction,
        fit_hardware=k.fit_hardware, predicted_time=k.predicted_time,
        LinkModel=kt.LinkModel, ArrivalPressure=e.ArrivalPressure,
        GygesScheduler=s.GygesScheduler, SchedulerConfig=s.SchedulerConfig,
        ScaleUp=s.ScaleUp, Spill=s.Spill, H20=c.H20,
        CFG=cfg_of("llama3-8b").reduced())


PKGS = {"ref": _ns(RK, RC, RE, RKT, RS, ref_config),
        "port": _ns(TK, TC, TE, TKT, TS, get_config)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# transform_time prices the real degree pair
# ---------------------------------------------------------------------------

def test_transform_time_degree_pair_monotone(pkg):
    cm = pkg.CostModel(pkg.CFG)
    t12 = cm.transform_time("gyges", tp_from=1, tp_to=2)
    t14 = cm.transform_time("gyges", tp_from=1, tp_to=4)
    assert 0.0 < t12 < t14


def test_transform_time_default_is_legacy_tp4(pkg):
    cm = pkg.CostModel(pkg.CFG)
    for method in ("gyges", "gyges-", "basic"):
        assert cm.transform_time(method) == cm.transform_time(
            method, tp_from=1, tp_to=4)


def test_transform_time_same_degree_free_and_down_differs(pkg):
    cm = pkg.CostModel(pkg.CFG)
    assert cm.transform_time("gyges", tp_from=2, tp_to=2) == 0.0
    up = cm.transform_time("gyges", tp_from=1, tp_to=4)
    down = cm.transform_time("gyges", tp_from=4, tp_to=1)
    assert up > 0.0 and down > 0.0 and up != down


# ---------------------------------------------------------------------------
# zero-horizon guard + derived horizon
# ---------------------------------------------------------------------------

def test_attach_pressure_warns_on_zero_horizon(pkg):
    s = pkg.GygesScheduler(pkg.SchedulerConfig(long_threshold=16))
    with pytest.warns(RuntimeWarning, match="zero transform-cost"):
        s.attach_pressure(pkg.ArrivalPressure())


def test_horizon_derived_from_attached_cost_model(pkg):
    s = pkg.GygesScheduler(pkg.SchedulerConfig(long_threshold=16,
                                               target_tp=4))
    s.attach_cost(pkg.CostModel(pkg.CFG))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.attach_pressure(pkg.ArrivalPressure())
    assert s.transform_horizon_s() == pytest.approx(
        pkg.CostModel(pkg.CFG).transform_time("gyges", tp_from=1,
                                              tp_to=4))


def test_explicit_transform_cost_still_wins(pkg):
    s = pkg.GygesScheduler(pkg.SchedulerConfig(long_threshold=16,
                                               transform_cost_s=5.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.attach_pressure(pkg.ArrivalPressure())
    assert s.transform_horizon_s() == 5.0


# ---------------------------------------------------------------------------
# spill_time tracks the pool's page geometry
# ---------------------------------------------------------------------------

def test_spill_time_threads_page_size(pkg):
    cm = pkg.CostModel(pkg.CFG)
    t16 = cm.spill_time(1024, page_tokens=16)
    t64 = cm.spill_time(1024, page_tokens=64)
    assert t16 > t64
    seg = cm.link.segment_overhead
    assert t16 - t64 == pytest.approx((1024 // 16 - 1024 // 64) * seg)
    assert cm.spill_time(1024, page_tokens=16, pages=1) == \
        pytest.approx(cm.spill_time(1024, page_tokens=1024))


def test_rung_cost_uses_configured_page_tokens(pkg):
    costs = {}
    for pt in (16, 64):
        s = pkg.GygesScheduler(pkg.SchedulerConfig(long_threshold=16,
                                                   page_tokens=pt))
        s.attach_cost(pkg.CostModel(pkg.CFG))
        costs[pt], _ = s._rung_cost(
            pkg.Spill(iid=0, host_iid=1, tokens=1024), 0)
    assert costs[16] > costs[64]


# ---------------------------------------------------------------------------
# The feedback loop: MeasuredCosts EWMA + _rung_cost consumption
# ---------------------------------------------------------------------------

def test_measured_costs_cold_then_warm(pkg):
    mc = pkg.MeasuredCosts(alpha=0.5, min_samples=3)
    assert mc.estimate("transform", 1, 4) is None
    mc.observe("transform", 1, 4, 1.0, nbytes=1e6)
    mc.observe("transform", 1, 4, 1.0, nbytes=1e6)
    assert mc.estimate("transform", 1, 4) is None
    mc.observe("transform", 1, 4, 1.0, nbytes=1e6)
    assert mc.warm("transform", 1, 4)
    assert mc.estimate("transform", 1, 4) == pytest.approx(1.0)
    assert mc.estimate("transform", 1, 2) is None


def test_measured_costs_bytes_bucket_selection(pkg):
    mc = pkg.MeasuredCosts(min_samples=2)
    for _ in range(2):
        mc.observe("spill", 0, 0, 0.010, nbytes=1 << 20)
    for _ in range(2):
        mc.observe("spill", 0, 0, 0.500, nbytes=1 << 28)
    small = mc.estimate("spill", 0, 0, nbytes=1 << 20)
    large = mc.estimate("spill", 0, 0, nbytes=1 << 28)
    assert small == pytest.approx(0.010)
    assert large == pytest.approx(0.500)
    blended = mc.estimate("spill", 0, 0)
    assert small < blended < large


def test_measured_costs_layout_records_keep_their_kind(pkg):
    mc = pkg.MeasuredCosts(min_samples=1)
    mc.observe_record({"kind": "transform", "tp_from": 4, "tp_to": 4,
                       "layout_from": "TP4", "layout_to": "SP2xTP2",
                       "wall_s": 2.0})
    assert mc.estimate("layout", 4, 4) == 2.0
    assert mc.estimate("transform", 4, 4) is None


def test_rung_cost_consumes_measured_ewma(pkg):
    cal = pkg.CalibratedCostModel(pkg.CFG)
    s = pkg.GygesScheduler(pkg.SchedulerConfig(long_threshold=16,
                                               target_tp=4))
    s.attach_cost(cal)
    act = pkg.ScaleUp(iid=0, tp_to=4, donor_iids=(1, 2, 3))
    modeled, _ = s._rung_cost(act, 2)
    assert modeled == pytest.approx(
        pkg.CostModel(pkg.CFG).transform_time("gyges", tp_from=1, tp_to=4))
    for _ in range(3):
        cal.observe_transform({"kind": "transform", "tp_from": 1,
                               "tp_to": 4, "wall_s": 0.321,
                               "bytes": 1e6})
    warm, _ = s._rung_cost(act, 2)
    assert warm == pytest.approx(0.321) and warm != modeled
    cold, _ = s._rung_cost(pkg.ScaleUp(iid=0, tp_to=2, donor_iids=(1,)), 2)
    assert cold == pytest.approx(
        pkg.CostModel(pkg.CFG).transform_time("gyges", tp_from=1, tp_to=2))


def test_pressure_horizon_tracks_measured_costs(pkg):
    cal = pkg.CalibratedCostModel(pkg.CFG)
    s = pkg.GygesScheduler(pkg.SchedulerConfig(long_threshold=16,
                                               target_tp=4))
    s.attach_cost(cal)
    for _ in range(3):
        cal.observe_transform({"kind": "transform", "tp_from": 1,
                               "tp_to": 4, "wall_s": 7.5})
    assert s.transform_horizon_s() == pytest.approx(7.5)


def test_calibrated_spill_time_warm_and_cold(pkg):
    cal = pkg.CalibratedCostModel(pkg.CFG)
    prior = pkg.CostModel(pkg.CFG)
    assert cal.spill_time(512, page_tokens=16) == pytest.approx(
        prior.spill_time(512, page_tokens=16))
    for _ in range(3):
        cal.observe_transform({"kind": "spill", "tp_from": 0,
                               "tp_to": 0, "wall_s": 0.042})
    assert cal.spill_time(512, page_tokens=16) == pytest.approx(0.042)


# ---------------------------------------------------------------------------
# fit_link_model on synthetic spans, and the two packages' fits equal
# ---------------------------------------------------------------------------

SYNTH = ((1 << 17, 16), (1 << 19, 512), (1 << 21, 64), (1 << 22, 4096))


def _synthetic(pkg, bw=2e8, seg=5e-6, kind="kv_migrate_up", geo=SYNTH):
    return [pkg.Measurement(kind, b, s, b / bw + s * seg) for b, s in geo]


def _link_fields(link):
    return (link.bandwidth, link.segment_overhead, link.overlap_fraction)


def test_fit_recovers_synthetic_link(pkg):
    ms = _synthetic(pkg)
    fit = pkg.fit_link_model(ms)
    assert fit.bandwidth == pytest.approx(2e8, rel=1e-6)
    assert fit.segment_overhead == pytest.approx(5e-6, rel=1e-6)
    for m in ms:
        assert pkg.predicted_time(m, fit) == pytest.approx(m.wall_s,
                                                           rel=1e-6)


def test_fit_degenerate_inputs_fall_back(pkg):
    prior = pkg.LinkModel()
    assert pkg.fit_link_model([], prior) == prior
    one = [pkg.Measurement("kv_migrate_up", 1 << 20, 16, 0.01)]
    fit = pkg.fit_link_model(one, prior)
    assert fit.bandwidth == pytest.approx((1 << 20) / 0.01)
    assert fit.segment_overhead == prior.segment_overhead
    assert fit.overlap_fraction == prior.overlap_fraction


def test_fit_kinds_scoping(pkg):
    kv = _synthetic(pkg, 1e8, 1e-6, geo=((1 << 17, 16), (1 << 20, 2048),
                                         (1 << 22, 256)))
    junk = [pkg.Measurement("spill_copy", 1 << 16, 4, 0.3)]
    fit = pkg.fit_link_model(kv + junk, kinds=("kv_migrate_up",
                                               "kv_migrate_down"))
    assert fit.bandwidth == pytest.approx(1e8, rel=1e-6)


#: noisy spans (the fit is no longer exact): the same numbers into both
NOISY = [("kv_migrate_up", 1 << 17, 16, 2.1e-3),
         ("kv_migrate_down", 1 << 19, 512, 7.3e-3),
         ("kv_migrate_up", 1 << 21, 64, 1.25e-2),
         ("kv_migrate_down", 1 << 22, 4096, 4.9e-2),
         ("weight_put", 1 << 21, 1, 3.0e-4),
         ("spill_copy", 1 << 18, 16, 9.0e-4)]


@pytest.mark.parametrize("kinds", [None, ("kv_migrate_up",
                                          "kv_migrate_down")],
                         ids=["all", "kv"])
def test_fits_equal_across_packages(kinds):
    r, t = PKGS["ref"], PKGS["port"]
    cases = ([], NOISY[:1], NOISY, NOISY[4:],
             [(k, b, s, w) for k, b, s, w in NOISY if k != "weight_put"])
    for rows in cases:
        fr = r.fit_link_model([r.Measurement(*x) for x in rows],
                              kinds=kinds)
        ft = t.fit_link_model([t.Measurement(*x) for x in rows],
                              kinds=kinds)
        for a, b in zip(_link_fields(fr), _link_fields(ft)):
            assert math.isclose(a, b, rel_tol=REL), (rows, fr, ft)
        for x in rows:
            assert math.isclose(r.predicted_time(r.Measurement(*x), fr),
                                t.predicted_time(t.Measurement(*x), ft),
                                rel_tol=REL)


def test_overlap_and_hardware_fits_equal_across_packages():
    r, t = PKGS["ref"], PKGS["port"]
    spans = [(1 << 20, 1e-3, 5e-3, 5.5e-3), (1 << 22, 4e-3, 5e-3, 9.2e-3),
             (1 << 24, 1.6e-2, 5e-3, 1.2e-2), (1 << 10, 0.0, 1e-3, 1e-3)]
    for n in range(len(spans) + 1):
        pr = [r.OverlapPair(*x) for x in spans[:n]]
        pt = [t.OverlapPair(*x) for x in spans[:n]]
        assert [p.overlap_frac for p in pr] == [p.overlap_frac for p in pt]
        assert r.fit_overlap_fraction(pr) == t.fit_overlap_fraction(pt)
    for kw in ({}, {"decode_tps": 812.5}, {"prefill_tps": 27_600.0},
               {"decode_tps": 812.5, "prefill_tps": -1.0}):
        prior_r = dataclasses.replace(r.H20, mem_bytes=85e9)
        prior_t = dataclasses.replace(t.H20, mem_bytes=85e9)
        assert dataclasses.asdict(r.fit_hardware(prior_r, **kw)) == \
            dataclasses.asdict(t.fit_hardware(prior_t, **kw))


# ---------------------------------------------------------------------------
# calibrate() on CPU workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def report():
    torch.manual_seed(0)
    return TK.calibrate(get_config("llama3-8b").reduced(),
                        devices=["cpu"] * 2, repeats=2)


def test_calibrate_accounting_equals_reference(report):
    """Every span carries the reference's accounting of the same
    geometry (the reference's measure functions' defaults, fp32)."""
    s = TK.MicroSizes()
    want = []
    for npw in s.pages_per_worker:
        st = RKT.sharded_migration_stats(2, npw, s.kv_slots, s.page_tokens,
                                         s.head_dim, dtype_bytes=4)
        want += [("kv_migrate_up", st.bytes_moved, st.segments, 1, 2),
                 ("kv_migrate_down", st.bytes_moved, st.segments, 2, 1)]
    want += [("weight_put", nb // 4 * 4, 1, 1, 1) for nb in s.layer_bytes]
    page = s.kv_slots * 2 * s.page_tokens * s.head_dim * 4
    want += [("spill_copy", n * page, n, 1, 1) for n in s.spill_pages]
    got = [(m.kind, m.bytes_moved, m.segments, m.tp_from, m.tp_to)
           for m in report.measurements]
    assert got == want


def test_calibrate_counts_the_bytes_really_copied(report):
    """``migrate_sharded`` moves gather + exchange + kept copy at W = 2:
    3x the pools' bytes up (6x the accounted sent half), 4x down; a
    weight put and a spill copy on one device read and write their
    bytes once."""
    for m in report.measurements:
        ratio = {"kv_migrate_up": 6, "kv_migrate_down": 8,
                 "weight_put": 2, "spill_copy": 2}[m.kind]
        assert m.copied_bytes == ratio * m.bytes_moved, m


def test_calibrate_constants_positive_and_finite(report):
    link = report.link
    assert math.isfinite(link.bandwidth) and link.bandwidth > 0
    assert math.isfinite(link.segment_overhead) \
        and link.segment_overhead >= 0
    assert 0.0 <= link.overlap_fraction <= 1.0
    assert report.overlap_prior == TKT.LinkModel().overlap_fraction
    assert len(report.overlap_pairs) == 2
    for m in report.measurements:
        assert math.isfinite(m.wall_s) and m.wall_s > 0, m
    for p in report.overlap_pairs:
        for x in (p.transfer_s, p.compute_s, p.both_s):
            assert math.isfinite(x) and x > 0, p
    assert len(report.drift_fracs) == len(report.measurements)
    assert all(math.isfinite(d) for d in report.drift_fracs)
    assert math.isfinite(report.kv_migration_drift_frac)
    assert isinstance(report.model, TK.CalibratedCostModel)
    assert report.model.link == link


def test_calibrate_ladder_order_holds(report):
    """The representative ladder scenario of the reference's
    cross-validation: spill cheapest, partial merge cheaper than the
    full merge, under the prior and under the fit."""
    def rung_costs(model):
        s = TS.GygesScheduler(TS.SchedulerConfig(
            long_threshold=16, target_tp=4, page_tokens=16))
        s.attach_cost(model)
        acts = [TS.Spill(iid=0, host_iid=1, tokens=24),
                TS.ScaleUp(iid=0, tp_to=4, donor_iids=(1, 2),
                           donor_devices=(1, 1)),
                TS.ScaleUp(iid=0, tp_to=4, donor_iids=(1, 2, 3))]
        return [s._rung_cost(a, i)[0] for i, a in enumerate(acts)]

    for model in (TC.CostModel(get_config("llama3-8b").reduced()),
                  report.model):
        spill, partial, full = rung_costs(model)
        assert spill < partial < full


def test_measure_decode_tps_on_cpu_engine():
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import ServeRequest
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    eng = Engine(cfg, max_batch=2, max_seq=64, page_tokens=16,
                 device="cpu")
    for i in range(2):
        eng.submit(ServeRequest(rid=i, prompt=list(range(3, 11 + i)),
                                max_new_tokens=12))
    eng.step()
    tps = TK.measure_decode_tps(eng, steps=4)
    assert math.isfinite(tps) and tps > 0


def test_calibrate_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TK.calibrate(get_config("llama3-8b").reduced())
