"""The port's cost model (``repro_torch.core.costmodel``) against the
reference's (``repro.core.costmodel``), call for call.

Every config of the registry goes through both packages' ``CostModel``
at each public method: memory and throughput over tp in {1, 2, 4, 8}
and sp in {1, 2} with both ``long_context`` values, the prefill and
spill times, and ``transform_time`` for every method over degree pairs
and layout pairs.  ``layout_decode_tps`` and ``kv_bytes_per_token``
too.  Pure Python, the same float arithmetic: relative tolerance 1e-12
(an exception, where the reference raises, must be the same type).
"""
import dataclasses
import math

import pytest

from repro.configs import get_config as ref_config
from repro.core import costmodel as RC
from repro.launch.mesh import Layout as RLayout
from repro_torch.configs import get_config
from repro_torch.configs.registry import all_configs
from repro_torch.core import costmodel as TC
from repro_torch.launch.mesh import Layout as TLayout

REL = 1e-12
NAMES = sorted(all_configs(include_paper_model=True))
METHODS = ("gyges", "gyges-", "basic", "seesaw", "kunserve", "loongserve")
TPS = (1, 2, 4, 8)
PAIRS = ((1, 2), (1, 4), (2, 4), (1, 8), (4, 8), (2, 1), (4, 1), (4, 2),
         (8, 1), (2, 2), (4, 4), (1, None))
LAYOUT_PAIRS = (((1, 4), (2, 2)), ((2, 2), (1, 4)), ((1, 2), (2, 1)),
                ((2, 1), (1, 2)), ((1, 4), (4, 1)), ((2, 2), (2, 2)),
                ((1, 2), (2, 2)), ((2, 2), (1, 1)))
HARDWARE = {"H20": (RC.H20, TC.H20), "A100_40G": (RC.A100_40G,
                                                  TC.A100_40G)}


def _same(a, b, what):
    if isinstance(a, float) or isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=REL, abs_tol=0.0), (what, a, b)
    else:
        assert a == b, (what, a, b)


def _both(what, ref_fn, port_fn):
    """Both calls' results (or exception types) must agree."""
    try:
        want = ref_fn()
    except Exception as e:           # noqa: BLE001 - compared below
        with pytest.raises(type(e)):
            port_fn()
        return
    _same(want, port_fn(), what)


def _models(name, hw="H20"):
    rh, th = HARDWARE[hw]
    return (RC.CostModel(ref_config(name), rh),
            TC.CostModel(get_config(name), th))


def test_hardware_presets_equal():
    for rh, th in HARDWARE.values():
        assert dataclasses.asdict(rh) == dataclasses.asdict(th)
    assert dataclasses.asdict(RC.Hardware()) == dataclasses.asdict(
        TC.Hardware())


def test_weight_and_kv_bytes_equal():
    for name in NAMES:
        r, t = ref_config(name), get_config(name)
        for fn in ("weight_bytes", "kv_bytes_per_token",
                   "_kv_bytes_guarded"):
            _same(getattr(RC, fn)(r), getattr(TC, fn)(t), (name, fn))
        rr, tr = r.reduced(), t.reduced()
        _same(RC.kv_bytes_per_token(rr), TC.kv_bytes_per_token(tr),
              (name, "reduced"))


@pytest.mark.parametrize("hw", sorted(HARDWARE))
def test_layout_decode_tps_equal(hw):
    rh, th = HARDWARE[hw]
    custom = (dataclasses.replace(rh, base_tps=1234.5, sp_gamma=0.1),
              dataclasses.replace(th, base_tps=1234.5, sp_gamma=0.1))
    for r_hw, t_hw in ((rh, th), custom):
        for tp in TPS:
            for sp in (1, 2, 4):
                for long_ in (False, True):
                    _same(RC.layout_decode_tps(RLayout(sp, tp), long_,
                                               r_hw),
                          TC.layout_decode_tps(TLayout(sp, tp), long_,
                                               t_hw),
                          (hw, sp, tp, long_))
                _same(RC.layout_decode_tps(tp, False, r_hw),
                      TC.layout_decode_tps(tp, False, t_hw), (hw, tp))


@pytest.mark.parametrize("hw", sorted(HARDWARE))
@pytest.mark.parametrize("name", NAMES)
def test_memory_and_throughput_equal(name, hw):
    r, t = _models(name, hw)
    for tp in TPS:
        for fn in ("kv_capacity_tokens", "max_seq", "per_gpu_tps"):
            _both((name, fn, tp), lambda: getattr(r, fn)(tp),
                  lambda: getattr(t, fn)(tp))
        for sp in (1, 2):
            for long_ in (False, True):
                _same(r.instance_tps(tp, sp, long_),
                      t.instance_tps(tp, sp, long_), (name, tp, sp, long_))
                _same(r.layout_tps(RLayout(sp, tp), long_),
                      t.layout_tps(TLayout(sp, tp), long_),
                      (name, "layout", tp, sp, long_))
            _same(r.layout_tps(tp), t.layout_tps(tp), (name, "int", tp))
        for n in (1, 1000, 50_000):
            _same(r.prefill_time(tp, n), t.prefill_time(tp, n),
                  (name, "prefill", tp, n))
    for tokens in (0, 1, 100, 1024, 5000):
        for pt in (16, 64):
            _same(r.spill_time(tokens, pt), t.spill_time(tokens, pt),
                  (name, "spill", tokens, pt))
        _same(r.spill_time(tokens, 16, pages=3),
              t.spill_time(tokens, 16, pages=3), (name, "pages", tokens))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_transform_time_equal(name, method):
    r, t = _models(name)
    _both((name, method, "default"), lambda: r.transform_time(method),
          lambda: t.transform_time(method))
    for a, b in PAIRS:
        _both((name, method, a, b),
              lambda: r.transform_time(method, tp_from=a, tp_to=b),
              lambda: t.transform_time(method, tp_from=a, tp_to=b))
    _both((name, method, "n_layers"),
          lambda: r.transform_time(method, n_layers=3, tp_from=1, tp_to=2),
          lambda: t.transform_time(method, n_layers=3, tp_from=1, tp_to=2))
    for la, lb in LAYOUT_PAIRS:
        ra, rb, ta, tb = RLayout(*la), RLayout(*lb), TLayout(*la), \
            TLayout(*lb)
        _both((name, method, la, lb),
              lambda: r.transform_time(method, tp_from=ra.degree,
                                       tp_to=rb.degree, layout_from=ra,
                                       layout_to=rb),
              lambda: t.transform_time(method, tp_from=ta.degree,
                                       tp_to=tb.degree, layout_from=ta,
                                       layout_to=tb))
