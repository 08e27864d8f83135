"""The port's configs and padding plans equal the reference's.

``repro_torch.configs`` and ``repro_torch.core.padding`` are jax-free
copies; every architecture's config, its ``reduced()`` variant and its
``PaddingPlan`` at TP 1, 2, 4 and 8 (both padding modes) must be
field-for-field equal to the JAX package's.
"""
import dataclasses

import pytest

from repro.configs import registry as jreg
from repro.core import padding as jpad
from repro_torch.configs import registry as treg
from repro_torch.core import padding as tpad

ARCHS = sorted(jreg._MODULES)


def _fields(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_equal(arch):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    assert _fields(j) == _fields(t)
    assert _fields(j.reduced()) == _fields(t.reduced())
    assert j.pattern == t.pattern
    assert j.param_count() == t.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_plans_equal_at_every_tp(arch):
    j, t = jreg.get_config(arch), treg.get_config(arch)
    for tp in (1, 2, 4, 8):
        for mode in ("lane", "page"):
            pj = jpad.make_plan(j, tp, mode=mode)
            pt = tpad.make_plan(t, tp, mode=mode)
            assert _fields(pj) == _fields(pt), (tp, mode)
            assert pj.q_head_mask() == pt.q_head_mask()
            assert pj.kv_head_mask() == pt.kv_head_mask()
        rj, rt = j.reduced(), t.reduced()
        assert (_fields(jpad.make_plan(rj, tp))
                == _fields(tpad.make_plan(rt, tp)))


def test_registry_lists_match():
    assert treg.ASSIGNED_ARCHS == jreg.ASSIGNED_ARCHS
    assert sorted(treg._MODULES) == ARCHS
