"""The port's config (sesr_tpu_torch/config.py) against the JAX package's,
field by field."""

import dataclasses

import pytest

from sesr_tpu import config as jcfg
from sesr_tpu_torch import config as tcfg

TASK_NAMES = sorted(jcfg.TASKS)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_task_registry_same_tasks():
    assert sorted(tcfg.TASKS) == TASK_NAMES == sorted(
        ["nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"])
    assert tcfg.MFLAG_TO_TASK == jcfg.MFLAG_TO_TASK


@pytest.mark.parametrize("task", TASK_NAMES)
def test_spec_fields_and_properties(task):
    j, t = jcfg.spec_for_task(task), tcfg.spec_for_task(task)
    assert _fields(t) == _fields(j)
    for prop in ("num_convs", "kernel_sizes", "conv_out_channels",
                 "has_pixel_shuffle"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.halo_width() == j.halo_width()


def test_hardware_config():
    assert _fields(tcfg.DEFAULT_HW) == _fields(jcfg.DEFAULT_HW)
    assert (tcfg.DEFAULT_HW.quan_min, tcfg.DEFAULT_HW.quan_max) == \
        (jcfg.DEFAULT_HW.quan_min, jcfg.DEFAULT_HW.quan_max)
    hw = tcfg.HardwareConfig(quan_bits=6)
    assert (hw.quan_min, hw.quan_max) == (-32, 31)


def test_unknown_task():
    with pytest.raises(KeyError, match="unknown task"):
        tcfg.spec_for_task("sr_x3")
