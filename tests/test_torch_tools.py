"""The port's measurement scripts (``feinsum_tpu_torch/tools``): the parts
that need no card."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from feinsum_tpu_torch.tools import profile_suite, sweep_block_long


def _ev(device_type, start, end):
    return SimpleNamespace(device_type=device_type,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("events,busy", [
    # a host operator spanning its kernel is not device time
    ([_ev(DeviceType.CPU, 0, 100), _ev(DeviceType.CUDA, 10, 40)], 30),
    # overlapping and nested device intervals count once, gaps not at all
    ([_ev(DeviceType.CUDA, 50, 70), _ev(DeviceType.CUDA, 0, 20),
      _ev(DeviceType.CUDA, 10, 30), _ev(DeviceType.CUDA, 55, 60)], 50),
    ([_ev(DeviceType.CPU, 0, 5)], 0),
])
def test_device_busy_counts_device_intervals_once(events, busy):
    assert profile_suite.device_busy_us(events) == busy


def test_sweep_covers_the_suite_value():
    from feinsum_tpu_torch.suite import BLOCK_LONG

    assert BLOCK_LONG in sweep_block_long.BLOCKS
