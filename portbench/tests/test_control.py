"""The control (portbench.control) fails the comparison that the program
passes: on two flagship tiles whose levels pass 127, as a grid in both
kinds of answer and as two single-item images in a burst."""

from __future__ import annotations

import pytest

from portbench import control
from portbench.run import load_cell
from portbench.tests.conftest import bench


@pytest.mark.parametrize("workload,config", [
    ("flagship.decode", "small_config"), ("flagship.burst", "small_config"),
    ("single1080.burst64", "single_large_config")])
def test_control_is_not_correct(workload, config, request):
    spec = load_cell(workload, bench())
    spec["config"] = request.getfixturevalue(config)
    spec["traffic"] = dict(spec["traffic"], distinct_images=2,
                           images_per_call=1, retain_calls=2)
    caches = ({}, {})
    out = control.readings(spec, 2**31 + 5, processes=2, caches=caches)
    assert not out["correct"]
    assert out["mismatched_samples"] > 0 and out["checked_images"] == 2
    exact = control.readings(spec, 2**31 + 5, level_bits=16, processes=2,
                             caches=(caches[0], {}))
    assert exact["correct"] and exact["mismatched_samples"] == 0
