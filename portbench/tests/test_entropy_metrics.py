"""The entropy layer's counter metrics read the native pool's counters
from DecodeStats, and read nothing (None) from a program without them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import metrics as M


def stats(entropy_s, **counters):
    return SimpleNamespace(stages={"entropy": entropy_s}, counters=counters)


def run(*calls) -> M.Run:
    return M.Run(images=len(calls), stats=list(calls))


def test_parallelism_is_busy_seconds_over_the_entropy_span():
    r = run(stats(0.1, entropy_busy_s=0.6, entropy_bins=10**6),
            stats(0.3, entropy_busy_s=0.2, entropy_bins=10**6))
    assert M.read("entropy_parallelism", r) == pytest.approx(2.0)


def test_mbins_s_is_bins_over_busy_seconds():
    r = run(stats(0.1, entropy_busy_s=0.5, entropy_bins=2 * 10**7),
            stats(0.1, entropy_busy_s=0.5, entropy_bins=10**7))
    assert M.read("entropy_mbins_s", r) == pytest.approx(30.0)


@pytest.mark.parametrize("name", ["entropy_parallelism", "entropy_mbins_s"])
def test_silent_without_the_counters(name):
    assert M.read(name, run(stats(0.2), stats(0.3, h2d_copies=1))) is None
    assert M.read(name, run()) is None
