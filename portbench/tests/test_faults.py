"""A run of the harness (portbench.run.run_cell, the look for a card
skipped: the plain PyTorch path on the CPU, on the 2x2 grid_irot and on
four single-item images) with the timed path broken
underneath comes out not correct, once for each fault a cell can have:
a call that returns its last answer again; half of a call's work left
out; a sample altered where the decode produces it. (Every cell runs on
one card: no exchange between cards exists to leave out.)"""

from __future__ import annotations

import pytest
import torch

import heif_tpu_torch
from heif_tpu_torch.ops import batch as B
from portbench.run import load_cell, run_cell
from portbench.tests.conftest import bench

SEED = 2**31 + 31


def cpu_spec(workload, config, cell_ratio=False):
    """The cell at 2 images a call (or its own 1), 4 distinct images, or
    with cell_ratio as many times 2 as the cell has calls' worth."""
    spec = load_cell(workload, bench())
    spec["config"] = config
    traffic = spec["traffic"]
    per = min(2, traffic["images_per_call"])
    distinct = (per * traffic["distinct_images"] // traffic["images_per_call"]
                if cell_ratio else 4)
    spec["traffic"] = dict(traffic, distinct_images=distinct,
                           warmup_calls=1, retain_calls=8,
                           images_per_call=per)
    return spec


def stale(monkeypatch, workload):
    """Every call after the first returns the first call's answers."""
    if workload.endswith("decode"):
        real = heif_tpu_torch.HeicDecoder.decode
        first = []

        def decode(data, **kw):
            if not first:
                first.append(real(data, **kw))
            return first[0]

        monkeypatch.setattr(heif_tpu_torch.HeicDecoder, "decode",
                            staticmethod(decode))
    else:
        real = B.decode_burst
        first = []

        def decode_burst(sps, pps, lists, **kw):
            if not first:
                first.append(real(sps, pps, lists, **kw))
            return first[0]

        monkeypatch.setattr(B, "decode_burst", decode_burst)


def half(monkeypatch, workload):
    """Half of a call's tiles (decode) or images (burst) left out."""
    if workload.endswith("decode"):
        real = B.reconstruct_tiles

        def reconstruct_tiles(syntaxes, sps, pps, slices, **kw):
            k = len(slices) // 2
            out = real(syntaxes[:k], sps, pps, slices[:k], **kw)
            return out + [[p * 0 for p in out[0]]] * (len(slices) - k)

        monkeypatch.setattr(B, "reconstruct_tiles", reconstruct_tiles)
    else:
        real = B.decode_burst

        def decode_burst(sps, pps, lists, **kw):
            k = len(lists) // 2
            return real(sps, pps, lists[:k], **kw) + [[]] * (len(lists) - k)

        monkeypatch.setattr(B, "decode_burst", decode_burst)


def altered(monkeypatch, workload):
    """One luma sample of every core call off by one."""
    real = B.core

    def core(*a, **kw):
        planes = real(*a, **kw)
        y = planes[0].clone()
        y[0, 0, 0] += 1
        return [y, *planes[1:]]

    monkeypatch.setattr(B, "core", core)


@pytest.mark.parametrize("workload,config,cell_ratio", [
    ("flagship.decode", "irot_config", False),
    ("flagship.burst", "irot_config", False),
    ("single1080.burst64", "single_config", False),
    ("single1080.burst64", "single_config", True)])
@pytest.mark.parametrize("fault", [None, stale, half, altered])
def test_fault_is_caught(workload, config, cell_ratio, fault, request,
                         monkeypatch):
    spec = cpu_spec(workload, request.getfixturevalue(config), cell_ratio)
    if fault is not None:
        fault(monkeypatch, workload)
    torch.manual_seed(0)
    out = run_cell(spec, SEED, seconds=2.0, trace=False, device="cpu",
                   processes=2)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["checks"]["checked_images"]["value"] >= 2
