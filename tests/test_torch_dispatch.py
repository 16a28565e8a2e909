"""ops.batch.plan_to_device: a plan as views of one buffer, on the CPU.

For a synthetic 8-bit plan, a synthetic 10-bit plan with PCM planes and
a natively pre-packed chunk of three flagship tiles (native
.decode_tiles_parallel with pack_pad), every tensor of
plan_to_device(bp, cpu) equals its BatchPlan array bit for bit, with the
same dtype and shape, and is contiguous; steps[c] equals the six scan
fields bp.xs[c] stacked on the last axis; all of them are views of one
storage, each at a 256-byte-aligned offset, none overlapping another.
On the card the same layout goes over in one copy
(tests/test_torch_card.py queues two plans back to back).

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from heif_tpu_torch import native
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.tools import image_slices
from heif_tpu_torch.utils.synthetic import synthetic_batch

CPU = torch.device("cpu")
CLASS_FIELDS = ("tc_coeffs", "tc_qp", "tc_dst", "tc_skip", "tc_bypass",
                "tc_org")
MAPS = ("qp_map", "nf_map", "vert_edges", "horiz_edges", "sao")


def _plan(kind: str, halfmoonbay_bytes: bytes) -> B.BatchPlan:
    if kind == "synthetic8":
        return B.pack_batch(*synthetic_batch(n=3, size=128, bd=8, pcm=False,
                                             seed=3))
    if kind == "synthetic10_pcm":
        return B.pack_batch(*synthetic_batch(n=3, size=64, bd=10, pcm=True,
                                             seed=5))
    sps, pps, slices, _ = image_slices(halfmoonbay_bytes)
    slices = slices[:3]
    sts = native.decode_tiles_parallel(sps, pps, slices, pack_pad=B.PAD)
    assert all(st.packed is not None for st in sts)
    return B.pack_batch(sts, sps, pps, slices)


def _pairs(d: dict, bp: B.BatchPlan):
    """(name, shipped tensor, its BatchPlan array) for every array."""
    assert [(comp, size) for comp, size, *_ in d["classes"]] == list(
        bp.tc_coeffs)
    for comp, size, *ts in d["classes"]:
        for f, t in zip(CLASS_FIELDS, ts, strict=True):
            yield f"{f}{comp, size}", t, getattr(bp, f)[(comp, size)]
    assert set(d["scaling"]) == {(s, c) for c, s in bp.tc_coeffs}
    for k, t in d["scaling"].items():
        yield f"scaling{k}", t, bp.scaling[k]
    for c in range(3):
        yield f"steps{c}", d["steps"][c], np.stack(bp.xs[c], axis=-1)
        yield f"counts{c}", d["counts"][c], bp.counts[c]
        assert (d["pcm"][c] is None) == (bp.pcm[c] is None)
        if bp.pcm[c] is not None:
            yield f"pcm{c}", d["pcm"][c], bp.pcm[c]
    for f in MAPS:
        yield f, d[f], getattr(bp, f)


@pytest.mark.parametrize("kind",
                         ["synthetic8", "synthetic10_pcm", "native_prepacked"])
def test_plan_ships_as_views_of_one_buffer(kind, halfmoonbay_bytes):
    bp = _plan(kind, halfmoonbay_bytes)
    assert (kind == "synthetic10_pcm") == any(p is not None for p in bp.pcm)
    d = B.plan_to_device(bp, CPU)
    assert d["schedules"] == [None, None]
    pairs = list(_pairs(d, bp))
    spans = []
    storage = pairs[0][1].untyped_storage().data_ptr()
    for name, t, a in pairs:
        assert t.dtype == torch.from_numpy(a).dtype, name
        assert tuple(t.shape) == a.shape and t.is_contiguous(), name
        np.testing.assert_array_equal(t.numpy(), a, err_msg=name)
        assert t.untyped_storage().data_ptr() == storage, name
        start = t.storage_offset() * t.element_size()
        assert start % 256 == 0, name
        spans.append((start, start + t.numel() * t.element_size(), name))
    spans.sort()
    for (_, end, name), (start, _, nxt) in zip(spans, spans[1:]):
        assert end <= start, (name, nxt)
