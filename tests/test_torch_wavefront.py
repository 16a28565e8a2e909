"""The intra kernels' wavefront schedule, checked on the CPU.

The CUDA intra kernels (csrc/intra.cu) walk each tile's CTB rows side by
side, as ops.intra.unit_table schedules them; the kernels themselves run
only on a card (chip_smoke.py and tests/test_torch_card.py hold them
against the plain walk there). Here, on flagship tile 0, the synthetic
10-bit PCM + strong-smoothing batch, the tiles-enabled fixture picture
(2x2 HEVC tiles) and a tall synthetic batch cut into HEVC tiles:
- wavefront_plain, the most eager order the unit table allows, equals
  the sequential walk (recon.intra_scan_component) bit for bit, luma and
  Cb + Cr;
- every reference sample a step reads (recon.ref_sources) lies in a CTB
  the schedule has finished: earlier in the step's own unit, or in its
  wait unit at most one CTB column to the right of the step's;
- with its waits removed the table gives another result (the check can
  fail); padded with empty units (ops.intra.pad_schedule) it gives the
  same;
- each unit is one run of steps of one CTB row of one HEVC tile, and
  the units cover every real step once;
- unit_table on hand-made worklists: padding steps, counts < S, HEVC
  tile columns and rows, and a worklist out of decode order (no unit
  then waits on a later one).
"""

import dataclasses

import numpy as np
import pytest
import torch

from heif_tpu.utils import hevc_synth
from heif_tpu.utils.heif_mux import mux_heic
from heif_tpu_torch import native
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.ops import intra as I
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.ops import residual as RS
from heif_tpu_torch.tools import image_slices
from heif_tpu_torch.utils.synthetic import synthetic_batch

CPU = torch.device("cpu")
KINDS = ("flagship0", "synthetic", "tiles", "tall")
PADDED_UNITS = 8150  # chip_smoke.py's padded unit tables


def _decoded(data: bytes):
    """Entropy-decoded first tile (grid order) of an image."""
    sps, pps, slices, _ = image_slices(data)
    slices = slices[:1]
    return native.decode_tiles_parallel(sps, pps, slices), sps, pps, slices


@pytest.fixture(scope="module")
def plans(halfmoonbay_bytes):
    tiles = mux_heic([hevc_synth.synthesize_tiled_intra_stream(
        96, 64, (2, 2), seed=3)])
    tall = B.pack_batch(*synthetic_batch(n=1, size=128, height=512, bd=8,
                                         pcm=False, seed=5))
    out = {
        "flagship0": B.pack_batch(*_decoded(halfmoonbay_bytes)),
        "synthetic": B.pack_batch(*synthetic_batch(n=2, size=64, height=96,
                                                   bd=10, pcm=True, seed=3)),
        "tiles": B.pack_batch(*_decoded(tiles)),
        "tall": dataclasses.replace(tall, tile_col_bd=(64,),
                                    tile_row_bd=(256,)),
    }
    assert out["tiles"].tile_col_bd and out["synthetic"].strong_smoothing
    return {k: (bp, *_inputs(bp)) for k, bp in out.items()}


def _inputs(bp):
    """Device dict (with the schedules the CUDA path builds), residual
    planes and source tables of a plan, on the CPU."""
    d = B.plan_to_device(bp, CPU)
    d["schedules"] = B.unit_tables(d, bp)
    return d, RS.residual_planes(d, bp), B.source_tables(d, bp)


def _walks(bp, d, res, srcs, comp, sch=None):
    """(sequential, wavefront) planes of luma (comp 0) or Cb + Cr."""
    c = min(comp, 1)
    sch = d["schedules"][c] if sch is None else sch
    h, w = bp.height >> c, bp.width >> c
    kw = dict(h=h, w=w, bd=bp.bit_depth_y if c == 0 else bp.bit_depth_c)
    steps, counts, pcm = d["steps"][c], d["counts"][c], d["pcm"]
    if c == 0:
        seq = I.luma_plain(res[0], steps, srcs[0], counts, pcm[0], h=h, w=w,
                           strong_smoothing=bp.strong_smoothing, bd=kw["bd"])
        wave = I.wavefront_plain(res[0], steps, srcs[0], sch, pcm[0],
                                 is_luma=True,
                                 strong_smoothing=bp.strong_smoothing, **kw)
        return seq, wave
    seq = torch.cat(I.chroma2_plain(res[1], res[2], steps, srcs[1], counts,
                                    pcm[1], pcm[2], h=h, w=w, bd=kw["bd"]))
    both_pcm = None if pcm[1] is None else torch.cat([pcm[1], pcm[2]])
    wave = I.wavefront_plain(
        torch.cat([res[1], res[2]]), steps.repeat(2, 1, 1),
        srcs[1].repeat(2, 1, 1, 1),
        sch._replace(units=sch.units.repeat(2, 1, 1)), both_pcm,
        is_luma=False, strong_smoothing=False, **kw)
    return seq, wave


@pytest.mark.parametrize("comp", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_wavefront_equals_sequential_walk(plans, kind, comp):
    seq, wave = _walks(*plans[kind], comp)
    assert torch.equal(seq, wave)


@pytest.mark.parametrize("kind", KINDS)
def test_sources_lie_in_finished_ctbs(plans, kind):
    """Every real step lies in one unit, of its own CTB row and HEVC
    tile; every available reference sample of it lies in its own unit's
    row at or left of its CTB, or in its wait unit's row at most one CTB
    right of it (never past that unit's last column)."""
    bp, d, _, srcs = plans[kind]
    checked = 0
    for c in range(2):
        sub = 1 if c == 0 else 2
        cl = d["schedules"][c].ctb_log2
        assert cl == B.walk_ctb_log2(bp, c)
        cols = np.asarray(bp.tile_col_bd, np.int64) // sub
        rows = np.asarray(bp.tile_row_bd, np.int64) // sub
        steps = d["steps"][c].numpy()
        src = srcs[c].numpy().reshape(bp.n, steps.shape[1], R.N_REF)
        units = d["schedules"][c].units.numpy()
        counts = d["counts"][c].numpy()
        for t in range(bp.n):
            covered = 0
            for u, (k0, k1, _, _, wait) in enumerate(units[t]):
                for k in range(k0, k1):
                    x, y, size = steps[t, k, :3]
                    if size <= 0:
                        continue
                    covered += 1
                    ux, uy = steps[t, k0, :2]
                    assert y >> cl == uy >> cl
                    assert (np.searchsorted(cols, x, "right")
                            == np.searchsorted(cols, ux, "right"))
                    s = src[t, k]
                    s = s[s < R.N_REF].astype(np.int64)
                    sx = np.where(s < R.REF_LEN, x - 1, x - 1 + s - R.REF_LEN)
                    sy = np.where(s < R.REF_LEN, y - 1 + s, y - 1)
                    # same HEVC tile as the step (ref_sources' rule)
                    assert (np.searchsorted(cols, sx, "right")
                            == np.searchsorted(cols, x, "right")).all()
                    assert (np.searchsorted(rows, sy, "right")
                            == np.searchsorted(rows, y, "right")).all()
                    r, col = y >> cl, x >> cl
                    same = (sy >> cl) == r
                    assert ((sx[same] >> cl) <= col).all()
                    above = ~same
                    assert ((sy[above] >> cl) == r - 1).all()
                    if above.any():
                        assert wait >= 0
                        last = units[t, wait, I.U_COL1]
                        assert ((sx[above] >> cl) <= min(col + 1, last)).all()
                        # the wait unit is that row of this HEVC tile
                        wx, wy = steps[t, units[t, wait, I.U_K0], :2]
                        assert wy >> cl == r - 1
                        assert (np.searchsorted(cols, wx, "right")
                                == np.searchsorted(cols, x, "right"))
                    checked += s.size
            assert covered == (steps[t, : counts[t], 2] > 0).sum()
    assert checked > 0


@pytest.mark.parametrize("comp", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_empty_units_leave_the_walk_unchanged(plans, kind, comp):
    """A unit table padded with empty units (ops.intra.pad_schedule, as
    chip_smoke.py pads the kernels' tables to PADDED_UNITS, past 48 KB of
    shared memory) schedules the same walk: nothing waits on an empty
    unit and it walks nothing."""
    bp, d, res, srcs = plans[kind]
    sch = d["schedules"][min(comp, 1)]
    padded = I.pad_schedule(sch, PADDED_UNITS)
    n_units = sch.units.shape[1]
    assert padded.units.shape == (sch.units.shape[0], PADDED_UNITS,
                                  I.UNIT_FIELDS)
    assert torch.equal(padded.units[:, :n_units], sch.units)
    assert (padded.units[:, n_units:]
            == torch.tensor([0, 0, 0, -1, -1], dtype=torch.int32)).all()
    seq, wave = _walks(bp, d, res, srcs, comp, padded)
    assert torch.equal(seq, wave)
    with pytest.raises(ValueError):
        I.pad_schedule(sch, n_units - 1)


def test_schedule_without_waits_differs(plans):
    bp, d, res, srcs = plans["flagship0"]
    units = d["schedules"][0].units.clone()
    units[..., I.U_WAIT] = -1
    seq, wave = _walks(bp, d, res, srcs, 0,
                       d["schedules"][0]._replace(units=units))
    assert not torch.equal(seq, wave)


def _table(xy, sizes, count, **tiles):
    steps = torch.tensor([[(x, y, s) for (x, y), s in zip(xy, sizes)]])
    sch = I.unit_table(steps, torch.tensor([count]), ctb_log2=4, rows=2,
                       **tiles)
    assert sch.ctb_log2 == 4
    return sch.units[0].numpy()


def test_unit_table_fields():
    # 2 CTB rows of 2 columns (CTB 16), a padding step inside row 0 and
    # two past counts
    xy = [(0, 0), (8, 8), (16, 0), (0, 0), (24, 8), (0, 16), (16, 16),
          (0, 0), (0, 0)]
    sizes = [8, 8, 16, 0, 8, 16, 16, 0, 0]
    np.testing.assert_array_equal(_table(xy, sizes, 7), [[0, 5, 0, 1, -1],
                                                         [5, 7, 0, 1, 0]])
    # two HEVC tile columns (boundary at 16): units in decode order (tile
    # 0's rows, then tile 1's), no waits across the tiles
    np.testing.assert_array_equal(
        _table(xy, sizes, 7, tile_col_bd=(16,)),
        [[0, 2, 0, 0, -1], [5, 6, 0, 0, 0], [2, 5, 1, 1, -1], [6, 7, 1, 1, 2]])
    # and two HEVC tile rows as well (boundary at 16): every unit one row
    np.testing.assert_array_equal(
        _table(xy, sizes, 7, tile_col_bd=(16,), tile_row_bd=(16,)),
        [[0, 2, 0, 0, -1], [2, 5, 1, 1, -1], [5, 6, 0, 0, -1],
         [6, 7, 1, 1, -1]])
    # a worklist with nothing to walk: every unit is empty
    np.testing.assert_array_equal(_table(xy, sizes, 0),
                                  [[0, 0, 0, -1, -1]] * 2)


def test_unit_table_never_waits_on_a_later_unit():
    """Out of decode order (row 1 before row 0, a row revisited) the
    table is no schedule, but no unit waits on a later one, so the
    kernel cannot deadlock on it."""
    xy = [(0, 16), (0, 0), (16, 16), (16, 0)]
    units = _table(xy, [16] * 4, 4)
    wait = units[:, I.U_WAIT]
    assert (wait < np.arange(len(units))).all()
