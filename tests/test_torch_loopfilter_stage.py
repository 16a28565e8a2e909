"""heif_tpu_torch.ops.loopfilter vs the loop-filter stages of
heif_tpu.ops.batch._core.

Each seeded case of utils.loopfilter_fuzz goes through the JAX stages as
`_core` runs them (stage 3: jax.vmap of J._deblock_luma_pass and
J._deblock_chroma_pass with the same transposes and the _onehot_take
chroma QP lookup; stage 4: jax.vmap of J.sao_component over per-sample
maps) and through the port's plain versions, deblock_plain and
sao_plain, which the wrappers run on CPU tensors. Tolerance 0. Where a
chroma dimension is not a multiple of 8 (cases 2, 3, 8, 9, 10), the chroma
planes' deblocking oracle is the port's host reference instead,
ref_recon._deblock_chroma_dir: the JAX stage stops one edge short of the
spec's last there (§8.7.2 filters every multiple of 8 below the plane's
size), and the test checks that it differs only beside that edge. The
kernels themselves run only on a card (tests/test_torch_card.py holds
them against the plain versions on the same cases). Here, without CUDA:
the kernels' schedules, modelled with the plain per-window filters from
the region sizes and halos read out of csrc/loopfilter.cu (deblocking:
each region plus its halo, vertical edges on every staged row, then
horizontal edges on the region's columns; SAO: each region plus one
sample), held equal to the plain versions at tolerance 0; the wrappers'
argument checks, the byte bound, and that `core` goes through the
wrappers.
"""

import dataclasses
import re
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heif_tpu.ops import jax_recon as J
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.ops import loopfilter as LF
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.ops import ref_recon
from heif_tpu_torch.tables import tables_on
from heif_tpu_torch.utils import loopfilter_fuzz as F
from heif_tpu_torch.utils.synthetic import synthetic_batch


def jax_deblock(planes, m, case):
    """Stage 3 of heif_tpu.ops.batch._core (its lines 565-629)."""
    H, W = case.height, case.width
    Hc, Wc = H // 2, W // 2
    qp_map, nf_map = jnp.asarray(m["qp_map"]), jnp.asarray(m["nf_map"])
    vert_edges = jnp.asarray(m["vert_edges"])
    horiz_edges = jnp.asarray(m["horiz_edges"])
    planes = [jnp.asarray(p) for p in planes]
    cols = 2 * jnp.arange(W // 8 - 1) + 2
    rows = 2 * jnp.arange(H // 8 - 1) + 2
    lv = jax.jit(jax.vmap(partial(J._deblock_luma_pass,
                                  beta_off=case.beta_off, tc_off=case.tc_off,
                                  bd=case.bit_depth_y)))
    y = lv(planes[0], vert_edges[:, :, cols], qp_map[:, :, cols - 1],
           qp_map[:, :, cols], nf_map[:, :, cols - 1], nf_map[:, :, cols])
    qT = jnp.swapaxes(qp_map, 1, 2)
    nT = jnp.swapaxes(nf_map, 1, 2)
    hT = jnp.swapaxes(horiz_edges, 1, 2)
    y = jnp.swapaxes(lv(jnp.swapaxes(y, 1, 2), hT[:, :, rows],
                        qT[:, :, rows - 1], qT[:, :, rows],
                        nT[:, :, rows - 1], nT[:, :, rows]), 1, 2)
    out = [y]
    ccols = 4 * jnp.arange(Wc // 8 - 1) + 4
    crows = 4 * jnp.arange(Hc // 8 - 1) + 4
    cv = jax.jit(jax.vmap(partial(J._deblock_chroma_pass, tc_off=case.tc_off,
                                  bd=case.bit_depth_c)))
    for ci, c_off in ((1, case.cb_qp_off), (2, case.cr_qp_off)):
        qp_avg = (qp_map[:, :, ccols - 1] + qp_map[:, :, ccols] + 1) >> 1
        qpc = J._onehot_take(J._CHROMA_QP_LUT,
                             jnp.clip(qp_avg + c_off, 0, 57), 58)
        p = cv(planes[ci], vert_edges[:, :, ccols], qpc,
               nf_map[:, :, ccols - 1], nf_map[:, :, ccols])
        qp_avg_t = (qT[:, :, crows - 1] + qT[:, :, crows] + 1) >> 1
        qpc_t = J._onehot_take(J._CHROMA_QP_LUT,
                               jnp.clip(qp_avg_t + c_off, 0, 57), 58)
        p = jnp.swapaxes(cv(jnp.swapaxes(p, 1, 2), hT[:, :, crows], qpc_t,
                            nT[:, :, crows - 1], nT[:, :, crows]), 1, 2)
        out.append(p)
    return [np.asarray(p) for p in out]


def jax_sao(planes, m, case):
    """Stage 4 of heif_tpu.ops.batch._core (its lines 631-656)."""
    H, W = case.height, case.width
    dims = [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
    sao, nf_map = jnp.asarray(m["sao"]), jnp.asarray(m["nf_map"])
    out = []
    for c in range(3):
        enabled = case.sao_luma if c == 0 else case.sao_chroma
        if not enabled:
            out.append(np.asarray(planes[c]))
            continue
        sv = jax.jit(jax.vmap(partial(
            J.sao_component,
            bd=case.bit_depth_y if c == 0 else case.bit_depth_c)))
        sub = 1 if c == 0 else 2
        cs = (1 << case.ctb_log2) // sub
        h, w = dims[c]

        def rep(a, k=cs):
            return jnp.repeat(jnp.repeat(a, k, 1), k, 2)[:, :h, :w]

        offs = jnp.stack([rep(sao[:, :, :, c, 2 + i]) for i in range(4)],
                         axis=-1)
        out.append(np.asarray(sv(jnp.asarray(planes[c]),
                                 rep(sao[:, :, :, c, 0]),
                                 rep(sao[:, :, :, c, 1]), offs,
                                 rep(nf_map, 4 // sub))))
    return out


def last_chroma_edges(case):
    """The chroma edges (vertical, horizontal) that the JAX stage skips:
    8 * floor(size / 8) where a chroma dimension is not a multiple of 8,
    else None."""
    hc, wc = case.height // 2, case.width // 2
    return tuple(8 * (s // 8) if s % 8 else None for s in (wc, hc))


def ref_deblock_chroma(planes, m, case):
    """Chroma deblocking by ref_recon._deblock_chroma_dir, tile by tile:
    every vertical edge of a plane, then every horizontal one. The shims
    carry what it reads of a tile's syntax (qp_y, the 4x4 QpY map) and of
    the PPS (the chroma QP offsets)."""
    pps = SimpleNamespace(pps_cb_qp_offset=case.cb_qp_off,
                          pps_cr_qp_offset=case.cr_qp_off)
    out = []
    for c in (1, 2):
        p = planes[c].copy()
        for t in range(case.n):
            st = SimpleNamespace(qp_y=m["qp_map"][t])
            for vertical, edges in ((True, m["vert_edges"]),
                                    (False, m["horiz_edges"])):
                ref_recon._deblock_chroma_dir(
                    p[t], c, st, pps, edges[t], vertical, case.tc_off,
                    m["nf_map"][t], case.bit_depth_c)
        out.append(p)
    return out


def test_fuzz_cases_with_a_last_partial_chroma_edge():
    """Cases 2 (chroma 36x20), 3 (20x68), 5 (28x24, deblocking off), 8
    (12x8), 9 (68x100) and 10 (36x68) have a chroma edge that the JAX
    stage skips; the others have none."""
    hit = [c.seed for c in F.CASES
           if any(e is not None for e in last_chroma_edges(c))]
    assert hit == [2, 3, 5, 8, 9, 10]  # case 5 has deblocking off
    assert F.CASES[4].deblock_disabled


@pytest.mark.parametrize("case", F.CASES, ids=lambda c: f"seed{c.seed}")
def test_plain_loop_filters_equal_the_jax_stages(case):
    planes, maps = F.inputs(case)
    tp, d = F.tensors(case, "cpu")
    LF.reset_launches()
    deblocked = LF.deblock(tp, d, case)
    if case.deblock_disabled:
        assert all(a is b for a, b in zip(deblocked, tp))
        want = planes
    else:
        want = jax_deblock(planes, maps, case)
        ev, eh = last_chroma_edges(case)
        if ev is not None or eh is not None:
            ref = ref_deblock_chroma(planes, maps, case)
            for c in (1, 2):
                # the JAX stage differs only beside the edges it skips
                diff = want[c] != ref[c - 1]
                near = np.zeros(diff.shape[1:], bool)
                if ev is not None:
                    near[:, ev - 1 : ev + 1] = True
                if eh is not None:
                    near[eh - 1 : eh + 1, :] = True
                assert not (diff & ~near).any(), c
                assert diff.any(), c
                want[c] = ref[c - 1]
        for c in range(3):
            np.testing.assert_array_equal(deblocked[c].numpy(), want[c],
                                          err_msg=f"deblock plane {c}")
        assert not np.array_equal(want[0], planes[0])
    got = LF.sao(deblocked, d, case)
    want_sao = jax_sao(want, maps, case)
    for c, on in enumerate(LF.sao_on(case)):
        np.testing.assert_array_equal(got[c].numpy(), want_sao[c],
                                      err_msg=f"sao plane {c}")
        assert on == (not np.array_equal(want_sao[c], want[c])), c
        if not on:
            assert got[c] is deblocked[c]
    assert LF.LAUNCHES == {"deblock": 0, "sao": 0}  # no kernel on the CPU


@pytest.mark.parametrize("case", F.CASES[:3], ids=lambda c: f"seed{c.seed}")
def test_plain_loop_filters_take_strided_planes(case):
    """The intra walk leaves its planes as views of padded planes; the
    filters give the same planes on such views."""
    planes, d = F.tensors(case, "cpu")
    views = []
    for p in planes:
        n, h, w = p.shape
        pad = torch.full((n, h + 3, w + 5), -77, dtype=torch.int32)
        pad[:, 1 : 1 + h, 2 : 2 + w] = p
        views.append(pad[:, 1 : 1 + h, 2 : 2 + w])
    for fn in (LF.deblock, LF.sao):
        for a, b in zip(fn(views, d, case), fn(planes, d, case)):
            assert torch.equal(a, b)


# the kernels' schedules (csrc/loopfilter.cu), modelled with the plain
# per-window filters

CU = Path(LF.__file__).resolve().parent.parent / "csrc" / "loopfilter.cu"


def cu_const(name: str) -> int:
    """A `constexpr int` of csrc/loopfilter.cu."""
    m = re.search(rf"constexpr int {name} = (\d+);", CU.read_text())
    assert m, name
    return int(m.group(1))


def _staged(plane, y0, y1, x0, x1, keep, rng):
    """plane[y0:y1, x0:x1] (coordinates may lie outside the plane), its
    samples outside `keep` (the rows and columns a block stages,
    (ky0, ky1, kx0, kx1), cut to the plane) replaced by noise: a model
    that reads one of those gives another result."""
    h, w = plane.shape
    out = torch.from_numpy(rng.integers(0, 1 << 8, (y1 - y0, x1 - x0))
                           .astype(np.int32))
    ky0, ky1, kx0, kx1 = keep
    ky0, ky1, kx0, kx1 = max(ky0, 0), min(ky1, h), max(kx0, 0), min(kx1, w)
    out[ky0 - y0 : ky1 - y0, kx0 - x0 : kx1 - x0] = plane[ky0:ky1, kx0:kx1]
    return out


def _maps(m, rows, cols, rows_ok, cols_ok):
    """m[rows][:, cols] of a [H4, W4] map, indices clipped; the entries
    whose row or column is not ok are zero."""
    h4, w4 = m.shape
    r = torch.as_tensor(rows).clamp(0, h4 - 1)
    c = torch.as_tensor(cols).clamp(0, w4 - 1)
    ok = torch.as_tensor(rows_ok)[:, None] & torch.as_tensor(cols_ok)[None, :]
    return torch.where(ok, m[r][:, c], torch.zeros((), dtype=m.dtype))


def region_deblock(planes, d, case):
    """csrc/loopfilter.cu's deblocking schedule with the plain passes: for
    each region of DB_RH x DB_RW luma samples (half each way in chroma) of
    each tile, the samples its block stages (the region plus HALO_L luma
    or HALO_C chroma samples a side, inside the picture; noise beyond,
    out to 8 a side so that the window's internal edges are the region's
    edges), every vertical edge that changes a sample of the region
    (positions x0 .. x0 + DB_RW, those inside the picture but not at 0)
    applied to every staged row, then every horizontal edge that changes
    one, over the region's columns; the region's samples out."""
    RH, RW = cu_const("DB_RH"), cu_const("DB_RW")
    HL, HC = cu_const("HALO_L"), cu_const("HALO_C")
    assert RH % 8 == 0 and RW % 8 == 0 and HL <= 8 and HC <= 8
    tables = tables_on("cpu")
    lut = tables.chroma_qp_lut
    rng = np.random.default_rng(0)
    H, W = case.height, case.width
    out = [torch.full_like(p, -1) for p in planes]
    qp, nf = d["qp_map"], d["nf_map"]
    ve, he = d["vert_edges"], d["horiz_edges"]
    bo, to = case.beta_off, case.tc_off

    def luma(t, y0, x0):
        win = _staged(planes[0][t], y0 - 8, y0 + RH + 8, x0 - 8, x0 + RW + 8,
                      (y0 - HL, y0 + RH + HL, x0 - HL, x0 + RW + HL), rng)
        # vertical: a segment a 4x4 row, edges at x0 + 8e
        rb = (y0 - 8) // 4 + np.arange((RH + 16) // 4)
        gx = x0 + 8 * np.arange(RW // 8 + 1)
        r_ok = (4 * rb >= max(0, y0 - HL)) & (4 * rb < min(H, y0 + RH + HL))
        e_ok = (gx > 0) & (gx < W)
        q, p = gx // 4, gx // 4 - 1
        win = R.deblock_luma_pass(
            win[None], _maps(ve[t], rb, q, r_ok, e_ok)[None],
            _maps(qp[t], rb, p, r_ok, e_ok)[None],
            _maps(qp[t], rb, q, r_ok, e_ok)[None],
            _maps(nf[t], rb, p, r_ok, e_ok)[None],
            _maps(nf[t], rb, q, r_ok, e_ok)[None], bo, to, case.bit_depth_y,
            tables)[0]
        # horizontal, over the region's columns: a segment a 4x4 column
        cb = x0 // 4 + np.arange(RW // 4)
        gy = y0 + 8 * np.arange(RH // 8 + 1)
        c_ok = 4 * cb < W
        e_ok = (gy > 0) & (gy < H)
        q, p = gy // 4, gy // 4 - 1
        cols = win[:, 8 : 8 + RW].T
        cols = R.deblock_luma_pass(
            cols[None], _maps(he[t].T, cb, q, c_ok, e_ok)[None],
            _maps(qp[t].T, cb, p, c_ok, e_ok)[None],
            _maps(qp[t].T, cb, q, c_ok, e_ok)[None],
            _maps(nf[t].T, cb, p, c_ok, e_ok)[None],
            _maps(nf[t].T, cb, q, c_ok, e_ok)[None], bo, to, case.bit_depth_y,
            tables)[0].T
        h, w = min(RH, H - y0), min(RW, W - x0)
        out[0][t, y0 : y0 + h, x0 : x0 + w] = cols[8 : 8 + h, :w]

    def chroma(c, c_off, t, y0, x0):
        Hc, Wc = H // 2, W // 2
        rh, rw = RH // 2, RW // 2
        win = _staged(planes[c][t], y0 - 8, y0 + rh + 8, x0 - 8, x0 + rw + 8,
                      (y0 - HC, y0 + rh + HC, x0 - HC, x0 + rw + HC), rng)

        def qpc(qp_p, qp_q):
            return lut[(((qp_p + qp_q + 1) >> 1) + c_off).clamp(0, 57).long()]

        # vertical: a 2-line segment a 4x4 row, edges at x0 + 8e
        seg = y0 - 8 + 2 * np.arange((rh + 16) // 2)
        rb = seg // 2
        gx = x0 + 8 * np.arange(rw // 8 + 1)
        r_ok = (seg >= max(0, y0 - HC)) & (seg < min(Hc, y0 + rh + HC))
        e_ok = (gx > 0) & (gx < Wc)
        q, p = gx // 2, gx // 2 - 1
        win = R.deblock_chroma_pass(
            win[None], _maps(ve[t], rb, q, r_ok, e_ok)[None],
            qpc(_maps(qp[t], rb, p, r_ok, e_ok),
                _maps(qp[t], rb, q, r_ok, e_ok))[None],
            _maps(nf[t], rb, p, r_ok, e_ok)[None],
            _maps(nf[t], rb, q, r_ok, e_ok)[None], to, case.bit_depth_c,
            tables)[0]
        # horizontal, over the region's columns: a segment 2 columns
        xs = x0 + 2 * np.arange(rw // 2)
        cb = xs // 2
        gy = y0 + 8 * np.arange(rh // 8 + 1)
        c_ok = xs < Wc
        e_ok = (gy > 0) & (gy < Hc)
        q, p = gy // 2, gy // 2 - 1
        cols = win[:, 8 : 8 + rw].T
        cols = R.deblock_chroma_pass(
            cols[None], _maps(he[t].T, cb, q, c_ok, e_ok)[None],
            qpc(_maps(qp[t].T, cb, p, c_ok, e_ok),
                _maps(qp[t].T, cb, q, c_ok, e_ok))[None],
            _maps(nf[t].T, cb, p, c_ok, e_ok)[None],
            _maps(nf[t].T, cb, q, c_ok, e_ok)[None], to, case.bit_depth_c,
            tables)[0].T
        h, w = min(rh, Hc - y0), min(rw, Wc - x0)
        out[c][t, y0 : y0 + h, x0 : x0 + w] = cols[8 : 8 + h, :w]

    for t in range(case.n):
        for y0 in range(0, H, RH):
            for x0 in range(0, W, RW):
                luma(t, y0, x0)
                chroma(1, case.cb_qp_off, t, y0 // 2, x0 // 2)
                chroma(2, case.cr_qp_off, t, y0 // 2, x0 // 2)
    return out


def region_sao(planes, d, case):
    """csrc/loopfilter.cu's SAO schedule with the plain per-sample pass:
    each region of SAO_RH x SAO_RW luma samples (half each way in chroma)
    of each tile through recon.sao_component on the region plus SAO_HALO
    samples a side, inside the picture (the picture's edges are the
    window's); the region's samples out. Parameters as sao_plain
    upsamples them."""
    RH, RW = cu_const("SAO_RH"), cu_const("SAO_RW")
    HALO = cu_const("SAO_HALO")
    H, W = case.height, case.width
    out = []
    for c, on in enumerate(LF.sao_on(case)):
        if not on:
            out.append(planes[c])
            continue
        sub = 1 if c == 0 else 2
        cs = (1 << case.ctb_log2) // sub
        h, w, rh, rw = H // sub, W // sub, RH // sub, RW // sub

        def rep(a, k=cs):
            return a.repeat_interleave(k, 1).repeat_interleave(k, 2)[:, :h, :w]

        sao = d["sao"]
        stype, sclass = rep(sao[:, :, :, c, 0]), rep(sao[:, :, :, c, 1])
        offs = torch.stack([rep(sao[:, :, :, c, 2 + i]) for i in range(4)],
                           -1)
        nf = rep(d["nf_map"], 4 // sub)
        res = torch.full_like(planes[c], -1)
        for y0 in range(0, h, rh):
            for x0 in range(0, w, rw):
                wy0, wy1 = max(y0 - HALO, 0), min(y0 + rh + HALO, h)
                wx0, wx1 = max(x0 - HALO, 0), min(x0 + rw + HALO, w)
                win = (slice(None), slice(wy0, wy1), slice(wx0, wx1))
                got = R.sao_component(
                    planes[c][win], stype[win], sclass[win], offs[win],
                    nf[win], case.bit_depth_y if c == 0 else case.bit_depth_c)
                y1, x1 = min(y0 + rh, h), min(x0 + rw, w)
                res[:, y0:y1, x0:x1] = got[:, y0 - wy0 : y1 - wy0,
                                           x0 - wx0 : x1 - wx0]
        out.append(res)
    return out


@pytest.mark.parametrize("case", F.CASES, ids=lambda c: f"seed{c.seed}")
def test_deblock_region_schedule_equals_plain(case):
    """The deblocking kernel's regions, halos and edge order give
    deblock_plain's planes, every sample (case 5's too, with deblocking
    turned on)."""
    case = dataclasses.replace(case, deblock_disabled=False)
    planes, d = F.tensors(case, "cpu")
    want = LF.deblock_plain(planes, d, case)
    for c, (a, b) in enumerate(zip(region_deblock(planes, d, case), want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                      err_msg=f"plane {c}")
    assert not torch.equal(want[0], planes[0])


@pytest.mark.parametrize("case", F.CASES, ids=lambda c: f"seed{c.seed}")
def test_sao_region_schedule_equals_plain(case):
    """The SAO kernel's regions and one-sample halo give sao_plain's
    planes, every sample, on the plain deblocked planes."""
    planes, d = F.tensors(case, "cpu")
    src = LF.deblock_plain(planes, d, case)
    want = LF.sao_plain(src, d, case)
    for c, (a, b) in enumerate(zip(region_sao(src, d, case), want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                      err_msg=f"plane {c}")


def test_region_cases_reach_past_the_regions():
    """Fuzz cases 9-11 are taller and wider than a deblocking and an SAO
    region, 9 and 10 not a multiple of one (their last regions are
    partial); case 10 is 10-bit at CTB 64 with chroma QP offsets and
    chroma sides of 4 mod 8; case 11's flat patches lie along the
    deblocking regions' borders."""
    regions = [(cu_const("DB_RH"), cu_const("DB_RW")),
               (cu_const("SAO_RH"), cu_const("SAO_RW"))]
    big = [c for c in F.CASES
           if all(c.height > rh and c.width > rw for rh, rw in regions)]
    by_seed = {c.seed: c for c in big}
    assert {9, 10, 11} <= set(by_seed)
    assert all(c.height % rh and c.width % rw
               for c in (by_seed[9], by_seed[10]) for rh, rw in regions)
    c10 = by_seed[10]
    assert (c10.bit_depth_y, c10.bit_depth_c, c10.ctb_log2) == (10, 10, 6)
    assert c10.cb_qp_off and c10.cr_qp_off
    assert (c10.height // 2) % 8 == 4 and (c10.width // 2) % 8 == 4
    assert by_seed[11].flat_borders == regions[0]


@pytest.mark.parametrize("direction", ["vertical", "horizontal"])
def test_flat_case_filters_strongly_on_region_borders(direction):
    """In case 11, luma edges on the deblocking regions' borders take the
    strong filter: it alone changes p2 and q2, 3 samples from the edge.
    Each direction alone (the other's edge map cleared)."""
    case = next(c for c in F.CASES if c.flat_borders)
    rh, rw = case.flat_borders
    planes, d = F.tensors(case, "cpu")
    other = "horiz_edges" if direction == "vertical" else "vert_edges"
    d[other] = torch.zeros_like(d[other])
    y, y_in = LF.deblock_plain(planes, d, case)[0], planes[0]
    if direction == "vertical":
        at = [x + o for x in range(rw, case.width, rw) for o in (-3, 2)]
        changed = (y[:, :, at] != y_in[:, :, at]).sum()
    else:
        at = [r + o for r in range(rh, case.height, rh) for o in (-3, 2)]
        changed = (y[:, at, :] != y_in[:, at, :]).sum()
    assert changed > 0


def _bad(kind: str):
    """A valid fuzz case and its tensors, then one argument made wrong."""
    case = F.CASES[0]
    planes, d = F.tensors(case, "cpu")
    if kind == "dtype":
        planes[1] = planes[1].to(torch.int16)
    elif kind == "shape":
        planes[2] = planes[2][:, :-2]
    elif kind == "planes":
        planes = planes[:2]
    elif kind == "column_stride":
        planes[0] = planes[0].repeat_interleave(2, 2)[:, :, ::2]
    elif kind == "edge_dtype":
        d["vert_edges"] = d["vert_edges"].to(torch.uint8)
    elif kind == "qp_shape":
        d["qp_map"] = d["qp_map"][:, :, :-1].contiguous()
    elif kind == "nf_layout":
        d["nf_map"] = d["nf_map"].transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "sao_shape":
        d["sao"] = d["sao"][:, :-1].contiguous()
    elif kind == "height":
        case = dataclasses.replace(case, height=case.height - 4)
    elif kind == "ctb":
        case = dataclasses.replace(case, ctb_log2=3)
    elif kind == "bit_depth":
        case = dataclasses.replace(case, bit_depth_c=7)
    elif kind == "device":
        planes = [p.to("meta") for p in planes]
        d = {k: v.to("meta") for k, v in d.items()}
    return planes, d, case


BAD = ("dtype", "shape", "planes", "column_stride", "edge_dtype", "qp_shape",
       "nf_layout", "sao_shape", "height", "ctb", "bit_depth", "device")


@pytest.mark.parametrize("kind", BAD)
@pytest.mark.parametrize("fn", [LF.deblock, LF.sao], ids=["deblock", "sao"])
def test_wrappers_raise_on_bad_arguments(fn, kind):
    """The checks run before any build or launch, so they hold without
    CUDA; nothing is counted."""
    planes, d, case = _bad(kind)
    LF.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        fn(planes, d, case)
    assert LF.LAUNCHES == {"deblock": 0, "sao": 0}


def test_loopfilter_bytes():
    """A 16-tile chunk of 512x512 4:2:0 int32 planes at CTB 32: the
    planes in and out (50,331,648 B), the maps of 16,384 4x4 blocks a
    tile, the SAO parameters of 16x16 CTBs."""
    bp = F.Case(0, 16, 512, 512, 5)
    blocks = 16 * 128 * 128
    assert LF.loopfilter_bytes("deblock", 16, bp) == 50_331_648 + 7 * blocks
    assert LF.loopfilter_bytes("sao", 16, bp) == (
        50_331_648 + 16 * 16 * 16 * 3 * 6 * 4 + blocks)
    luma = dataclasses.replace(bp, sao_chroma=False, deblock_disabled=True)
    assert LF.loopfilter_bytes("sao", 16, luma) == (
        2 * 4 * 16 * 512 * 512 + 16 * 16 * 16 * 3 * 6 * 4 + blocks)
    assert LF.loopfilter_bytes("deblock", 16, luma) == 0
    with pytest.raises(ValueError):
        LF.loopfilter_bytes("alf", 16, bp)


def test_core_filters_through_the_wrappers(monkeypatch):
    """core hands the intra planes to loopfilter.deblock and its output
    to loopfilter.sao, once each, and returns what sao returns."""
    bp = B.pack_batch(*synthetic_batch(n=2, size=64, bd=10, pcm=True,
                                       seed=5))
    assert not bp.deblock_disabled and (bp.sao_luma or bp.sao_chroma)
    d = B.plan_to_device(bp, torch.device("cpu"))
    want = B.core(d, bp, torch.device("cpu"))
    calls = []

    def spy(name, fn):
        def run(planes, d_, bp_):
            calls.append(name)
            assert d_ is d and bp_ is bp
            return fn(planes, d_, bp_)
        return run

    monkeypatch.setattr(LF, "deblock", spy("deblock", LF.deblock))
    monkeypatch.setattr(LF, "sao", spy("sao", LF.sao))
    got = B.core(d, bp, torch.device("cpu"))
    assert calls == ["deblock", "sao"]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
