"""heif_tpu_torch.ops.loopfilter vs the loop-filter stages of
heif_tpu.ops.batch._core.

Each seeded case of utils.loopfilter_fuzz goes through the JAX stages as
`_core` runs them (stage 3: jax.vmap of J._deblock_luma_pass and
J._deblock_chroma_pass with the same transposes and the _onehot_take
chroma QP lookup; stage 4: jax.vmap of J.sao_component over per-sample
maps) and through the port's plain versions, deblock_plain and
sao_plain, which the wrappers run on CPU tensors. Tolerance 0. Where a
chroma dimension is not a multiple of 8 (cases 2, 3 and 8), the chroma
planes' deblocking oracle is the port's host reference instead,
ref_recon._deblock_chroma_dir: the JAX stage stops one edge short of the
spec's last there (§8.7.2 filters every multiple of 8 below the plane's
size), and the test checks that it differs only beside that edge. The
kernels themselves run only on a card (tests/test_torch_card.py holds
them against the plain versions on the same cases). Here, without CUDA:
the wrappers' argument checks, the byte bound, and that `core` goes
through the wrappers.
"""

import dataclasses
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heif_tpu.ops import jax_recon as J
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.ops import loopfilter as LF
from heif_tpu_torch.ops import ref_recon
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
    """Cases 2 (chroma 36x20), 3 (20x68), 5 (28x24, deblocking off) and
    8 (12x8) have a chroma edge that the JAX stage skips; the others have
    none."""
    hit = [c.seed for c in F.CASES
           if any(e is not None for e in last_chroma_edges(c))]
    assert hit == [2, 3, 5, 8]  # case 5 has deblocking off
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
