"""The in-loop filters of `batch.core`: deblocking and SAO over N tiles.

`deblock` and `sao` are stages 3 and 4 of heif_tpu.ops.batch._core (its
lines 565-660). No Pallas kernel stands behind them there: XLA fuses
their jnp code. On a CUDA tensor each wrapper launches a kernel of
csrc/loopfilter.cu (built on first use by ops._build) on the current
stream and raises if the launch fails: `deblock` launches once for the
three planes (every vertical edge, then every horizontal one, region by
region in shared memory), `sao` once for every enabled plane. On a CPU
tensor each runs its plain version, `deblock_plain` / `sao_plain`:
recon.deblock_luma_pass, deblock_chroma_pass and sao_component composed
as `_core` composes the JAX passes, which is also the kernels' oracle on
the card. There is no fallback from one to the other. LAUNCHES counts
kernel launches only.

Both take the planes as the intra walk leaves them (Y [N, H, W], Cb and
Cr [N, H/2, W/2], int32; views with unit column stride are fine), `d`
as batch.plan_to_device ships the plan (vert_edges, horiz_edges, nf_map
[N, H/4, W/4] bool, qp_map [N, H/4, W/4] int32, sao [N, ceil(H/ctb),
ceil(W/ctb), 3, 6] int32), and `bp`, any object with a BatchPlan's
fields height, width, ctb_log2, deblock_disabled, sao_luma, sao_chroma,
beta_off, tc_off, cb_qp_off, cr_qp_off, bit_depth_y and bit_depth_c.
They return new planes; a stage or plane switched off returns its input.
"""

from __future__ import annotations

import torch

from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.ops.intra import _check
from heif_tpu_torch.tables import tables_on

LAUNCHES = {"deblock": 0, "sao": 0}

SAO_FIELDS = 6  # type, class (band position or EO class), 4 offsets


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def sao_on(bp) -> tuple:
    """Whether SAO runs on Y, Cb and Cr."""
    return bool(bp.sao_luma), bool(bp.sao_chroma), bool(bp.sao_chroma)


def _ctbs(bp) -> tuple:
    """CTB rows and columns of a tile."""
    cs = 1 << bp.ctb_log2
    return -(-bp.height // cs), -(-bp.width // cs)


def _check_args(planes, d, bp) -> None:
    H, W = bp.height, bp.width
    if H % 8 or W % 8 or H <= 0 or W <= 0:
        raise ValueError(f"planes of {H}x{W}: height and width must be "
                         "positive multiples of 8")
    if not 4 <= bp.ctb_log2 <= 6:
        raise ValueError(f"ctb_log2 {bp.ctb_log2}: HEVC CTBs are 16 to 64")
    for name, bd in (("bit_depth_y", bp.bit_depth_y),
                     ("bit_depth_c", bp.bit_depth_c)):
        if not 8 <= bd <= 16:
            raise ValueError(f"{name} {bd}: 8 to 16 bits")
    if len(planes) != 3:
        raise ValueError(f"{len(planes)} planes, expected Y, Cb and Cr")
    dev = planes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    n = planes[0].shape[0]
    for name, p, shape in (("Y", planes[0], (n, H, W)),
                           ("Cb", planes[1], (n, H // 2, W // 2)),
                           ("Cr", planes[2], (n, H // 2, W // 2))):
        if p.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {p.dtype}, expected torch.int32")
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)}, expected {shape}")
        if p.device != dev:
            raise ValueError(f"{name}: on {p.device}, expected {dev}")
        if p.stride(2) != 1 or p.stride(1) < p.shape[2] or p.stride(0) < 0:
            raise ValueError(f"{name}: strides {p.stride()}, expected rows "
                             "of unit column stride")
    m = (n, H // 4, W // 4)
    _check("vert_edges", d["vert_edges"], torch.bool, m, dev)
    _check("horiz_edges", d["horiz_edges"], torch.bool, m, dev)
    _check("qp_map", d["qp_map"], torch.int32, m, dev)
    _check("nf_map", d["nf_map"], torch.bool, m, dev)
    _check("sao", d["sao"], torch.int32, (n, *_ctbs(bp), 3, SAO_FIELDS), dev)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _plane_args(planes) -> list:
    """Per plane its pointer, then per plane its batch and row strides."""
    return ([p.data_ptr() for p in planes]
            + [s for p in planes for s in (p.stride(0), p.stride(1))])


def _outputs(planes, on) -> list:
    """New contiguous int32 planes shaped as `planes` where `on` says so
    (None elsewhere), views of one flat buffer: one allocation a call.
    Each plane starts 16-byte aligned (its samples are a multiple of 4)."""
    sizes = [p.numel() if o else 0 for p, o in zip(planes, on)]
    flat = torch.empty(sum(sizes), dtype=torch.int32, device=planes[0].device)
    return [v.view(p.shape) if o else None
            for v, p, o in zip(flat.split(sizes), planes, on)]


def deblock(planes, d: dict, bp) -> list:
    """Deblocking (H.265 §8.7.2) of N tiles: [Y, Cb, Cr] int32 in, new
    [Y, Cb, Cr] out (contiguous on CUDA). Luma edges every 8 samples,
    chroma edges every 8 chroma samples with the chroma QP from the LUT;
    the vertical edges of the picture before the horizontal ones."""
    _check_args(planes, d, bp)
    if bp.deblock_disabled:
        return list(planes)
    dev = planes[0].device
    if dev.type == "cpu":
        return deblock_plain(planes, d, bp)
    from heif_tpu_torch.ops import _build

    tables = tables_on(dev)
    out = _outputs(planes, (True, True, True))
    rc = _build.load().heif_deblock(
        *[p.data_ptr() for p in out], *_plane_args(planes),
        d["vert_edges"].data_ptr(), d["horiz_edges"].data_ptr(),
        d["qp_map"].data_ptr(), d["nf_map"].data_ptr(),
        tables.beta.data_ptr(), tables.tc.data_ptr(),
        tables.chroma_qp_lut.data_ptr(), planes[0].shape[0], bp.height,
        bp.width, bp.beta_off, bp.tc_off, bp.cb_qp_off, bp.cr_qp_off,
        bp.bit_depth_y, bp.bit_depth_c,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "heif_deblock")
    LAUNCHES["deblock"] += 1
    return out


def sao(planes, d: dict, bp) -> list:
    """SAO (H.265 §8.7.3) of N deblocked tiles: [Y, Cb, Cr] int32 in; new
    planes out for the enabled components, the inputs for the others."""
    _check_args(planes, d, bp)
    on = sao_on(bp)
    if not any(on):
        return list(planes)
    dev = planes[0].device
    if dev.type == "cpu":
        return sao_plain(planes, d, bp)
    from heif_tpu_torch.ops import _build

    out = _outputs(planes, on)
    rows, cols = _ctbs(bp)
    rc = _build.load().heif_sao(
        *[None if o is None else o.data_ptr() for o in out],
        *_plane_args(planes), d["sao"].data_ptr(), d["nf_map"].data_ptr(),
        planes[0].shape[0], bp.height, bp.width, rows, cols, bp.ctb_log2,
        bp.bit_depth_y, bp.bit_depth_c,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "heif_sao")
    LAUNCHES["sao"] += 1
    return [p if o is None else o for p, o in zip(planes, out)]


# plain versions: the CPU path of the wrappers, and on the card the
# oracle each kernel is held against (chip_smoke.py)


def deblock_plain(planes, d: dict, bp) -> list:
    """Plain PyTorch deblocking on any device; same contract as deblock.
    The JAX stage's passes, transposes and chroma QP lookup, batched."""
    if bp.deblock_disabled:
        return list(planes)
    device = planes[0].device
    tables = tables_on(device)
    H, W = bp.height, bp.width
    Hc, Wc = H // 2, W // 2
    qp, nf = d["qp_map"], d["nf_map"]
    ve, he = d["vert_edges"], d["horiz_edges"]
    qT, nT, hT = qp.transpose(1, 2), nf.transpose(1, 2), he.transpose(1, 2)
    bo, to = bp.beta_off, bp.tc_off
    bd_y, bd_c = bp.bit_depth_y, bp.bit_depth_c

    def ar(k, mul, add):
        return torch.arange(k, device=device) * mul + add

    # vertical edges index by W, the transposed (horizontal) pass by H
    cols = ar(W // 8 - 1, 2, 2)
    rows = ar(H // 8 - 1, 2, 2)
    y = R.deblock_luma_pass(
        planes[0], ve[:, :, cols], qp[:, :, cols - 1], qp[:, :, cols],
        nf[:, :, cols - 1], nf[:, :, cols], bo, to, bd_y, tables,
    )
    y = R.deblock_luma_pass(
        y.transpose(1, 2), hT[:, :, rows], qT[:, :, rows - 1], qT[:, :, rows],
        nT[:, :, rows - 1], nT[:, :, rows], bo, to, bd_y, tables,
    ).transpose(1, 2)
    out = [y]

    # chroma edges at every multiple of 8 below Wc and Hc (§8.7.2), the
    # last one too where a chroma dimension is not a multiple of 8
    ccols = ar((Wc - 1) // 8, 4, 4)
    crows = ar((Hc - 1) // 8, 4, 4)
    lut = tables.chroma_qp_lut
    for ci, c_off in ((1, bp.cb_qp_off), (2, bp.cr_qp_off)):
        qp_avg = (qp[:, :, ccols - 1] + qp[:, :, ccols] + 1) >> 1
        qpc = lut[(qp_avg + c_off).clamp(0, 57).long()]
        p = R.deblock_chroma_pass(
            planes[ci], ve[:, :, ccols], qpc, nf[:, :, ccols - 1],
            nf[:, :, ccols], to, bd_c, tables,
        )
        qp_avg_t = (qT[:, :, crows - 1] + qT[:, :, crows] + 1) >> 1
        qpc_t = lut[(qp_avg_t + c_off).clamp(0, 57).long()]
        p = R.deblock_chroma_pass(
            p.transpose(1, 2), hT[:, :, crows], qpc_t, nT[:, :, crows - 1],
            nT[:, :, crows], to, bd_c, tables,
        ).transpose(1, 2)
        out.append(p)
    return out


def sao_plain(planes, d: dict, bp) -> list:
    """Plain PyTorch SAO on any device; same contract as sao. The
    per-CTB parameters and the 4x4 bypass map are upsampled to
    per-sample maps, as the JAX stage does."""
    sao_p, nf = d["sao"], d["nf_map"]
    H, W = bp.height, bp.width
    dims = [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
    out = []
    for c, enabled in enumerate(sao_on(bp)):
        if not enabled:
            out.append(planes[c])
            continue
        sub = 1 if c == 0 else 2
        cs = (1 << bp.ctb_log2) // sub
        h, w = dims[c]

        def rep(a, k=cs):
            return a.repeat_interleave(k, 1).repeat_interleave(k, 2)[:, :h, :w]

        stype = rep(sao_p[:, :, :, c, 0])
        sclass = rep(sao_p[:, :, :, c, 1])
        offs = torch.stack([rep(sao_p[:, :, :, c, 2 + i]) for i in range(4)],
                           dim=-1)
        nf_pix = rep(nf, 4 // sub)
        out.append(R.sao_component(
            planes[c], stype, sclass, offs, nf_pix,
            bp.bit_depth_y if c == 0 else bp.bit_depth_c,
        ))
    return out


def loopfilter_bytes(kind: str, n: int, bp) -> int:
    """The bytes a loop filter of n tiles must move, each input read once
    and each output written once (its time bound at the card's memory
    rate). "deblock": the three int32 planes in and out, and the two edge
    maps, the QP map and the bypass map. "sao": the enabled planes in
    and out, the per-CTB parameters and the bypass map. The work is a
    few dozen integer operations a sample, far below the card's integer
    rate, so bytes bound both."""
    H, W = bp.height, bp.width
    sizes = [H * W, H * W // 4, H * W // 4]
    blocks = n * (H // 4) * (W // 4)
    if kind == "deblock":
        if bp.deblock_disabled:
            return 0
        return 2 * 4 * n * sum(sizes) + blocks * (1 + 1 + 4 + 1)
    if kind == "sao":
        on = sao_on(bp)
        if not any(on):
            return 0
        rows, cols = _ctbs(bp)
        planes = sum(s for s, o in zip(sizes, on) if o)
        return 2 * 4 * n * planes + n * rows * cols * 3 * SAO_FIELDS * 4 + blocks
    raise ValueError(f"unknown loop filter {kind!r}")
