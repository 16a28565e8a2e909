"""Intra-walk wrappers: the CUDA kernels on CUDA tensors, the plain walk
on CPU tensors.

intra_scan_luma replaces heif_tpu.ops.pallas_intra.intra_scan_pallas and
intra_scan_chroma2 replaces intra_scan_pallas_chroma2. On a CUDA tensor
each launches its kernel from csrc/intra.cu (built on first use by
ops._build) on the current stream, and raises if the launch fails. On a
CPU tensor each runs recon.intra_scan_component, the plain PyTorch walk
that is also the kernels' oracle. There is no fallback from one to the
other. LAUNCHES counts kernel launches (not plain runs), so a caller can
show that a decode went through the kernels.

The kernels walk each tile as a CTB-row wavefront (csrc/intra.cu). Their
schedule (unit_table, a Schedule) is the unit table, the worklist cut
into runs of steps that lie in one CTB row of one HEVC tile, each with
the unit of the row above that it waits on, together with the CTB size
that cut it. The plain walk needs no schedule. wavefront_plain runs the
steps in the most eager order a schedule allows, in plain PyTorch, so
the table's correctness is testable where the kernel cannot run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.tables import tables_on

LAUNCHES = {"luma": 0, "chroma": 0}

_STEP_FIELDS = 6
# unit table fields: first step, end step, first CTB column, last CTB
# column, index of the unit waited on (-1: none)
UNIT_FIELDS = 5
U_K0, U_K1, U_COL0, U_COL1, U_WAIT = range(UNIT_FIELDS)


class Schedule(NamedTuple):
    """The wavefront schedule of N worklists: the unit table, int32
    [N, U, 5], and log2 of the CTB size (component samples) it was cut
    at, which the kernel's waits use."""
    units: torch.Tensor
    ctb_log2: int


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def unit_table(steps: torch.Tensor, counts: torch.Tensor, *, ctb_log2: int,
               rows: int, tile_col_bd=(), tile_row_bd=()) -> Schedule:
    """The wavefront schedule of N worklists, on their device.

    steps: [N, S, >=3] integer tensor (x, y, size, ... in component
    samples); counts: [N] real step counts; ctb_log2: log2 of the CTB
    size in component samples; rows: CTB rows of the component plane;
    tile_col_bd / tile_row_bd: interior HEVC tile boundaries in component
    samples (() = no tiles).

    A unit is the steps of one CTB row of one HEVC tile, numbered in HEVC
    decode order: the HEVC tiles in raster order, then each tile's CTB
    rows. Returns a Schedule at ctb_log2 whose units are int32
    [N, rows * (HEVC tile columns), 5]: per unit (k0, k1, first CTB
    column, last CTB column, wait), where [k0, k1) spans the unit's real
    steps (k < count, size > 0) and wait is the unit of the CTB row above
    in the same HEVC tile (the one before it), or -1. Every source sample
    of a step lies in its own unit (an earlier step) or in the CTBs of
    its wait unit up to one column right of its own (recon.ref_sources
    marks nothing else available), so a walker may start CTB column c
    once its wait unit has finished column min(c + 1, its last column).
    Units with no step are empty (k0 = k1 = 0, columns 0 and -1, wait
    -1). Built with a few tensor ops (the unit of each step is a formula
    of its CTB; one scatter gathers the fields), so a decode neither
    waits for it nor syncs. A worklist in HEVC decode order gives every
    unit one run of steps; for any other order the table is no valid
    schedule, but a unit still never waits on a later one.
    """
    dev = steps.device
    n, s_len = steps.shape[0], steps.shape[1]
    n_tcols = len(tile_col_bd) + 1
    n_units = max(rows * n_tcols, 1)
    steps = steps.to(torch.int32)  # a no-op for the plan's worklists
    x = steps[..., 0]
    col = x >> ctb_log2
    row = steps[..., 1] >> ctb_log2
    unit, first = row, 0
    if tile_col_bd or tile_row_bd:
        # the HEVC tile column of each step, and the first and end CTB
        # rows of its tile row (python scalars: no host-to-device copy)
        tc = sum((x >= b).to(torch.int32) for b in tile_col_bd)
        bounds = [0, *(b >> ctb_log2 for b in tile_row_bd), rows]
        end = bounds[1]
        for i in range(1, len(bounds) - 1):
            below = (row >= bounds[i]).to(torch.int32)
            first = first + below * (bounds[i] - bounds[i - 1])
            end = end + below * (bounds[i + 1] - bounds[i])
        unit = n_tcols * first + tc * (end - first) + row - first
    wait = torch.where(row > first, unit - 1, -1)
    k = torch.arange(s_len, dtype=torch.int32, device=dev).expand(n, s_len)
    real = (k < counts[:, None]) & (steps[..., 2] > 0)
    unit = torch.where(real, unit, n_units).long()  # others: a spare unit
    # one amax per field over each unit's steps (first step and first
    # column negated); the fill values leave an empty unit as documented
    out = torch.full((n, n_units + 1, UNIT_FIELDS), -1, dtype=torch.int32,
                     device=dev)
    out[..., U_K0] = -s_len
    out[..., U_K1] = 0
    out[..., U_COL0] = -(1 << 30)
    out.scatter_reduce_(
        1, unit[..., None].expand(-1, -1, UNIT_FIELDS),
        torch.stack([-k, k + 1, -col, col, wait], dim=-1), "amax")
    out[..., U_K0] = torch.minimum(-out[..., U_K0], out[..., U_K1])
    out[..., U_COL0] = torch.minimum(-out[..., U_COL0], out[..., U_COL1] + 1)
    return Schedule(out[:, :n_units].contiguous(), ctb_log2)


def pad_schedule(schedule: Schedule, n_units: int) -> Schedule:
    """The schedule with empty units appended up to n_units a worklist
    (k0 = k1 = 0, columns 0 and -1, wait -1: nothing to walk, nobody
    waits on them), so the same walk runs against a larger unit table."""
    units = schedule.units
    extra = n_units - units.shape[1]
    if extra < 0:
        raise ValueError(f"{units.shape[1]} units > {n_units}")
    empty = torch.tensor([0, 0, 0, -1, -1], dtype=units.dtype,
                         device=units.device)
    pad = empty.expand(units.shape[0], extra, UNIT_FIELDS)
    return schedule._replace(units=torch.cat([units, pad], dim=1))


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_walk(res, pcm, steps, src, counts, schedule, h, w):
    n = res.shape[0]
    dev = res.device
    s = steps.shape[1]
    _check("res", res, torch.int32, (n, h + R.PAD, w + R.PAD), dev)
    if pcm is not None:
        _check("pcm", pcm, torch.int32, (n, h + R.PAD, w + R.PAD), dev)
    _check("steps", steps, torch.int32, (n, s, _STEP_FIELDS), dev)
    _check("src", src, torch.uint8, (n, s, 2, R.REF_LEN), dev)
    _check("counts", counts, torch.int32, (n,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if schedule is not None:
        u = schedule.units
        _check("units", u, torch.int32, (n, u.shape[1], UNIT_FIELDS), dev)
    elif dev.type == "cuda":
        raise ValueError("the CUDA intra kernels need schedule= "
                         "(ops.intra.unit_table of these steps)")


def _plane(n, h, w, dev):
    return torch.zeros((n, 1 + h + R.SPAD, 1 + w + R.SPAD), dtype=torch.int32,
                       device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


_ERR_SMEM = -1  # csrc/intra.cu: the unit table does not fit


def _raise_on(rc: int, name: str, n_units: int):
    if rc == _ERR_SMEM:
        raise RuntimeError(
            f"{name}: a unit table of {n_units} units does not fit in the "
            "shared memory a block may use (its counters beside the "
            "kernel's own, at most 227 KB on an H100)")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def intra_scan_luma(res, steps, src, counts, pcm=None, *, h: int, w: int,
                    strong_smoothing: bool, bd: int,
                    schedule: Optional[Schedule] = None) -> torch.Tensor:
    """Luma intra walk over N tiles.

    res / pcm: [N, h+PAD, w+PAD] int32 (pcm None when no tile has PCM);
    steps: [N, S, 6] int32 per-TU (x, y, size, mode, filter, pcm);
    src: [N, S, 2, 65] uint8 (recon.ref_sources); counts: [N] int32;
    schedule: unit_table of these steps at the luma CTB size, required
    on CUDA (the plain walk on the CPU needs none). Returns [N, h, w]
    int32 reconstructed planes.
    """
    _check_walk(res, pcm, steps, src, counts, schedule, h, w)
    if res.device.type == "cpu":
        return luma_plain(res, steps, src, counts, pcm, h=h, w=w,
                          strong_smoothing=strong_smoothing, bd=bd)
    from heif_tpu_torch.ops import _build

    n, s = steps.shape[0], steps.shape[1]
    units = schedule.units
    plane = _plane(n, h, w, res.device)
    rc = _build.load().heif_intra_luma(
        plane.data_ptr(), res.data_ptr(), _ptr(pcm), steps.data_ptr(),
        src.data_ptr(), counts.data_ptr(), units.data_ptr(), n, s,
        units.shape[1], plane.shape[1], plane.shape[2], res.shape[1],
        res.shape[2], bd, int(bool(strong_smoothing)), schedule.ctb_log2,
        torch.cuda.current_stream(res.device).cuda_stream,
    )
    _raise_on(rc, "heif_intra_luma", units.shape[1])
    LAUNCHES["luma"] += 1
    return plane[:, 1 : 1 + h, 1 : 1 + w]


def intra_scan_chroma2(res_cb, res_cr, steps, src, counts, pcm_cb=None,
                       pcm_cr=None, *, h: int, w: int, bd: int,
                       schedule: Optional[Schedule] = None):
    """Cb + Cr intra walk over N tiles sharing one worklist (HEVC shares
    chroma TU geometry and mode). Shapes as in intra_scan_luma, at the
    chroma plane size (h, w); the schedule is cut at the chroma CTB size.
    Returns (cb, cr) [N, h, w] int32."""
    _check_walk(res_cb, pcm_cb, steps, src, counts, schedule, h, w)
    _check_walk(res_cr, pcm_cr, steps, src, counts, schedule, h, w)
    dev = res_cb.device
    if dev.type == "cpu":
        return chroma2_plain(res_cb, res_cr, steps, src, counts, pcm_cb,
                             pcm_cr, h=h, w=w, bd=bd)
    from heif_tpu_torch.ops import _build

    n, s = steps.shape[0], steps.shape[1]
    units = schedule.units
    cb = _plane(n, h, w, dev)
    cr = _plane(n, h, w, dev)
    rc = _build.load().heif_intra_chroma2(
        cb.data_ptr(), cr.data_ptr(), res_cb.data_ptr(), res_cr.data_ptr(),
        _ptr(pcm_cb), _ptr(pcm_cr), steps.data_ptr(), src.data_ptr(),
        counts.data_ptr(), units.data_ptr(), n, s, units.shape[1],
        cb.shape[1], cb.shape[2], res_cb.shape[1], res_cb.shape[2], bd,
        schedule.ctb_log2, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "heif_intra_chroma2", units.shape[1])
    LAUNCHES["chroma"] += 1
    return cb[:, 1 : 1 + h, 1 : 1 + w], cr[:, 1 : 1 + h, 1 : 1 + w]


# plain versions: the CPU path of the wrappers, and on the card the
# oracle each kernel is held against (chip_smoke.py)


def luma_plain(res, steps, src, counts, pcm=None, *, h: int, w: int,
               strong_smoothing: bool, bd: int) -> torch.Tensor:
    """Plain PyTorch luma walk on any device; same contract as
    intra_scan_luma."""
    plane = _plane(res.shape[0], h, w, res.device)
    R.intra_scan_component(
        plane, res, pcm, steps, src, counts, is_luma=True,
        strong_smoothing=strong_smoothing, bd=bd, tables=tables_on(res.device),
    )
    return plane[:, 1 : 1 + h, 1 : 1 + w]


def chroma2_plain(res_cb, res_cr, steps, src, counts, pcm_cb=None,
                  pcm_cr=None, *, h: int, w: int, bd: int):
    """Plain PyTorch Cb + Cr walk on any device: both planes run as one
    batch of 2N chains. Same contract as intra_scan_chroma2."""
    n = res_cb.shape[0]
    pcm = None
    if pcm_cb is not None or pcm_cr is not None:
        pcm = torch.cat([
            torch.zeros_like(res_cb) if pcm_cb is None else pcm_cb,
            torch.zeros_like(res_cr) if pcm_cr is None else pcm_cr,
        ])
    both = _plane(2 * n, h, w, res_cb.device)
    R.intra_scan_component(
        both, torch.cat([res_cb, res_cr]), pcm, steps.repeat(2, 1, 1),
        src.repeat(2, 1, 1, 1), counts.repeat(2), is_luma=False,
        strong_smoothing=False, bd=bd, tables=tables_on(res_cb.device),
    )
    both = both[:, 1 : 1 + h, 1 : 1 + w]
    return both[:n], both[n:]


# the schedule check: the kernels' wavefront order in plain PyTorch


def wavefront_rounds(steps: np.ndarray, units: np.ndarray, ctb_log2: int):
    """The most eager order the unit table allows, as rounds.

    In each round every unfinished unit whose wait is met walks its next
    CTB; units are checked from the last to the first, so a unit always
    sees its wait unit as it stood before the round (never one CTB
    further). Every CTB of a round runs as if at the same time. Returns
    a list of rounds, each a list of (tile, [step indices of one CTB]).
    Raises RuntimeError if a round makes no progress (a deadlock)."""
    n, n_units = units.shape[0], units.shape[1]
    groups = []  # per tile, per unit: [(column, [k, ...]), ...]
    for t in range(n):
        per = []
        for u in range(n_units):
            k0, k1 = int(units[t, u, U_K0]), int(units[t, u, U_K1])
            g: list = []
            for k in range(k0, k1):
                if steps[t, k, 2] <= 0:
                    continue
                c = int(steps[t, k, 0]) >> ctb_log2
                if not g or g[-1][0] != c:
                    g.append((c, []))
                g[-1][1].append(k)
            per.append(g)
        groups.append(per)
    done = units[..., U_COL0].astype(np.int64) - 1  # last finished column
    pos = np.zeros((n, n_units), np.int64)  # next CTB group of each unit
    finished = np.int64(1 << 40)
    for t in range(n):
        for u in range(n_units):
            if not groups[t][u]:
                done[t, u] = finished
    rounds = []
    while (done < finished).any():
        this = []
        for t in range(n):
            for u in reversed(range(n_units)):
                g = groups[t][u]
                if pos[t, u] >= len(g):
                    continue
                col, ks = g[pos[t, u]]
                wait = int(units[t, u, U_WAIT])
                if wait >= 0:
                    need = min(col + 1, int(units[t, wait, U_COL1]))
                    if done[t, wait] < need:
                        continue
                this.append((t, ks))
                pos[t, u] += 1
                done[t, u] = col if pos[t, u] < len(g) else finished
        if not this:
            raise RuntimeError("the unit table deadlocks")
        rounds.append(this)
    return rounds


def wavefront_plain(res, steps, src, schedule: Schedule, pcm=None, *,
                    h: int, w: int, is_luma: bool, strong_smoothing: bool,
                    bd: int) -> torch.Tensor:
    """Plain PyTorch walk of N tiles (one plane each) in the order of
    wavefront_rounds: every CTB that a round walks advances one step at a
    time together, each step reading the plane as it stands before the
    step. A sample that the table let a step read before its writer ran
    comes out wrong, so this equals the sequential walk
    (recon.intra_scan_component) exactly when the unit table is a valid
    schedule. Shapes as in luma_plain (the schedule's units also bound
    each worklist: no step outside a unit runs); returns [N, h, w]
    int32."""
    dev = res.device
    n = res.shape[0]
    plane = _plane(n, h, w, dev)
    _, hp, wp = plane.shape
    wr = res.shape[2]
    mxv = (1 << bd) - 1
    tables = tables_on(dev)
    pflat = plane.view(-1)
    rflat = res.reshape(-1)
    cflat = None if pcm is None else pcm.reshape(-1)
    r65 = torch.arange(R.REF_LEN, dtype=torch.int64, device=dev)[None]
    r32 = torch.arange(R.MAX_S, dtype=torch.int64, device=dev)
    blk_p = r32[:, None] * wp + r32[None, :]
    blk_r = r32[:, None] * wr + r32[None, :]
    st_all = steps.to(torch.int64)
    src_all = src.reshape(n, src.shape[1], R.N_REF).to(torch.int64)
    rounds = wavefront_rounds(steps.cpu().numpy(),
                              schedule.units.cpu().numpy(), schedule.ctb_log2)
    for chains in rounds:
        for j in range(max(len(ks) for _, ks in chains)):
            live = [(t, ks[j]) for t, ks in chains if j < len(ks)]
            ti = torch.tensor([t for t, _ in live], dtype=torch.int64,
                              device=dev)
            ki = torch.tensor([k for _, k in live], dtype=torch.int64,
                              device=dev)
            tx, ty, size, mode, filt, is_pcm = st_all[ti, ki].unbind(1)
            base = ti * (hp * wp) + ty * wp + tx
            left = pflat[base[:, None] + r65 * wp]
            top = pflat[base[:, None] + r65]
            local = torch.cat([left, top], dim=1)
            sk = src_all[ti, ki]
            refs = torch.where(sk >= R.N_REF, 1 << (bd - 1),
                               local.gather(1, sk.clamp(max=R.N_REF - 1)))
            lref, tref = refs[:, : R.REF_LEN], refs[:, R.REF_LEN :]
            size32 = size.to(torch.int32)
            if is_luma:
                lref, tref = R.filter_refs(lref, tref, size32, filt,
                                           strong_smoothing, bd)
            pred = R.predict_block(lref, tref, size32, mode, is_luma, bd,
                                   tables)
            ridx = (ti * res[0].numel() + ty * wr + tx)[:, None, None] + blk_r
            new = (pred + rflat[ridx]).clamp(0, mxv)
            pcm_v = torch.zeros_like(new) if cflat is None else cflat[ridx]
            new = torch.where((is_pcm != 0)[:, None, None], pcm_v, new)
            pidx = (base + wp + 1)[:, None, None] + blk_p
            inside = (r32[None, :, None] < size[:, None, None]) & (
                r32[None, None, :] < size[:, None, None])
            pflat[pidx[inside]] = new[inside]
    return plane[:, 1 : 1 + h, 1 : 1 + w]
