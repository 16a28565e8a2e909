#!/usr/bin/env python3
"""Smoke run of the heif_tpu_torch decode on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit), torch / CUDA versions;
     build the native entropy library (heif_tpu_torch/native/entropy.cpp
     -> build/) and load it;
  2. build and load the CUDA kernels (heif_tpu_torch/csrc -> build/);
  3. each intra kernel against its plain PyTorch walk on the card,
     bit-exact, on three inputs: the flagship plan (all 48 tiles of
     tests/assets/halfmoonbay.heic), a synthetic 4x128x128 10-bit batch
     with PCM blocks and strong smoothing, and a synthetic batch of tall
     pictures cut into HEVC tiles, with more CTB rows than the kernels
     have warps; kernel time (CUDA events, warm, many launches) beside
     the earlier kernel's, the plain walk's time and the bound; then
     both kernels on the synthetic batch with every unit table padded to
     PADDED_UNITS empty units (more than 48 KB of shared memory a block),
     still equal to the plain walk, and to UNFIT_UNITS (more than a block
     may have), which must raise;
  4. the slice: HeicDecoder.decode(data, device="cuda") cold and warm;
     both kernels must have been launched by it, tiles 1, 22, 24, 38 and
     46 must equal the numpy reference (heif_tpu_torch.ops.ref_recon) bit for
     bit; stage times and MP/s;
  5. the host envelope trace of all 48 flagship tiles (768 WPP
     substreams: full trace segments, envelope tapes, residual spans);
  6. the three CABAC kernels against the host golden on all 768 full
     streams, through their image entry points (replay_image,
     replay_windowed_image, gen_image): bins, scattered coefficients and
     final contexts bit for bit; kernel ms (CUDA events) and Mbins/s; per
     kernel the longest lane's steps, ns and SM cycles a step of it (the
     clock sampled while the generator runs) and the byte bound;
  7. each CABAC kernel against its plain PyTorch version on the card, on
     the 768 streams cut to 2048 bins (replays) or 2048 steps (generator):
     whole bin / event / debug / state planes; both times; then all
     three on the seeded contract inputs of
     heif_tpu_torch/utils/cabac_fuzz.py, equal to their plain versions;
  8. the raw-HEVC slice: flagship tiles 1, 22 and 24 as Annex-B streams
     through HeicDecoder.decode_hevc(entropy="device-gen", device="cuda")
     must equal ref_recon and launch the generator and both intra
     kernels; then `python -m heif_tpu_torch decode tile.hevc --entropy
     device-gen -o out.npz` once as a subprocess, held equal too;
  9. the bulk paths: decode_reconstruct_overlapped on all 48 flagship
     tiles with readback at the default chunk and at chunk=48 (both
     equal to the one-batch tile stacks of phase 4's path, and stitched
     equal to phase 4's decode), decode to device (readback=False), and
     decode_burst of 4 flagship images (48 tiles each); the intra
     kernels must launch in each; walls, MP/s, the host stage split,
     the intra kernel time per chunk, the device's idle share, and the
     one-batch decode() wall from the same run;
 10. the tile split: decode(mesh_devices=1) equals phase 4, and a
     one-process nccl group runs decode_burst_sharded in a subprocess,
     equal to phase 4 and launching both kernels;
 11. the entry points a user runs: `python -m heif_tpu_torch decode
     IMAGE --trace -o x.npz` through cli.main equals phase 4, and its
     torch.profiler trace holds one CUDA kernel event for each launch of
     both intra kernels (then the same decode untraced, timed beside
     it); `decode tile1.hevc --backend ref` equals phase 4's tile 1; the
     burst tool (heif_tpu_torch.tools.bench_burst.run, 4 images after a
     warm-up) prints its JSON line and launches both kernels once a chunk
     of each image; the device entropy tools (bench_device_entropy
     run_replay and run_gen) check and time all 768 substreams of phase
     5; `pytest tests/test_torch_card.py` passes with nothing skipped;
 12. the Main-10 grid (tests/assets/torch/main10_grid_4032x3024.heic:
     the flagship's 48 tiles re-encoded at 10 bits, CTB 64, irot 3):
     HeicDecoder.decode(device="cuda") cold and warm (uint16 planes of
     3024x4032 after rotation, warm equal to cold, both intra kernels
     launched, tiles 1, 22, 24, 38 and 46 equal to ref_recon), the
     overlapped decode with readback at the default chunk and to device
     (int16), each equal to the one-batch decode, and both intra kernels
     against their plain walks on its plan (times, bound); the walls,
     MP/s and the stage split.
The last two lines are a JSON summary of the kernels (the CABAC kernels
with phase 6's figures) and the card's nvidia-smi line before a final
{"ok": true, "device": {...}} line.
Without a CUDA device it exits 2 before doing anything. Any import of
jax or heif_tpu fails inside this script: the port runs without them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "tests", "assets", "halfmoonbay.heic")
# the flagship's 48 tiles at 10 bits, CTB 64, irot 3 (phase 12;
# tests/test_torch_fixtures.py encodes it)
MAIN10_GRID = os.path.join(ROOT, "tests", "assets", "torch",
                           "main10_grid_4032x3024.heic")
ORACLE_TILES = (1, 22, 24, 38, 46)
HEVC_TILES = (1, 22, 24)
PREFIX = 2048  # bins (replays) / steps (generator) of the plain comparison
KERNEL_SOURCE = "heif_tpu_torch/csrc/intra.cu"
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
# the one-block-a-tile intra kernels that the wavefront replaced, on the
# flagship plan, ms (PERF.md section 6; H100 80GB HBM3, 700 W)
EARLIER_MS = {"luma": 10.203, "chroma": 2.912}
KERNEL_REPS = 20  # timed launches of each intra kernel (phase 3)
# unit-table size a worklist of the padded intra check (phase 3): its
# counters pass 48 KB of shared memory together with the kernel's own
PADDED_UNITS = 8150
UNFIT_UNITS = 60000  # 240,000 B of counters: more than a block may use
# the CABAC kernels' full-flagship times, ms, before each carried a
# substream a warp (PERF.md section 6; H100 80GB HBM3, 700 W)
EARLIER_CABAC_MS = {"replay": 35.816, "windowed": 25.034, "gen": 135.602}
REPS = 3  # timed runs of each bulk path (phase 9)
SCHEDULE_REPS = 20  # timed builds of a chunk's intra schedules (phase 9)
BURST = 4  # images in the burst (phase 9)
BACKEND = "nccl"  # process-group backend of phase 10


def card_line() -> str:
    from heif_tpu_torch.utils.profiling import nvidia_smi

    return nvidia_smi("name,power.limit")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def parse_flagship(data: bytes):
    """SPS, PPS, tile ids and parsed slice headers of the flagship grid."""
    from heif_tpu_torch.container.reader import HeifReader
    from heif_tpu_torch.hevc import params
    from heif_tpu_torch.hevc import slice as sl
    from heif_tpu_torch.hevc.rbsp import remove_emulation_prevention

    reader = HeifReader(data)
    heif = reader.read()
    rec = heif.hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    tile_ids = heif.item_ids_referencing(heif.primary_item_id(), "dimg")
    slices = [
        sl.parse_slice_header(
            sl.split_length_prefixed_nals(reader.get_item_data(t), 4)[0],
            sps, pps)
        for t in tile_ids
    ]
    return sps, pps, tile_ids, slices


def load_flagship(data: bytes):
    """Parse and entropy-decode every tile of the flagship grid."""
    from heif_tpu_torch import native
    from heif_tpu_torch.cabac.syntax import TileSyntaxDecoder

    sps, pps, tile_ids, slices = parse_flagship(data)
    if native.available():
        sts = native.decode_tiles_parallel(sps, pps, slices)
    else:
        sts = [TileSyntaxDecoder(sps, pps, ps).decode() for ps in slices]
    return sps, pps, tile_ids, slices, sts


def bound_ms(n_bytes: int) -> float:
    """The least time the card takes to move n_bytes (HBM rate)."""
    return n_bytes / HBM_BYTES_PER_MS


def critical_steps(steps: np.ndarray, units: np.ndarray, ctb_log2: int) -> int:
    """Steps on the wavefront's longest chain, over all tiles: a CTB
    starts when its unit's previous CTB and its wait unit's CTB one column
    right (or that unit's last) are done, and takes one time unit a step.
    Returns the longest chain's step count (the whole worklist's length
    bounds the one-block-a-tile walk)."""
    longest = 0
    for t in range(units.shape[0]):
        finish = {}  # (unit, column) -> steps done when that CTB ends
        last_done = {}  # unit -> finish of its latest CTB
        for u, (k0, k1, _, _, wait) in enumerate(units[t]):
            xs = steps[t, k0:k1, 0][steps[t, k0:k1, 2] > 0] >> ctb_log2
            cols, w = np.unique(xs, return_counts=True)
            t_prev = 0
            for c, n in zip(cols.tolist(), w.tolist()):
                start = t_prev
                if wait >= 0:
                    need = min(c + 1, int(units[t, wait, 3]))
                    start = max(start, max([f for (uu, cc), f in finish.items()
                                            if uu == wait and cc <= need],
                                           default=0))
                t_prev = finish[(u, c)] = start + n
            last_done[u] = t_prev
        longest = max([longest, *last_done.values()])
    return longest


def walk_bytes(steps, counts, units, n_planes: int) -> int:
    """The bytes an intra walk must move, from its real steps (k < count,
    size > 0): each step's six fields and the 2 * (2N + 1) source indices
    it uses, its N x N samples of each plane read once (from the residual
    or, for a PCM step, the PCM plane) and written once, the counts, and
    the units that hold steps. The zero fill of the padded output planes
    is a separate launch, not the walk's."""
    s_len = steps.shape[1]
    k = np.arange(s_len)
    size = steps[..., 2].astype(np.int64)
    real = (k[None] < np.minimum(counts, s_len)[:, None]) & (size > 0)
    n = size[real]
    fields = int(real.sum()) * steps.shape[2] * 4
    sources = int((2 * (2 * n + 1)).sum())
    samples = int((n * n).sum()) * n_planes * 4 * 2  # read + written
    used = int((units[..., 1] > units[..., 0]).sum()) * units.shape[2] * 4
    return fields + sources + samples + counts.size * 4 + used


def intra_calls(bp, dev, n_units: int = 0):
    """A plan's device inputs (plan_to_device) and its schedules, and per
    intra kernel ("luma", "chroma") a call of the kernel's wrapper and
    one of its plain walk on them, each returning a tuple of planes.
    n_units: pad each unit table with empty units to n_units a worklist
    (ops.intra.pad_schedule)."""
    from heif_tpu_torch.ops import batch as B
    from heif_tpu_torch.ops import intra as I

    d = B.plan_to_device(bp, dev)
    res = B.residual_planes(d, bp, dev)
    srcs = B.source_tables(d, bp)
    steps, counts, pcm, sch = d["steps"], d["counts"], d["pcm"], d["schedules"]
    if n_units:
        sch = [I.pad_schedule(s, n_units) for s in sch]
    luma = (res[0], steps[0], srcs[0], counts[0], pcm[0])
    lkw = dict(h=bp.height, w=bp.width, strong_smoothing=bp.strong_smoothing,
               bd=bp.bit_depth_y)
    chroma = (res[1], res[2], steps[1], srcs[1], counts[1], pcm[1], pcm[2])
    ckw = dict(h=bp.height // 2, w=bp.width // 2, bd=bp.bit_depth_c)
    calls = {
        "luma": (lambda: (I.intra_scan_luma(*luma, schedule=sch[0], **lkw),),
                 lambda: (I.luma_plain(*luma, **lkw),)),
        "chroma": (lambda: I.intra_scan_chroma2(*chroma, schedule=sch[1],
                                                **ckw),
                   lambda: I.chroma2_plain(*chroma, **ckw)),
    }
    return d, sch, calls


def check_kernels(label: str, bp, dev) -> dict:
    """Run both intra kernels and their plain walks on the same device
    inputs; require bit equality. Returns per-kernel error, times (the
    kernel's mean of KERNEL_REPS launches; the plain walk's comparison
    run, by CUDA events) and bound (walk_bytes over the HBM rate; the
    walk's arithmetic is far below the card's integer rate, so bytes
    bound it)."""
    import torch

    d, sch, calls = intra_calls(bp, dev)
    steps, counts = d["steps"], d["counts"]
    out = {}
    for c, (name, (kern, plain)) in enumerate(calls.items()):
        got = kern()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain()
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
        diff = sum(int((a != b).sum()) for a, b in zip(got, want))
        ms = cuda_ms(kern, KERNEL_REPS)
        st_np, units_np = steps[c].cpu().numpy(), sch[c].units.cpu().numpy()
        bound = bound_ms(walk_bytes(st_np, counts[c].cpu().numpy(), units_np,
                                    len(got)))
        chain = critical_steps(st_np, units_np, sch[c].ctb_log2)
        longest = int(counts[c].max())
        print(f"[kernel] {label} {name}: max_abs_err={err} mismatches={diff} "
              f"units {tuple(sch[c].units.shape)}; kernel {ms:.3f} ms "
              f"(mean of {KERNEL_REPS}), plain {plain_ms:.1f} ms, bound "
              f"{bound:.4f} ms (bytes); longest chain {chain} steps of a "
              f"longest worklist of {longest}: {ms * 1e3 / chain:.3f} us a "
              f"chain step")
        if diff:
            raise SystemExit(f"{label} {name} kernel disagrees with its plain walk")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "chain_steps": chain}
    return out


def check_padded_units(label: str, bp, dev) -> None:
    """Both intra kernels with every unit table padded to PADDED_UNITS
    empty units: the unit counters (4 bytes each, dynamic shared memory)
    and the kernel's static shared memory then pass 48 KB together, so
    the launch must opt in to more. Empty units publish at once, so the
    planes must equal the plain walk's. Padded to UNFIT_UNITS the
    counters pass what a block may use: the wrapper must raise."""
    import torch

    _, sch, calls = intra_calls(bp, dev, PADDED_UNITS)
    for name, (kern, plain) in calls.items():
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        diff = sum(int((a != b).sum()) for a, b in zip(got, want))
        print(f"[kernel] {label} {name}, unit tables padded to "
              f"{tuple(sch[0].units.shape)} ({4 * PADDED_UNITS} B of "
              f"counters): mismatches={diff}")
        if diff:
            raise SystemExit(f"{label} {name} kernel with padded unit tables "
                             "disagrees with its plain walk")
    _, _, calls = intra_calls(bp, dev, UNFIT_UNITS)
    for name, (kern, _) in calls.items():
        try:
            kern()
        except RuntimeError as e:
            if "does not fit" not in str(e):
                raise
            print(f"[kernel] {label} {name}, {UNFIT_UNITS} units: raises "
                  f"({e})")
        else:
            raise SystemExit(f"{label} {name}: {UNFIT_UNITS} units launched")


def phase3_kernels(sps, pps, slices, sts, dev, card):
    """Phase 3: both intra kernels against their plain walks on the
    flagship plan, the synthetic 10-bit PCM + strong-smoothing batch, and
    tall tiled pictures (more CTB rows than warps; HEVC tile columns and
    rows, so units of different tiles run side by side). Returns the
    three check_kernels results."""
    import dataclasses

    from heif_tpu_torch.ops import batch as B
    from heif_tpu_torch.utils.synthetic import synthetic_batch

    bp = B.pack_batch(sts, sps, pps, slices)
    flag = check_kernels(f"flagship {bp.n}x{bp.height}x{bp.width}", bp, dev)
    for name in ("luma", "chroma"):
        print(f"[kernel] flagship {name}: wavefront {flag[name]['ms']:.3f} ms "
              f"against {EARLIER_MS[name]:.3f} ms for the one-block-a-tile "
              f"kernel (PERF.md), bound {flag[name]['bound_ms']:.4f} ms; "
              f"{card}")
    syn = synthetic_batch(n=4, size=128, bd=10, pcm=True, seed=7)
    sbp = B.pack_batch(*syn)
    synth = check_kernels("synthetic 4x128x128 10-bit+PCM", sbp, dev)
    check_padded_units("synthetic 4x128x128 10-bit+PCM", sbp, dev)
    # the whole synthetic slice on the card equals the CPU path
    got = B.reconstruct_batch(sbp, dev)
    want = B.reconstruct_batch(sbp, "cpu")
    for c in range(3):
        if not np.array_equal(got[c], want[c]):
            raise SystemExit(f"synthetic batch plane {c}: cuda != cpu")
    print("[kernel] synthetic 10-bit+PCM batch: cuda decode == cpu decode")
    tbp = B.pack_batch(*synthetic_batch(n=3, size=256, height=1024, bd=10,
                                        pcm=True, seed=11))
    tbp = dataclasses.replace(tbp, tile_col_bd=(128,), tile_row_bd=(512,))
    tall = check_kernels(
        f"tall 3x{tbp.height}x{tbp.width} in 2x2 HEVC tiles "
        f"({tbp.height >> tbp.ctb_log2} luma CTB rows)", tbp, dev)
    return flag, synth, tall


def tile_planes(out: dict, i: int, sps) -> list:
    """The Y, Cb and Cr planes of tile i (grid order) of a decoded grid
    image, cut to the crop at the grid's right and bottom edges."""
    info = out["info"]
    r, c = divmod(i, info.grid.columns)
    th, tw = sps.pic_height_in_luma_samples, sps.pic_width_in_luma_samples
    planes = []
    for ci, k in enumerate(("Y", "Cb", "Cr")):
        h, w = (th, tw) if ci == 0 else (th // 2, tw // 2)
        p = np.rot90(out[k], k=-info.rotation)
        planes.append(p[r * h : (r + 1) * h, c * w : (c + 1) * w])
    return planes


def oracle_check(out: dict, sps, pps, tile_ids, slices, sts):
    """Tiles ORACLE_TILES of the decoded image vs ref_recon, bit for bit."""
    from heif_tpu_torch.ops.ref_recon import reconstruct_tile

    for tid in ORACLE_TILES:
        i = tile_ids.index(tid)
        gold = reconstruct_tile(sts[i], sps, pps, slices[i].header)
        for ci, (name, got) in enumerate(zip(("Y", "Cb", "Cr"),
                                             tile_planes(out, i, sps))):
            want = gold[ci][: got.shape[0], : got.shape[1]]
            bad = int((got.astype(int) != want.astype(int)).sum())
            if bad:
                raise SystemExit(f"tile {tid} {name}: {bad} samples differ "
                                 "from ref_recon")
    print(f"[oracle] tiles {list(ORACLE_TILES)} equal ref_recon bit for bit")


def _same_ctx(res, segs, what):
    for i, ((_, p_fin, mps_fin), seg) in enumerate(zip(res, segs)):
        if not (np.array_equal(p_fin, seg.p_final)
                and np.array_equal(mps_fin, seg.mps_final)):
            raise SystemExit(f"{what}: stream {i} final contexts differ "
                             "from the host decoder's")


def check_golden(rentries, gentries, tile_of, goldens, dev, card) -> dict:
    """Phase 6: the three kernels over every full stream, through their
    image entry points, against the host golden. Returns launches (the
    replays' own runs), kernel times and, per kernel, the figures of its
    longest lane's steps at the SM clock sampled while the generator
    runs."""
    from heif_tpu_torch.ops import cabac as C
    from heif_tpu_torch.ops import cabac_gen as G
    from heif_tpu_torch.utils.profiling import sm_clock_mhz

    segs = [s for _, s in rentries]
    total_bins = sum(s.n_bins for s in segs)
    out = {}

    C.reset_launches()
    res = C.replay_image(rentries, device=dev)
    out["replay_launches"] = C.LAUNCHES["replay"]
    for i, (bins, _, _) in enumerate(res):
        if not np.array_equal(bins, segs[i].bins):
            raise SystemExit(f"replay: stream {i} bins differ from the trace")
    _same_ctx(res, segs, "replay")
    out["replay_full_ms"] = C.bench_device_entropy(rentries, device=dev)[2] * 1e3

    C.reset_launches()
    res = C.replay_windowed_image(rentries, device=dev)
    out["windowed_launches"] = C.LAUNCHES["windowed"]
    for i, (bins, _, _) in enumerate(res):
        if not np.array_equal(bins, segs[i].bins):
            raise SystemExit(f"windowed: stream {i} bins differ from the trace")
    _same_ctx(res, segs, "windowed")
    wargs, _ = C.windowed_image_inputs(rentries, device=dev)
    out["windowed_full_ms"] = cuda_ms(lambda: C.replay_windowed(*wargs), 3)

    res = G.gen_image(gentries, device=dev)
    _same_ctx(res, segs, "gen")
    planes = [[np.zeros_like(p) for p in g] for g in goldens]
    for ei, (ev, _, _) in enumerate(res):
        G.scatter_events(ev, gentries[ei][4], planes[tile_of[ei]])
    for ti, g in enumerate(goldens):
        for c in range(3):
            bad = int(np.count_nonzero(planes[ti][c] != g[c]))
            if bad:
                raise SystemExit(f"gen: tile {ti} plane {c}: {bad} "
                                 "coefficients differ from the host decoder")
    out["gen_full_ms"] = G.bench_gen_image(gentries, device=dev)[2] * 1e3
    gargs, n_steps, _ = G.image_inputs(gentries, device=dev)
    mhz = sm_clock_mhz(lambda: G.gen(*gargs, n_steps))

    # per step of the longest lane, whose chain bounds each kernel; the
    # byte bound counts each stream's real work (ops.cabac.replay_bytes,
    # ops.cabac_gen.gen_bytes)
    wblk = wargs[3].shape[1] // wargs[0].shape[1]
    longest = {"replay": C.longest_lane(rentries),
               "windowed": C.longest_lane(rentries),
               "gen": G.longest_lane(gentries)}
    n_bytes = {"replay": C.replay_bytes(rentries, C.N_CTX),
               "windowed": C.replay_bytes(rentries, C.N_CTXP, wblk),
               "gen": G.gen_bytes(gentries)}
    n = len(rentries)
    for name in ("replay", "windowed", "gen"):
        ms = out[f"{name}_full_ms"]
        ns = ms * 1e6 / longest[name]
        out[name] = {"longest_steps": longest[name], "full_ms": ms,
                     "ns_per_step": ns, "cycles_per_step": ns * mhz / 1e3,
                     "sm_clock_mhz": mhz,
                     "full_bound_ms": bound_ms(n_bytes[name])}
        print(f"[golden] {name}: {n} full streams bit-exact vs the host "
              f"decoder; kernel {ms:.3f} ms (earlier "
              f"{EARLIER_CABAC_MS[name]:.3f} ms, PERF.md), "
              f"{total_bins / ms / 1e3:.1f} Mbins/s ({total_bins} bins); "
              f"longest lane {longest[name]} steps: {ns:.1f} ns, "
              f"{ns * mhz / 1e3:.0f} SM cycles at {mhz:.0f} MHz a step; "
              f"bound {out[name]['full_bound_ms']:.4f} ms (bytes) on {card}")
    return out


def _prefix(seg, k: int):
    from heif_tpu_torch.cabac.trace import TraceSegment

    t = TraceSegment(byte_start=seg.byte_start, byte_end=seg.byte_end)
    t.p0, t.mps0 = seg.p0, seg.mps0
    t.kinds, t.slots, t.bins = seg.kinds[:k], seg.slots[:k], seg.bins[:k]
    t.positions = seg.positions[:k]
    return t


def _kernel_vs_plain(name, kern, plain, n_bytes, card) -> dict:
    """Run a kernel and its plain version on the same device inputs;
    require equal planes. Times: kernel by CUDA events over 5 runs, plain
    its one comparison run. Bound: n_bytes(outputs) at the HBM rate (a
    CABAC step is a few integer operations a lane, far below the card's
    integer rate)."""
    import torch

    got = kern()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain()
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max_err(name, got, want)
    ms = cuda_ms(kern, 5)
    bound = bound_ms(n_bytes(got))
    print(f"[plain] {name}: max_abs_err={err} kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, bound {bound:.4f} ms (bytes) on {card}")
    if err:
        raise SystemExit(f"{name} kernel disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound}


def max_err(name, got, want) -> int:
    """The largest |kernel - plain| over two tuples of output planes (a
    plane may be None in both)."""
    err = 0
    for a, b in zip(got, want):
        if (a is None) != (b is None):
            raise SystemExit(f"{name}: kernel and plain outputs differ in kind")
        if a is not None:
            if a.shape != b.shape:
                raise SystemExit(f"{name}: shapes {a.shape} != {b.shape}")
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def check_fuzz(dev) -> dict:
    """Phase 7: the three CABAC kernels against their plain versions on
    the seeded contract inputs of utils.cabac_fuzz (ragged lanes,
    KIND_PAD and unknown kinds mid-tape, slots outside [0, 136), reads
    past the words, through the word ring's slides too; the windowed
    replay's packed context bytes with bit 7 set and window ends inside
    its 32-step blocks; TU descriptors of every kind, lanes that finish
    at different steps). Returns the largest error of each."""
    from heif_tpu_torch.ops import cabac as C
    from heif_tpu_torch.ops import cabac_gen as G
    from heif_tpu_torch.utils import cabac_fuzz as F

    out = {"replay": 0, "windowed": 0, "gen": 0}
    for case in F.WINDOWED_CASES:
        wargs = [C.as_tensor(a, dev) for a in F.windowed_inputs(*case)]
        err = max_err(f"windowed fuzz {case}", C.replay_windowed(*wargs),
                      C.replay_windowed_plain(*wargs))
        print(f"[plain] windowed fuzz (seed, B, nb, blk, w_blk[, bypass]) = "
              f"{case}: max_abs_err={err}")
        if err:
            raise SystemExit("windowed kernel disagrees with its plain "
                             f"version on fuzz input {case}")
        out["windowed"] = max(out["windowed"], err)
    for case in F.CASES:
        S = case[2]
        rargs = [C.as_tensor(a, dev) for a in F.replay_inputs(*case)]
        gargs = [C.as_tensor(a, dev) for a in F.gen_inputs(*case)]
        for name, kern, plain in (
            ("replay", lambda: C.replay(*rargs), lambda: C.replay_plain(*rargs)),
            ("gen", lambda: G.gen(*gargs, S, debug=True),
             lambda: G.gen_plain(*gargs, S, debug=True)),
        ):
            err = max_err(f"{name} fuzz {case}", kern(), plain())
            print(f"[plain] {name} fuzz (seed, B, S) = {case}: "
                  f"max_abs_err={err}")
            if err:
                raise SystemExit(f"{name} kernel disagrees with its plain "
                                 f"version on fuzz input {case}")
            out[name] = max(out[name], err)
    # the replay reading through 100 words and past them (its word ring
    # slides across their end)
    rargs = [C.as_tensor(a, dev) for a in F.replay_inputs(*F.LONG_REPLAY)]
    err = max_err(f"replay fuzz {F.LONG_REPLAY}", C.replay(*rargs),
                  C.replay_plain(*rargs))
    print(f"[plain] replay fuzz (seed, B, S, W, bypass) = {F.LONG_REPLAY}: "
          f"max_abs_err={err}")
    if err:
        raise SystemExit("replay kernel disagrees with its plain version on "
                         f"fuzz input {F.LONG_REPLAY}")
    out["replay"] = max(out["replay"], err)
    return out


def check_plain(rentries, gentries, dev, card) -> dict:
    """Phase 7: each CABAC kernel vs its plain version on the 768 streams
    cut to PREFIX bins / steps. The bounds count the real work only: per
    stream its real steps (a replay: kind and slot read, bin written; the
    generator: event and debug word written), its context state read and
    written once, and the stream bytes and envelope-tape rows its steps
    consume; the padding of lanes, steps and words is not counted."""
    from heif_tpu_torch.cabac.trace import KIND_PAD
    from heif_tpu_torch.ops import cabac as C
    from heif_tpu_torch.ops import cabac_gen as G

    cut = [(rb, _prefix(s, PREFIX)) for rb, s in rentries]
    arrays = C.stack_batches(C.pack_sorted_batches(cut, blk=PREFIX),
                             ("words", "c0", "kinds", "slots"),
                             (0, 0, C.KIND_PAD, 0))
    args = [C.as_tensor(a, dev) for a in arrays]
    out = {"replay": _kernel_vs_plain(
        f"replay {args[2].shape[0]}x{args[2].shape[1]} steps x 128 lanes",
        lambda: C.replay(*args), lambda: C.replay_plain(*args),
        lambda got: C.replay_bytes(cut, C.N_CTX), card)}
    wargs, _ = C.windowed_image_inputs(cut, device=dev)
    wblk = wargs[3].shape[1] // wargs[0].shape[1]
    out["windowed"] = _kernel_vs_plain(
        f"windowed {wargs[3].shape[0]}x{wargs[3].shape[1]} steps x 128 lanes",
        lambda: C.replay_windowed(*wargs),
        lambda: C.replay_windowed_plain(*wargs),
        lambda got: C.replay_bytes(cut, C.N_CTXP, wblk), card)
    capped = [(rb, s, t, min(ns, PREFIX), sp) for rb, s, t, ns, sp in gentries]
    gargs, S, gbatches = G.image_inputs(capped, device=dev)

    def gen_bytes(got):
        dbg = got[1].cpu().numpy()
        total = 0
        for bi, (_, idx) in enumerate(gbatches):
            for lane, ei in enumerate(idx):
                ns = capped[ei][3]
                d = dbg[bi, :ns, lane]
                asked = (d & 7) != KIND_PAD  # a bin was decoded
                tape = int((asked & ((d >> 16) == G.P_TAPE)).sum()) + 1
                total += (8 * ns + 2 * 4 * C.N_CTX + 4 * tape
                          + C.stream_bytes(capped[ei][1], int(asked.sum())))
        return total

    out["gen"] = _kernel_vs_plain(
        f"gen {gargs[0].shape[0]}x{S} steps x 128 lanes (events, dbg, state)",
        lambda: G.gen(*gargs, S, debug=True),
        lambda: G.gen_plain(*gargs, S, debug=True), gen_bytes, card)
    return out


def check_hevc_slice(data, sps, pps, tile_ids, slices, sts, dev, card) -> dict:
    """Phase 8: flagship tiles as Annex-B streams through decode_hevc with
    device-gen entropy on the card, and once through the CLI."""
    import tempfile

    import torch

    from heif_tpu_torch.ops.ref_recon import reconstruct_tile
    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.ops import cabac_gen as G
    from heif_tpu_torch.ops import intra as I
    from heif_tpu_torch.utils.annexb import tile_annexb

    streams, golds = {}, {}
    for tid in HEVC_TILES:
        i = tile_ids.index(tid)
        streams[tid] = tile_annexb(data, i)
        golds[tid] = reconstruct_tile(sts[i], sps, pps, slices[i].header)

    G.reset_launches()
    I.reset_launches()
    t0 = time.perf_counter()
    outs = {tid: HeicDecoder.decode_hevc(s, entropy="device-gen", device=dev)
            for tid, s in streams.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gen": G.LAUNCHES["gen"], **I.LAUNCHES}
    print(f"[hevc] kernel launches in {len(streams)} decode_hevc calls: "
          f"{launches}; {wall * 1e3:.1f} ms on {card}")
    for name, count in launches.items():
        if count <= 0:
            raise SystemExit(f"decode_hevc never launched the {name} kernel")
    for tid, got in outs.items():
        for c, k in enumerate(("Y", "Cb", "Cr")):
            if not np.array_equal(got[k], golds[tid][c]):
                raise SystemExit(f"decode_hevc tile {tid} {k} differs from "
                                 "ref_recon")
    print(f"[hevc] tiles {list(HEVC_TILES)}: decode_hevc(entropy="
          "'device-gen', device='cuda') equals ref_recon bit for bit")

    tid = HEVC_TILES[0]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "tile.hevc")
        dst = os.path.join(tmp, "out.npz")
        with open(src, "wb") as f:
            f.write(streams[tid])
        proc = subprocess.run(
            [sys.executable, "-m", "heif_tpu_torch", "decode", src,
             "--entropy", "device-gen", "--device", dev.type, "-o", dst],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"CLI decode failed ({proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
        got = np.load(dst)
        for c, k in enumerate(("Y", "Cb", "Cr")):
            if not np.array_equal(got[k], golds[tid][c]):
                raise SystemExit(f"CLI decode of tile {tid}: {k} differs "
                                 "from ref_recon")
    print(f"[hevc] python -m heif_tpu_torch decode tile{tid}.hevc --entropy "
          "device-gen: equals ref_recon")
    return launches


def _same_stacks(got, ref, what):
    for c, k in enumerate(("Y", "Cb", "Cr")):
        if got[c].shape != ref[c].shape or not np.array_equal(got[c], ref[c]):
            raise SystemExit(f"{what}: {k} differs from the one-batch tile "
                             "stacks")


def _launched(what) -> dict:
    """The intra launch counts since the last reset; fail unless both
    kernels ran."""
    from heif_tpu_torch.ops import intra as I

    counts = dict(I.LAUNCHES)
    for name, count in counts.items():
        if count <= 0:
            raise SystemExit(f"{what} never launched the {name} kernel")
    return counts


def _device_stacks(chunks):
    """Per-chunk device planes as host tile stacks (uint16 for int16)."""
    import torch

    from heif_tpu_torch.ops.batch import host_view

    return [host_view(torch.cat([ch[c] for ch in chunks]).cpu())
            for c in range(3)]


def intra_kernel_ms(bp, dev) -> float:
    """Luma + chroma intra kernel time (CUDA events, 5 runs) on bp."""
    _, _, calls = intra_calls(bp, dev)
    return sum(cuda_ms(kern, 5) for kern, _ in calls.values())


def check_bulk(data, out4, sts, dev, card) -> dict:
    """Phase 9: the bulk paths on all 48 flagship tiles, each held equal
    to the one-batch tile stacks (the path of phase 4's decode, whose
    stitch must equal phase 4's output), each launching both kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from heif_tpu_torch.utils.profiling import DecodeStats
    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.ops import batch as B
    from heif_tpu_torch.ops import intra as I

    info = out4["info"]
    mp = info.ispe_width * info.ispe_height / 1e6
    sps, pps, _, slices = parse_flagship(data)
    n = len(slices)
    chunk = B.schedule_hints(None, sps, pps, n)["chunk"]
    tiles = B.reconstruct_tiles(sts, sps, pps, slices, device=dev)
    ref = [np.stack([t[c] for t in tiles]) for c in range(3)]

    def stitch(stacks, sps_):
        return HeicDecoder._stitch([[p[i] for p in stacks] for i in range(n)],
                                   info.grid, sps_, True, info.rotation)

    for k, p in stitch(ref, sps).items():
        if not np.array_equal(p, out4[k]):
            raise SystemExit(f"one-batch tile stacks stitch to a {k} plane "
                             "unlike phase 4's decode")
    out = {"chunk": chunk, "mp": mp}

    # readback=True at the default chunk and at one chunk of 48, then
    # timed in turns, end to end as a caller runs them (slice headers,
    # the overlapped decode, stitch) beside the one-batch decode()
    for c in (chunk, n):
        I.reset_launches()
        _same_stacks(B.decode_reconstruct_overlapped(
            sps, pps, slices, chunk=c, device=dev), ref, f"overlapped chunk={c}")
        out[f"launches_chunk{c}"] = _launched(f"overlapped chunk={c}")

    def e2e(c):
        t0 = time.perf_counter()
        s_sps, s_pps, _, s_slices = parse_flagship(data)
        got = B.decode_reconstruct_overlapped(s_sps, s_pps, s_slices,
                                              chunk=c, device=dev)
        planes = stitch(got, s_sps)
        wall = time.perf_counter() - t0
        _same_stacks(got, ref, f"overlapped chunk={c}")
        return wall, planes

    walls = {f"chunk{chunk}": [], f"chunk{n}": [], "decode": []}
    for _ in range(REPS):
        for c in (chunk, n):
            wall, planes = e2e(c)
            walls[f"chunk{c}"].append(wall)
        t0 = time.perf_counter()
        got = HeicDecoder.decode(data, device="cuda")
        walls["decode"].append(time.perf_counter() - t0)
        for k in ("Y", "Cb", "Cr"):
            if not (np.array_equal(got[k], out4[k])
                    and np.array_equal(planes[k], out4[k])):
                raise SystemExit(f"{k}: a timed decode differs from phase 4")
    out["walls_s"] = walls
    for key, ws in walls.items():
        print(f"[bulk] e2e {key}: {' '.join(f'{w * 1e3:.1f}' for w in ws)} ms"
              f"; best {mp / min(ws):.2f} MP/s ({mp:.2f} MP) on {card}")

    # the host stage split, stats on (core runs without stats: no sync)
    for c in (chunk, n):
        stats = DecodeStats()
        t0 = time.perf_counter()
        B.decode_reconstruct_overlapped(sps, pps, slices, chunk=c,
                                        stats=stats, device=dev)
        wall = time.perf_counter() - t0
        stages = {k: v * 1e3 for k, v in stats.stages.items()}
        out[f"stages_ms_chunk{c}"] = stages
        print(f"[bulk] stage split chunk={c}, wall {wall * 1e3:.1f} ms: "
              + " ".join(f"{k}={v:.1f}ms" for k, v in stages.items()))

    # the device's idle share over one overlapped decode
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        B.decode_reconstruct_overlapped(sps, pps, slices, device=dev)
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in on_card)
    out["profiled_wall_ms"] = wall * 1e3
    out["device_busy_ms"] = busy_us / 1e3
    out["device_ops"] = sum(e.count for e in on_card)
    print(f"[bulk] profiled overlapped decode chunk={chunk}: wall "
          f"{wall * 1e3:.1f} ms, device activity {busy_us / 1e3:.1f} ms in "
          f"{out['device_ops']} kernels and copies, idle "
          f"{100 * (1 - busy_us / 1e3 / (wall * 1e3)):.1f}% on {card}")

    # intra kernel time: chunks of the default size in series vs one 48
    split = sum(intra_kernel_ms(B.pack_batch(sts[lo : lo + chunk], sps, pps,
                                             slices[lo : lo + chunk]), dev)
                for lo in range(0, n, chunk))
    whole = intra_kernel_ms(B.pack_batch(sts, sps, pps, slices), dev)
    out["intra_ms"] = {f"chunk{chunk}": split, f"chunk{n}": whole}
    print(f"[bulk] intra kernels (luma + chroma): {n // chunk} chunks of "
          f"{chunk} {split:.3f} ms, one of {n} {whole:.3f} ms on {card}")

    # the host cost of the intra schedules a chunk: plan_to_device builds
    # them (unit_tables, tensor ops on the card) on the dispatch path
    bp = B.pack_batch(sts[:chunk], sps, pps, slices[:chunk])
    d = B.plan_to_device(bp, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SCHEDULE_REPS):
        B.unit_tables(d, bp)
    host_ms = (time.perf_counter() - t0) * 1e3 / SCHEDULE_REPS
    device_ms = cuda_ms(lambda: B.unit_tables(d, bp), SCHEDULE_REPS)
    t0 = time.perf_counter()
    for _ in range(SCHEDULE_REPS):
        B.plan_to_device(bp, dev)
    plan_ms = (time.perf_counter() - t0) * 1e3 / SCHEDULE_REPS
    torch.cuda.synchronize()
    dispatch = out[f"stages_ms_chunk{chunk}"].get("dispatch", 0.0) / (n // chunk)
    out["schedule_ms"] = {"host": host_ms, "device": device_ms,
                          "plan_to_device": plan_ms, "dispatch": dispatch}
    print(f"[bulk] intra schedules (unit_tables) of a chunk of {chunk}: host "
          f"{host_ms:.3f} ms (mean of {SCHEDULE_REPS}, no synchronize), device "
          f"{device_ms:.3f} ms; plan_to_device with them {plan_ms:.3f} ms; "
          f"dispatch {dispatch:.1f} ms a chunk in the stage split on {card}")

    # decode to device: per-chunk CUDA planes, only real tiles
    dev_walls = []
    for _ in range(REPS):
        I.reset_launches()
        t0 = time.perf_counter()
        chunks = B.decode_reconstruct_overlapped(sps, pps, slices,
                                                 readback=False, device=dev)
        torch.cuda.synchronize()
        dev_walls.append(time.perf_counter() - t0)
        out["launches_to_device"] = _launched("decode to device")
        if (sum(ch[0].shape[0] for ch in chunks) != n
                or any(p.device.type != dev.type or p.dtype != torch.uint8
                       for ch in chunks for p in ch)):
            raise SystemExit("decode to device: wrong tile count, device or "
                             "dtype")
        _same_stacks(_device_stacks(chunks), ref, "decode to device")
    out["to_device_s"] = dev_walls
    print(f"[bulk] decode to device: "
          f"{' '.join(f'{w * 1e3:.1f}' for w in dev_walls)} ms; best "
          f"{mp / min(dev_walls):.2f} MP/s on {card}")

    # burst: BURST images through one entropy queue
    burst_walls = []
    for _ in range(2):
        lists = [parse_flagship(data)[3] for _ in range(BURST)]
        I.reset_launches()
        t0 = time.perf_counter()
        outs = B.decode_burst(sps, pps, lists, device=dev)
        torch.cuda.synchronize()
        burst_walls.append(time.perf_counter() - t0)
        out["launches_burst"] = _launched("decode_burst")
        if len(outs) != BURST:
            raise SystemExit(f"decode_burst: {len(outs)} images of {BURST}")
        for ii, img in enumerate(outs):
            _same_stacks(_device_stacks(img), ref, f"burst image {ii}")
    out["burst_s"] = burst_walls
    print(f"[bulk] burst of {BURST}: "
          f"{' '.join(f'{w * 1e3:.1f}' for w in burst_walls)} ms; best "
          f"{BURST * mp / min(burst_walls):.2f} MP/s on {card}")
    return out


_BURST_WORKER = """
import json, sys
sys.modules["jax"] = None
import numpy as np
from heif_tpu_torch.ops import intra as I
from heif_tpu_torch.parallel import distributed as D
assert D.init_distributed(backend=sys.argv[3])
outs, res = D.decode_burst_sharded([open(sys.argv[1], "rb").read()])
np.savez(sys.argv[2], **outs[0])
import torch.distributed as dist
print(json.dumps({"launches": dict(I.LAUNCHES), "burst": res.as_dict(),
                  "backend": dist.get_backend()}))
dist.destroy_process_group()
"""


def check_split(data, out4, card) -> dict:
    """Phase 10: decode(mesh_devices=1) and a one-process nccl group's
    decode_burst_sharded (in a subprocess), both equal to phase 4."""
    import socket
    import tempfile

    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.ops import intra as I

    I.reset_launches()
    t0 = time.perf_counter()
    got = HeicDecoder.decode(data, device="cuda", mesh_devices=1)
    wall = time.perf_counter() - t0
    out = {"mesh1_s": wall, "launches_mesh1": _launched("decode(mesh_devices=1)")}
    for k in ("Y", "Cb", "Cr"):
        if not np.array_equal(got[k], out4[k]):
            raise SystemExit(f"decode(mesh_devices=1): {k} differs from phase 4")
    print(f"[split] decode(mesh_devices=1) equals phase 4; {wall * 1e3:.1f} ms, "
          f"launches {out['launches_mesh1']} on {card}")

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="1", RANK="0", PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        dst = os.path.join(tmp, "burst.npz")
        proc = subprocess.run([sys.executable, "-c", _BURST_WORKER, ASSET, dst,
                               BACKEND],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"nccl decode_burst_sharded failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        planes = np.load(dst)
        for k in ("Y", "Cb", "Cr"):
            if not np.array_equal(np.rot90(planes[k], k=out4["info"].rotation),
                                  out4[k]):
                raise SystemExit(f"nccl decode_burst_sharded: {k} differs "
                                 "from phase 4")
    for name, count in rep["launches"].items():
        if count <= 0:
            raise SystemExit(f"nccl decode_burst_sharded never launched the "
                             f"{name} kernel")
    if rep["backend"] != BACKEND or rep["burst"]["n_processes"] != 1:
        raise SystemExit(f"nccl decode_burst_sharded: {rep}")
    out["burst_sharded"] = rep
    print(f"[split] world-size-1 {rep['backend']} decode_burst_sharded equals "
          f"phase 4; {rep['burst']}; launches {rep['launches']} on {card}")
    return out


def _same_planes(got, want, what):
    for k in ("Y", "Cb", "Cr"):
        if not np.array_equal(got[k], want[k]):
            raise SystemExit(f"{what}: {k} differs from phase 4")


def _intra_events(path: str) -> dict:
    """Kernel events of the intra walk in a torch.profiler Chrome trace:
    {kernel name: count}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = str(e.get("name", ""))
        if str(e.get("cat", "")).lower() == "kernel" and "intra_walk" in name:
            out[name] = out.get(name, 0) + 1
    return out


def check_entry_points(data, out4, sps, pps, n_tiles, rentries, gentries,
                       goldens, tile_of, dev, card) -> dict:
    """Phase 11: the entry points a user runs. (a) `decode --trace`
    through cli.main, equal to phase 4, its trace holding every intra
    launch as a CUDA kernel event; (b) the burst tool; (c) the device
    entropy tools on phase 5's 768 substreams; (d) the JAX-free card test
    file under pytest, nothing skipped; (e) `decode --backend ref` of
    tile 1 as an Annex-B stream, equal to phase 4's tile."""
    import glob
    import tempfile

    from heif_tpu_torch import cli
    from heif_tpu_torch.ops import batch as B
    from heif_tpu_torch.ops import cabac as C
    from heif_tpu_torch.ops import cabac_gen as G
    from heif_tpu_torch.ops import intra as I
    from heif_tpu_torch.tools import bench_burst
    from heif_tpu_torch.tools import bench_device_entropy as BDE
    from heif_tpu_torch.utils import profiling
    from heif_tpu_torch.utils.annexb import tile_annexb

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) traced decode, then the same command untraced
        logdir = profiling.DEFAULT_LOGDIR
        profiling.DEFAULT_LOGDIR = os.path.join(tmp, "trace")
        dst = os.path.join(tmp, "x.npz")
        try:
            I.reset_launches()
            t0 = time.perf_counter()
            rc = cli.main(["decode", ASSET, "--device", "cuda", "--trace",
                           "-o", dst])
            out["traced_s"] = time.perf_counter() - t0
            launches = dict(I.LAUNCHES)
        finally:
            profiling.DEFAULT_LOGDIR = logdir
        if rc != 0:
            raise SystemExit(f"decode --trace returned {rc}")
        _same_planes(np.load(dst), out4, "decode --trace")
        traces = glob.glob(os.path.join(tmp, "trace", "*.pt.trace.json"))
        if len(traces) != 1:
            raise SystemExit(f"decode --trace wrote {len(traces)} trace files")
        kernels = _intra_events(traces[0])
        print(f"[entry] decode --trace: intra kernel events {kernels}, "
              f"launches {launches}")
        if (len(kernels) != 2 or min(launches.values()) <= 0
                or sum(kernels.values()) != sum(launches.values())):
            raise SystemExit("the trace does not hold one CUDA kernel event "
                             "for each launch of both intra kernels")
        t0 = time.perf_counter()
        if cli.main(["decode", ASSET, "--device", "cuda", "-o", dst]) != 0:
            raise SystemExit("decode (untraced) failed")
        out["untraced_s"] = time.perf_counter() - t0
        _same_planes(np.load(dst), out4, "decode")
        print(f"[entry] cli decode -o x.npz: traced {out['traced_s'] * 1e3:.1f}"
              f" ms, untraced {out['untraced_s'] * 1e3:.1f} ms on {card}")

        # (e) --backend ref on tile 1 as a raw stream
        src = os.path.join(tmp, "tile1.hevc")
        with open(src, "wb") as f:
            f.write(tile_annexb(data, 1))
        t0 = time.perf_counter()
        if cli.main(["decode", src, "--backend", "ref", "--device", "cuda",
                     "-o", dst]) != 0:
            raise SystemExit("decode --backend ref failed")
        got = np.load(dst)
        for k, want in zip(("Y", "Cb", "Cr"), tile_planes(out4, 1, sps)):
            if not np.array_equal(got[k][: want.shape[0], : want.shape[1]],
                                  want):
                raise SystemExit(f"decode --backend ref of tile 1: {k} "
                                 "differs from phase 4")
        print(f"[entry] decode tile1.hevc --backend ref equals phase 4's tile "
              f"1; {(time.perf_counter() - t0) * 1e3:.1f} ms on {card}")

    # (b) the burst tool: a warm-up image and BURST timed ones
    chunks = -(-n_tiles // B.schedule_hints(None, sps, pps, n_tiles)["chunk"])
    I.reset_launches()
    res = bench_burst.run(data, BURST, dev)
    want = (BURST + 1) * chunks
    keys = {"metric", "value", "unit", "images", "megapixels_total", "wall_s",
            "per_image_s", "best_image_mp_s"}
    if set(res) != keys or not res["value"] > 0:
        raise SystemExit(f"bench_burst: {res}")
    if I.LAUNCHES != {"luma": want, "chroma": want}:
        raise SystemExit(f"bench_burst launched {I.LAUNCHES}, expected "
                         f"{want} of each intra kernel")
    out["burst"] = res
    print(f"[entry] bench_burst {json.dumps(res)} on {card}")

    # (c) the device entropy tools on every substream, timed
    for name, fn, counts, reset in (
        ("replay", lambda: BDE.run_replay(rentries, dev), C.LAUNCHES,
         C.reset_launches),
        ("gen", lambda: BDE.run_gen(gentries, goldens, tile_of, dev),
         G.LAUNCHES, G.reset_launches),
    ):
        reset()
        t0 = time.perf_counter()
        res = fn()
        if counts[name] <= 0 or not res["value"] > 0:
            raise SystemExit(f"bench_device_entropy {name}: {res}, launches "
                             f"{counts}")
        out[name] = res
        print(f"[entry] bench_device_entropy {json.dumps(res)} on {card}; "
              f"{res['streams']} streams bit-exact, "
              f"{time.perf_counter() - t0:.1f} s")

    # (d) the card test file
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-rs", "tests/test_torch_card.py"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    if proc.returncode != 0 or "passed" not in tail or "skipped" in tail:
        raise SystemExit(f"tests/test_torch_card.py ({proc.returncode}): "
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
    print(f"[entry] pytest tests/test_torch_card.py: {tail}; "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    return out


def check_main10_grid(dev, card) -> dict:
    """Phase 12: the Main-10 grid (MAIN10_GRID) through decode() cold and
    warm (uint16 planes after rotation, warm equal to cold, both intra
    kernels launched, tiles ORACLE_TILES equal to ref_recon), the
    overlapped decode with readback at the default chunk and to device,
    each equal to the one-batch tile stacks (whose stitch equals the
    decode), and both intra kernels against their plain walks on its
    plan, timed."""
    import torch

    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.ops import batch as B
    from heif_tpu_torch.ops import intra as I
    from heif_tpu_torch.utils.profiling import DecodeStats

    data = open(MAIN10_GRID, "rb").read()
    sps, pps, tile_ids, slices, sts = load_flagship(data)
    out = {}
    decoded = {}
    for label in ("cold", "warm"):
        I.reset_launches()
        stats = DecodeStats()
        t0 = time.perf_counter()
        decoded[label] = HeicDecoder.decode(data, device=dev, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[f"launches_{label}"] = _launched(f"main-10 grid {label} decode")
        out[f"{label}_s"] = wall
        out[f"{label}_stages_ms"] = {k: v * 1e3 for k, v in stats.stages.items()}
    img = decoded["cold"]
    info = img["info"]
    mp = info.ispe_width * info.ispe_height / 1e6
    shape = (info.display_height, info.display_width)
    if (shape != (4032, 3024) or info.rotation != 3
            or info.luma_bit_depth != 10):
        raise SystemExit(f"main-10 grid: {info}")
    for k, sub in (("Y", 1), ("Cb", 2), ("Cr", 2)):
        p = img[k]
        if p.dtype != np.uint16 or p.shape != (shape[0] // sub, shape[1] // sub):
            raise SystemExit(f"main-10 grid {k}: {p.dtype} {p.shape}, "
                             f"expected uint16 {(shape[0] // sub, shape[1] // sub)}")
        if not np.array_equal(p, decoded["warm"][k]):
            raise SystemExit(f"main-10 grid {k}: warm decode differs from cold")
    print(f"[main10] output Y {img['Y'].shape} Cb {img['Cb'].shape} uint16 "
          f"(CTB {1 << sps.ctb_log2_size_y}, {len(slices)} tiles, rotation "
          f"{info.rotation}); warm == cold; launches {out['launches_cold']}")
    oracle_check(img, sps, pps, tile_ids, slices, sts)
    for label in ("cold", "warm"):
        wall = out[f"{label}_s"]
        stages = " ".join(f"{k}={v:.1f}ms"
                          for k, v in out[f"{label}_stages_ms"].items())
        print(f"[main10] {label}: {wall * 1e3:.1f} ms, {mp / wall:.2f} MP/s "
              f"({mp:.2f} MP) on {card}; {stages}")

    # the bulk paths against the one-batch tile stacks
    n = len(slices)
    ref = [np.stack([t[c] for t in B.reconstruct_tiles(sts, sps, pps, slices,
                                                         device=dev)])
           for c in range(3)]
    stitched = HeicDecoder._stitch([[p[i] for p in ref] for i in range(n)],
                                   info.grid, sps, True, info.rotation)
    for k in ("Y", "Cb", "Cr"):
        if not np.array_equal(stitched[k], img[k]):
            raise SystemExit(f"main-10 grid: the one-batch tile stacks stitch "
                             f"to a {k} plane unlike decode()'s")
    I.reset_launches()
    t0 = time.perf_counter()
    got = B.decode_reconstruct_overlapped(sps, pps, slices, device=dev)
    out["overlapped_s"] = time.perf_counter() - t0
    out["launches_overlapped"] = _launched("main-10 grid overlapped decode")
    _same_stacks(got, ref, "main-10 grid overlapped")
    I.reset_launches()
    t0 = time.perf_counter()
    chunks = B.decode_reconstruct_overlapped(sps, pps, slices, readback=False,
                                             device=dev)
    torch.cuda.synchronize()
    out["to_device_s"] = time.perf_counter() - t0
    out["launches_to_device"] = _launched("main-10 grid decode to device")
    if any(p.device.type != dev.type or p.dtype != torch.int16
           for ch in chunks for p in ch):
        raise SystemExit("main-10 grid decode to device: not int16 on the card")
    _same_stacks(_device_stacks(chunks), ref, "main-10 grid decode to device")
    chunk = B.schedule_hints(None, sps, pps, n)["chunk"]
    print(f"[main10] overlapped chunk={chunk} (readback) "
          f"{out['overlapped_s'] * 1e3:.1f} ms, {mp / out['overlapped_s']:.2f} "
          f"MP/s; to device (int16) {out['to_device_s'] * 1e3:.1f} ms, "
          f"{mp / out['to_device_s']:.2f} MP/s; both equal the one-batch tile "
          f"stacks, launches {out['launches_overlapped']} / "
          f"{out['launches_to_device']} on {card}")

    # both intra kernels on this plan, against their plain walks
    bp = B.pack_batch(sts, sps, pps, slices)
    out["kernels"] = check_kernels(
        f"main-10 grid {bp.n}x{bp.height}x{bp.width} CTB {1 << bp.ctb_log2}",
        bp, dev)
    print(f"[main10] {card}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the port runs without JAX and without the JAX package: make any
    # import of either fail
    sys.modules["jax"] = None
    sys.modules["heif_tpu"] = None

    from heif_tpu_torch import native
    from heif_tpu_torch.utils.profiling import DecodeStats
    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.ops import _build
    from heif_tpu_torch.ops import intra as I
    from heif_tpu_torch.tools import bench_device_entropy as BDE

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    # phase 1
    print(f"[card] {card}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}")
    t0 = time.perf_counter()
    entropy_lib = native.build()
    native.load()  # raises if it does not load or has another ABI
    print(f"[build] native entropy library {os.path.relpath(entropy_lib, ROOT)}"
          f" built from heif_tpu_torch/native/entropy.cpp and loaded in "
          f"{time.perf_counter() - t0:.1f} s")

    # phase 2
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"[build] {_build.library_path().name} loaded in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    del lib

    # phase 3
    data = open(ASSET, "rb").read()
    sps, pps, tile_ids, slices, sts = load_flagship(data)
    flag, synth, tall = phase3_kernels(sps, pps, slices, sts, dev, card)

    # phase 4: the main path, through the entry point a user calls
    I.reset_launches()
    cold = DecodeStats()
    t0 = time.perf_counter()
    out = HeicDecoder.decode(data, device="cuda", stats=cold)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(I.LAUNCHES)
    print(f"[slice] kernel launches in the decode: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise SystemExit(f"the decode never launched the {name} kernel")
    warm = DecodeStats()
    t0 = time.perf_counter()
    out2 = HeicDecoder.decode(data, device="cuda", stats=warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    info = out["info"]
    shape = (info.display_height, info.display_width)
    for k, sub in (("Y", 1), ("Cb", 2), ("Cr", 2)):
        p = out[k]
        if p.dtype != np.uint8 or p.shape != (shape[0] // sub, shape[1] // sub):
            raise SystemExit(f"{k}: {p.dtype} {p.shape}, expected uint8 "
                             f"{(shape[0] // sub, shape[1] // sub)}")
        if not np.array_equal(p, out2[k]):
            raise SystemExit(f"{k}: warm decode differs from cold decode")
    print(f"[slice] output Y {out['Y'].shape} Cb {out['Cb'].shape} uint8; "
          "warm == cold")
    oracle_check(out, sps, pps, tile_ids, slices, sts)
    mp = info.ispe_width * info.ispe_height / 1e6
    for label, st, wall in (("cold", cold, cold_s), ("warm", warm, warm_s)):
        stages = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in st.stages.items())
        print(f"[slice] {label}: {wall * 1e3:.1f} ms, {mp / wall:.2f} MP/s "
              f"({mp:.2f} MP) on {card}; {stages}")

    # phase 5: generator entries; the replays take their (rbsp, segment)
    t0 = time.perf_counter()
    gentries, goldens, tile_of = BDE.trace_entries(data, gen=True)
    rentries = [e[:2] for e in gentries]
    n_bins = sum(s.n_bins for _, s in rentries)
    print(f"[trace] {len(slices)} tiles -> {len(rentries)} substreams, "
          f"{n_bins} bins, at most {max(e[3] for e in gentries)} generator "
          f"steps a stream; host envelope trace {time.perf_counter() - t0:.1f} s")

    # phase 6
    t0 = time.perf_counter()
    golden = check_golden(rentries, gentries, tile_of, goldens, dev, card)
    print(f"[golden] phase took {time.perf_counter() - t0:.1f} s")

    # phase 7
    t0 = time.perf_counter()
    plain = check_plain(rentries, gentries, dev, card)
    fuzz = check_fuzz(dev)
    print(f"[plain] phase took {time.perf_counter() - t0:.1f} s")

    # phase 8: the raw-HEVC path with device entropy
    t0 = time.perf_counter()
    hevc = check_hevc_slice(data, sps, pps, tile_ids, slices, sts, dev, card)
    print(f"[hevc] phase took {time.perf_counter() - t0:.1f} s")

    # phase 9: the bulk paths
    t0 = time.perf_counter()
    check_bulk(data, out, sts, dev, card)
    print(f"[bulk] phase took {time.perf_counter() - t0:.1f} s")

    # phase 10: the tile split
    t0 = time.perf_counter()
    check_split(data, out, card)
    print(f"[split] phase took {time.perf_counter() - t0:.1f} s")

    # phase 11: the user entry points
    t0 = time.perf_counter()
    check_entry_points(data, out, sps, pps, len(slices), rentries, gentries,
                       goldens, tile_of, dev, card)
    print(f"[entry] phase took {time.perf_counter() - t0:.1f} s")

    # phase 12: the Main-10 grid at full size
    t0 = time.perf_counter()
    check_main10_grid(dev, card)
    print(f"[main10] phase took {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, replaces in (("luma", "heif_tpu/ops/pallas_intra.py:420"),
                           ("chroma", "heif_tpu/ops/pallas_intra.py:647")):
        kernels.append({
            "name": f"intra_{name}",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(flag[name]["max_abs_err"],
                               synth[name]["max_abs_err"],
                               tall[name]["max_abs_err"]),
            "ms": flag[name]["ms"],
            "plain_ms": flag[name]["plain_ms"],
            "bound_ms": flag[name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    for name, source, replaces, count in (
        ("cabac_replay", "heif_tpu_torch/csrc/cabac.cu",
         "heif_tpu/ops/pallas_cabac.py:82", golden["replay_launches"]),
        ("cabac_windowed", "heif_tpu_torch/csrc/cabac.cu",
         "heif_tpu/ops/pallas_cabac.py:377", golden["windowed_launches"]),
        ("cabac_gen", "heif_tpu_torch/csrc/cabac_gen.cu",
         "heif_tpu/ops/pallas_cabac_gen.py:171", hevc["gen"]),
    ):
        if count <= 0:
            raise SystemExit(f"{name}: its entry point never launched it")
        key = name.split("_")[1]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": max(plain[key]["max_abs_err"], fuzz[key]),
            "ms": plain[key]["ms"], "plain_ms": plain[key]["plain_ms"],
            "bound_ms": plain[key]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, **golden[key],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
