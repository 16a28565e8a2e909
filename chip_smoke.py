#!/usr/bin/env python3
"""Smoke run of the heif_tpu_torch decode on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. the card (nvidia-smi name and power limit), torch / CUDA versions,
     whether the native entropy library loaded;
  2. build and load the CUDA kernels (heif_tpu_torch/csrc -> build/);
  3. each intra kernel against its plain PyTorch walk on the card,
     bit-exact, on the flagship plan (all 48 tiles of
     tests/assets/halfmoonbay.heic) and on a synthetic 10-bit batch with
     PCM blocks; kernel and plain times side by side;
  4. the slice: HeicDecoder.decode(data, device="cuda") cold and warm;
     both kernels must have been launched by it, tiles 1, 22, 24, 38 and
     46 must equal the numpy reference (heif_tpu.ops.ref_recon) bit for
     bit; stage times and MP/s.
The last two lines are a JSON summary of the kernels and the card's
nvidia-smi line before a final {"ok": true, "device": {...}} line.
Without a CUDA device it exits 2 before doing anything. Any import of
jax fails inside this script: the port runs without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(ROOT, "tests", "assets", "halfmoonbay.heic")
ORACLE_TILES = (1, 22, 24, 38, 46)
KERNEL_SOURCE = "heif_tpu_torch/csrc/intra.cu"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def load_flagship(data: bytes):
    """Parse and entropy-decode every tile of the flagship grid."""
    from heif_tpu import native
    from heif_tpu.cabac.syntax import TileSyntaxDecoder
    from heif_tpu.container.reader import HeifReader
    from heif_tpu.hevc import params
    from heif_tpu.hevc import slice as sl
    from heif_tpu.hevc.rbsp import remove_emulation_prevention

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
    if native.available():
        sts = native.decode_tiles_parallel(sps, pps, slices)
    else:
        sts = [TileSyntaxDecoder(sps, pps, ps).decode() for ps in slices]
    return sps, pps, tile_ids, slices, sts


def check_kernels(label: str, bp, dev) -> dict:
    """Run both intra kernels and their plain walks on the same device
    inputs; require bit equality. Returns per-kernel error and times."""
    import torch

    from heif_tpu_torch.ops import batch as B
    from heif_tpu_torch.ops import intra as I

    d = B.plan_to_device(bp, dev)
    res = B.residual_planes(d, bp, dev)
    srcs = B.source_tables(d, bp)
    steps, counts, pcm = d["steps"], d["counts"], d["pcm"]
    H, W = bp.height, bp.width
    Hc, Wc = H // 2, W // 2
    bdy, bdc = bp.bit_depth_y, bp.bit_depth_c

    def luma_kernel():
        return I.intra_scan_luma(
            res[0], steps[0], srcs[0], counts[0], pcm[0], h=H, w=W,
            strong_smoothing=bp.strong_smoothing, bd=bdy)

    def luma_plain():
        return I.luma_plain(
            res[0], steps[0], srcs[0], counts[0], pcm[0], h=H, w=W,
            strong_smoothing=bp.strong_smoothing, bd=bdy)

    def chroma_kernel():
        return I.intra_scan_chroma2(
            res[1], res[2], steps[1], srcs[1], counts[1], pcm[1], pcm[2],
            h=Hc, w=Wc, bd=bdc)

    def chroma_plain():
        return I.chroma2_plain(
            res[1], res[2], steps[1], srcs[1], counts[1], pcm[1], pcm[2],
            h=Hc, w=Wc, bd=bdc)

    out = {}
    for name, kern, plain in (("luma", luma_kernel, luma_plain),
                              ("chroma", chroma_kernel, chroma_plain)):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
        diff = sum(int((a != b).sum()) for a, b in zip(got, want))
        ms = cuda_ms(kern, 5)
        plain_ms = cuda_ms(plain, 1)
        print(f"[kernel] {label} {name}: max_abs_err={err} mismatches={diff} "
              f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
        if diff:
            raise SystemExit(f"{label} {name} kernel disagrees with its plain walk")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return out


def oracle_check(out: dict, sps, pps, tile_ids, slices, sts):
    """Tiles ORACLE_TILES of the decoded image vs ref_recon, bit for bit."""
    import numpy as np

    from heif_tpu.ops.ref_recon import reconstruct_tile

    info = out["info"]
    cols = info.grid.columns
    th, tw = sps.pic_height_in_luma_samples, sps.pic_width_in_luma_samples
    planes = [np.rot90(out[k], k=-info.rotation) for k in ("Y", "Cb", "Cr")]
    for tid in ORACLE_TILES:
        i = tile_ids.index(tid)
        gold = reconstruct_tile(sts[i], sps, pps, slices[i].header)
        r, c = divmod(i, cols)
        for ci, name in enumerate(("Y", "Cb", "Cr")):
            sub = 1 if ci == 0 else 2
            h, w = th // sub, tw // sub
            got = planes[ci][r * h : (r + 1) * h, c * w : (c + 1) * w]
            want = gold[ci][: got.shape[0], : got.shape[1]]
            bad = int((got.astype(int) != want.astype(int)).sum())
            if bad:
                raise SystemExit(f"tile {tid} {name}: {bad} samples differ "
                                 "from ref_recon")
    print(f"[oracle] tiles {list(ORACLE_TILES)} equal ref_recon bit for bit")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the port runs without JAX: make any import of it fail
    sys.modules["jax"] = None
    import numpy as np

    from heif_tpu import native
    from heif_tpu.utils.profiling import DecodeStats
    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.ops import _build
    from heif_tpu_torch.ops import batch as B
    from heif_tpu_torch.ops import intra as I
    from heif_tpu_torch.utils.synthetic import synthetic_batch

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    # phase 1
    print(f"[card] {card}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}")
    print(f"[env] native entropy library loaded: {native.available()}")

    # phase 2
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"[build] {_build.library_path().name} loaded in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds:.1f} s)")
    del lib

    # phase 3
    data = open(ASSET, "rb").read()
    sps, pps, tile_ids, slices, sts = load_flagship(data)
    bp = B.pack_batch(sts, sps, pps, slices)
    flag = check_kernels(f"flagship {bp.n}x{bp.height}x{bp.width}", bp, dev)
    syn = synthetic_batch(n=4, size=128, bd=10, pcm=True, seed=7)
    sbp = B.pack_batch(*syn)
    synth = check_kernels("synthetic 4x128x128 10-bit+PCM", sbp, dev)
    # the whole synthetic slice on the card equals the CPU path
    got = B.reconstruct_batch(sbp, dev)
    want = B.reconstruct_batch(sbp, "cpu")
    for c in range(3):
        if not np.array_equal(got[c], want[c]):
            raise SystemExit(f"synthetic batch plane {c}: cuda != cpu")
    print("[kernel] synthetic 10-bit+PCM batch: cuda decode == cpu decode")

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
                               synth[name]["max_abs_err"]),
            "ms": flag[name]["ms"],
            "plain_ms": flag[name]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
