"""Command-line interface of the PyTorch / CUDA port: probe / decode /
verify / bench (port of heif_tpu/cli.py).

  python -m heif_tpu_torch probe  IMAGE.heic
  python -m heif_tpu_torch decode IMAGE.heic [-o out.ppm|out.npz]
                                  [--device cuda|cpu] [--backend torch|ref]
                                  [--item ID] [--mesh N] [--isolate-errors]
                                  [--stats] [--trace]
  python -m heif_tpu_torch decode STREAM.hevc [--entropy auto|device-gen]
  python -m heif_tpu_torch verify IMAGE.heic     # vs the libde265 oracle
  python -m heif_tpu_torch bench  IMAGE.heic [-n 3]

Input that starts with an Annex-B start code (00 00 01 or 00 00 00 01)
is a raw HEVC stream and goes to HeicDecoder.decode_hevc; anything else
is a HEIF container and goes to HeicDecoder.decode. Options that apply
to only one of the two are refused on the other. --backend (decode,
verify, bench) picks the reconstruction: torch (the port, on --device)
or ref (the host numpy reference, ops.ref_recon). decode --trace writes a
torch.profiler trace of the decode into
heif_tpu_torch.utils.profiling.DEFAULT_LOGDIR and prints its path.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def is_annexb(data: bytes) -> bool:
    """True when `data` starts with an Annex-B start code."""
    return data.startswith(b"\x00\x00\x01") or data.startswith(b"\x00\x00\x00\x01")


def _write_ppm(path: str, rgb: np.ndarray) -> None:
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def probe_annexb(data: bytes) -> dict:
    """Picture metadata of a raw Annex-B stream, from its SPS and PPS."""
    from heif_tpu_torch.hevc import params
    from heif_tpu_torch.hevc import slice as sl
    from heif_tpu_torch.hevc.rbsp import remove_emulation_prevention

    sps = pps = None
    for nal in sl.split_annexb_nals(data):
        kind = (nal[0] >> 1) & 0x3F
        if kind == 33 and sps is None:
            sps = params.parse_sps(remove_emulation_prevention(nal[2:]))
        elif kind == 34 and pps is None:
            pps = params.parse_pps(remove_emulation_prevention(nal[2:]))
    if sps is None or pps is None:
        raise ValueError("stream lacks SPS/PPS")
    return {
        "format": "annexb",
        "coded": [sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples],
        "luma_bit_depth": sps.bit_depth_y,
        "chroma_bit_depth": sps.bit_depth_c,
        "chroma_format_idc": sps.chroma_format_idc,
        "tiles_enabled": bool(pps.tiles_enabled_flag),
        "wpp": bool(pps.entropy_coding_sync_enabled_flag),
    }


def cmd_probe(args) -> int:
    from heif_tpu_torch import HeicDecoder

    data = _read(args.file)
    if is_annexb(data):
        print(json.dumps(probe_annexb(data), indent=2))
        return 0
    info = HeicDecoder.probe(data)
    out = {
        "ispe": [info.ispe_width, info.ispe_height],
        "display": [info.display_width, info.display_height],
        "rotation_ccw_deg": info.rotation * 90,
        "luma_bit_depth": info.luma_bit_depth,
        "chroma_bit_depth": info.chroma_bit_depth,
        "chroma_format_idc": info.chroma_format_idc,
        "primary_item_id": info.primary_item_id,
        "grid": (
            {
                "rows": info.grid.rows,
                "columns": info.grid.columns,
                "output": [info.grid.output_width, info.grid.output_height],
                "tiles": len(info.tile_ids),
            }
            if info.grid
            else None
        ),
        "thumbnail_count": info.thumbnail_count,
    }
    print(json.dumps(out, indent=2))
    return 0


def _decode(args, data: bytes, **kwargs) -> dict:
    """Planes of `data` with the command's backend and device: a raw
    stream through decode_hevc (kwargs: its entropy), a container
    through decode (kwargs: its options)."""
    from heif_tpu_torch import HeicDecoder

    if is_annexb(data):
        return HeicDecoder.decode_hevc(data, backend=args.backend,
                                       device=args.device, **kwargs)
    return HeicDecoder.decode(data, backend=args.backend, device=args.device,
                              **kwargs)


def cmd_decode(args) -> int:
    from heif_tpu_torch import HeicDecoder
    from heif_tpu_torch.utils import profiling

    data = _read(args.file)
    raw = is_annexb(data)
    if raw:
        for flag, given in (("--item", args.item is not None),
                            ("--isolate-errors", args.isolate_errors),
                            ("--mesh", args.mesh is not None)):
            if given:
                print(f"{flag} applies to HEIF containers only; "
                      f"{args.file} is a raw Annex-B HEVC stream",
                      file=sys.stderr)
                return 2
    elif args.entropy != "auto":
        print(f"--entropy {args.entropy} applies to raw Annex-B HEVC "
              f"streams only; {args.file} is a HEIF container",
              file=sys.stderr)
        return 2
    stats = profiling.DecodeStats()
    options = ({"entropy": args.entropy} if raw else
               {"mesh_devices": args.mesh, "item_id": args.item,
                "isolate_tile_errors": args.isolate_errors, "stats": stats})
    with profiling.device_trace(args.trace, profiling.DEFAULT_LOGDIR,
                                args.device) as trace:
        with profiling.span("total", stats):
            planes = _decode(args, data, **options)
    dt = stats.stages["total"]
    y = planes["Y"]
    mp = y.size / 1e6
    stats.megapixels = mp
    print(f"decoded {y.shape[1]}x{y.shape[0]} ({mp:.1f} MP) in {dt:.3f}s "
          f"[{args.backend} on {args.device}{', traced' if args.trace else ''}]",
          file=sys.stderr)
    if trace.path:
        print(f"trace: {trace.path}", file=sys.stderr)
    if args.stats:
        print(stats.json(), file=sys.stderr)
    if stats.tile_errors:
        print(f"WARNING: {stats.tile_errors}/{stats.tiles} tiles failed "
              f"(decoded as gray): {stats.errors}", file=sys.stderr)
    if args.output:
        if args.output.endswith(".ppm"):
            _write_ppm(args.output, HeicDecoder.to_rgb(planes))
        elif args.output.endswith(".npz"):
            np.savez(args.output, **{k: planes[k] for k in ("Y", "Cb", "Cr")
                                     if planes[k] is not None})
        else:
            print("unsupported output format (use .ppm or .npz)",
                  file=sys.stderr)
            return 2
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_verify(args) -> int:
    """Bit-exact plane comparison against the libde265 oracle."""
    from heif_tpu_torch.utils import oracle

    data = _read(args.file)
    if is_annexb(data):
        ours = _decode(args, data)
        golden = dict(zip(("Y", "Cb", "Cr"), oracle.decode_hevc_annexb(data)))
    else:
        ours = _decode(args, data, apply_rotation=False)
        golden = oracle.decode_heic_via_de265(data)
    ok = True
    for k in ("Y", "Cb", "Cr"):
        a, b = ours[k], golden[k]
        if a is None or b is None:
            if (a is None) != (b is None):
                print(f"{k}: present in only one decode")
                ok = False
            continue
        if a.shape != b.shape:
            print(f"{k}: SHAPE MISMATCH ours={a.shape} golden={b.shape}")
            ok = False
            continue
        diff = int(np.count_nonzero(a != b))
        status = "OK (bit-exact)" if diff == 0 else f"MISMATCH {diff} px"
        print(f"{k}: {a.shape[1]}x{a.shape[0]}  {status}")
        ok = ok and diff == 0
    return 0 if ok else 1


def cmd_bench(args) -> int:
    data = _read(args.file)
    _decode(args, data)  # warm-up
    times = []
    for _ in range(args.n):
        t0 = time.perf_counter()
        planes = _decode(args, data)
        times.append(time.perf_counter() - t0)
    mp = planes["Y"].size / 1e6
    best = min(times)
    print(json.dumps({
        "metric": "e2e_heif_decode_throughput",
        "value": round(mp / best, 3),
        "unit": "megapixels/s",
        "best_s": round(best, 4),
        "runs": args.n,
        "backend": args.backend,
        "device": args.device,
    }))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="heif_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; fails without a CUDA device) "
                             "or cpu (the plain PyTorch path)")
        sp.add_argument("--backend", default="torch", choices=["torch", "ref"],
                        help="reconstruction: torch (default; the port on "
                             "--device) or ref (the host numpy "
                             "reference)")

    pp = sub.add_parser("probe", help="container metadata only")
    pp.add_argument("file")
    pp.set_defaults(fn=cmd_probe)

    pd = sub.add_parser("decode", help="full pixel decode")
    pd.add_argument("file")
    pd.add_argument("-o", "--output", help=".ppm or .npz output path")
    device_arg(pd)
    pd.add_argument("--item", type=int, default=None,
                    help="decode this item id instead of the primary "
                         "(containers only)")
    pd.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="split the tiles over N devices: the first N "
                         "CUDA cards, or N CPU shards with --device cpu "
                         "(containers only)")
    pd.add_argument("--isolate-errors", action="store_true",
                    help="corrupt tiles decode as gray instead of failing "
                         "the image (containers only)")
    pd.add_argument("--entropy", default="auto", choices=["auto", "device-gen"],
                    help="entropy front end for raw Annex-B input: auto "
                         "(native C++ / Python twin) or device-gen (the "
                         "residual request generator decodes every "
                         "residual bin on --device)")
    pd.add_argument("--stats", action="store_true",
                    help="print per-stage decode stats JSON to stderr")
    pd.add_argument("--trace", action="store_true",
                    help="capture a torch.profiler trace of the decode "
                         "(CUDA kernels included on --device cuda) and "
                         "print its path")
    pd.set_defaults(fn=cmd_decode)

    pv = sub.add_parser("verify", help="bit-exact check vs libde265 oracle")
    pv.add_argument("file")
    device_arg(pv)
    pv.set_defaults(fn=cmd_verify)

    pb = sub.add_parser("bench", help="decode throughput benchmark")
    pb.add_argument("file")
    pb.add_argument("-n", type=int, default=3)
    device_arg(pb)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
