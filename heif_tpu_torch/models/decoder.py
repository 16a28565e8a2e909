"""HeicDecoder — container -> host entropy -> batched reconstruction on
one PyTorch device.

Port of heif_tpu/models/decoder.py (HeicDecoder.probe, decode,
decode_hevc, _entropy_device_gen, _stitch and to_rgb; ImageInfo and
_select_vcl_nal are copies of heif_tpu's). The container, header and
entropy layers are the port's own copies (container/, hevc/, cabac/,
native/); reconstruction runs in heif_tpu_torch.ops.batch, all tiles in
one batch (or split over a mesh of devices by parallel.pipeline), or
with backend="ref" in the host reference (ops.ref_recon); device-side
entropy runs in ops.cabac_gen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from heif_tpu_torch.container import grammar as g
from heif_tpu_torch.container.reader import HeifReader, parse_grid_config
from heif_tpu_torch.utils.profiling import span


@dataclass
class ImageInfo:
    """Resolved metadata for the primary picture (config 0 deliverable)."""

    ispe_width: int
    ispe_height: int
    display_width: int  # after irot
    display_height: int
    rotation: int  # irot angle, multiples of 90 deg CCW
    luma_bit_depth: int
    chroma_bit_depth: int
    chroma_format_idc: int
    grid: Optional[g.GridConfig]
    tile_ids: list[int]
    primary_item_id: int
    thumbnail_count: int
    icc: Optional[object] = None  # container.icc.IccProfile when present


def _select_vcl_nal(nals: list[bytes]) -> bytes:
    """Pick THE slice NAL of an hvc1 item.

    Items may legally carry non-VCL NALs (SEI, parameter sets) alongside
    the slice; more than one VCL NAL would mean a multi-slice picture,
    which this decoder (like the reference, src/heic/decoder.rs:152-157)
    rejects loudly rather than silently decoding only the first.
    """
    vcl = [n for n in nals if ((n[0] >> 1) & 0x3F) <= 31]
    if not vcl:
        raise ValueError("item contains no VCL (slice) NAL unit")
    if len(vcl) > 1:
        raise ValueError(
            f"item contains {len(vcl)} VCL NAL units; multi-slice items "
            "are not supported"
        )
    return vcl[0]


class HeicDecoder:
    """End-to-end HEIC decode with reconstruction on a torch device."""

    @staticmethod
    def probe(data: bytes) -> ImageInfo:
        """Parse container metadata only (no entropy/pixel work).

        Mirrors what the reference can do today plus grid-config resolution
        (which requires idat support, reference's todo! at
        src/heif/reader.rs:42).
        """
        reader = HeifReader(data)
        heif = reader.read()
        primary = heif.primary_item_id()
        info = heif.item_info_by_item_id(primary)
        if info is None:
            raise ValueError(f"primary item {primary} missing from iinf")

        props = heif.meta.item_properties
        ispe = props.property_of_type(primary, g.ImageSpatialExtentsProperty)
        if ispe is None:
            raise ValueError("primary item has no ispe property")
        irot = props.property_of_type(primary, g.ImageRotationProperty)
        angle = irot.angle if irot else 0
        if angle in (1, 3):
            disp_w, disp_h = ispe.height, ispe.width
        else:
            disp_w, disp_h = ispe.width, ispe.height

        grid = None
        tile_ids: list[int] = []
        if info.item_type == g.ItemType.GRID:
            grid = parse_grid_config(reader.get_item_data(primary))
            tile_ids = heif.item_ids_referencing(primary, "dimg")

        hvcc = heif.hevc_configuration_record(
            tile_ids[0] if tile_ids else primary
        )
        if hvcc is None:
            raise ValueError("no hvcC record found")

        thumbs = heif.items_referring_to(primary, "thmb")

        # ICC: parse header + tag table from a prof/rICC colr payload
        # (completes the reference's dead color module,
        # src/color/reader.rs:11-135)
        icc = None
        colr = props.property_of_type(
            tile_ids[0] if tile_ids else primary, g.ColorInformationProperty
        ) or props.property_of_type(primary, g.ColorInformationProperty)
        if colr is not None and colr.icc_profile:
            from heif_tpu_torch.container.icc import parse_icc_header

            try:
                icc = parse_icc_header(colr.icc_profile)
            except ValueError:
                icc = None

        return ImageInfo(
            ispe_width=ispe.width,
            ispe_height=ispe.height,
            display_width=disp_w,
            display_height=disp_h,
            rotation=angle,
            luma_bit_depth=hvcc.bit_depth_luma_minus8 + 8,
            chroma_bit_depth=hvcc.bit_depth_chroma_minus8 + 8,
            chroma_format_idc=hvcc.chroma_format_idc,
            grid=grid,
            tile_ids=tile_ids,
            primary_item_id=primary,
            thumbnail_count=len(thumbs),
            icc=icc,
        )

    @staticmethod
    def decode(
        data: bytes,
        backend: str = "torch",
        apply_rotation: bool = True,
        item_id: Optional[int] = None,
        mesh_devices: Optional[int] = None,
        isolate_tile_errors: bool = False,
        stats=None,
        device="cuda",
    ) -> dict:
        """Decode the primary (or given) image item to YCbCr planes.

        Returns {"Y", "Cb", "Cr", "info"} like heif_tpu's decode: uint8
        numpy planes (uint16 above 8 bits; Cb/Cr None for monochrome).
        backend: "torch" (the default: the port's batched reconstruction
          on `device`) or "ref" (the host numpy reference,
          ops.ref_recon, tile by tile; it takes no mesh_devices).
        device: "cuda" (default; raises without a usable CUDA device) or
          "cpu" (the plain PyTorch path). Nothing falls back silently.
        isolate_tile_errors: a corrupt tile yields a mid-gray tile and an
          error record in stats.tile_errors / stats.errors instead of
          aborting the image.
        stats: optional heif_tpu_torch.utils.profiling.DecodeStats; receives
          the host wall times of the spans (hdr, entropy, pack, h2d,
          launch, residual, intra, deblock, sao, d2h, stitch; with a
          mesh: hdr, entropy, sharded, stitch; with backend "ref": hdr,
          entropy, recon, stitch), the h2d_copies and h2d_bytes counters,
          the native entropy pool's entropy_tasks, entropy_busy_s and
          entropy_bins counters,
          scheduler["effective_backend"] and, on CUDA, device times
          (stats.device) from CUDA events. Stats add no synchronize: the
          call queues its device work as it does without them.
        mesh_devices: split the tiles over N devices
          (parallel.pipeline.decode_grid_sharded): the first N CUDA
          devices (RuntimeError if fewer exist), or N CPU shards when
          device is "cpu". Tiles-enabled pictures decode on the mesh too.
        """
        from heif_tpu_torch import native
        from heif_tpu_torch.cabac.syntax import TileSyntaxDecoder
        from heif_tpu_torch.hevc import params
        from heif_tpu_torch.hevc import slice as sl
        from heif_tpu_torch.hevc.rbsp import remove_emulation_prevention
        from heif_tpu_torch.device import resolve_device
        from heif_tpu_torch.ops.batch import reconstruct_tiles, schedule_hints
        from heif_tpu_torch.parallel.pipeline import (
            decode_grid_sharded,
            make_mesh,
        )

        if backend not in ("torch", "ref"):
            raise ValueError(f"unknown backend {backend!r} (torch or ref)")
        if backend == "ref" and mesh_devices:
            raise ValueError("mesh_devices needs backend 'torch': the host "
                             "reference decodes on no mesh")
        device = resolve_device(device)
        mesh = None
        if mesh_devices:
            mesh = (make_mesh(devices=[device] * mesh_devices)
                    if device.type == "cpu" else make_mesh(mesh_devices))

        with span("hdr", stats):
            reader = HeifReader(data)
            heif = reader.read()
            info = HeicDecoder.probe(data)
            target = item_id if item_id is not None else info.primary_item_id
            tgt_info = heif.item_info_by_item_id(target)
            if tgt_info is None:
                raise ValueError(f"item {target} not present in container")

            rec = heif.hevc_configuration_record(target)
            if rec is None:
                raise ValueError("no hvcC record")
            sps = params.parse_sps(
                remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:])
            )
            pps = params.parse_pps(
                remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:])
            )
            length_size = rec.length_size_minus_one + 1

            # crop + rotation come from the TARGET item's own properties
            props = heif.meta.item_properties
            irot_t = props.property_of_type(target, g.ImageRotationProperty)
            angle = irot_t.angle if irot_t else 0
            if tgt_info.item_type == g.ItemType.GRID:
                grid = parse_grid_config(reader.get_item_data(target))
                tile_ids = heif.item_ids_referencing(target, "dimg")
                crop_off = (0, 0)
            else:
                ispe_t = props.property_of_type(
                    target, g.ImageSpatialExtentsProperty
                )
                # the crop origin comes from the SPS conformance window
                # (§7.4.3.2.1); sub-sampling is 2 for 4:2:0, 1 for 4:0:0
                sub = 2 if sps.chroma_format_idc == 1 else 1
                crop_off = (
                    sub * sps.conf_win_left_offset,
                    sub * sps.conf_win_top_offset,
                )
                if ispe_t is not None:
                    out_w, out_h = ispe_t.width, ispe_t.height
                else:
                    out_w = sps.pic_width_in_luma_samples - sub * (
                        sps.conf_win_left_offset + sps.conf_win_right_offset
                    )
                    out_h = sps.pic_height_in_luma_samples - sub * (
                        sps.conf_win_top_offset + sps.conf_win_bottom_offset
                    )
                grid = g.GridConfig(
                    rows=1, columns=1, output_width=out_w, output_height=out_h
                )
                tile_ids = [target]

            slices = []
            bad: dict[int, Exception] = {}
            for ti, tid in enumerate(tile_ids):
                try:
                    nals = sl.split_length_prefixed_nals(
                        reader.get_item_data(tid), length_size
                    )
                    slices.append(
                        sl.parse_slice_header(_select_vcl_nal(nals), sps, pps)
                    )
                except Exception as e:
                    if not isolate_tile_errors:
                        raise
                    bad[ti] = e
                    slices.append(None)
            good = [ps for ps in slices if ps is not None]
            if not good:
                raise ValueError("no decodable tiles")

        hints = schedule_hints(rec, sps, pps, len(tile_ids))
        if stats is not None:
            stats.scheduler = dict(hints)
            stats.scheduler["device"] = str(device)
            stats.scheduler["effective_backend"] = backend
            if mesh is not None:
                stats.scheduler["mesh"] = [str(d) for d in mesh]
                stats.n_devices = len(mesh)

        # tile-clamped SAO (tiles with loop_filter_across_tiles=0 + SAO)
        # exists only in the host reference; fail at once instead of
        # downgrading to a path that cannot decode it either
        if pps.tiles_enabled_flag and not pps.loop_filter_across_tiles_enabled_flag:
            if any(
                s.header.slice_sao_luma_flag or s.header.slice_sao_chroma_flag
                for s in good
            ):
                raise NotImplementedError(
                    "tiles with loop_filter_across_tiles_enabled_flag=0 and "
                    "SAO (tile-clamped SAO) are not supported"
                )

        def entropy(parsed):
            with span("entropy", stats):
                if native.available():
                    return native.decode_tiles_parallel(
                        sps, pps, parsed,
                        max_workers=hints.get("entropy_workers"), stats=stats)
                return [TileSyntaxDecoder(sps, pps, ps).decode()
                        for ps in parsed]

        if isolate_tile_errors:
            syntaxes_good = []
            for ti, ps in enumerate(slices):
                if ps is None:
                    continue
                try:
                    syntaxes_good.extend(entropy([ps]))
                except Exception as e:
                    bad[ti] = e
                    slices[ti] = None
            slices_good = [ps for ps in slices if ps is not None]
        else:
            slices_good = slices
            syntaxes_good = entropy(slices_good)
        if not slices_good:
            raise ValueError("no decodable tiles")

        if backend == "ref":
            from heif_tpu_torch.ops.ref_recon import reconstruct_tile

            with span("recon", stats):
                tiles_good = [reconstruct_tile(st, sps, pps, ps.header)
                              for st, ps in zip(syntaxes_good, slices_good)]
        elif mesh is None:
            tiles_good = reconstruct_tiles(
                syntaxes_good, sps, pps, slices_good, device=device,
                stats=stats,
            )
        else:
            with span("sharded", stats):
                planes3 = decode_grid_sharded(
                    syntaxes_good, sps, pps, slices_good, mesh=mesh
                )
            tiles_good = [[p[i] for p in planes3]
                          for i in range(len(syntaxes_good))]

        with span("stitch", stats):
            if bad:
                th = sps.pic_height_in_luma_samples
                tw = sps.pic_width_in_luma_samples
                bd = max(sps.bit_depth_y, sps.bit_depth_c)
                gdt = np.uint8 if bd <= 8 else np.uint16
                mid = 1 << (bd - 1)
                gray = [
                    np.full((th, tw), mid, gdt),
                    np.full((th >> 1, tw >> 1), mid, gdt),
                    np.full((th >> 1, tw >> 1), mid, gdt),
                ]
                it = iter(tiles_good)
                tiles = [gray if ti in bad else next(it)
                         for ti in range(len(tile_ids))]
            else:
                tiles = tiles_good
            planes = HeicDecoder._stitch(
                tiles, grid, sps, apply_rotation, angle, crop_off=crop_off
            )
        planes["info"] = info
        if stats is not None:
            if bad:
                stats.tile_errors = len(bad)
                stats.errors = {
                    ti: f"{type(e).__name__}: {e}" for ti, e in bad.items()
                }
            stats.tiles = len(tile_ids)
            stats.megapixels = grid.output_width * grid.output_height / 1e6
        return planes

    @staticmethod
    def _entropy_device_gen(sps, pps, ps, device):
        """Entropy through the residual request generator on `device`.

        The host envelope trace supplies the non-residual syntax and one
        marker per TU; the generator (ops.cabac_gen: the CUDA kernel on a
        CUDA device, the plain version on the CPU) decodes every
        residual-coding bin from the raw substream bytes and emits the
        coefficients as events, which replace the host's coefficient
        planes. Raises ValueError if a substream's final context state
        differs from the host decoder's.
        """
        from heif_tpu_torch.ops import cabac_gen as G

        if pps.tiles_enabled_flag:
            raise NotImplementedError(
                "device-gen entropy does not take tile-segmented "
                "substreams yet"
            )
        entries, st = G.envelope_entries(sps, pps, ps)
        results = G.gen_image(entries, device=device)
        # the device's coefficients replace the host's
        st.coeffs = [np.zeros_like(p) for p in st.coeffs]
        for ei, (events_col, p_fin, mps_fin) in enumerate(results):
            _, seg, _, _, spans = entries[ei]
            G.scatter_events(events_col, spans, st.coeffs)
            if not (np.array_equal(p_fin, seg.p_final)
                    and np.array_equal(mps_fin, seg.mps_final)):
                raise ValueError(f"device-gen entropy desync in substream {ei}")
        return st

    @staticmethod
    def decode_hevc(stream: bytes, backend: str = "torch",
                    entropy: str = "auto", device="cuda") -> dict:
        """Decode a raw single-picture HEVC Annex-B intra stream.

        Returns {"Y", "Cb", "Cr", "sps", "pps"}: uint8 numpy planes
        (uint16 above 8 bits; Cb/Cr None for monochrome), as heif_tpu's
        decode_hevc.

        backend: "torch" (the default: the port's batched reconstruction,
          ops.batch.reconstruct_tiles, on `device`) or "ref" (the
          host numpy reference, ops.ref_recon).
        entropy: "auto" (native C++ when available, the Python twin
          otherwise) or "device-gen" (the residual request generator on
          `device`, see _entropy_device_gen).
        device: "cuda" (default; raises without a usable CUDA device) or
          "cpu" (the plain PyTorch path). Nothing falls back silently.
        Tiles with loop_filter_across_tiles_enabled_flag=0 and SAO
        (tile-clamped SAO) raise NotImplementedError at once.
        """
        from heif_tpu_torch import native
        from heif_tpu_torch.cabac.syntax import TileSyntaxDecoder
        from heif_tpu_torch.hevc import params
        from heif_tpu_torch.hevc import slice as sl
        from heif_tpu_torch.hevc.rbsp import remove_emulation_prevention
        from heif_tpu_torch.device import resolve_device

        if backend not in ("torch", "ref"):
            raise ValueError(f"unknown backend {backend!r} (torch or ref)")
        if entropy not in ("auto", "device-gen"):
            raise ValueError(f"unknown entropy {entropy!r} (auto or device-gen)")
        device = resolve_device(device)
        sps = pps = slice_nal = None
        for nal in sl.split_annexb_nals(stream):
            kind = (nal[0] >> 1) & 0x3F
            if kind == 33:
                sps = params.parse_sps(remove_emulation_prevention(nal[2:]))
            elif kind == 34:
                pps = params.parse_pps(remove_emulation_prevention(nal[2:]))
            elif kind <= 31 and slice_nal is None:  # first VCL NAL
                slice_nal = nal
        if sps is None or pps is None or slice_nal is None:
            raise ValueError("stream lacks SPS/PPS/slice NAL")
        ps = sl.parse_slice_header(slice_nal, sps, pps)
        if (pps.tiles_enabled_flag
                and not pps.loop_filter_across_tiles_enabled_flag
                and (ps.header.slice_sao_luma_flag
                     or ps.header.slice_sao_chroma_flag)):
            raise NotImplementedError(
                "tiles with loop_filter_across_tiles_enabled_flag=0 and "
                "SAO (tile-clamped SAO) are not supported"
            )

        if entropy == "device-gen":
            st = HeicDecoder._entropy_device_gen(sps, pps, ps, device)
        elif native.available():
            st = native.decode_tile_native(sps, pps, ps)
        else:
            st = TileSyntaxDecoder(sps, pps, ps).decode()

        if backend == "ref":
            from heif_tpu_torch.ops.ref_recon import reconstruct_tile

            y, cb, cr = reconstruct_tile(st, sps, pps, ps.header)
        else:
            from heif_tpu_torch.ops.batch import reconstruct_tiles

            y, cb, cr = reconstruct_tiles([st], sps, pps, [ps], device=device)[0]
        if sps.chroma_format_idc == 0:
            cb = cr = None  # monochrome: no chroma planes
        return {"Y": y, "Cb": cb, "Cr": cr, "sps": sps, "pps": pps}

    @staticmethod
    def _stitch(tiles, grid, sps, apply_rotation: bool, angle: int,
                crop_off: tuple = (0, 0)) -> dict:
        """Assemble decoded tiles into the output canvas, crop to the grid
        output size, and apply irot (CCW multiples of 90 degrees).

        Canvas dtype follows the decoded tile planes (uint8, or uint16 for
        >8-bit streams — allocating uint8 unconditionally silently
        truncated Main-10 output). Monochrome (4:0:0) streams stitch the
        luma canvas only; Cb/Cr are None.
        """
        tw = sps.pic_width_in_luma_samples
        th = sps.pic_height_in_luma_samples
        mono = sps.chroma_format_idc == 0
        dt = tiles[0][0].dtype
        canvas_w, canvas_h = grid.columns * tw, grid.rows * th
        y = np.zeros((canvas_h, canvas_w), dtype=dt)
        if mono:
            cb = cr = None
        else:
            cb = np.zeros((canvas_h >> 1, canvas_w >> 1), dtype=dt)
            cr = np.zeros((canvas_h >> 1, canvas_w >> 1), dtype=dt)
        for i, t in enumerate(tiles):
            r, c = divmod(i, grid.columns)
            y[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = t[0]
            if not mono:
                cb[r * (th >> 1) : (r + 1) * (th >> 1), c * (tw >> 1) : (c + 1) * (tw >> 1)] = t[1]
                cr[r * (th >> 1) : (r + 1) * (th >> 1), c * (tw >> 1) : (c + 1) * (tw >> 1)] = t[2]
        ox, oy = crop_off
        y = y[oy : oy + grid.output_height, ox : ox + grid.output_width]
        if not mono:
            cb = cb[oy >> 1 : (oy >> 1) + (grid.output_height >> 1),
                    ox >> 1 : (ox >> 1) + (grid.output_width >> 1)]
            cr = cr[oy >> 1 : (oy >> 1) + (grid.output_height >> 1),
                    ox >> 1 : (ox >> 1) + (grid.output_width >> 1)]
        if apply_rotation and angle:
            y = np.rot90(y, k=angle).copy()
            if not mono:
                cb = np.rot90(cb, k=angle).copy()
                cr = np.rot90(cr, k=angle).copy()
        return {"Y": y, "Cb": cb, "Cr": cr}

    @staticmethod
    def to_rgb(planes: dict) -> "np.ndarray":
        """YCbCr (BT.601 full-range) -> uint8 RGB HxWx3 for preview/export.

        >8-bit planes are scaled to 8-bit for export; monochrome images
        (Cb/Cr None) replicate luma across the three channels.
        """
        y = planes["Y"]
        bd_shift = 0
        if y.dtype == np.uint16:
            # infer the source bit depth from the info when present
            info = planes.get("info")
            bd = getattr(info, "luma_bit_depth", 10) if info else 10
            bd_shift = bd - 8
        y = (y.astype(np.float32) / (1 << bd_shift)) if bd_shift else y.astype(
            np.float32
        )
        if planes.get("Cb") is None:
            g8 = np.clip(y, 0, 255).astype(np.uint8)
            return np.stack([g8, g8, g8], axis=-1)
        cb = planes["Cb"].astype(np.float32) / (1 << bd_shift) - 128.0
        cr = planes["Cr"].astype(np.float32) / (1 << bd_shift) - 128.0
        cb = np.repeat(np.repeat(cb, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
        cr = np.repeat(np.repeat(cr, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
        r = y + 1.402 * cr
        gch = y - 0.344136 * cb - 0.714136 * cr
        b = y + 1.772 * cb
        return np.clip(np.stack([r, gch, b], axis=-1), 0, 255).astype(np.uint8)
