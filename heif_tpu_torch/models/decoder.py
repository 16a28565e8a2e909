"""HeicDecoder — container -> host entropy -> batched reconstruction on
one PyTorch device.

Port of heif_tpu/models/decoder.py (HeicDecoder.decode). The container,
header and entropy layers and the output assembly (probe, _stitch,
_select_vcl_nal) are heif_tpu's own, imported unchanged; reconstruction
runs in heif_tpu_torch.ops.batch, all tiles in one batch.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from heif_tpu.container import grammar as g
from heif_tpu.container.reader import HeifReader, parse_grid_config
from heif_tpu.models.decoder import HeicDecoder as _Ref
from heif_tpu.models.decoder import _select_vcl_nal


class HeicDecoder:
    """End-to-end HEIC decode with reconstruction on a torch device."""

    probe = staticmethod(_Ref.probe)
    _stitch = staticmethod(_Ref._stitch)

    @staticmethod
    def decode(
        data: bytes,
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
        device: "cuda" (default; raises without a usable CUDA device) or
          "cpu" (the plain PyTorch path). Nothing falls back silently.
        isolate_tile_errors: a corrupt tile yields a mid-gray tile and an
          error record in stats.tile_errors / stats.errors instead of
          aborting the image.
        stats: optional heif_tpu.utils.profiling.DecodeStats; receives
          stage wall times (entropy, pack, h2d, residual, intra, deblock,
          sao, d2h, stitch). With stats on CUDA each device stage ends in
          a synchronize so its time is its own.
        mesh_devices: not ported yet (raises NotImplementedError).
        """
        from heif_tpu import native
        from heif_tpu.cabac.syntax import TileSyntaxDecoder
        from heif_tpu.hevc import params
        from heif_tpu.hevc import slice as sl
        from heif_tpu.hevc.rbsp import remove_emulation_prevention
        from heif_tpu_torch.device import resolve_device
        from heif_tpu_torch.ops.batch import reconstruct_tiles, schedule_hints

        if mesh_devices:
            raise NotImplementedError(
                "mesh_devices: multi-device decode is not ported to "
                "heif_tpu_torch yet"
            )
        device = resolve_device(device)

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
            t0 = time.perf_counter()
            if native.available():
                out = native.decode_tiles_parallel(
                    sps, pps, parsed, max_workers=hints.get("entropy_workers")
                )
            else:
                out = [TileSyntaxDecoder(sps, pps, ps).decode() for ps in parsed]
            if stats is not None:
                stats.stages["entropy"] = stats.stages.get("entropy", 0.0) + (
                    time.perf_counter() - t0
                )
            return out

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

        tiles_good = reconstruct_tiles(
            syntaxes_good, sps, pps, slices_good, device=device, stats=stats
        )

        t0 = time.perf_counter()
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
            tiles = [gray if ti in bad else next(it) for ti in range(len(tile_ids))]
            if stats is not None:
                stats.tile_errors = len(bad)
                stats.errors = {
                    ti: f"{type(e).__name__}: {e}" for ti, e in bad.items()
                }
        else:
            tiles = tiles_good
        if stats is not None:
            stats.tiles = len(tile_ids)

        planes = HeicDecoder._stitch(
            tiles, grid, sps, apply_rotation, angle, crop_off=crop_off
        )
        planes["info"] = info
        if stats is not None:
            stats.stages["stitch"] = stats.stages.get("stitch", 0.0) + (
                time.perf_counter() - t0
            )
            stats.megapixels = grid.output_width * grid.output_height / 1e6
        return planes
