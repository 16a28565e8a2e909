"""The stream-defined kernel bytes (portbench.metrics.kernel_bytes) against
counts made by hand."""

from __future__ import annotations

from portbench.metrics.kernel_bytes import tile_bytes
from portbench.reference import image as ref_image
from portbench.tests.conftest import FLAGSHIP, TORCH_ASSETS
from portbench.reference.hevc import params
from portbench.reference.hevc import slice as sl
from portbench.reference.hevc.rbsp import remove_emulation_prevention
from portbench.reference.cabac.syntax import TileSyntaxDecoder


def annexb_syntax(stream: bytes):
    sps = pps = vcl = None
    for nal in sl.split_annexb_nals(stream):
        kind = (nal[0] >> 1) & 0x3F
        if kind == 33:
            sps = params.parse_sps(remove_emulation_prevention(nal[2:]))
        elif kind == 34:
            pps = params.parse_pps(remove_emulation_prevention(nal[2:]))
        elif kind <= 31 and vcl is None:
            vcl = nal
    ps = sl.parse_slice_header(vcl, sps, pps)
    return sps, ps, TileSyntaxDecoder(sps, pps, ps).decode()


def test_edge72_by_hand():
    """edge72.hevc: 72x72 8-bit 4:2:0, CTB 64 (2x2 CTBs), deblocking on,
    band SAO in all 4 CTBs of all 3 components. Its 123 TUs, all coded,
    none PCM: luma 68 of 4x4, 4 of 16x16, 3 of 32x32 (5,184 samples);
    each chroma plane 17 of 4x4, 4 of 8x8, 3 of 16x16 (1,296)."""
    sps, ps, st = annexb_syntax((TORCH_ASSETS / "edge72.hevc").read_bytes())
    samples = 72 * 72 + 2 * 36 * 36  # 7,776 at 1 B
    residual = 4 * samples  # every TU coded: 2 B in, 2 B out a sample
    # availability bits (4N + 1) a TU, rounded up to bytes: luma 68*3 +
    # 4*9 + 3*17, chroma (one table for Cb and Cr) 17*3 + 4*5 + 3*9
    avail = 68 * 3 + 4 * 9 + 3 * 17 + 17 * 3 + 4 * 5 + 3 * 9  # 389
    tables = 75 + 24  # luma TUs and chroma TU pairs
    want = {
        "residual_kernel": residual,  # 31,104
        "ref_sources_kernel": 4 * tables + avail,  # 785
        "intra_walk": 4 * 123 + residual // 2 + avail + samples,  # 24,209
        # bS on 9x18 vertical and 18x9 horizontal segments, QpY on 9x9
        "deblock_kernel": 2 * samples + 9 * 18 + 18 * 9 + 9 * 9,  # 15,957
        "sao_kernel": 6 * 4 * 3 + 2 * samples,  # 15,624
    }
    assert tile_bytes(st, sps, ps.header) == want


def test_flagship_tile_by_hand():
    """Tile 22 of the flagship (512x512 8-bit, CTB 32: 16x16 CTBs),
    counted TU by TU and CTB by CTB."""
    pic = ref_image.parse(FLAGSHIP.read_bytes())
    sps, pps, ps, st = ref_image.tile_syntax(pic.sps_nal, pic.pps_nal,
                                             pic.tiles[22], pic.length_size)
    samples = 512 * 512 + 2 * 256 * 256
    residual = avail = tables = 0
    for comp, x, y, log2, cbf, *_rest, pcm in st.tu_table.tolist():
        n = 1 << log2
        assert not pcm
        if cbf:
            residual += 4 * n * n
        if comp <= 1:
            tables += 1
            avail += (4 * n + 1 + 7) // 8
    sao = 0
    flags = (ps.header.slice_sao_luma_flag, ps.header.slice_sao_chroma_flag,
             ps.header.slice_sao_chroma_flag)
    for c in range(3):
        if not flags[c]:
            continue
        side = 32 if c == 0 else 16
        for row in st.sao[:, :, c, 0].tolist():
            for kind in row:
                sao += 6 + (2 * side * side if kind else 0)
    want = {
        "residual_kernel": residual,
        "ref_sources_kernel": 4 * tables + avail,
        "intra_walk": 4 * len(st.tu_table) + residual // 2 + avail + samples,
        "deblock_kernel": 2 * samples + 64 * 128 + 128 * 64 + 64 * 64,
        "sao_kernel": sao,
    }
    assert not ps.header.slice_deblocking_filter_disabled_flag
    assert tile_bytes(st, sps, ps.header) == want
