"""The bytes that the stream defines for each of the port's five core
kernels, counted from the reference's own syntax decode of a tile, so
that the count reads the same whatever layout implements the work.

A sample counts at the stream's storage size: 1 B up to 8 bits, 2 B
above. A coefficient level or a residual sample counts 2 B (the spec's
16-bit TransCoeffLevel; a residual needs bit depth + 1 bits). Each input
counts as read once and each output as written once; a kernel's re-reads
of what it wrote itself (the intra walk's neighbours) count nothing.

- residual_kernel: per coded TU (cbf set, not PCM) of side N, its N*N
  levels read and its N*N residual samples written.
- ref_sources_kernel: per luma TU and per chroma TU pair (Cb and Cr share
  their geometry and mode), not PCM: 4 B of geometry read, and one
  availability bit per reference sample (4N + 1) written.
- intra_walk (luma and chroma): per TU 4 B of geometry and mode, the coded
  TUs' residuals, the availability bits and the PCM samples read; every
  sample of the picture written.
- deblock_kernel (where the slice turns it on): every sample read and
  written, plus 1 B of boundary strength per 4-sample edge segment on the
  8x8 grid (vertical and horizontal) and 1 B of QpY per 8x8 luma block.
- sao_kernel (per component the slice turns it on): 6 B of parameters a
  CTB, and the samples of each CTB whose SAO type is not 0, read and
  written.
"""

from __future__ import annotations

import numpy as np

KERNELS = ("residual_kernel", "ref_sources_kernel", "intra_walk",
           "deblock_kernel", "sao_kernel")
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA data sheet, 700 W)

# tu_table columns (reference/cabac/types.py)
_COMP, _LOG2, _CBF, _PCM = 0, 3, 4, 10
_SAO_TYPE = 0


def _avail_bytes(n: np.ndarray) -> np.ndarray:
    return (4 * n + 1 + 7) // 8


def tile_bytes(st, sps, header) -> dict:
    """{kernel: bytes} of one tile from its SyntaxTensors `st`, its SPS
    and its slice header."""
    W, H = st.width, st.height
    sy = 1 if sps.bit_depth_y <= 8 else 2
    sc = 1 if sps.bit_depth_c <= 8 else 2
    chroma = st.chroma_format_idc != 0
    if chroma and st.chroma_format_idc != 1:
        raise NotImplementedError("only 4:2:0 and 4:0:0 are counted")
    Wc, Hc = (W // 2, H // 2) if chroma else (0, 0)
    samples = W * H * sy + 2 * Wc * Hc * sc

    tu = st.tu_table.astype(np.int64)
    comp, n = tu[:, _COMP], np.left_shift(1, tu[:, _LOG2])
    pcm = tu[:, _PCM] != 0
    coded = (tu[:, _CBF] != 0) & ~pcm
    tables = (comp <= 1) & ~pcm
    per_s = np.where(comp == 0, sy, sc)

    residual_io = int((4 * n[coded] ** 2).sum())
    avail = int(_avail_bytes(n[tables]).sum())
    out = {
        "residual_kernel": residual_io,
        "ref_sources_kernel": 4 * int(tables.sum()) + avail,
        "intra_walk": (4 * len(tu) + residual_io // 2 + avail
                       + int((n[pcm] ** 2 * per_s[pcm]).sum()) + samples),
        "deblock_kernel": 0,
        "sao_kernel": 0,
    }
    if not header.slice_deblocking_filter_disabled_flag:
        side = (-(-W // 8) * -(-H // 4) + -(-W // 4) * -(-H // 8)
                + -(-W // 8) * -(-H // 8))
        out["deblock_kernel"] = 2 * samples + side

    ctb = 1 << sps.ctb_log2_size_y
    comps = ([0] if header.slice_sao_luma_flag else []) + (
        [1, 2] if chroma and header.slice_sao_chroma_flag else [])
    rows, cols = st.sao.shape[:2]
    for c in comps:
        size, s = (ctb, sy) if c == 0 else (ctb // 2, sc)
        pw, ph = (W, H) if c == 0 else (Wc, Hc)
        on = st.sao[:, :, c, _SAO_TYPE] != 0
        hs = np.minimum(size, ph - np.arange(rows) * size)
        ws = np.minimum(size, pw - np.arange(cols) * size)
        area = int((np.outer(hs, ws) * on).sum())
        out["sao_kernel"] += 6 * rows * cols + 2 * area * s
    return out
