"""Synthetic tile batches that reach the paths the flagship image does not.

Built on heif_tpu.utils.synthetic (a consistent sps / pps / slice header
and SyntaxTensors without a bitstream), extended to a random transform
quadtree in z-order (TUs of 4 to 32), random intra modes, PCM blocks,
random SAO parameters and a chosen bit depth. The flagship file is 8-bit
without PCM, and the TPU Pallas intra kernels never took 10-bit or PCM;
these batches hold the port's kernels against its plain walk there.
"""

from __future__ import annotations

import numpy as np

from heif_tpu.cabac import types as T
from heif_tpu.cabac.syntax import chroma_qp_from_luma
from heif_tpu.utils.synthetic import _FakeParsed, synthetic_sps_pps

CTB = 32


def _quadtree(rng, x, y, size, out):
    """Append (x, y, size) leaves of a random split of one block, z-order."""
    if size > 4 and rng.random() < (0.4 if size == 32 else 0.5):
        h = size // 2
        for dy in (0, h):
            for dx in (0, h):
                _quadtree(rng, x + dx, y + dy, h, out)
    else:
        out.append((x, y, size))


def synthetic_tile(width: int, height: int, bd: int, seed: int,
                   pcm: bool) -> T.SyntaxTensors:
    """One width x height 4:2:0 tile (multiples of 32): a random
    quadtree of intra TUs."""
    rng = np.random.default_rng(seed)
    st = T.SyntaxTensors(width=width, height=height, chroma_format_idc=1)
    cdims = (height // 2, width // 2)
    st.coeffs = [np.zeros((height, width), np.int32),
                 np.zeros(cdims, np.int32), np.zeros(cdims, np.int32)]
    st.pcm_planes = [np.zeros((height, width), np.uint16),
                     np.zeros(cdims, np.uint16), np.zeros(cdims, np.uint16)]
    g4 = (height // 4, width // 4)
    st.pcm_map = np.zeros(g4, bool)
    ve = np.zeros(g4, bool)
    he = np.zeros(g4, bool)
    qp = 30 + 6 * (bd - 8)  # QP'Y = QpY + QpBdOffsetY
    qpc = chroma_qp_from_luma(30, 0) + 6 * (bd - 8)
    amp = 40 << (bd - 8)
    leaves = []
    for cy in range(0, height, CTB):
        for cx in range(0, width, CTB):
            _quadtree(rng, cx, cy, CTB, leaves)
    rows = []

    def tu(comp, x, y, log2, mode, q, is_pcm):
        row = [0] * T.TU_FIELDS
        row[T.TU_COMP], row[T.TU_X], row[T.TU_Y] = comp, x, y
        row[T.TU_LOG2], row[T.TU_PRED_MODE], row[T.TU_QP] = log2, mode, q
        row[T.TU_CBF] = 0 if is_pcm else 1
        row[T.TU_PCM] = int(is_pcm)
        s = 1 << log2
        if is_pcm:
            st.pcm_planes[comp][y : y + s, x : x + s] = rng.integers(
                0, 1 << bd, (s, s))
        else:
            st.coeffs[comp][y : y + 2, x : x + 2] = rng.integers(-amp, amp, (2, 2))
        rows.append(row)

    pcm_left = 1 if pcm else 0
    chroma_mode = 1
    for i, (x, y, s) in enumerate(leaves):
        is_pcm = pcm_left > 0 and s == 8 and i > 2
        pcm_left -= int(is_pcm)
        log2 = s.bit_length() - 1
        ve[y // 4 : (y + s) // 4, x // 4] = True
        he[y // 4, x // 4 : (x + s) // 4] = True
        if is_pcm:
            st.pcm_map[y // 4 : (y + s) // 4, x // 4 : (x + s) // 4] = True
        tu(0, x, y, log2, int(rng.integers(0, 35)), qp, is_pcm)
        if s == 4 and (x & 4) == 0 and (y & 4) == 0:
            chroma_mode = int(rng.choice([0, 1, 10, 26, 34, 18]))
        if s >= 8 or (x & 4 and y & 4):
            # chroma follows the luma TU (4x4 luma: after the 4th block)
            cs = max(s // 2, 4)
            cxy = ((x & ~4) // 2, (y & ~4) // 2) if s == 4 else (x // 2, y // 2)
            if s >= 8:
                chroma_mode = int(rng.choice([0, 1, 10, 26, 34, 18]))
            for c in (1, 2):
                tu(c, cxy[0], cxy[1], cs.bit_length() - 1, chroma_mode, qpc,
                   is_pcm)
    st.tu_table = np.asarray(rows, dtype=np.int32)
    st.intra_mode_y = np.ones(g4, np.int8)
    st.intra_mode_c = np.ones(g4, np.int8)
    st.qp_y = rng.integers(20, 45, g4).astype(np.int8)
    st.bypass_map = np.zeros(g4, bool)
    st.vert_edges = ve
    st.horiz_edges = he
    ctbs = (-(-height // CTB), -(-width // CTB), 3)
    st.sao = np.zeros(ctbs + (T.SAO_FIELDS,), np.int16)
    st.sao[..., T.SAO_TYPE] = rng.integers(0, 3, ctbs)
    band = st.sao[..., T.SAO_TYPE] == 1
    st.sao[..., T.SAO_CLASS] = np.where(
        band, rng.integers(0, 32, ctbs), rng.integers(0, 4, ctbs))
    st.sao[..., T.SAO_O0 :] = rng.integers(-7, 8, ctbs + (4,))
    return st


def synthetic_batch(n: int = 2, size: int = 64, bd: int = 10,
                    pcm: bool = True, strong_smoothing: bool = True,
                    seed: int = 0, height: int | None = None):
    """(syntaxes, sps, pps, slices) for n synthetic tiles of one geometry:
    size wide, `height` (default: size) high."""
    height = size if height is None else height
    sps, pps, sh = synthetic_sps_pps(size)
    sps.pic_height_in_luma_samples = height
    sps.bit_depth_luma_minus8 = bd - 8
    sps.bit_depth_chroma_minus8 = bd - 8
    sps.strong_intra_smoothing_enabled_flag = strong_smoothing
    if pcm:
        sps.pcm_enabled_flag = True
        sps.pcm_loop_filter_disabled_flag = True
    syntaxes = [synthetic_tile(size, height, bd, seed + i, pcm)
                for i in range(n)]
    return syntaxes, sps, pps, [_FakeParsed(sh)] * n
