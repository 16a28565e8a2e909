"""SyntaxTensors: the contract between entropy decode (host) and
reconstruction (TPU).

Entropy decoding of one tile/picture produces fixed-layout numpy arrays that
feed the device pipeline. This is the same contract the C++ fast entropy
path emits, and the target output layout for the on-device Pallas CABAC
stage — flat tensors, no pointer structures (SURVEY.md §7 'hard parts #2':
the dynamic quadtree is flattened to a TU worklist + dense planes here).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# TU table column indices
TU_COMP = 0        # 0=Y 1=Cb 2=Cr
TU_X = 1           # position in component samples
TU_Y = 2
TU_LOG2 = 3        # log2 transform size (component samples)
TU_CBF = 4
TU_PRED_MODE = 5   # intra pred mode for this component block (0..34)
TU_QP = 6          # component QP' (includes bit-depth offset; drives dequant)
TU_SKIP = 7        # transform_skip_flag
TU_BYPASS = 8      # cu_transquant_bypass_flag
TU_SCAN = 9        # scanIdx used for coefficient scan (0 diag, 1 horiz, 2 vert)
TU_PCM = 10        # block is PCM (no transform; samples in pcm planes)
TU_FIELDS = 11

# SAO table layout: per CTB per component [type, class_or_band, o0, o1, o2, o3]
SAO_TYPE = 0       # 0=off 1=band 2=edge
SAO_CLASS = 1      # eo class (0..3) or band position (0..31)
SAO_O0 = 2
SAO_FIELDS = 6


@dataclass
class SyntaxTensors:
    """Entropy-decode output for one picture (one HEIF tile)."""

    width: int
    height: int
    chroma_format_idc: int

    # Quantized coefficient planes, one per component, coefficients placed
    # at their TU's spatial block position (component coordinates).
    coeffs: list[np.ndarray] = field(default_factory=list)  # int32 [h, w]

    # Leaf transform blocks in decode (z) order; columns per TU_* above.
    tu_table: np.ndarray = None  # int32 [n_tu, TU_FIELDS]

    # Per-4x4-block (luma grid) maps:
    intra_mode_y: np.ndarray = None   # int8 [h/4, w/4] luma pred mode
    intra_mode_c: np.ndarray = None   # int8 [h/4, w/4] chroma pred mode
    qp_y: np.ndarray = None           # int8 [h/4, w/4] luma QP per CU
    bypass_map: np.ndarray = None     # bool [h/4, w/4] transquant bypass
    pcm_map: np.ndarray = None        # bool [h/4, w/4]

    # Deblocking edge flags on the 4x4 luma grid: True where a TU or PU
    # boundary starts at this block's left (vert) / top (horiz) edge.
    vert_edges: np.ndarray = None     # bool [h/4, w/4]
    horiz_edges: np.ndarray = None    # bool [h/4, w/4]

    # SAO parameters per CTB per component: int16 [ctbs_y, ctbs_x, 3, SAO_FIELDS]
    sao: np.ndarray = None

    # PCM sample planes (only where pcm_map set): uint16 per component
    pcm_planes: list[np.ndarray] = field(default_factory=list)

    # Diagnostics
    n_bins: int = 0  # total CABAC bins decoded (perf accounting)

    # Optional native pre-pack (see native.pack_tile_native): device-ready
    # per-class coefficient blocks + scan-field arrays, produced GIL-free
    # inside the entropy worker threads. ops.batch.pack_batch consumes it
    # when present and falls back to the numpy pack otherwise.
    packed: object = None

    def tu_count(self) -> int:
        return 0 if self.tu_table is None else self.tu_table.shape[0]


@dataclass
class PackedTile:
    """Native per-tile pack output (see native.pack_tile_native)."""

    cls_counts: np.ndarray  # [10] int32, per ops.batch.CLASSES order
    cls: list               # [(coeffs int16 [k,s,s], meta int32 [4,k])] * 10
    scans: list             # per comp int32 [6, m]: x,y,size,mode,filter,pcm
    pad: int
