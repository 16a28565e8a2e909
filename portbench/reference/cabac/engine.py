"""CABAC arithmetic decoding engine (H.265 §9.3.4.3) with dense context state.

Canonical host implementation (parity target: reference
src/cabac/arithmetic.rs:1-255). Differences by design:

- Context storage is a dense ``int8[N_CTX]`` p-state array plus an MPS
  bitmask-style array, not a HashMap — the flat (element → slot) layout is
  shared with the C++ fast path and the Pallas CABAC state machine, which
  treat context state as a vector.
- Snapshots (for WPP context inheritance, §9.3.1) are O(1) array copies.

Tables 9-45/9-46 are H.265 spec constants.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Spec constants
# --------------------------------------------------------------------------

# Table 9-45: state transition
TRANS_IDX_MPS = bytes(
    [
        1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
        17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
        33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48,
        49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 62, 63,
    ]
)

TRANS_IDX_LPS = bytes(
    [
        0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
        13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
        24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
        33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
    ]
)

# Table 9-46: rangeTabLps[pStateIdx][qRangeIdx], flattened row-major
RANGE_TAB_LPS = bytes(
    [
        128, 176, 208, 240, 128, 167, 197, 227, 128, 158, 187, 216,
        123, 150, 178, 205, 116, 142, 169, 195, 111, 135, 160, 185,
        105, 128, 152, 175, 100, 122, 144, 166, 95, 116, 137, 158,
        90, 110, 130, 150, 85, 104, 123, 142, 81, 99, 117, 135,
        77, 94, 111, 128, 73, 89, 105, 122, 69, 85, 100, 116,
        66, 80, 95, 110, 62, 76, 90, 104, 59, 72, 86, 99,
        56, 69, 81, 94, 53, 65, 77, 89, 51, 62, 73, 85,
        48, 59, 69, 80, 46, 56, 66, 76, 43, 53, 63, 72,
        41, 50, 59, 69, 39, 48, 56, 65, 37, 45, 54, 62,
        35, 43, 51, 59, 33, 41, 48, 56, 32, 39, 46, 53,
        30, 37, 43, 50, 29, 35, 41, 48, 27, 33, 39, 45,
        26, 31, 37, 43, 24, 30, 35, 41, 23, 28, 33, 39,
        22, 27, 32, 37, 21, 26, 30, 35, 20, 24, 29, 33,
        19, 23, 27, 31, 18, 22, 26, 30, 17, 21, 25, 28,
        16, 20, 23, 27, 15, 19, 22, 25, 14, 18, 21, 24,
        14, 17, 20, 23, 13, 16, 19, 22, 12, 15, 18, 21,
        12, 14, 17, 20, 11, 14, 16, 19, 11, 13, 15, 18,
        10, 12, 15, 17, 10, 12, 14, 16, 9, 11, 13, 15,
        9, 11, 12, 14, 8, 10, 12, 14, 8, 9, 11, 13,
        7, 9, 11, 12, 7, 9, 10, 12, 7, 8, 10, 11,
        6, 8, 9, 11, 6, 7, 9, 10, 6, 7, 8, 9,
        2, 2, 2, 2,
    ]
)


# --------------------------------------------------------------------------
# Context catalog: dense slot layout for I-slice syntax elements.
#
# Init values are the initType-0 columns of Tables 9-5..9-31 (spec
# constants; cross-checked against reference src/cabac/syntax_element.rs).
# --------------------------------------------------------------------------

_ELEMENTS: list[tuple[str, list[int]]] = [
    ("sao_merge", [153]),                   # Table 9-5  (left+up share ctx)
    ("sao_type", [200]),                    # Table 9-6  (luma+chroma share)
    ("split_cu", [139, 141, 157]),          # Table 9-7
    ("cu_transquant_bypass", [154]),        # Table 9-8
    ("part_mode", [184]),                   # Table 9-11 (I: 1 ctx)
    ("prev_intra", [184]),                  # Table 9-12
    ("chroma_mode", [63]),                  # Table 9-13
    ("split_transform", [153, 138, 138]),   # Table 9-20
    ("cbf_luma", [111, 141]),               # Table 9-21
    ("cbf_chroma", [94, 138, 182, 154]),    # Table 9-22 (ctx = trafoDepth)
    ("cu_qp_delta", [154, 154]),            # Table 9-24
    ("transform_skip_luma", [139]),         # Table 9-25
    ("transform_skip_chroma", [139]),       # Table 9-25
    (
        "last_x",                           # Table 9-26
        [110, 110, 124, 125, 140, 153, 125, 127, 140,
         109, 111, 143, 127, 111, 79, 108, 123, 63],
    ),
    (
        "last_y",                           # Table 9-27
        [110, 110, 124, 125, 140, 153, 125, 127, 140,
         109, 111, 143, 127, 111, 79, 108, 123, 63],
    ),
    ("csbf", [91, 171, 134, 141]),          # Table 9-28
    (
        "sig",                              # Table 9-29 (42 v1 + 2 TS ctx)
        [111, 111, 125, 110, 110, 94, 124, 108, 124,
         107, 125, 141, 179, 153, 125,
         107, 125, 141, 179, 153, 125,
         107, 125, 141, 179, 153, 125,
         140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139,
         111, 136, 139, 111,
         111, 111],
    ),
    (
        "g1",                               # Table 9-30
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92,
         139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
    ),
    ("g2", [138, 153, 136, 167, 152, 152]),  # Table 9-31
]

CTX_OFFSET: dict[str, int] = {}
_INIT_VALUES: list[int] = []
for _name, _vals in _ELEMENTS:
    CTX_OFFSET[_name] = len(_INIT_VALUES)
    _INIT_VALUES.extend(_vals)
N_CTX = len(_INIT_VALUES)
INIT_VALUES = np.asarray(_INIT_VALUES, dtype=np.int32)


def init_context_state(slice_qp_y: int) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized context init (§9.3.2.2; reference
    src/cabac/arithmetic.rs:51-78 does the same math scalar-wise).

    Returns (p_state[N_CTX] uint8, val_mps[N_CTX] uint8).
    """
    qp = int(np.clip(slice_qp_y, 0, 51))
    m = (INIT_VALUES >> 4) * 5 - 45
    n = ((INIT_VALUES & 15) << 3) - 16
    pre = np.clip(((m * qp) >> 4) + n, 1, 126)
    val_mps = (pre > 63).astype(np.uint8)
    p_state = np.where(val_mps, pre - 64, 63 - pre).astype(np.uint8)
    return p_state, val_mps


class CabacEngine:
    """Arithmetic decoder over one substream of a de-emulated slice RBSP.

    Bits are pulled from `data` starting at `bit_pos`. State: 9-bit
    ivl_curr_range / ivl_offset (§9.3.4.3.1).
    """

    __slots__ = (
        "data",
        "bit_pos",
        "bit_end",
        "ivl_curr_range",
        "ivl_offset",
        "p_state",
        "val_mps",
    )

    def __init__(self, data: bytes, byte_start: int, byte_end: int):
        self.data = data
        self.bit_pos = byte_start * 8
        self.bit_end = byte_end * 8
        self.ivl_curr_range = 0
        self.ivl_offset = 0
        self.p_state = np.zeros(N_CTX, dtype=np.uint8)
        self.val_mps = np.zeros(N_CTX, dtype=np.uint8)

    # -- bit input ---------------------------------------------------------

    def _read_bit(self) -> int:
        p = self.bit_pos
        if p >= self.bit_end:
            # §9.3.4.3.2 note: reading past the substream yields 0s; a
            # conforming stream never depends on more than alignment bits.
            self.bit_pos = p + 1
            return 0
        self.bit_pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    # -- engine init -------------------------------------------------------

    def start(self) -> None:
        """§9.3.4.3.1: ivlCurrRange=510; ivlOffset = next 9 bits."""
        self.ivl_curr_range = 510
        off = 0
        for _ in range(9):
            off = (off << 1) | self._read_bit()
        if off >= 510:
            raise ValueError("invalid ivlOffset (510/511) — corrupt stream")
        self.ivl_offset = off

    def init_contexts(self, slice_qp_y: int) -> None:
        self.p_state, self.val_mps = init_context_state(slice_qp_y)

    def snapshot_contexts(self) -> tuple[np.ndarray, np.ndarray]:
        """WPP storage process (§9.3.1): copy context variables."""
        return self.p_state.copy(), self.val_mps.copy()

    def restore_contexts(self, snap: tuple[np.ndarray, np.ndarray]) -> None:
        self.p_state = snap[0].copy()
        self.val_mps = snap[1].copy()

    # -- bin decoding ------------------------------------------------------

    def decode_bin(self, ctx: int) -> int:
        """decode_decision (§9.3.4.3.2)."""
        rng = self.ivl_curr_range
        p = self.p_state[ctx]
        lps = RANGE_TAB_LPS[(p << 2) | ((rng >> 6) & 3)]
        rng -= lps
        off = self.ivl_offset
        if off >= rng:
            # LPS path
            bin_val = 1 - self.val_mps[ctx]
            off -= rng
            rng = lps
            if p == 0:
                self.val_mps[ctx] ^= 1
            self.p_state[ctx] = TRANS_IDX_LPS[p]
        else:
            bin_val = int(self.val_mps[ctx])
            self.p_state[ctx] = TRANS_IDX_MPS[p]
        # renormalization (§9.3.4.3.3)
        while rng < 256:
            rng <<= 1
            off = (off << 1) | self._read_bit()
        self.ivl_curr_range = rng
        self.ivl_offset = off
        return int(bin_val)

    def decode_bypass(self) -> int:
        """§9.3.4.3.4."""
        off = (self.ivl_offset << 1) | self._read_bit()
        rng = self.ivl_curr_range
        if off >= rng:
            self.ivl_offset = off - rng
            return 1
        self.ivl_offset = off
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        """§9.3.4.3.5 (end_of_slice_segment_flag, end_of_subset_one_bit,
        pcm_flag)."""
        rng = self.ivl_curr_range - 2
        if self.ivl_offset >= rng:
            self.ivl_curr_range = rng
            return 1
        # renorm
        off = self.ivl_offset
        while rng < 256:
            rng <<= 1
            off = (off << 1) | self._read_bit()
        self.ivl_curr_range = rng
        self.ivl_offset = off
        return 0

    # -- binarization helpers (§9.3.3; reference src/cabac/decoder.rs) -----

    def decode_tr_ctx(self, cmax: int, ctx_base: int, ctx_map) -> int:
        """Truncated-Rice prefix (cRiceParam=0 → truncated unary) with
        per-bin context selection via ctx_map(bin_idx) → ctx offset."""
        for k in range(cmax):
            if self.decode_bin(ctx_base + ctx_map(k)) == 0:
                return k
        return cmax

    def decode_tr_bypass(self, cmax: int) -> int:
        for k in range(cmax):
            if self.decode_bypass() == 0:
                return k
        return cmax

    def decode_egk_bypass(self, k: int) -> int:
        """k-th order Exp-Golomb, bypass bins (§9.3.3.3)."""
        prefix = 0
        while self.decode_bypass() == 1:
            prefix += 1
            if prefix > 31:
                raise ValueError("EGk prefix too long (corrupt stream)")
        value = 0
        n = prefix + k
        if n:
            value = self.decode_bypass_bits(n)
        return ((1 << prefix) - 1 << k) + value

    # -- alignment (between WPP substreams) --------------------------------

    def align_to_byte(self) -> None:
        self.bit_pos = (self.bit_pos + 7) & ~7
