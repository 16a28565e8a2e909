"""RBSP bit reading: emulation prevention, MSB-first bits, Exp-Golomb.

Host-side canonical implementation (parity target: reference
src/hevc/rbsp_reader.rs:1-137). The C++ native module mirrors this for the
production path; a numpy-vectorized de-emulation pass is provided for bulk
tile preprocessing feeding device buffers.
"""

from __future__ import annotations

import numpy as np


def remove_emulation_prevention(data: bytes) -> bytes:
    """Strip 00 00 03 emulation-prevention bytes from a NAL payload.

    An 0x03 is removed only when preceded by exactly 00 00 and followed by a
    byte <= 0x03 (H.265 §7.4.2; reference src/hevc/rbsp_reader.rs:11-39
    including the overlapping-pattern handling).
    """
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 0x03 and (i + 1 == n or data[i + 1] <= 0x03):
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def remove_emulation_prevention_np(
    data: np.ndarray, return_mask: bool = False
):
    """Vectorized de-emulation over a uint8 array (bulk tile preprocessing).

    Identical semantics to remove_emulation_prevention. Candidate 0x03 bytes
    are located with vectorized compares; the rare sequential dependency
    (overlapping 00 00 03 00 00 03 runs) is resolved in a short scalar pass
    over candidates only, so cost is O(n) vector + O(#candidates) scalar.

    With return_mask=True, returns (rbsp, kept_mask) where kept_mask[i] is
    True iff data[i] survived (used for exact entry-point coordinate
    conversion without replaying the walk).
    """
    n = data.shape[0]
    if n < 3:
        out = data.copy()
        return (out, np.ones(n, dtype=bool)) if return_mask else out
    is3 = data == 3
    z = data == 0
    cand = np.zeros(n, dtype=bool)
    cand[2:] = is3[2:] & z[1:-1] & z[:-2]
    nxt_ok = np.ones(n, dtype=bool)
    nxt_ok[:-1] = data[1:] <= 3
    cand &= nxt_ok
    idx = np.nonzero(cand)[0]
    if idx.size == 0:
        out = data.copy()
        return (out, np.ones(n, dtype=bool)) if return_mask else out
    # Sequential fix-up: a removed 0x03 breaks the zero-run for later
    # candidates (e.g. 00 00 03 03: only the first 03 is removed).
    keep_removed = []
    last_removed = -10
    for i in idx:
        if i - 1 == last_removed or i - 2 == last_removed:
            # preceding run includes a removed byte: recheck real zero count
            j = i - 1
            zeros = 0
            removed_set = set(keep_removed)
            while j >= 0 and zeros < 2:
                if j in removed_set:
                    j -= 1
                    continue
                if data[j] == 0:
                    zeros += 1
                    j -= 1
                else:
                    break
            if zeros < 2:
                continue
        keep_removed.append(int(i))
        last_removed = int(i)
    mask = np.ones(n, dtype=bool)
    mask[np.asarray(keep_removed, dtype=np.int64)] = False
    out = data[mask]
    return (out, mask) if return_mask else out


def insert_emulation_prevention(rbsp: bytes) -> bytes:
    """Inverse of removal: insert 0x03 after any 00 00 followed by <= 0x03."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 0x03:
            out.append(0x03)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class BitReader:
    """MSB-first bit reader with Exp-Golomb (reference
    src/hevc/rbsp_reader.rs:73-136)."""

    __slots__ = ("data", "bit_pos")

    def __init__(self, data: bytes):
        self.data = data
        self.bit_pos = 0

    # -- position --

    @property
    def byte_pos(self) -> int:
        return self.bit_pos >> 3

    def bits_remaining(self) -> int:
        return len(self.data) * 8 - self.bit_pos

    def is_byte_aligned(self) -> bool:
        return (self.bit_pos & 7) == 0

    # -- primitive reads --

    def read_bit(self) -> int:
        p = self.bit_pos
        if p >= len(self.data) * 8:
            raise EOFError("bit reader exhausted")
        self.bit_pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def read_flag(self) -> bool:
        return self.read_bit() == 1

    # -- Exp-Golomb (H.265 §9.2, Tables 9-2/9-3) --

    def read_ue(self) -> int:
        leading_zeros = 0
        while self.read_bit() == 0:
            leading_zeros += 1
            if leading_zeros > 31:
                raise ValueError("ue(v) prefix too long (corrupt stream)")
        if leading_zeros == 0:
            return 0
        return (1 << leading_zeros) - 1 + self.read_bits(leading_zeros)

    def read_se(self) -> int:
        k = self.read_ue()
        # 0,1,2,3,4… → 0,1,-1,2,-2,…
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    # -- alignment --

    def byte_alignment(self) -> None:
        """Consume alignment_bit_equal_to_one + zeros to the byte boundary
        (reference src/hevc/rbsp_reader.rs:53-63 asserts the same pattern)."""
        one = self.read_bit()
        if one != 1:
            raise ValueError("byte_alignment: expected leading 1 bit")
        while not self.is_byte_aligned():
            if self.read_bit() != 0:
                raise ValueError("byte_alignment: expected 0 padding bit")

    def more_rbsp_data(self) -> bool:
        """True if there is payload before rbsp_stop_one_bit (H.265 §7.2)."""
        rem = self.bits_remaining()
        if rem <= 0:
            return False
        # find last set bit in the stream (the stop bit)
        for byte_idx in range(len(self.data) - 1, -1, -1):
            b = self.data[byte_idx]
            if b:
                low = 0
                while not (b >> low) & 1:
                    low += 1
                stop_pos = byte_idx * 8 + (7 - low)
                return self.bit_pos < stop_pos
        return False
