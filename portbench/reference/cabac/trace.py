"""Bin-trace recording for the CABAC engine.

A trace is the golden contract between the host entropy oracle and the
Pallas device CABAC state machine (SURVEY.md §7 step 3: "a bin-trace dump
format ... that becomes the golden for the kernel"). Each SEGMENT is one
independent arithmetic-decoder run — a slice start or a WPP substream —
carrying its byte window, its initial context state (spec-init or WPP
snapshot-inherited), and the per-bin request tape (kind, ctx slot) plus
the decoded bin values.

Replay semantics: feeding (bytes, ctx0, tape) to any conforming engine
must reproduce `bins` exactly and end in `ctx_final`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.reference.cabac.engine import CabacEngine, N_CTX

KIND_CTX = 0
KIND_BYPASS = 1
KIND_TERMINATE = 2
KIND_PAD = 3


@dataclass
class TraceSegment:
    byte_start: int
    byte_end: int
    p0: np.ndarray = None  # uint8 [N_CTX] at segment start
    mps0: np.ndarray = None
    kinds: list = field(default_factory=list)
    slots: list = field(default_factory=list)
    bins: list = field(default_factory=list)
    # absolute bit position (within rbsp) AFTER each bin — lets the
    # windowed device engine rebase its bit reader per bin-block
    positions: list = field(default_factory=list)
    p_final: np.ndarray = None
    mps_final: np.ndarray = None

    def finalize(self, engine: CabacEngine) -> None:
        self.p_final = engine.p_state.copy()
        self.mps_final = engine.val_mps.copy()
        self.kinds = np.asarray(self.kinds, dtype=np.uint8)
        self.slots = np.asarray(self.slots, dtype=np.uint8)
        self.bins = np.asarray(self.bins, dtype=np.uint8)
        self.positions = np.asarray(self.positions, dtype=np.int64)

    @property
    def n_bins(self) -> int:
        return len(self.kinds)


class TracingCabacEngine(CabacEngine):
    """Drop-in CabacEngine that records a TraceSegment per start()."""

    def __init__(self, data, byte_start, byte_end):
        super().__init__(data, byte_start, byte_end)
        self.segments: list[TraceSegment] = []

    def _seg(self) -> TraceSegment:
        return self.segments[-1]

    def start(self) -> None:
        if self.segments:
            self._seg().finalize(self)
        self.segments.append(
            TraceSegment(byte_start=self.bit_pos >> 3, byte_end=self.bit_end >> 3)
        )
        super().start()
        # context state at this point is whatever start inherits; it gets
        # overwritten below if init/restore follows (syntax layer calls
        # start() first, then init_contexts/restore_contexts)
        self._seg().p0 = self.p_state.copy()
        self._seg().mps0 = self.val_mps.copy()

    def init_contexts(self, slice_qp_y: int) -> None:
        super().init_contexts(slice_qp_y)
        if self.segments and not len(self._seg().kinds):
            self._seg().p0 = self.p_state.copy()
            self._seg().mps0 = self.val_mps.copy()

    def restore_contexts(self, snap) -> None:
        super().restore_contexts(snap)
        if self.segments and not len(self._seg().kinds):
            self._seg().p0 = self.p_state.copy()
            self._seg().mps0 = self.val_mps.copy()

    def decode_bin(self, ctx: int) -> int:
        b = super().decode_bin(ctx)
        s = self._seg()
        s.kinds.append(KIND_CTX)
        s.slots.append(ctx)
        s.bins.append(b)
        s.positions.append(self.bit_pos)
        return b

    def decode_bypass(self) -> int:
        b = super().decode_bypass()
        s = self._seg()
        s.kinds.append(KIND_BYPASS)
        s.slots.append(0)
        s.bins.append(b)
        s.positions.append(self.bit_pos)
        return b

    def decode_terminate(self) -> int:
        b = super().decode_terminate()
        s = self._seg()
        s.kinds.append(KIND_TERMINATE)
        s.slots.append(0)
        s.bins.append(b)
        s.positions.append(self.bit_pos)
        return b

    def done(self) -> list[TraceSegment]:
        if self.segments and self._seg().p_final is None:
            self._seg().finalize(self)
        return self.segments


def trace_tile(sps, pps, parsed) -> list[TraceSegment]:
    """Run the Python syntax decoder over one tile with tracing; returns
    the per-substream segments (16 for a WPP 16-row tile)."""
    from portbench.reference.cabac.syntax import TileSyntaxDecoder

    dec = TileSyntaxDecoder(sps, pps, parsed)
    eng = TracingCabacEngine(dec.rbsp, *dec.substreams[0])
    dec.engine = eng
    dec.decode()
    return eng.done()
