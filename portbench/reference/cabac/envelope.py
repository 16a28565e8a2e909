"""Envelope traces: host syntax decode with residual-coding spans marked.

This is the host half of the device-side residual request GENERATOR
(ops.pallas_cabac_gen). A full tape (cabac/trace.py) records every bin;
an ENVELOPE tape strips the residual_coding() bins — ~80% of all bins on
real content — and replaces each TU's span with one KIND_TU marker
carrying the TU descriptor (component, size, scan, sign-hiding). The
device engine replays the envelope entries and, at each marker, switches
into its own residual state machine: it derives every last_sig / csbf /
sig / greater1 / greater2 / sign / remaining request itself and emits
decoded coefficients as events — no host decode of those bins is shipped.

(The host still runs its own full decode here to produce the envelope —
that is today's production entropy path; what the envelope breaks is the
device engine's dependence on a host-traced tape for residual bins, the
round-4 circularity finding.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.reference.cabac.syntax import TileSyntaxDecoder
from portbench.reference.cabac.trace import TracingCabacEngine

KIND_TU = 4  # envelope-tape marker: device generates the TU's residual


@dataclass
class ResidualSpan:
    """One residual_coding() call: its bin range within a trace segment
    plus the descriptor the device generator needs."""

    seg: int
    b0: int
    b1: int
    x0: int
    y0: int
    log2: int
    c_idx: int
    scan_idx: int
    sign_hiding: bool
    n_sig: int = 0  # significant coefficients (flush steps), for sizing


@dataclass
class EnvelopeTrace:
    segments: list = field(default_factory=list)  # TraceSegments (full)
    spans: list = field(default_factory=list)  # ResidualSpans, decode order
    # SyntaxTensors of the host decode (golden coefficient planes)
    syntax: object = None


class _RecordingDecoder(TileSyntaxDecoder):
    def __init__(self, sps, pps, parsed):
        super().__init__(sps, pps, parsed)
        self.engine = TracingCabacEngine(
            self.rbsp, *self.substreams[0]
        )
        self.spans: list[ResidualSpan] = []

    def _residual_coding(self, x0, y0, log2_size, c_idx, scan_idx,
                         transform_skip):
        eng = self.engine
        seg_i = len(eng.segments) - 1
        b0 = len(eng.segments[-1].kinds)
        plane = self.coeffs[c_idx]
        size = 1 << log2_size
        before = np.count_nonzero(plane[y0 : y0 + size, x0 : x0 + size])
        super()._residual_coding(
            x0, y0, log2_size, c_idx, scan_idx, transform_skip
        )
        after = np.count_nonzero(plane[y0 : y0 + size, x0 : x0 + size])
        self.spans.append(
            ResidualSpan(
                seg=seg_i,
                b0=b0,
                b1=len(eng.segments[-1].kinds),
                x0=x0,
                y0=y0,
                log2=log2_size,
                c_idx=c_idx,
                scan_idx=scan_idx,
                sign_hiding=bool(
                    self.pps.sign_data_hiding_enabled_flag
                    and not self.cu_bypass
                ),
                n_sig=int(after),  # levels never cancel to 0 (before==0)
            )
        )
        assert before == 0


def envelope_trace(sps, pps, parsed) -> EnvelopeTrace:
    """Host decode of one tile recording trace segments + residual spans.

    Returns an EnvelopeTrace whose .syntax carries the host-decoded
    SyntaxTensors (the validation golden for device-emitted events).
    """
    dec = _RecordingDecoder(sps, pps, parsed)
    st = dec.decode()
    out = EnvelopeTrace()
    out.segments = dec.engine.done()
    out.spans = dec.spans
    out.syntax = st
    return out


def pack_tu_desc(span: ResidualSpan) -> int:
    """TU descriptor payload: cidx | (log2-2)<<2 | scan<<4 | shide<<6."""
    return (
        span.c_idx
        | ((span.log2 - 2) << 2)
        | (span.scan_idx << 4)
        | (int(span.sign_hiding) << 6)
    )


def build_envelope_tape(trace: EnvelopeTrace, seg: int):
    """Envelope tape for one segment: int32 entries kind | payload<<3.

    Residual spans collapse to single KIND_TU entries; every other bin
    keeps its (kind, slot). Returns (entries int32[n], n_steps) where
    n_steps is the exact number of lockstep engine steps this lane will
    take: envelope bins + generated residual bins + one flush step per
    significant coefficient (TU markers are consumed at request time and
    cost no step).
    """
    s = trace.segments[seg]
    spans = [sp for sp in trace.spans if sp.seg == seg]
    spans.sort(key=lambda sp: sp.b0)
    entries = []
    n_steps = 0
    b = 0
    si = 0
    n = s.n_bins
    kinds = np.asarray(s.kinds)
    slots = np.asarray(s.slots)
    while b < n:
        if si < len(spans) and spans[si].b0 == b:
            sp = spans[si]
            entries.append(KIND_TU | (pack_tu_desc(sp) << 3))
            n_steps += (sp.b1 - sp.b0) + sp.n_sig
            b = sp.b1
            si += 1
        else:
            entries.append(int(kinds[b]) | (int(slots[b]) << 3))
            n_steps += 1
            b += 1
    assert si == len(spans)
    return np.asarray(entries, dtype=np.int32), n_steps
