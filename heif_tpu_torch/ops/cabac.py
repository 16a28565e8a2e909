"""CABAC replay engines (H.265 §9.3.4.3): host packers, plain PyTorch
engines and the CUDA kernel wrappers.

Port of heif_tpu/ops/pallas_cabac.py. That module imports JAX at module
level, so this one carries its own copy of the numpy half (`_pack_ctx4`,
`_unpack_ctx4`, `pack_segments`, `pack_sorted_batches`,
`pack_windowed_batch`); tests/test_torch_cabac.py holds the copy against
the original.

A replay engine decodes one CABAC substream per lane from its raw bytes,
its initial context state and a host-traced request tape of
(kind, ctx-slot) entries, and returns the bins and the final context
state. Two contracts, as in the JAX package:

- `replay`: whole-stream words [B, W, 128] (big-endian bytes packed 4 to
  an int32), c0 [B, 136, 128] (p | mps<<6), kinds / slots [B, S, 128]
  -> bins [B, S, 128], state [B, 136, 128];
- `replay_windowed`: per-block rebased word windows
  [B, nb, w_blk, 128] with the bit offset of each window's start
  biw0 [B, nb, 128], contexts packed 4 to a word c0p [B, 34, 128],
  kinds / slots [B, nb*blk, 128] -> bins [B, nb*blk, 128],
  state [B, 34, 128] packed the same way.

On a CUDA tensor each wrapper launches its kernel from csrc/cabac.cu
(built on first use by ops._build) and raises if the launch fails; on a
CPU tensor it runs the plain version (`replay_plain`,
`replay_windowed_plain`), a lane-vectorised transcription of the Pallas
step that is also the kernels' oracle on the card. There is no fallback
from one to the other. LAUNCHES counts kernel launches only.
"""

from __future__ import annotations

import numpy as np
import torch

from heif_tpu_torch.cabac import engine as E
from heif_tpu_torch.cabac.trace import KIND_BYPASS, KIND_CTX, KIND_PAD, KIND_TERMINATE
from heif_tpu_torch.device import resolve_device
from heif_tpu_torch.tables import cabac_tables_on

LANES = 128
N_CTX = E.N_CTX  # 136
N_CTXP = N_CTX // 4  # packed context rows (4 slots of p|mps<<6 per word)

LAUNCHES = {"replay": 0, "windowed": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# host half: numpy copies of heif_tpu.ops.pallas_cabac's packers
# --------------------------------------------------------------------------


def _be_words(by: np.ndarray) -> np.ndarray:
    """[W*4, ...] uint8 -> [W, ...] int32 words, big-endian bytes (bit
    patterns kept through the view: bytes >= 0x80 make words negative)."""
    w32 = by.reshape(by.shape[0] // 4, 4, *by.shape[1:]).astype(np.uint32)
    return ((w32[:, 0] << 24) | (w32[:, 1] << 16) | (w32[:, 2] << 8)
            | w32[:, 3]).view(np.int32)


def _ctx0(s) -> np.ndarray:
    return s.p0.astype(np.int32) | (s.mps0.astype(np.int32) << 6)


def _n_words(max_bytes: int) -> int:
    """Stream words per lane: the bytes plus 8 of funnel lookahead, in
    rows of 8 words."""
    w = -(-(max_bytes + 8) // 4)
    return -(-w // 8) * 8


def _pack_ctx4(c0: np.ndarray) -> np.ndarray:
    """[N_CTX, LANES] -> [N_CTX//4, LANES], 4 slots per word (8 bits
    each, p|mps<<6 in the low 7)."""
    c = c0.astype(np.int64).reshape(N_CTXP, 4, -1)
    return (
        c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | (c[:, 3] << 24)
    ).astype(np.int32)


def _unpack_ctx4(packed: np.ndarray) -> np.ndarray:
    """[N_CTX//4, LANES] -> [N_CTX, LANES] (row r holds slots 4r..4r+3)."""
    out = np.zeros((N_CTX, packed.shape[-1]), np.int32)
    for j in range(4):
        out[j::4] = (packed >> (8 * j)) & 127
    return out


def pack_segments(rbsp: bytes, segments, blk: int = 2048):
    """Pack up to 128 TraceSegments into one replay batch.

    Returns (words [W,128], c0 [N_CTX,128], kinds [S,128], slots [S,128]).
    """
    n = len(segments)
    if n > LANES:
        raise ValueError(f"{n} segments > {LANES} lanes")
    W = _n_words(max((s.byte_end - s.byte_start for s in segments),
                     default=4))
    by = np.zeros((W * 4, LANES), np.uint8)
    for i, s in enumerate(segments):
        chunk = np.frombuffer(rbsp[s.byte_start : s.byte_end], np.uint8)
        by[: chunk.size, i] = chunk
    S = max((s.n_bins for s in segments), default=1)
    kinds = np.full((S, LANES), KIND_PAD, np.int32)
    slots = np.zeros((S, LANES), np.int32)
    c0 = np.zeros((N_CTX, LANES), np.int32)
    for i, s in enumerate(segments):
        kinds[: s.n_bins, i] = s.kinds
        slots[: s.n_bins, i] = s.slots
        c0[:, i] = _ctx0(s)
    return _be_words(by), c0, kinds, slots


def pack_sorted_batches(entries, blk: int = 1024):
    """Pack (rbsp, TraceSegment) pairs into 128-lane batches grouped by
    tape length (keeps each batch's pad target close to its lanes' real
    lengths). Returns a list of dicts with the packed arrays and the
    batch's entry order (`entry_idx`, lane -> entry)."""
    order = sorted(range(len(entries)), key=lambda i: entries[i][1].n_bins)
    out = []
    for lo in range(0, len(order), LANES):
        idx = order[lo : lo + LANES]
        batch = [entries[i] for i in idx]
        W = _n_words(max(s.byte_end - s.byte_start for _, s in batch))
        by = np.zeros((W * 4, LANES), np.uint8)
        S = max(s.n_bins for _, s in batch)
        S_pad = -(-S // blk) * blk
        kinds = np.full((S_pad, LANES), KIND_PAD, np.int32)
        slots = np.zeros((S_pad, LANES), np.int32)
        c0 = np.zeros((N_CTX, LANES), np.int32)
        for i, (rbsp, s) in enumerate(batch):
            chunk = np.frombuffer(rbsp[s.byte_start : s.byte_end], np.uint8)
            by[: chunk.size, i] = chunk
            kinds[: s.n_bins, i] = s.kinds
            slots[: s.n_bins, i] = s.slots
            c0[:, i] = _ctx0(s)
        out.append({
            "words": _be_words(by), "c0": c0, "kinds": kinds, "slots": slots,
            "W": W, "S_pad": S_pad, "entry_idx": idx,
        })
    return out


def pack_windowed_batch(batch, blk: int = 256):
    """Pack up to 128 (rbsp, TraceSegment) pairs into windowed-replay
    arrays. Segments must carry `positions` (bit position after each bin).

    Returns dict(windows [nb,w_blk,128], biw0 [nb,1,128], c0, kinds,
    slots, n_blocks, w_blk, S_pad)."""
    n = len(batch)
    if n > LANES:
        raise ValueError(f"{n} segments > {LANES} lanes")
    S = max(s.n_bins for _, s in batch)
    S_pad = -(-S // blk) * blk
    n_blocks = S_pad // blk
    kinds = np.full((S_pad, LANES), KIND_PAD, np.int32)
    slots = np.zeros((S_pad, LANES), np.int32)
    c0 = np.zeros((N_CTX, LANES), np.int32)

    lane_words = []
    base_bits = []
    for i, (rbsp, s) in enumerate(batch):
        kinds[: s.n_bins, i] = s.kinds
        slots[: s.n_bins, i] = s.slots
        c0[:, i] = _ctx0(s)
        chunk = np.frombuffer(rbsp[s.byte_start : s.byte_end], np.uint8)
        nw = -(-(chunk.size + 8) // 4)
        by = np.zeros(nw * 4, np.uint8)
        by[: chunk.size] = chunk
        lane_words.append(_be_words(by))
        base_bits.append(s.byte_start * 8)

    # block-start positions per lane (relative to the segment start)
    starts = np.zeros((n_blocks, LANES), np.int64)
    ends = np.zeros((n_blocks, LANES), np.int64)
    for i, (_, s) in enumerate(batch):
        pos = np.asarray(s.positions, np.int64) - base_bits[i]
        nb = s.n_bins
        for k in range(n_blocks):
            b0 = k * blk
            starts[k, i] = 0 if b0 == 0 else pos[min(b0, nb) - 1]
            b1 = min((k + 1) * blk, nb)
            ends[k, i] = pos[b1 - 1] if b1 > 0 else 0
    # window size: bits consumed + funnel lookahead (cur, nxt + prefetch)
    need = ((starts & 31) + (ends - starts)) // 32 + 3
    w_blk = int(-(-int(need.max()) // 8) * 8)

    windows = np.zeros((n_blocks, w_blk, LANES), np.int32)
    biw0 = np.zeros((n_blocks, 1, LANES), np.int32)
    for i in range(n):
        lw = lane_words[i]
        for k in range(n_blocks):
            base = int(starts[k, i] >> 5)
            biw0[k, 0, i] = int(starts[k, i] & 31)
            src = lw[base : base + w_blk]
            windows[k, : src.size, i] = src
    return {
        "windows": windows, "biw0": biw0, "c0": c0,
        "kinds": kinds, "slots": slots,
        "n_blocks": n_blocks, "w_blk": w_blk, "S_pad": S_pad,
    }


# --------------------------------------------------------------------------
# plain engine: lane-vectorised transcription of the Pallas bin step
# --------------------------------------------------------------------------


def srl(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int32 `x` (torch's `>>` is arithmetic; the
    stream words are negative whenever their top byte is >= 0x80). A
    shift by n outside [0, 32) gives 0, as XLA's does."""
    if isinstance(n, int):
        return x if n == 0 else (x >> n) & ((1 << (32 - n)) - 1)
    ok = (n >= 0) & (n < 32)
    v = (x.to(torch.int64) & 0xFFFFFFFF) >> n.clamp(0, 31).to(torch.int64)
    return torch.where(ok, v.to(torch.int32), 0)


def shl(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x << n on int32 (wrapping), 0 for a shift outside [0, 32) (XLA's
    rule; C++ leaves it undefined)."""
    ok = (n >= 0) & (n < 32)
    return torch.where(ok, x << n.clamp(0, 31), 0)


def to_lanes(t: torch.Tensor) -> torch.Tensor:
    """[B, R, 128] -> [R, B*128]: every lane of every batch is one column."""
    B, R, lanes = t.shape
    return t.permute(1, 0, 2).reshape(R, B * lanes)


def from_lanes(t: torch.Tensor, B: int) -> torch.Tensor:
    """[R, B*128] -> [B, R, 128]."""
    return t.reshape(t.shape[0], B, LANES).permute(1, 0, 2).contiguous()


def fetch(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane[idx[lane], lane], and 0 where idx is outside the plane (the
    Pallas kernels' masked-sum fetch reads 0 there)."""
    n = plane.shape[0]
    v = plane.gather(0, idx.clamp(0, n - 1).to(torch.int64)[None])[0]
    return torch.where((idx >= 0) & (idx < n), v, 0)


class Engine:
    """Per-lane arithmetic-decoder registers (rng, off, word index, bit
    in word, and the cur/nxt word funnel), as int32 [L] tensors."""

    def __init__(self, words: torch.Tensor, biw: torch.Tensor):
        """Engine start (§9.3.4.3.1): range 510, offset = the first 9
        bits at bit `biw` of word 0."""
        zero = torch.zeros_like(biw)
        self.wi, self.biw = zero, biw
        self.cur, self.nxt = fetch(words, zero), fetch(words, zero + 1)
        self.rng = zero + 510
        self.off = self.read_bits(words, zero + 9)

    def rebase(self, words: torch.Tensor, biw: torch.Tensor) -> None:
        """Re-anchor the bit reader at bit `biw` of a new word window."""
        self.wi = torch.zeros_like(biw)
        self.biw = biw
        self.cur, self.nxt = fetch(words, self.wi), fetch(words, self.wi + 1)

    def read_bits(self, words: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
        """Consume L[lane] (0..9) bits MSB-first from the funnel."""
        biw = self.biw
        top = (self.cur << biw) | torch.where(
            biw > 0, srl(self.nxt, torch.where(biw > 0, 32 - biw, 0)), 0)
        v = torch.where(L > 0, srl(top, torch.where(L > 0, 32 - L, 0)), 0)
        biw = biw + L
        crossed = biw >= 32
        self.biw = torch.where(crossed, biw - 32, biw)
        self.wi = self.wi + crossed.to(torch.int32)
        nxt_f = fetch(words, self.wi + 1)
        self.cur = torch.where(crossed, self.nxt, self.cur)
        self.nxt = torch.where(crossed, nxt_f, self.nxt)
        return v

    def decode(self, words, kind, c, lps, t_mps, t_lps):
        """One bin per lane for request `kind`, context value c = p|mps<<6
        and its table row (rangeTabLps, transIdxMps, transIdxLps). All
        paths run and `kind` selects, as in the Pallas step. Returns
        (bin, c_new, is_ctx): the caller writes c_new back where is_ctx."""
        rng, off = self.rng, self.off
        p = c & 63
        mps = srl(c, 6)
        # decision path (§9.3.4.3.2)
        rng2 = rng - lps
        is_lps = off >= rng2
        bin_ctx = torch.where(is_lps, 1 - mps, mps)
        off_ctx = torch.where(is_lps, off - rng2, off)
        rng_ctx = torch.where(is_lps, lps, rng2)
        new_mps = torch.where(is_lps & (p == 0), 1 - mps, mps)
        new_p = torch.where(is_lps, t_lps, t_mps)
        c_new = new_p | (new_mps << 6)
        # terminate path (§9.3.4.3.5)
        rng_t = rng - 2
        bin_t = (off >= rng_t).to(torch.int32)
        is_ctx = kind == KIND_CTX
        is_byp = kind == KIND_BYPASS
        is_trm = kind == KIND_TERMINATE
        offb = torch.where(is_ctx, off_ctx, off)
        rngf = torch.where(is_ctx, rng_ctx, torch.where(is_trm, rng_t, rng))
        sh = ((rngf < 256).to(torch.int32) + (rngf < 128).to(torch.int32)
              + (rngf < 64).to(torch.int32) + (rngf < 32).to(torch.int32)
              + (rngf < 16).to(torch.int32) + (rngf < 8).to(torch.int32)
              + (rngf < 4).to(torch.int32))
        # bypass reads 1 bit; terminate with bin 1 does not renormalise;
        # a pad (or any other kind) consumes nothing
        L = torch.where(is_byp, 1, torch.where(
            is_trm, torch.where(bin_t > 0, 0, sh), torch.where(is_ctx, sh, 0)))
        v = self.read_bits(words, L)
        off_sh = shl(offb, L) | v
        bin_b = (off_sh >= rng).to(torch.int32)
        bin_out = torch.where(is_ctx, bin_ctx, torch.where(is_byp, bin_b, bin_t))
        off_new = torch.where(is_byp, off_sh - rng * bin_b, off_sh)
        rng_new = torch.where(is_byp, rng, shl(rngf, L))
        is_pad = kind == KIND_PAD
        self.off = torch.where(is_pad, off, off_new)
        self.rng = torch.where(is_pad, rng, rng_new)
        return bin_out, c_new, is_ctx


def table_row(tbl: torch.Tensor, c: torch.Tensor, rng: torch.Tensor):
    """(rangeTabLps, transIdxMps, transIdxLps) for context value c at
    range rng, from the packed [256] table."""
    q = srl(rng, 6) & 3
    packed = tbl[((c & 63) * 4 + q).to(torch.int64)]
    return srl(packed, 16) & 255, packed & 255, srl(packed, 8) & 255


def ctx_read(ctx: torch.Tensor, slot: torch.Tensor, lane: torch.Tensor):
    """ctx[slot[lane], lane], 0 for a slot outside the plane. Returns the
    value, the clamped row and the in-range mask for the write-back."""
    ok = (slot >= 0) & (slot < ctx.shape[0])
    row = slot.clamp(0, ctx.shape[0] - 1).to(torch.int64)
    return torch.where(ok, ctx[row, lane], 0), row, ok


def replay_plain(words, c0, kinds, slots, tables=None):
    """Plain PyTorch replay on any device; same contract as `replay`."""
    B = words.shape[0]
    tbl = (tables or cabac_tables_on(words.device)).tbl
    w, ctx = to_lanes(words), to_lanes(c0).clone()
    ks, ss = to_lanes(kinds), to_lanes(slots)
    lane = torch.arange(w.shape[1], device=w.device)
    eng = Engine(w, torch.zeros_like(lane, dtype=torch.int32))
    bins = torch.empty_like(ks)
    for t in range(ks.shape[0]):
        c, row, ok = ctx_read(ctx, ss[t], lane)
        b, c_new, is_ctx = eng.decode(w, ks[t], c, *table_row(tbl, c, eng.rng))
        ctx[row, lane] = torch.where(is_ctx & ok, c_new, ctx[row, lane])
        bins[t] = b
    return from_lanes(bins, B), from_lanes(ctx, B)


def replay_windowed_plain(windows, biw0, c0p, kinds, slots, tables=None):
    """Plain PyTorch windowed replay on any device; same contract as
    `replay_windowed`."""
    B, nb = windows.shape[0], windows.shape[1]
    blk = kinds.shape[1] // nb
    tw = (tables or cabac_tables_on(windows.device)).tbl_win
    ctx = to_lanes(c0p).clone()
    ks, ss = to_lanes(kinds), to_lanes(slots)
    lane = torch.arange(ctx.shape[1], device=ctx.device)
    bins = torch.empty_like(ks)
    eng = None
    for k in range(nb):
        win = to_lanes(windows[:, k])
        biw = to_lanes(biw0[:, k : k + 1])[0]
        if eng is None:
            eng = Engine(win, biw)
        else:
            eng.rebase(win, biw)
        for j in range(blk):
            t = k * blk + j
            slot = ss[t]
            cword, row, ok = ctx_read(ctx, srl(slot, 2), lane)
            csh = (slot & 3) << 3
            c = srl(cword, csh) & 127
            p = c & 63
            q = srl(eng.rng, 6) & 3
            ta = tw[p.to(torch.int64)]
            tb = tw[(64 + p).to(torch.int64)]
            b, c_new, is_ctx = eng.decode(
                win, ks[t], c, srl(ta, q << 3) & 255, tb & 255,
                srl(tb, 8) & 255)
            word_new = (cword & ~(127 << csh)) | (c_new << csh)
            ctx[row, lane] = torch.where(is_ctx & ok, word_new, ctx[row, lane])
            bins[t] = b
    return from_lanes(bins, B), from_lanes(ctx, B)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def check(name, t, shape, device):
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def replay(words, c0, kinds, slots):
    """Replay B x 128 substreams (see the module docstring for shapes).
    Context values are 7-bit (p | mps<<6), as the packers build them.
    Returns (bins [B, S, 128], state [B, 136, 128]) int32."""
    B, W = words.shape[0], words.shape[1]
    S = kinds.shape[1]
    dev = words.device
    check("words", words, (B, W, LANES), dev)
    check("c0", c0, (B, N_CTX, LANES), dev)
    check("kinds", kinds, (B, S, LANES), dev)
    check("slots", slots, (B, S, LANES), dev)
    if dev.type == "cpu":
        return replay_plain(words, c0, kinds, slots)
    from heif_tpu_torch.ops import _build

    bins = torch.empty_like(kinds)
    state = torch.empty_like(c0)
    rc = _build.load().heif_cabac_replay(
        bins.data_ptr(), state.data_ptr(), words.data_ptr(), c0.data_ptr(),
        kinds.data_ptr(), slots.data_ptr(),
        cabac_tables_on(dev).tbl.data_ptr(), B, W, S,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(rc, "heif_cabac_replay")
    LAUNCHES["replay"] += 1
    return bins, state


def replay_windowed(windows, biw0, c0p, kinds, slots):
    """Windowed replay of B x 128 substreams (see the module docstring).
    Returns (bins [B, nb*blk, 128], packed state [B, 34, 128]) int32."""
    B, nb, w_blk = windows.shape[0], windows.shape[1], windows.shape[2]
    S = kinds.shape[1]
    dev = windows.device
    if nb == 0 or S % nb:
        raise ValueError(f"{S} steps do not split into {nb} blocks")
    check("windows", windows, (B, nb, w_blk, LANES), dev)
    check("biw0", biw0, (B, nb, LANES), dev)
    check("c0p", c0p, (B, N_CTXP, LANES), dev)
    check("kinds", kinds, (B, S, LANES), dev)
    check("slots", slots, (B, S, LANES), dev)
    if dev.type == "cpu":
        return replay_windowed_plain(windows, biw0, c0p, kinds, slots)
    from heif_tpu_torch.ops import _build

    bins = torch.empty_like(kinds)
    state = torch.empty_like(c0p)
    rc = _build.load().heif_cabac_windowed(
        bins.data_ptr(), state.data_ptr(), windows.data_ptr(),
        biw0.data_ptr(), c0p.data_ptr(), kinds.data_ptr(), slots.data_ptr(),
        cabac_tables_on(dev).tbl.data_ptr(), B, nb, w_blk, S // nb,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(rc, "heif_cabac_windowed")
    LAUNCHES["windowed"] += 1
    return bins, state


# --------------------------------------------------------------------------
# numpy entry points, as heif_tpu.ops.pallas_cabac's (device selects the
# kernel on "cuda", the default, or the plain engine on "cpu"; without a
# card a call that names no device raises)
# --------------------------------------------------------------------------


def as_tensor(a: np.ndarray, device) -> torch.Tensor:
    """int32 numpy array -> contiguous tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


def _pad_steps(kinds, slots, blk):
    """Pad the step axis (-2) to a multiple of blk with KIND_PAD steps."""
    S = kinds.shape[-2]
    S_pad = -(-S // blk) * blk
    if S_pad == S:
        return kinds, slots
    shape = kinds.shape[:-2] + (S_pad - S, LANES)
    pad = np.full(shape, KIND_PAD, np.int32)
    return (np.concatenate([kinds, pad], axis=-2),
            np.concatenate([slots, np.zeros_like(pad)], axis=-2))


def cabac_replay_batches(words, c0, kinds, slots, blk: int = 2048,
                         device=None):
    """Decode S bins for B x 128 streams in one launch. Returns numpy
    (bins [B, S, 128], ctx_final [B, N_CTX, 128])."""
    device = resolve_device(device)
    S = kinds.shape[1]
    kinds, slots = _pad_steps(kinds, slots, blk)
    bins, state = replay(*(as_tensor(a, device) for a in (words, c0, kinds, slots)))
    return bins.cpu().numpy()[:, :S], state.cpu().numpy()


def cabac_replay_batch(words, c0, kinds, slots, blk: int = 2048,
                       device=None):
    """Decode S bins for 128 streams; returns (bins [S, 128], ctx_final)."""
    device = resolve_device(device)
    bins, state = cabac_replay_batches(
        words[None], c0[None], kinds[None], slots[None], blk=blk,
        device=device)
    return bins[0], state[0]


def replay_segments(rbsp: bytes, segments, blk: int = 2048, device=None):
    """Replay trace segments; returns per-segment (bins, p_final,
    mps_final)."""
    device = resolve_device(device)
    words, c0, kinds, slots = pack_segments(rbsp, segments)
    bins, state = cabac_replay_batch(words, c0, kinds, slots, blk=blk,
                                     device=device)
    return [
        (bins[: s.n_bins, i].astype(np.uint8),
         (state[:, i] & 63).astype(np.uint8),
         (state[:, i] >> 6).astype(np.uint8))
        for i, s in enumerate(segments)
    ]


def stack_batches(batches: list, keys: tuple, fills: tuple) -> list:
    """Stack per-batch [R_b, 128] arrays into [B, max R_b, 128], padding
    each with its fill value (0 words read like the kernels' past-the-end
    fetch; KIND_PAD steps change no state), so one launch covers every
    batch: one CUDA block per batch."""
    out = []
    for key, fill in zip(keys, fills):
        rows = max(b[key].shape[0] for b in batches)
        a = np.full((len(batches), rows, LANES), fill, np.int32)
        for i, b in enumerate(batches):
            a[i, : b[key].shape[0]] = b[key]
        out.append(a)
    return out


def replay_image(entries, blk: int = 1024, device=None):
    """Replay every stream of an image (list of (rbsp, TraceSegment)) in
    one launch of length-sorted 128-lane batches; returns per-entry
    (bins, p_final, mps_final) in input order."""
    device = resolve_device(device)
    packed = pack_sorted_batches(entries, blk=blk)
    arrays = stack_batches(packed, ("words", "c0", "kinds", "slots"),
                           (0, 0, KIND_PAD, 0))
    bins, state = replay(*(as_tensor(a, device) for a in arrays))
    bins, state = bins.cpu().numpy(), state.cpu().numpy()
    results = [None] * len(entries)
    for bi, b in enumerate(packed):
        for lane, ei in enumerate(b["entry_idx"]):
            s = entries[ei][1]
            results[ei] = (
                bins[bi, : s.n_bins, lane].astype(np.uint8),
                (state[bi, :, lane] & 63).astype(np.uint8),
                (state[bi, :, lane] >> 6).astype(np.uint8),
            )
    return results


def windowed_inputs(p: dict, device) -> tuple:
    """Tensors of one pack_windowed_batch dict for `replay_windowed`."""
    return (
        as_tensor(p["windows"][None], device),
        as_tensor(p["biw0"][None, :, 0], device),
        as_tensor(_pack_ctx4(p["c0"])[None], device),
        as_tensor(p["kinds"][None], device),
        as_tensor(p["slots"][None], device),
    )


def replay_windowed_batch(batch, blk: int = 256, device=None):
    """Windowed replay of <=128 segments; returns numpy (bins [S_pad,128],
    state [N_CTX,128])."""
    device = resolve_device(device)
    p = pack_windowed_batch(batch, blk=blk)
    bins, state = replay_windowed(*windowed_inputs(p, device))
    return bins.cpu().numpy()[0], _unpack_ctx4(state.cpu().numpy()[0])


def windowed_image_inputs(entries, blk: int = 256, device=None):
    """Pack (rbsp, TraceSegment) pairs, segments with `positions`, into one
    windowed launch: length-sorted 128-lane batches (pack_windowed_batch
    each) stacked on the batch axis. Zero window words past a batch's
    w_blk read like the kernel's past-the-end fetch, and extra blocks hold
    only KIND_PAD steps, so each batch gives what its own launch would.
    Returns (tensors for `replay_windowed`, batches of entry indices)."""
    device = resolve_device(device)
    order = sorted(range(len(entries)), key=lambda i: entries[i][1].n_bins)
    batches = [order[lo : lo + LANES] for lo in range(0, len(order), LANES)]
    packed = [pack_windowed_batch([entries[i] for i in idx], blk=blk)
              for idx in batches]
    B = len(packed)
    nb = max(p["n_blocks"] for p in packed)
    w_blk = max(p["w_blk"] for p in packed)
    windows = np.zeros((B, nb, w_blk, LANES), np.int32)
    biw0 = np.zeros((B, nb, LANES), np.int32)
    c0p = np.zeros((B, N_CTXP, LANES), np.int32)
    kinds = np.full((B, nb * blk, LANES), KIND_PAD, np.int32)
    slots = np.zeros((B, nb * blk, LANES), np.int32)
    for i, p in enumerate(packed):
        n, w = p["n_blocks"], p["w_blk"]
        windows[i, :n, :w] = p["windows"]
        biw0[i, :n] = p["biw0"][:, 0]
        c0p[i] = _pack_ctx4(p["c0"])
        kinds[i, : p["S_pad"]] = p["kinds"]
        slots[i, : p["S_pad"]] = p["slots"]
    args = tuple(as_tensor(a, device) for a in (windows, biw0, c0p, kinds, slots))
    return args, batches


def replay_windowed_image(entries, blk: int = 256, device=None):
    """Windowed replay of every stream of an image in one launch; returns
    per-entry (bins, p_final, mps_final) in input order."""
    device = resolve_device(device)
    args, batches = windowed_image_inputs(entries, blk, device)
    bins, state = replay_windowed(*args)
    bins, state = bins.cpu().numpy(), state.cpu().numpy()
    results = [None] * len(entries)
    for bi, idx in enumerate(batches):
        ctx = _unpack_ctx4(state[bi])
        for lane, ei in enumerate(idx):
            s = entries[ei][1]
            results[ei] = (
                bins[bi, : s.n_bins, lane].astype(np.uint8),
                (ctx[:, lane] & 63).astype(np.uint8),
                (ctx[:, lane] >> 6).astype(np.uint8),
            )
    return results


def longest_lane(entries) -> int:
    """Steps of the longest lane of a replay of (rbsp, TraceSegment)
    entries: its bins. A replay's time is that lane's chain."""
    return max((s.n_bins for _, s in entries), default=0)


def stream_bytes(seg, n_bins: int) -> int:
    """Bytes of a substream that its first n_bins bins consume (the host
    decoder's bit position after the last of them)."""
    if n_bins <= 0:
        return 0
    return -(-(int(seg.positions[n_bins - 1]) - 8 * seg.byte_start) // 8)


def replay_bytes(entries, state_words: int, blk: int = 0) -> int:
    """The bytes a replay of (rbsp, TraceSegment) entries must move,
    padding not counted: per lane its steps (kind and slot read, bin
    written), its state_words of context state read and written once and
    the stream bytes its bins consume; with blk (the windowed replay) also
    the bit offset of each block of blk steps."""
    total = 0
    for _, s in entries:
        k = s.n_bins
        total += 12 * k + 2 * 4 * state_words + stream_bytes(s, k)
        if blk:
            total += 4 * -(-k // blk)
    return total


def cuda_ms(fn, reps: int, device="cuda") -> float:
    """Mean device time of fn() over `reps` runs, by CUDA events, after
    one warm-up run. A device without CUDA events (the CPU) raises: a
    CPU run gives no device time."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"device timing needs a CUDA device, not {device}")
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_replay_device(words, c0, kinds, slots, blk: int = 2048,
                        reps: int = 3, device="cuda"):
    """Kernel-only throughput of the replay on the card: inputs staged on
    the device once, launches timed with CUDA events. Returns
    (mbins_per_s, us_per_step)."""
    kinds, slots = _pad_steps(kinds, slots, blk)
    args = [as_tensor(a, device) for a in (words, c0, kinds, slots)]
    ms = cuda_ms(lambda: replay(*args), reps, device)
    B, S_pad = kinds.shape[0], kinds.shape[1]
    return B * S_pad * LANES / (ms * 1e3), ms * 1e3 / S_pad


def bench_device_entropy(entries, blk: int = 1024, reps: int = 3,
                         device="cuda"):
    """Aggregate replay throughput over every stream of an image, one
    launch of all its batches timed with CUDA events. Returns
    (real_mbins_per_s, padded_mbins_per_s, seconds)."""
    packed = pack_sorted_batches(entries, blk=blk)
    arrays = stack_batches(packed, ("words", "c0", "kinds", "slots"),
                           (0, 0, KIND_PAD, 0))
    args = [as_tensor(a, device) for a in arrays]
    s = cuda_ms(lambda: replay(*args), reps, device) / 1e3
    total_bins = sum(seg.n_bins for _, seg in entries)
    pad_steps = arrays[2].shape[0] * arrays[2].shape[1]
    return total_bins / s / 1e6, pad_steps * LANES / s / 1e6, s
