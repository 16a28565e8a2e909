"""Seeded random inputs for the CABAC kernels' contracts.

The replay and generator kernels (csrc/cabac.cu, csrc/cabac_gen.cu) must
equal their plain PyTorch versions on any input, not only on traced
streams. These inputs reach the corners a traced stream rarely does, in
the kernels' own layouts ([B, rows, 128] int32, lane on the fast axis):

- `replay_inputs`: random stream words, with each lane's words zero past
  a random end and a word array short enough that lanes read past it;
  tapes of ragged lane lengths (KIND_PAD after each lane's end), KIND_PAD
  steps and kinds outside 0..3 in the middle, slots outside [0, 136).
  LONG_REPLAY gives the lanes more words than the kernel's word ring
  holds and a tape long enough to read through them and past their end;
- `windowed_inputs`: the windowed replay's per-block word windows
  (random words, each lane zero past a random end) and bit offsets,
  contexts packed 4 to a word from random 32-bit words, so bit 7 of many
  bytes is set (a context write changes only a byte's low 7 bits), and
  the replay's tapes. Every eighth lane is a fast lane: context bins on
  probability state 63 over words of all ones, so every bin is a least
  probable one that reads 7 bits, the most a bin reads, and the lane
  reads past its windows (WINDOWED_CASES);
- `gen_inputs`: envelope tapes of random bins (slots in and out of
  range, kinds 0..7 apart from KIND_TU) and KIND_TU markers whose
  descriptors cycle through every legal (component, log2 size, scan,
  sign hiding), lanes of very different lengths (an empty tape included),
  so every phase and a finished lane's stop are reached within the steps.

Random words make invalid streams, whose offsets leave the range and
wrap: the contract (wrapping int32 arithmetic, shifts past 31 give 0)
covers that too. Numpy only; the same (seed, B, S) give the same arrays
everywhere (the CPU tests hold the plain versions against heif_tpu's
Pallas kernels on them, the card tests and chip_smoke.py the kernels
against the plain versions).
"""

from __future__ import annotations

import numpy as np

LANES = 128
N_CTX = 136
KIND_BYPASS = 1
KIND_PAD = 3
KIND_TU = 4

# (seed, lane batches B, steps S): two batch counts, one S not a
# multiple of 32
CASES = ((1, 1, 256), (2, 2, 200))
# (seed, B, S, words W, bypass share): lanes read about 0.9 bits a step
# (mostly bypass bins, a bit each), so over their ragged lengths they end
# anywhere up to about 150 words: the replay kernel's 64-row word ring
# (csrc/cabac_engine.cuh) slides at words 53, 85, 117, ..., loading rows
# 96-127, 128-159, 160-191, ...: across the end of the 100 words, then
# past it.
LONG_REPLAY = (3, 1, 5120, 100, 0.8)
# (seed, B, windows nb, steps a window blk, words a window w_blk[, bypass
# share]) of the windowed replay. The Pallas kernel runs blk // 8 groups
# of 8 steps a window, so its contract holds for blk % 8 == 0 only.
# blk = 40 and 48 end windows inside the kernel's 32-step blocks; the fast
# lanes (7 bits a step) read past windows of 8 words; the second case has
# two batches. The kernel's 64-row word ring slides when a 32-step block
# may read word 64, from word 53 on: a bin reads at most 7 bits, so no
# lane gets that far into a window of 256 steps. In the third case's
# windows of 2048 steps, lanes of mostly bypass bins (about a bit a step)
# slide it once inside a window over random words, and the fast lanes
# many times, through their 96 words and past them.
WINDOWED_CASES = ((5, 1, 4, 40, 8), (6, 2, 3, 48, 8), (7, 1, 2, 2048, 96, 0.9))
FAST = slice(0, LANES, 8)  # the windowed inputs' fast lanes


def _words(rng, B: int, W: int) -> np.ndarray:
    """[B, W, 128] random int32 words, each lane zero past a random end
    (some lanes end at once)."""
    words = rng.integers(-(1 << 31), 1 << 31, (B, W, LANES), dtype=np.int64)
    end = rng.integers(0, W + 1, (B, 1, LANES))
    end[:, :, ::16] = 1
    return np.where(np.arange(W)[None, :, None] < end, words, 0).astype(np.int32)


def _contexts(rng, B: int) -> np.ndarray:
    """[B, 136, 128] random 7-bit context values p | mps<<6."""
    return (rng.integers(0, 64, (B, N_CTX, LANES))
            | (rng.integers(0, 2, (B, N_CTX, LANES)) << 6)).astype(np.int32)


def _lengths(rng, B: int, n: int) -> np.ndarray:
    """[B, 128] lane lengths in [0, n], very different from lane to lane:
    some empty, some full."""
    lens = rng.integers(0, n + 1, (B, LANES))
    lens[:, ::7] = n
    lens[:, 3::11] = 0
    return lens


def replay_inputs(seed: int, B: int, S: int, W: int = 2,
                  bypass: float = 0.0):
    """(words [B,W,128], c0 [B,136,128], kinds [B,S,128], slots [B,S,128])
    int32 for ops.cabac.replay. The default W = 2 (64 bits a lane) has
    many lanes read past the end within a few hundred steps; `bypass`
    turns that share of the steps into bypass bins before the lanes end."""
    rng = np.random.default_rng(seed)
    words = _words(rng, B, W)
    c0 = _contexts(rng, B)
    kinds, slots = _kinds_slots(rng, B, S, bypass)
    return words, c0, kinds.astype(np.int32), slots.astype(np.int32)


def _kinds_slots(rng, B: int, S: int, bypass: float = 0.0):
    """[B, S, 128] tapes: context, bypass, terminate, KIND_PAD and unknown
    kinds (`bypass` of them turned into bypass bins), KIND_PAD after each
    lane's ragged end; slots in [0, 136), one in twenty in [-40, 176)
    (136-139 are packed context row 34 of the windowed replay, past its
    34 rows)."""
    kinds = rng.choice(np.array([0, 0, 0, 0, 1, 1, 2, 3, 5, -1]), (B, S, LANES))
    if bypass:
        kinds = np.where(rng.random(kinds.shape) < bypass, KIND_BYPASS, kinds)
    kinds = np.where(np.arange(S)[None, :, None] < _lengths(rng, B, S)[:, None],
                     kinds, KIND_PAD)
    slots = rng.integers(0, N_CTX, (B, S, LANES))
    odd = rng.random((B, S, LANES)) < 0.05
    slots = np.where(odd, rng.integers(-40, N_CTX + 40, (B, S, LANES)), slots)
    return kinds, slots


def windowed_inputs(seed: int, B: int, nb: int, blk: int, w_blk: int,
                    bypass: float = 0.0):
    """(windows [B,nb,w_blk,128], biw0 [B,nb,128], c0p [B,34,128],
    kinds [B,nb*blk,128], slots [B,nb*blk,128]) int32 for
    ops.cabac.replay_windowed; blk a multiple of 8. `bypass` as in
    replay_inputs."""
    if blk % 8:
        raise ValueError(f"blk {blk}: the windowed contract needs blk % 8 == 0")
    rng = np.random.default_rng(seed)
    windows = _words(rng, B * nb, w_blk).reshape(B, nb, w_blk, LANES)
    biw0 = rng.integers(0, 32, (B, nb, LANES))
    c0p = rng.integers(-(1 << 31), 1 << 31, (B, N_CTX // 4, LANES))
    kinds, slots = _kinds_slots(rng, B, nb * blk, bypass)
    # fast lanes: context bins on slots inside [0, 136) whose bytes are
    # 63 | mps<<6 | bit 7 (random in their top two bits), over words of
    # all ones after a first offset of 509 (bits 111111101): every bin is
    # then a least probable one, leaving the offset at 255 of a range of
    # 256 and reading 7 bits
    top = rng.integers(0, 4, (B, N_CTX, LANES))[:, :, FAST] << 6
    fast = (63 | top).reshape(B, N_CTX // 4, 4, -1)
    c0p[:, :, FAST] = (fast[:, :, 0] | fast[:, :, 1] << 8 | fast[:, :, 2] << 16
                       | fast[:, :, 3] << 24)
    kinds[:, :, FAST] = 0
    slots[:, :, FAST] = rng.integers(0, N_CTX, slots[:, :, FAST].shape)
    windows[..., FAST] = -1
    windows[:, 0, 0, FAST] = -0x1000001  # 0xFEFFFFFF
    biw0[:, 0, FAST] = 0
    return (windows, biw0.astype(np.int32), c0p.astype(np.int32),
            kinds.astype(np.int32), slots.astype(np.int32))


def tu_descriptors() -> list:
    """Every legal TU descriptor cidx | (log2-2)<<2 | scan<<4 | shide<<6
    of 4:2:0: luma 4x4 to 32x32, chroma 4x4 to 16x16, the horizontal and
    vertical scans only at 4x4 and 8x8."""
    out = []
    for cidx in range(3):
        for lg in range(4 if cidx == 0 else 3):
            for scan in (range(3) if lg < 2 else (0,)):
                for shide in range(2):
                    out.append(cidx | lg << 2 | scan << 4 | shide << 6)
    return out


def gen_inputs(seed: int, B: int, S: int):
    """(words [B,W,128], tape [B,S_env,128], c0 [B,136,128]) int32 for
    ops.cabac_gen.gen at S steps."""
    rng = np.random.default_rng(seed)
    W = 64  # a generator step reads up to 7 bits: some lanes run out
    words = _words(rng, B, W)
    c0 = _contexts(rng, B)
    n_env = max(S // 4, 8)
    s_env = -(-(n_env + 1) // 8) * 8
    kind = rng.choice(np.array([0, 0, 0, 1, 1, 2, 5, 7]), (B, n_env, LANES))
    slot = rng.integers(0, N_CTX, (B, n_env, LANES))
    odd = rng.random((B, n_env, LANES)) < 0.05
    slot = np.where(odd, rng.integers(-40, N_CTX + 40, (B, n_env, LANES)), slot)
    tape = kind | (slot << 3)
    # about one entry in three a TU marker, the descriptors in turn
    descs = np.asarray(tu_descriptors())
    is_tu = rng.random((B, n_env, LANES)) < 0.35
    order = np.cumsum(is_tu.reshape(-1)).reshape(is_tu.shape) + seed
    tape = np.where(is_tu, KIND_TU | (descs[order % descs.size] << 3), tape)
    tape = np.where(
        np.arange(n_env)[None, :, None] < _lengths(rng, B, n_env)[:, None],
        tape, KIND_PAD)
    full = np.full((B, s_env, LANES), KIND_PAD, np.int64)
    full[:, :n_env] = tape
    return words, full.astype(np.int32), c0
