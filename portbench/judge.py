"""What decides `correct`: the reference decodes every distinct tile of
the run's images (a single item's one coded picture counts as one tile)
from the file bytes, in worker processes, once the
window has closed; the program's answers are then compared with it
sample for sample. The limit on mismatched samples is 0: the decode is
bit-exact by the HEVC specification.

Nothing here imports the program: the answers arrive as numpy planes.
"""

from __future__ import annotations

import gc
import multiprocessing as mp
import os
from multiprocessing import resource_tracker

import numpy as np

from portbench.metrics import kernel_bytes
from portbench.reference import image as ref_image


def _tile_job(job):
    """One tile through the reference, in a worker: ([Y, Cb, Cr] planes,
    {kernel: bytes}). level_bits, where set, clips every coefficient
    level to that many signed bits before the reconstruction: the
    control's lower precision."""
    sps_nal, pps_nal, length_size, payload, level_bits = job
    sps, pps, ps, st = ref_image.tile_syntax(sps_nal, pps_nal, payload,
                                             length_size)
    counts = kernel_bytes.tile_bytes(st, sps, ps.header)
    if level_bits:
        lim = 1 << (level_bits - 1)
        st.coeffs = [np.clip(c, -lim, lim - 1) for c in st.coeffs]
    return ref_image.reconstruct(sps, pps, ps, st), counts


def workers() -> int:
    return max(1, len(os.sched_getaffinity(0)))


def _pool_map(n: int, jobs: list) -> list:
    """_tile_job over jobs in n spawned workers. Once the pool has ended
    and its semaphores are released, the resource tracker that the pool
    started is stopped and waited for, so no process of the pool's
    outlives this call (the next pool starts a new tracker)."""
    pool = mp.get_context("spawn").Pool(n)
    try:
        return pool.map(_tile_job, jobs, chunksize=1)
    finally:
        pool.terminate()
        pool.join()
        del pool
        gc.collect()
        resource_tracker._resource_tracker._stop()


class Reference:
    """The reference's decode of every distinct tile of `images` (HEIF
    files), each tile decoded once. level_bits: see _tile_job. cache: a
    dict that keeps the decoded tiles across instances of one
    level_bits."""

    def __init__(self, images: list, level_bits: int | None = None,
                 processes: int | None = None, cache: dict | None = None):
        self.pictures = [ref_image.parse(d) for d in images]
        keys = []
        for pic in self.pictures:
            for payload in pic.tiles:
                keys.append((pic.sps_nal, pic.pps_nal, pic.length_size,
                             payload))
        self._tiles = {} if cache is None else cache
        unique = [k for k in dict.fromkeys(keys) if k not in self._tiles]
        jobs = [(*k, level_bits) for k in unique]
        n = min(processes or workers(), len(jobs))
        if n > 1:
            done = _pool_map(n, jobs)
        else:
            done = [_tile_job(j) for j in jobs]
        self._tiles.update(zip(unique, done))

    def tiles(self, k: int) -> list:
        """Image k's decoded tiles in grid order."""
        pic = self.pictures[k]
        return [self._tiles[(pic.sps_nal, pic.pps_nal, pic.length_size, p)][0]
                for p in pic.tiles]

    def image(self, k: int) -> dict:
        """Image k as a decode returns it: stitched, cropped, rotated."""
        return ref_image.assemble(self.tiles(k), self.pictures[k])

    def kernel_bytes(self, k: int) -> dict:
        """{kernel: bytes} the stream defines for image k."""
        pic = self.pictures[k]
        out = dict.fromkeys(kernel_bytes.KERNELS, 0)
        for p in pic.tiles:
            counts = self._tiles[(pic.sps_nal, pic.pps_nal, pic.length_size,
                                  p)][1]
            for name, b in counts.items():
                out[name] += b
        return out


def _compare(want, got, tally: dict) -> None:
    if want is None and got is None:
        return
    if want is None or got is None or np.shape(want) != np.shape(got):
        tally["missing_answers"] += 1
        return
    diff = want.astype(np.int64) != np.asarray(got).astype(np.int64)
    n = int(np.count_nonzero(diff))
    tally["mismatched_samples"] += n
    if n:
        err = np.abs(want.astype(np.int64)[diff]
                     - np.asarray(got).astype(np.int64)[diff])
        tally["max_abs_err"] = max(tally["max_abs_err"], int(err.max()))


def judge(ref: Reference, answers: list) -> dict:
    """Compare answers, a list of (image index, kind, answer): kind
    "image" for a decode's {"Y", "Cb", "Cr"} planes, "tiles" for a list
    of [Y, Cb, Cr] tile planes in grid order (None where the program gave
    no answer). Returns the tallies that decide `correct`."""
    tally = {"checked_images": 0, "mismatched_samples": 0,
             "missing_answers": 0, "max_abs_err": 0}
    for k, kind, got in answers:
        tally["checked_images"] += 1
        if got is None:
            tally["missing_answers"] += 1
            continue
        if kind == "image":
            want = ref.image(k)
            if not isinstance(got, dict):
                tally["missing_answers"] += 1
                continue
            for c in ("Y", "Cb", "Cr"):
                _compare(want[c], got.get(c), tally)
        else:
            want = ref.tiles(k)
            if len(got) != len(want):
                tally["missing_answers"] += 1
                continue
            for w, g in zip(want, got):
                for c in range(3):
                    _compare(w[c], g[c] if len(g) > c else None, tally)
    return tally
