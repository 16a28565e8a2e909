"""ctypes bindings for the native entropy decoder (the port's copy of
heif_tpu/native).

The C++ decoder (entropy.cpp here) is a bit-exact twin of
heif_tpu_torch.cabac.syntax. `decode_tile_native` mirrors
TileSyntaxDecoder.decode()'s output (SyntaxTensors).
`decode_tiles_parallel` fans tiles across threads — the C call releases
the GIL, so a pool of OS threads gives real parallelism. The C decoder
counts the CABAC bins it decodes (SyntaxTensors.n_bins); given a
DecodeStats, the pool adds its tasks, their busy seconds and their bins
to its counters.

The library is built from entropy.cpp at first use, with the flags of
heif_tpu/native/Makefile:

    g++ -O3 -mtune=generic -fPIC -std=c++17 -shared
        -o build/heif_tpu_torch/libheif_entropy_<hash>.so entropy.cpp

The name carries a hash of the source and flags (as ops._build names the
CUDA library), and the file is written through a temporary name and
os.replace, so concurrent builds never see a partial library.
`available()` says whether the library is built or a compiler is there
to build it; only where neither is do callers decode entropy with the
Python twin (cabac.syntax). Where it is True, a failed build or a wrong
ABI raises from the first native call: a decode never falls back to the
Python path, nor to another library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from heif_tpu_torch.cabac import types as T
from heif_tpu_torch.hevc import grammar as g
from heif_tpu_torch.hevc.slice import ParsedSlice

SOURCE = Path(__file__).resolve().parent / "entropy.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "heif_tpu_torch"
CXX_FLAGS = ["-O3", "-mtune=generic", "-fPIC", "-std=c++17", "-shared"]
ABI_VERSION = 5
_lib = None
_lock = threading.Lock()


class _TileParams(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "width", "height", "ctb_log2", "min_cb_log2", "min_tb_log2",
        "max_tb_log2", "max_hier_depth_intra", "slice_qp", "sign_hiding",
        "cu_qp_delta_enabled", "diff_cu_qp_delta_depth", "cb_qp_offset",
        "cr_qp_offset", "transform_skip_enabled", "transquant_bypass_enabled",
        "wpp", "sao_luma", "sao_chroma", "amp_enabled", "pcm_enabled",
        "pcm_log2_min", "pcm_log2_max", "pcm_bd_luma", "pcm_bd_chroma",
        "bit_depth", "bit_depth_c", "chroma_format",
    )]


class _TileOutput(ctypes.Structure):
    _fields_ = [
        ("coeff_y", ctypes.c_void_p),
        ("coeff_cb", ctypes.c_void_p),
        ("coeff_cr", ctypes.c_void_p),
        ("tu_table", ctypes.c_void_p),
        ("tu_count", ctypes.c_void_p),
        ("max_tu", ctypes.c_int32),
        ("intra_mode_y", ctypes.c_void_p),
        ("intra_mode_c", ctypes.c_void_p),
        ("qp_map", ctypes.c_void_p),
        ("bypass_map", ctypes.c_void_p),
        ("pcm_map", ctypes.c_void_p),
        ("vert_edges", ctypes.c_void_p),
        ("horiz_edges", ctypes.c_void_p),
        ("sao", ctypes.c_void_p),
        ("pcm_y", ctypes.c_void_p),
        ("pcm_cb", ctypes.c_void_p),
        ("pcm_cr", ctypes.c_void_p),
        ("n_bins", ctypes.c_void_p),
    ]


def _compiler() -> Optional[str]:
    return os.environ.get("CXX") or shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libheif_entropy_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile entropy.cpp into the hashed library (if absent); return it.
    Raises with the compiler's stderr on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = _compiler() or "g++"
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        so = os.path.join(tmpdir, out.name)
        cmd = [cxx, *CXX_FLAGS, "-o", so, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"entropy library build failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stderr}")
        # atomic: a concurrent build never sees a partial file
        os.replace(so, out)
    return out


def load():
    """Build (if needed) and load the library; check its ABI. Raises on
    any failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        version = lib.heif_entropy_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(
                f"entropy library ABI {version}, expected {ABI_VERSION}")
        lib.heif_entropy_decode_tile.restype = ctypes.c_int
        lib.heif_entropy_decode_tile.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(_TileParams),
            ctypes.POINTER(_TileOutput),
        ]
        lib.heif_entropy_decode_tile_tiled.restype = ctypes.c_int
        lib.heif_entropy_decode_tile_tiled.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(_TileParams),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(_TileOutput),
        ]
        lib.heif_pack_counts.restype = ctypes.c_int
        lib.heif_pack_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.heif_pack_tile.restype = ctypes.c_int
        lib.heif_pack_tile.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built or a C++ compiler can build it.
    It does not build or load: the native calls do, and raise if that
    fails."""
    return _lib is not None or library_path().exists() or bool(_compiler())


def _make_params(sps: g.SequenceParameterSet, pps: g.PictureParameterSet,
                 sh: g.SliceSegmentHeader) -> _TileParams:
    return _TileParams(
        width=sps.pic_width_in_luma_samples,
        height=sps.pic_height_in_luma_samples,
        ctb_log2=sps.ctb_log2_size_y,
        min_cb_log2=sps.min_cb_log2_size_y,
        min_tb_log2=sps.min_tb_log2_size_y,
        max_tb_log2=sps.max_tb_log2_size_y,
        max_hier_depth_intra=sps.max_transform_hierarchy_depth_intra,
        slice_qp=sh.slice_qp_y(pps),
        sign_hiding=int(pps.sign_data_hiding_enabled_flag),
        cu_qp_delta_enabled=int(pps.cu_qp_delta_enabled_flag),
        diff_cu_qp_delta_depth=pps.diff_cu_qp_delta_depth,
        cb_qp_offset=pps.pps_cb_qp_offset + sh.slice_cb_qp_offset,
        cr_qp_offset=pps.pps_cr_qp_offset + sh.slice_cr_qp_offset,
        transform_skip_enabled=int(pps.transform_skip_enabled_flag),
        transquant_bypass_enabled=int(pps.transquant_bypass_enabled_flag),
        wpp=int(pps.entropy_coding_sync_enabled_flag),
        sao_luma=int(sh.slice_sao_luma_flag),
        sao_chroma=int(sh.slice_sao_chroma_flag),
        amp_enabled=int(sps.amp_enabled_flag),
        pcm_enabled=int(sps.pcm_enabled_flag),
        pcm_log2_min=sps.log2_min_pcm_luma_coding_block_size_minus3 + 3,
        pcm_log2_max=(
            sps.log2_min_pcm_luma_coding_block_size_minus3
            + 3
            + sps.log2_diff_max_min_pcm_luma_coding_block_size
        ),
        pcm_bd_luma=sps.pcm_sample_bit_depth_luma_minus1 + 1,
        pcm_bd_chroma=sps.pcm_sample_bit_depth_chroma_minus1 + 1,
        bit_depth=sps.bit_depth_y,
        bit_depth_c=sps.bit_depth_c,
        chroma_format=sps.chroma_format_idc,
    )


# must match heif_tpu_torch.ops.batch.CLASSES
_CLASSES = [
    (0, 4), (0, 8), (0, 16), (0, 32),
    (1, 4), (1, 8), (1, 16),
    (2, 4), (2, 8), (2, 16),
]


def pack_tile_native(st: T.SyntaxTensors, pad: int) -> None:
    """Populate st.packed with device-ready per-class blocks and scan
    fields (C gather at memcpy speed; runs GIL-free inside the per-tile
    entropy worker threads). Layout contract:

      packed.cls[i]   = (coeffs int16 [k,s,s], meta int32 [4,k]) for
                        CLASSES[i]; meta rows = qp, skip, bypass,
                        local flat org (y*(w+pad)+x, no tile term)
      packed.scans[c] = int32 [6, m] rows x, y, size, mode, filter, pcm
                        (z-order, all TUs of component c)
    """
    lib = load()
    tu = np.ascontiguousarray(st.tu_table, dtype=np.int32)
    n_tu = np.int32(tu.shape[0])
    cls_counts = np.zeros(10, np.int32)
    scan_counts = np.zeros(3, np.int32)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.heif_pack_counts(vp(tu), n_tu, vp(cls_counts), vp(scan_counts))
    cls = []
    for i, (_, s) in enumerate(_CLASSES):
        k = int(cls_counts[i])
        cls.append((np.empty((k, s, s), np.int16), np.empty((4, k), np.int32)))
    scans = [np.empty((6, int(scan_counts[c])), np.int32) for c in range(3)]
    pp = (ctypes.c_void_p * 3)(*[st.coeffs[c].ctypes.data for c in range(3)])
    pc = (ctypes.c_void_p * 10)(*[a.ctypes.data for a, _ in cls])
    pm = (ctypes.c_void_p * 10)(*[m.ctypes.data for _, m in cls])
    ps = (ctypes.c_void_p * 3)(*[a.ctypes.data for a in scans])
    lib.heif_pack_tile(
        vp(tu), n_tu, pp, np.int32(st.width), np.int32(st.height),
        np.int32(pad), pc, pm, ps, vp(cls_counts), vp(scan_counts),
    )
    st.packed = T.PackedTile(
        cls_counts=cls_counts, cls=cls, scans=scans, pad=pad
    )


def decode_tile_native(
    sps: g.SequenceParameterSet,
    pps: g.PictureParameterSet,
    parsed: ParsedSlice,
) -> T.SyntaxTensors:
    """Native equivalent of TileSyntaxDecoder(...).decode()."""
    if pps.tiles_enabled_flag and pps.entropy_coding_sync_enabled_flag:
        raise NotImplementedError(
            "tiles + WPP in one PPS is not supported"
        )
    lib = load()
    W = sps.pic_width_in_luma_samples
    H = sps.pic_height_in_luma_samples
    ctbs_x = sps.pic_width_in_ctbs_y
    ctbs_y = sps.pic_height_in_ctbs_y
    g4h, g4w = H >> 2, W >> 2
    max_tu = (g4h * g4w) * 2  # generous: every 4x4 luma + chroma leaves

    st = T.SyntaxTensors(
        width=W, height=H, chroma_format_idc=sps.chroma_format_idc
    )
    st.coeffs = [
        np.zeros((H, W), dtype=np.int32),
        np.zeros((H >> 1, W >> 1), dtype=np.int32),
        np.zeros((H >> 1, W >> 1), dtype=np.int32),
    ]
    tu_table = np.zeros((max_tu, T.TU_FIELDS), dtype=np.int32)
    tu_count = np.zeros(1, dtype=np.int32)
    n_bins = np.zeros(1, dtype=np.int64)
    st.intra_mode_y = np.ones((g4h, g4w), dtype=np.int8)
    st.intra_mode_c = np.ones((g4h, g4w), dtype=np.int8)
    st.qp_y = np.zeros((g4h, g4w), dtype=np.int8)
    bypass = np.zeros((g4h, g4w), dtype=np.uint8)
    pcm = np.zeros((g4h, g4w), dtype=np.uint8)
    vert = np.zeros((g4h, g4w), dtype=np.uint8)
    horiz = np.zeros((g4h, g4w), dtype=np.uint8)
    st.sao = np.zeros((ctbs_y, ctbs_x, 3, T.SAO_FIELDS), dtype=np.int16)
    if sps.pcm_enabled_flag:
        st.pcm_planes = [
            np.zeros((H, W), dtype=np.uint16),
            np.zeros((H >> 1, W >> 1), dtype=np.uint16),
            np.zeros((H >> 1, W >> 1), dtype=np.uint16),
        ]
    else:
        st.pcm_planes = [
            np.zeros((H, W), dtype=np.uint16),
            np.zeros((H >> 1, W >> 1), dtype=np.uint16),
            np.zeros((H >> 1, W >> 1), dtype=np.uint16),
        ]

    ranges = parsed.substream_ranges()
    offsets = np.asarray(ranges, dtype=np.int32).reshape(-1)

    def vp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    out = _TileOutput(
        coeff_y=vp(st.coeffs[0]),
        coeff_cb=vp(st.coeffs[1]),
        coeff_cr=vp(st.coeffs[2]),
        tu_table=vp(tu_table),
        tu_count=vp(tu_count),
        max_tu=max_tu,
        intra_mode_y=vp(st.intra_mode_y),
        intra_mode_c=vp(st.intra_mode_c),
        qp_map=vp(st.qp_y),
        bypass_map=vp(bypass),
        pcm_map=vp(pcm),
        vert_edges=vp(vert),
        horiz_edges=vp(horiz),
        sao=vp(st.sao),
        pcm_y=vp(st.pcm_planes[0]),
        pcm_cb=vp(st.pcm_planes[1]),
        pcm_cr=vp(st.pcm_planes[2]),
        n_bins=vp(n_bins),
    )
    params = _make_params(sps, pps, parsed.header)
    rbsp = (
        parsed.rbsp if isinstance(parsed.rbsp, bytes) else bytes(parsed.rbsp)
    )
    if pps.tiles_enabled_flag:
        col_bd, row_bd = pps.tile_bounds(sps)
        col_arr = np.asarray(col_bd, dtype=np.int32)
        row_arr = np.asarray(row_bd, dtype=np.int32)
        rc = lib.heif_entropy_decode_tile_tiled(
            rbsp,
            len(rbsp),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(ranges),
            ctypes.byref(params),
            col_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(col_bd) - 1,
            row_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(row_bd) - 1,
            ctypes.byref(out),
        )
    else:
        rc = lib.heif_entropy_decode_tile(
            rbsp,
            len(rbsp),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(ranges),
            ctypes.byref(params),
            ctypes.byref(out),
        )
    if rc == 2:
        raise NotImplementedError(
            f"chroma_format_idc={sps.chroma_format_idc} not supported "
            "(only 4:0:0 and 4:2:0)"
        )
    if rc != 0:
        raise ValueError("native entropy decode failed (stream desync)")
    st.tu_table = tu_table[: int(tu_count[0])].copy()
    st.n_bins = int(n_bins[0])
    st.bypass_map = bypass.astype(bool)
    st.pcm_map = pcm.astype(bool)
    st.vert_edges = vert.astype(bool)
    st.horiz_edges = horiz.astype(bool)
    return st


# shared worker pools, one per requested size: decode_tiles_parallel is
# called per chunk on the decode critical path, and re-spawning OS
# threads each call costs more than the work they amortize on 2-core
# hosts. Size-keyed (never shut down, lock-guarded) so concurrent
# callers cannot race a shutdown and a smaller max_workers is honored
# rather than fanning across a wider cached pool.
_POOLS: dict = {}
_POOL_LOCK = threading.Lock()
# guards DecodeStats.counters against the pool's workers
_STATS_LOCK = threading.Lock()


def _pool(workers: int) -> ThreadPoolExecutor:
    with _POOL_LOCK:
        p = _POOLS.get(workers)
        if p is None:
            p = ThreadPoolExecutor(max_workers=workers)
            _POOLS[workers] = p
        return p


def _count(stats, **amounts) -> None:
    with _STATS_LOCK:
        c = stats.counters
        for k, v in amounts.items():
            c[k] = c.get(k, 0) + v


def decode_tiles_parallel(
    sps, pps, parsed_list, max_workers: Optional[int] = None,
    pack_pad: Optional[int] = None, stats=None,
) -> list:
    """Entropy-decode many tiles concurrently (GIL released per C call),
    one pool task a tile.

    pack_pad: when set, also run the native per-tile pack (device-ready
    class blocks / scan fields, attached as st.packed) inside the same
    worker threads; the value is the residual-plane PAD of ops.batch.
    stats: a DecodeStats whose counters receive entropy_tasks (the pool
    tasks run), entropy_busy_s (the wall seconds the workers spent inside
    them, each timed in its worker, the pre-pack included) and
    entropy_bins (the CABAC bins they decoded).
    """

    def one(p):
        t0 = time.perf_counter()
        st = decode_tile_native(sps, pps, p)
        if pack_pad is not None:
            pack_tile_native(st, pack_pad)
        if stats is not None:
            _count(stats, entropy_busy_s=time.perf_counter() - t0,
                   entropy_bins=st.n_bins)
        return st

    workers = max_workers or min(len(parsed_list), os.cpu_count() or 4)
    out = list(_pool(workers).map(one, parsed_list))
    if stats is not None:
        _count(stats, entropy_tasks=len(parsed_list))
    return out
