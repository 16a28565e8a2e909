"""Build and bind the CUDA sources in heif_tpu_torch/csrc/.

nvcc compiles each csrc/*.cu to an object for sm_90a (Hopper), one nvcc
process per source, all started together, each in a session of its own,
then links them into one shared library with a plain C interface, at
first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <src>.o <src>.cu          (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/heif_tpu_torch/libheif_kernels_<hash>.so *.o

The file name carries a hash of the sources (headers included) and
flags, so an edited source rebuilds and an unchanged one loads the
existing library. The library is loaded with ctypes; pointers and the
CUDA stream are passed as void*, and each launcher returns
cudaGetLastError(). A failed build raises with nvcc's stderr: there is
no fallback. When one compile fails, the others are killed with their
whole process group (nvcc's cicc, ptxas and host compiler included), so
a failed build leaves no process behind.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "heif_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = 0.0  # wall time of the build that produced the loaded library

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ip = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # plane, res, pcm, steps, src, counts, units, n, S, U, HP, WP, HR, WR,
    # bd, strong, ctb_log2, stream
    "heif_intra_luma": [_vp] * 7 + [_i] * 10 + [_vp],
    # cb, cr, res_cb, res_cr, pcm_cb, pcm_cr, steps, src, counts, units, n,
    # S, U, HP, WP, HR, WR, bd, ctb_log2, stream
    "heif_intra_chroma2": [_vp] * 10 + [_i] * 9 + [_vp],
    # bins, state, words, c0, kinds, slots, tbl, B, W, S, stream
    "heif_cabac_replay": [_vp] * 7 + [_i] * 3 + [_vp],
    # bins, state, windows, biw0, c0p, kinds, slots, tbl, B, nb, w_blk,
    # blk, stream
    "heif_cabac_windowed": [_vp] * 8 + [_i] * 4 + [_vp],
    # events, dbg, state, words, tape, c0, tbl, sb_fwd, sb_inv, co_fwd,
    # co_inv, sig4, B, W, S_env, S, stream
    "heif_cabac_gen": [_vp] * 12 + [_i] * 4 + [_vp],
    # y, cb, cr, y_in, cb_in, cr_in, (batch, row) strides of the three
    # inputs, vert_edges, horiz_edges, qp, nf, beta, tc, cqp, n, H, W,
    # beta_off, tc_off, cb_off, cr_off, bd_y, bd_c, stream
    "heif_deblock": [_vp] * 6 + [_ll] * 6 + [_vp] * 7 + [_i] * 9 + [_vp],
    # y, cb, cr, y_in, cb_in, cr_in, strides as above, sao, nf, n, H, W,
    # R, C, ctb_log2, bd_y, bd_c, stream
    "heif_sao": [_vp] * 6 + [_ll] * 6 + [_vp] * 2 + [_i] * 8 + [_vp],
    # classes (ResClass array), n_classes, stream
    "heif_residual": [_vp, _i, _vp],
    # steps_y, out_y, n_y, S_y, F_y, steps_c, out_c, n_c, S_c, F_c, W, H,
    # ctb_log2, col_bd, n_col, row_bd, n_row, stream
    "heif_ref_sources2": ([_vp] * 2 + [_i] * 3) * 2 + [_i] * 3
                         + [_ip, _i, _ip, _i, _vp],
}


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "heif_tpu_torch CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libheif_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library (if absent); return it."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        try:
            for src in (p for p in _sources() if p.suffix == ".cu"):
                obj = os.path.join(tmpdir, src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, start_new_session=True)))
                objs.append(obj)
            for cmd, proc in procs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    # nvcc leads its own group: kill its children with it
                    with contextlib.suppress(ProcessLookupError):
                        os.killpg(proc.pid, signal.SIGKILL)
                    proc.communicate()
        so = os.path.join(tmpdir, out.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        # atomic: a concurrent build never sees a partial file
        os.replace(so, out)
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """The loaded kernel library (built on first call), argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
