"""Minimal ctypes binding to libx265 for generating test bitstreams (the
port's copy of heif_tpu.utils.x265enc, logic unchanged, held against it
in tests/test_torch_copies.py).

Test-only utility (not part of any decode path): encodes numpy YUV
planes into an HEVC Annex-B byte string with controllable coding-tool
flags, so the test suite can cover syntax branches the single
real-world fixture (halfmoonbay.heic) never exercises — transform
skip, transquant bypass (lossless), sign-data-hiding off, WPP off,
CTU 16/64, QP extremes, Main-10 — each cross-checked bit-exact against
libde265 (mirrors the reference's libheif-oracle doctrine,
tests/libheif_comparison.rs:10-112, extended to pixel planes per
SURVEY.md §4).

Binding strategy: we have no x265.h on this image, so we go through
``x265_api_get_<BUILD>()`` and validate the returned table's embedded
metadata (build number, bit depth, version string) before trusting any
function pointer; the only struct whose layout we rely on beyond that
is the long-stable head of x265_picture (pts..forceqp) and x265_nal.
"""

from __future__ import annotations

import ctypes
from ctypes import (
    POINTER,
    c_char_p,
    c_int,
    c_int64,
    c_uint8,
    c_uint32,
    c_void_p,
)

import numpy as np

_BUILD = 199  # libx265.so.199 (x265 3.5)


class _Nal(ctypes.Structure):
    _fields_ = [
        ("type", c_uint32),
        ("sizeBytes", c_uint32),
        ("payload", POINTER(c_uint8)),
    ]


class _PicturePrefix(ctypes.Structure):
    """Head of x265_picture — stable across x265 2.x/3.x; everything past
    forceqp is initialized by picture_init and never touched here."""

    _fields_ = [
        ("pts", c_int64),
        ("dts", c_int64),
        ("userData", c_void_p),
        ("planes", c_void_p * 3),
        ("stride", c_int * 3),
        ("bitDepth", c_int),
        ("sliceType", c_int),
        ("poc", c_int),
        ("colorSpace", c_int),
        ("forceqp", c_int),
    ]


class _Api(ctypes.Structure):
    """Head of x265_api (x265 3.5 / build 199) — validated at load."""

    _fields_ = [
        ("api_major_version", c_int),
        ("api_build_number", c_int),
        ("sizeof_param", c_int),
        ("sizeof_picture", c_int),
        ("sizeof_analysis_data", c_int),
        ("sizeof_zone", c_int),
        ("sizeof_stats", c_int),
        ("bit_depth", c_int),
        ("version_str", c_char_p),
        ("build_info_str", c_char_p),
        ("param_alloc", ctypes.CFUNCTYPE(c_void_p)),
        ("param_free", ctypes.CFUNCTYPE(None, c_void_p)),
        ("param_default", ctypes.CFUNCTYPE(None, c_void_p)),
        ("param_parse", ctypes.CFUNCTYPE(c_int, c_void_p, c_char_p, c_char_p)),
        ("param_apply_profile", ctypes.CFUNCTYPE(c_int, c_void_p, c_char_p)),
        (
            "param_default_preset",
            ctypes.CFUNCTYPE(c_int, c_void_p, c_char_p, c_char_p),
        ),
        ("picture_alloc", ctypes.CFUNCTYPE(c_void_p)),
        ("picture_free", ctypes.CFUNCTYPE(None, c_void_p)),
        ("picture_init", ctypes.CFUNCTYPE(None, c_void_p, c_void_p)),
        ("encoder_open", ctypes.CFUNCTYPE(c_void_p, c_void_p)),
        ("encoder_parameters", ctypes.CFUNCTYPE(None, c_void_p, c_void_p)),
        ("encoder_reconfig", ctypes.CFUNCTYPE(c_int, c_void_p, c_void_p)),
        ("encoder_reconfig_zone", ctypes.CFUNCTYPE(c_int, c_void_p, c_void_p)),
        (
            "encoder_headers",
            ctypes.CFUNCTYPE(
                c_int, c_void_p, POINTER(POINTER(_Nal)), POINTER(c_uint32)
            ),
        ),
        (
            "encoder_encode",
            ctypes.CFUNCTYPE(
                c_int,
                c_void_p,
                POINTER(POINTER(_Nal)),
                POINTER(c_uint32),
                c_void_p,
                c_void_p,
            ),
        ),
    ]


_api_cache: dict[int, "_Api"] = {}


def _get_api(bit_depth: int) -> _Api:
    if bit_depth in _api_cache:
        return _api_cache[bit_depth]
    lib = ctypes.CDLL(f"libx265.so.{_BUILD}")
    getter = getattr(lib, f"x265_api_get_{_BUILD}")
    getter.restype = POINTER(_Api)
    ptr = getter(bit_depth)
    if not ptr:
        raise RuntimeError(f"libx265 has no {bit_depth}-bit encoder")
    api = ptr.contents
    # layout validation: if any of these mismatch, the struct head above
    # does not match this build and no pointer in it can be trusted
    if api.api_build_number != _BUILD:
        raise RuntimeError(
            f"x265_api layout mismatch: build {api.api_build_number}"
        )
    if api.bit_depth != bit_depth:
        raise RuntimeError(
            f"x265_api layout mismatch: depth {api.bit_depth}"
        )
    ver = (api.version_str or b"").decode(errors="replace")
    if not ver or ver[0] not in "0123456789":
        raise RuntimeError(f"x265_api layout mismatch: version {ver!r}")
    _api_cache[bit_depth] = api
    return api


def available(bit_depth: int = 8) -> bool:
    try:
        _get_api(bit_depth)
        return True
    except (OSError, RuntimeError):
        return False


def _cache_dir() -> "str | None":
    import os

    if os.environ.get("HEIF_TPU_NO_X265_CACHE"):
        return None
    d = os.environ.get(
        "HEIF_TPU_X265_CACHE",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
            "tests", "assets", ".x265cache",
        ),
    )
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def encode_i_frame(
    y: np.ndarray,
    cb: np.ndarray | None,
    cr: np.ndarray | None,
    qp: int = 30,
    bit_depth: int = 8,
    options: dict[str, str] | None = None,
    csp: str = "i420",
) -> bytes:
    """Encode one intra frame to an HEVC Annex-B byte string.

    y: (H, W), cb/cr: (H/2, W/2); uint8 for 8-bit, uint16 for 10-bit.
    options: extra x265 key=value settings (e.g. {"wpp": "0",
    "ctu": "16", "tskip": "1", "lossless": "1", "signhide": "0"}).
    csp: "i420" (default) or "i400" (monochrome; cb/cr may be None —
    emits chroma_format_idc=0 streams like the flagship file's
    auxiliary alpha item).

    Encoded streams are cached on disk keyed by (planes, settings,
    encoder version): the fixture matrix re-encodes identical content
    every test process, and the encodes dominated the fast tier's wall
    time. Delete tests/assets/.x265cache (or set
    HEIF_TPU_NO_X265_CACHE=1) to force fresh encodes.
    """
    api = _get_api(bit_depth)

    import hashlib
    import os

    cdir = _cache_dir()
    cpath = None
    if cdir is not None:
        hsh = hashlib.sha256()
        ver = bytes(api.version_str or b"?")
        hsh.update(
            repr(
                (
                    ver, qp, bit_depth, csp,
                    sorted((options or {}).items()),
                    y.shape, None if cb is None else cb.shape,
                )
            ).encode()
        )
        # file-valued options (scaling-list) key on content, not path
        slist = (options or {}).get("scaling-list")
        if slist and os.path.isfile(slist):
            with open(slist, "rb") as f:
                hsh.update(f.read())
        hsh.update(np.ascontiguousarray(y).tobytes())
        if cb is not None and csp != "i400":
            hsh.update(np.ascontiguousarray(cb).tobytes())
            hsh.update(np.ascontiguousarray(cr).tobytes())
        cpath = os.path.join(cdir, hsh.hexdigest() + ".hevc")
        try:
            with open(cpath, "rb") as f:
                return f.read()
        except OSError:
            pass
    h, w = y.shape
    mono = csp == "i400"
    dt = np.uint8 if bit_depth == 8 else np.uint16
    y = np.ascontiguousarray(y, dtype=dt)
    if mono:
        cb = cr = None
    else:
        assert cb.shape == cr.shape == (h // 2, w // 2)
        cb = np.ascontiguousarray(cb, dtype=dt)
        cr = np.ascontiguousarray(cr, dtype=dt)

    param = api.param_alloc()
    if not param:
        raise RuntimeError("x265_param_alloc failed")
    try:
        if api.param_default_preset(param, b"medium", None) != 0:
            raise RuntimeError("param_default_preset failed")

        def setp(k: str, v: str):
            if api.param_parse(param, k.encode(), v.encode()) != 0:
                raise RuntimeError(f"x265 rejected {k}={v}")

        # (input/output-depth are CLI-only options; the encoding depth is
        # fixed by which api table we fetched, pic.bitDepth covers input)
        setp("input-res", f"{w}x{h}")
        setp("fps", "1")
        setp("input-csp", csp)
        base = {
            "qp": str(qp),
            "keyint": "1",
            "frame-threads": "1",
            "pools": "1",
            "wpp": "1",
            "sao": "1",
            "info": "0",
            "temporal-layers": "0",
            "bframes": "0",
            "rc-lookahead": "0",
            "lookahead-slices": "0",
            "annexb": "1",
            "repeat-headers": "0",
            "aud": "0",
            "hrd": "0",
        }
        base.update(options or {})
        for k, v in base.items():
            setp(k, v)
        if mono:
            # 4:0:0 needs a Rext profile; let the encoder derive it from
            # the csp instead of forcing main/main10
            prof = None
        else:
            prof = b"main" if bit_depth == 8 else b"main10"
        if prof is not None and api.param_apply_profile(param, prof) != 0:
            raise RuntimeError(f"profile {prof!r} rejected")

        enc = api.encoder_open(param)
        if not enc:
            raise RuntimeError("x265_encoder_open failed")
        try:
            out = bytearray()
            nals = POINTER(_Nal)()
            n_nal = c_uint32()

            def drain():
                for i in range(n_nal.value):
                    nal = nals[i]
                    out.extend(ctypes.string_at(nal.payload, nal.sizeBytes))

            if api.encoder_headers(enc, ctypes.byref(nals),
                                   ctypes.byref(n_nal)) < 0:
                raise RuntimeError("encoder_headers failed")
            drain()

            pic = api.picture_alloc()
            if not pic:
                raise RuntimeError("x265_picture_alloc failed")
            try:
                api.picture_init(param, pic)
                pp = ctypes.cast(pic, POINTER(_PicturePrefix)).contents
                pp.planes[0] = y.ctypes.data
                nbytes = 1 if bit_depth == 8 else 2
                pp.stride[0] = w * nbytes
                if mono:
                    pp.planes[1] = None
                    pp.planes[2] = None
                    pp.stride[1] = 0
                    pp.stride[2] = 0
                else:
                    pp.planes[1] = cb.ctypes.data
                    pp.planes[2] = cr.ctypes.data
                    pp.stride[1] = (w // 2) * nbytes
                    pp.stride[2] = (w // 2) * nbytes
                pp.bitDepth = bit_depth

                rc = api.encoder_encode(
                    enc, ctypes.byref(nals), ctypes.byref(n_nal), pic, None
                )
                if rc < 0:
                    raise RuntimeError("encoder_encode failed")
                drain()
                while True:
                    rc = api.encoder_encode(
                        enc, ctypes.byref(nals), ctypes.byref(n_nal), None,
                        None,
                    )
                    if rc < 0:
                        raise RuntimeError("encoder_encode flush failed")
                    drain()
                    if rc == 0:
                        break
            finally:
                api.picture_free(pic)
        finally:
            # encoder_close is past the validated prefix; leak the encoder
            # handle instead of calling through an unverified pointer —
            # fixture generation is a short-lived test process.
            pass
        stream = bytes(out)
        if cpath is not None:
            try:  # atomic publish: concurrent test processes may race
                tmp = cpath + f".tmp{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(stream)
                os.replace(tmp, cpath)
            except OSError:
                pass
        return stream
    finally:
        api.param_free(param)
