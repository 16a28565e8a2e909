"""The port's own copies of heif_tpu's JAX-free layers, held against the
originals on the same inputs, tolerance 0.

heif_tpu_torch carries copies of heif_tpu's container, hevc and cabac
layers, ops.tables (as ops.ref_tables), ops.ref_recon, the native entropy
decoder (built from heif_tpu_torch/native/entropy.cpp into build/), the
decoder's probe / _stitch and the synthetic SPS / PPS, so that it imports
nothing of heif_tpu. Each case below runs the copy and the original on
the same input and compares every field or array:
- the flagship's box tree (item table, references, item locations,
  properties with ispe / irot / hvcC), its grid, and its hvcC record;
- tile 0's SPS, PPS and slice header, field by field;
- the native entropy output of tile 0 (every _TileOutput array) and the
  native pre-pack;
- tile 0's host trace and envelope tape (cabac.syntax, engine, trace,
  envelope);
- ref_recon's planes of tile 0;
- the CABAC engine tables, the scan tables and the reconstruction tables;
- probe and _stitch;
- the synthetic SPS / PPS / slice header;
- the fixture modules: hevc_synth's VPS / SPS / PPS (conformance window
  included), PCM streams (nal_type 20 and 21) and tiled intra streams
  (seeds 0-2); heif_mux's containers (a single item, a grid with irot,
  extra_item_nals, the committed Main-10 and 4:0:0 streams); where libx265
  is present, x265enc's 8- and 10-bit encodes with the encode cache off.
And the port's entropy library lands under build/, never in
heif_tpu/native/; a library that fails to build, or has another ABI,
makes a decode raise rather than fall back to the Python entropy path.
"""

import dataclasses
import enum
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from heif_tpu import native as ref_native
from heif_tpu.cabac import engine as ref_engine
from heif_tpu.cabac import envelope as ref_envelope
from heif_tpu.cabac import trace as ref_trace
from heif_tpu.container import reader as ref_reader
from heif_tpu.hevc import params as ref_params
from heif_tpu.hevc import scans as ref_scans
from heif_tpu.hevc import slice as ref_slice
from heif_tpu.hevc.rbsp import remove_emulation_prevention as ref_unescape
from heif_tpu.models.decoder import HeicDecoder as RefDecoder
from heif_tpu.ops import ref_recon as ref_recon
from heif_tpu.ops import tables as ref_tables
from heif_tpu.utils import heif_mux as ref_heif_mux
from heif_tpu.utils import hevc_synth as ref_hevc_synth
from heif_tpu.utils import synthetic as ref_synthetic
from heif_tpu.utils import x265enc as ref_x265enc
from heif_tpu_torch import HeicDecoder, native
from heif_tpu_torch.cabac import engine, envelope, trace
from heif_tpu_torch.container import reader
from heif_tpu_torch.hevc import params, scans
from heif_tpu_torch.hevc import slice as sl
from heif_tpu_torch.hevc.rbsp import remove_emulation_prevention as unescape
from heif_tpu_torch.ops import ref_recon, ref_tables as tables
from heif_tpu_torch.utils import heif_mux, hevc_synth, synthetic, x265enc

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "assets" / "torch"


def plain(v):
    """A comparable value: dataclasses as dicts, enums as their values,
    byte buffers as bytes, arrays as (dtype, shape, bytes)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    if isinstance(v, np.ndarray):
        return (str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, dict):
        return {plain(k): plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _headers(mod_reader, mod_params, mod_slice, unesc, data, tile=0):
    r = mod_reader.HeifReader(data)
    heif = r.read()
    rec = heif.hevc_configuration_record()
    sps = mod_params.parse_sps(unesc(rec.nal_units_of_type(33)[0][2:]))
    pps = mod_params.parse_pps(unesc(rec.nal_units_of_type(34)[0][2:]))
    tid = heif.item_ids_referencing(heif.primary_item_id(), "dimg")[tile]
    ps = mod_slice.parse_slice_header(
        mod_slice.split_length_prefixed_nals(r.get_item_data(tid), 4)[0],
        sps, pps)
    return r, heif, sps, pps, ps


@pytest.fixture(scope="module")
def both(halfmoonbay_bytes):
    """(port, reference) headers of flagship tile 0."""
    return (_headers(reader, params, sl, unescape, halfmoonbay_bytes),
            _headers(ref_reader, ref_params, ref_slice, ref_unescape,
                     halfmoonbay_bytes))


@pytest.fixture(scope="module")
def entropy(both):
    """(port, reference) native entropy output of tile 0."""
    (_, _, sps, pps, ps), (_, _, rsps, rpps, rps) = both
    return (native.decode_tile_native(sps, pps, ps),
            ref_native.decode_tile_native(rsps, rpps, rps))


def _syntax(st):
    return {k: plain(getattr(st, k)) for k in (
        "width", "height", "chroma_format_idc", "coeffs", "tu_table",
        "intra_mode_y", "intra_mode_c", "qp_y", "bypass_map", "pcm_map",
        "vert_edges", "horiz_edges", "sao", "pcm_planes")}


def _module_tables(mod):
    return {k: plain(v) for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (np.ndarray, bytes, int, dict,
                                               tuple, list))}


def case_box_tree(both, entropy, data):
    return plain(both[0][1]), plain(both[1][1])


def case_grid(both, entropy, data):
    (r, heif, *_), (rr, rheif, *_) = both
    return (plain(reader.parse_grid_config(r.get_item_data(heif.primary_item_id()))),
            plain(ref_reader.parse_grid_config(
                rr.get_item_data(rheif.primary_item_id()))))


def case_hvcc(both, entropy, data):
    return (plain(both[0][1].hevc_configuration_record()),
            plain(both[1][1].hevc_configuration_record()))


def case_sps(both, entropy, data):
    return plain(both[0][2]), plain(both[1][2])


def case_pps(both, entropy, data):
    return plain(both[0][3]), plain(both[1][3])


def case_slice_header(both, entropy, data):
    return plain(both[0][4].header), plain(both[1][4].header)


def case_native_entropy(both, entropy, data):
    return _syntax(entropy[0]), _syntax(entropy[1])


def case_native_pack(both, entropy, data):
    got, want = entropy
    native.pack_tile_native(got, 32)
    ref_native.pack_tile_native(want, 32)
    return plain(got.packed), plain(want.packed)


def case_host_trace(both, entropy, data):
    (_, _, sps, pps, ps), (_, _, rsps, rpps, rps) = both
    return (plain(trace.trace_tile(sps, pps, ps)),
            plain(ref_trace.trace_tile(rsps, rpps, rps)))


def case_envelope(both, entropy, data):
    (_, _, sps, pps, ps), (_, _, rsps, rpps, rps) = both
    got = envelope.envelope_trace(sps, pps, ps)
    want = ref_envelope.envelope_trace(rsps, rpps, rps)
    tapes = [plain(envelope.build_envelope_tape(got, i))
             for i in range(len(got.segments))]
    rtapes = [plain(ref_envelope.build_envelope_tape(want, i))
              for i in range(len(want.segments))]
    return ((plain(got.segments), plain(got.spans), tapes),
            (plain(want.segments), plain(want.spans), rtapes))


def case_ref_recon(both, entropy, data):
    (_, _, sps, pps, ps), (_, _, rsps, rpps, rps) = both
    return (plain(ref_recon.reconstruct_tile(entropy[0], sps, pps, ps.header)),
            plain(ref_recon.reconstruct_tile(entropy[1], rsps, rpps,
                                             rps.header)))


def case_engine_tables(both, entropy, data):
    got = _module_tables(engine)
    want = _module_tables(ref_engine)
    got["init"] = [plain(engine.init_context_state(q)) for q in range(52)]
    want["init"] = [plain(ref_engine.init_context_state(q)) for q in range(52)]
    return got, want


def case_scan_tables(both, entropy, data):
    def tabs(m):
        return ([plain(m.scan_order(s, i)) for s in (2, 4, 8) for i in range(3)]
                + [plain(m.scan_pos_of(s, i)) for s in (2, 4, 8) for i in range(3)]
                + [m.intra_scan_idx(lg, mode, c, cf) for lg in range(2, 6)
                   for mode in range(35) for c in range(3) for cf in (0, 1, 2)])
    return tabs(scans), tabs(ref_scans)


def case_recon_tables(both, entropy, data):
    sps = both[0][2]

    def tabs(m):
        return (_module_tables(m), [plain(m.dct_matrix(n)) for n in (4, 8, 16, 32)],
                [m.intra_angle(mode) for mode in range(2, 35)],
                [m.inv_angle(a) for a in (-2, -5, -9, -13, -17, -21, -26, -32)],
                [plain(m.scaling_factor_matrix(s, i, sps.effective_scaling_lists()))
                 for s in (4, 8, 16, 32) for i in range(3)])
    return tabs(tables), tabs(ref_tables)


def case_probe(both, entropy, data):
    return plain(HeicDecoder.probe(data)), plain(RefDecoder.probe(data))


def case_stitch(both, entropy, data):
    rng = np.random.default_rng(5)
    sps = both[0][2]
    info = HeicDecoder.probe(data)
    th, tw = 64, 96
    small = dataclasses.replace(sps, pic_width_in_luma_samples=tw,
                                pic_height_in_luma_samples=th)
    grid = dataclasses.replace(info.grid, rows=2, columns=3,
                               output_width=3 * tw - 10, output_height=2 * th - 6)
    tiles = [[rng.integers(0, 256, (th, tw)).astype(np.uint8),
              rng.integers(0, 256, (th // 2, tw // 2)).astype(np.uint8),
              rng.integers(0, 256, (th // 2, tw // 2)).astype(np.uint8)]
             for _ in range(6)]
    got = [plain(HeicDecoder._stitch(tiles, grid, small, True, a)) for a in range(4)]
    want = [plain(RefDecoder._stitch(tiles, grid, small, True, a)) for a in range(4)]
    rgb = plain(HeicDecoder.to_rgb(HeicDecoder._stitch(tiles, grid, small, True, 1)))
    rrgb = plain(RefDecoder.to_rgb(RefDecoder._stitch(tiles, grid, small, True, 1)))
    return (got, rgb), (want, rrgb)


def case_synthetic_sps_pps(both, entropy, data):
    return (plain(synthetic.synthetic_sps_pps(96)),
            plain(ref_synthetic.synthetic_sps_pps(96)))


def _pcm_planes(seed, h=64, w=96):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))


def case_synth_parameter_sets(both, entropy, data):
    def sets(m):
        return [m.write_vps(), m.write_sps(96, 64), m.write_sps(
            128, 64, ctb_log2=4, min_cb_log2=3, pcm=False), m.write_sps(
            96, 64, pcm_log2=3, pcm_bd=7, conf_win=(2, 1, 3, 0)),
            m.write_pps(), m.write_pps(tiles=(2, 2)), m.write_pps(tiles=(3, 1))]
    return sets(hevc_synth), sets(ref_hevc_synth)


def case_synth_pcm_streams(both, entropy, data):
    def streams(m):
        return [m.synthesize_pcm_stream(*_pcm_planes(1), nal_type=t,
                                        conf_win=cw)
                for t in (20, 21) for cw in (None, (2, 1, 3, 0))]
    return streams(hevc_synth), streams(ref_hevc_synth)


def case_synth_tiled_streams(both, entropy, data):
    def streams(m):
        return [m.synthesize_tiled_intra_stream(96, 64, (2, 2), seed=s)
                for s in range(3)] + [
            m.synthesize_tiled_intra_stream(128, 96, (3, 2), seed=s)
            for s in range(3)]
    return streams(hevc_synth), streams(ref_hevc_synth)


def case_mux(both, entropy, data):
    pcm = [hevc_synth.synthesize_pcm_stream(*_pcm_planes(s, 64, 64))
           for s in range(4)]
    sei = b"\x4e\x01\x05\x02\xaa\xbb\x80"  # a prefix SEI NAL

    def containers(m):
        return [m.mux_heic(pcm[:1]), m.mux_heic(pcm, grid=(2, 2, 120, 124),
                                                irot=1),
                m.mux_heic(pcm[:1], irot=3, extra_item_nals=[sei]),
                m.mux_heic(pcm, grid=(2, 2, 128, 128), extra_item_nals=[sei]),
                m.mux_heic([(FIXTURES / "main10.hevc").read_bytes()]),
                m.mux_heic([(FIXTURES / "mono.hevc").read_bytes()], irot=2)]
    return containers(heif_mux), containers(ref_heif_mux)


def _x265_case(bit_depth):
    if not (x265enc.available(bit_depth) and ref_x265enc.available(bit_depth)):
        pytest.skip(f"{bit_depth}-bit libx265 unavailable")
    rng = np.random.default_rng(bit_depth)
    mx = (1 << bit_depth) - 1
    dt = np.uint8 if bit_depth == 8 else np.uint16
    y = rng.integers(0, mx + 1, (64, 96)).astype(dt)
    cb = rng.integers(0, mx + 1, (32, 48)).astype(dt)
    cr = rng.integers(0, mx + 1, (32, 48)).astype(dt)

    def encodes(m):
        return [m.encode_i_frame(y, cb, cr, qp=30, bit_depth=bit_depth),
                m.encode_i_frame(y, cb, cr, qp=22, bit_depth=bit_depth,
                                 options={"wpp": "0", "ctu": "16"}),
                m.encode_i_frame(y, None, None, qp=28, bit_depth=bit_depth,
                                 csp="i400")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HEIF_TPU_NO_X265_CACHE", "1")
        assert x265enc._cache_dir() is None
        return encodes(x265enc), encodes(ref_x265enc)


def case_x265_cache_dir(both, entropy, data):
    """The same cache directory, tests/assets/.x265cache/ by default."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("HEIF_TPU_NO_X265_CACHE", "HEIF_TPU_X265_CACHE"):
            mp.delenv(var, raising=False)
        got, want = x265enc._cache_dir(), ref_x265enc._cache_dir()
    assert Path(got) == ROOT / "tests" / "assets" / ".x265cache"
    return got, want


def case_x265_8bit(both, entropy, data):
    return _x265_case(8)


def case_x265_10bit(both, entropy, data):
    return _x265_case(10)


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_matches_original(case, both, entropy, halfmoonbay_bytes):
    got, want = CASES[case](both, entropy, halfmoonbay_bytes)
    assert got == want


def test_entropy_library_is_built_into_build_dir(tmp_path):
    """The port's library is built from its own entropy.cpp, under a
    hashed name in build/, through a temporary file; building it leaves
    every file of heif_tpu/native/ as it was."""
    ref_dir = ROOT / "heif_tpu" / "native"
    products = {"libheif_entropy.so", "entropy.gcda"}  # heif_tpu's own make

    def snapshot():
        return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
                for p in ref_dir.iterdir() if p.name not in products}

    before = snapshot()
    code = textwrap.dedent("""
        import sys
        from pathlib import Path
        from heif_tpu_torch import native
        native.BUILD_DIR = Path(sys.argv[1])
        out = native.build()
        assert native.available()
        print(out)
    """)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "b")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    built = Path(proc.stdout.strip().splitlines()[-1])
    assert built.parent == tmp_path / "b" and built.exists()
    assert built.name == native.library_path().name
    assert not [p for p in built.parent.iterdir() if p != built]  # no temp left
    assert snapshot() == before
    assert native.SOURCE == ROOT / "heif_tpu_torch" / "native" / "entropy.cpp"
    assert native.BUILD_DIR == ROOT / "build" / "heif_tpu_torch"
    assert native.library_path().name.startswith("libheif_entropy_")
    assert not list(ref_dir.glob("libheif_entropy_*.so"))


@pytest.mark.parametrize("source,error", [
    ("this is not C++\n", "entropy library build failed"),
    ('extern "C" int heif_entropy_abi_version() { return 3; }\n',
     "entropy library ABI 3, expected 5"),
])
def test_bad_entropy_library_makes_decode_raise(monkeypatch, tmp_path,
                                                halfmoonbay_bytes, source,
                                                error):
    """With a compiler present, a library that does not build or has
    the wrong ABI raises from the container and the raw-stream decode;
    neither quietly decodes entropy in Python."""
    from heif_tpu_torch.utils.annexb import tile_annexb

    bad = tmp_path / "entropy.cpp"
    bad.write_text(source)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    with pytest.raises(RuntimeError, match=error):
        HeicDecoder.decode(halfmoonbay_bytes, device="cpu")
    with pytest.raises(RuntimeError, match=error):
        HeicDecoder.decode_hevc(tile_annexb(halfmoonbay_bytes, 0),
                                device="cpu")
