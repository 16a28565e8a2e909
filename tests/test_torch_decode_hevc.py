"""heif_tpu_torch raw-HEVC decode and CLI vs heif_tpu (bit-exact).

- HeicDecoder.decode_hevc(device="cpu") on flagship tile 0 as an Annex-B
  stream, with both entropy front ends, vs heif_tpu's numpy reference
  (ref_recon of the native-entropy syntax);
- an x265-encoded 32x32 stream (when libx265 is present) through the
  port vs heif_tpu.HeicDecoder.decode_hevc(entropy="device-gen") and vs
  libde265;
- the CLI (python -m heif_tpu_torch): probe and decode of the Annex-B
  tile, the raw-input detection and the options it refuses, and --mesh
  on a container;
- the new modules import and run with jax unimportable.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from heif_tpu import native
from heif_tpu.cabac.syntax import TileSyntaxDecoder
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.ops.ref_recon import reconstruct_tile
from heif_tpu.utils import oracle, x265enc
from heif_tpu_torch import HeicDecoder
from heif_tpu_torch import cli
from heif_tpu_torch.utils.annexb import tile_annexb

ROOT = Path(__file__).resolve().parents[1]


def _parse(stream):
    sps = pps = vcl = None
    for nal in sl.split_annexb_nals(stream):
        k = (nal[0] >> 1) & 0x3F
        if k == 33:
            sps = params.parse_sps(remove_emulation_prevention(nal[2:]))
        elif k == 34:
            pps = params.parse_pps(remove_emulation_prevention(nal[2:]))
        elif k <= 31 and vcl is None:
            vcl = nal
    return sps, pps, sl.parse_slice_header(vcl, sps, pps)


@pytest.fixture(scope="module")
def tile0(halfmoonbay_bytes):
    """Flagship tile 0 as an Annex-B stream, and ref_recon of it."""
    stream = tile_annexb(halfmoonbay_bytes, 0)
    sps, pps, ps = _parse(stream)
    if native.available():
        st = native.decode_tile_native(sps, pps, ps)
    else:
        st = TileSyntaxDecoder(sps, pps, ps).decode()
    return stream, reconstruct_tile(st, sps, pps, ps.header)


@pytest.fixture(scope="module")
def tile0_file(tile0, tmp_path_factory):
    path = tmp_path_factory.mktemp("annexb") / "tile0.hevc"
    path.write_bytes(tile0[0])
    return path


def test_tile_annexb_is_the_oracle_stream(halfmoonbay_bytes, tile0):
    stream, want = tile0
    assert stream.startswith(b"\x00\x00\x00\x01")
    got = oracle.decode_hevc_annexb(stream)
    for c in range(3):
        np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("entropy", ["auto", "device-gen"])
def test_decode_hevc_tile0_matches_ref_recon(tile0, entropy):
    stream, want = tile0
    got = HeicDecoder.decode_hevc(stream, entropy=entropy, device="cpu")
    for c, k in enumerate(("Y", "Cb", "Cr")):
        assert got[k].dtype == np.uint8
        np.testing.assert_array_equal(got[k], want[c], err_msg=k)
    assert got["sps"].pic_width_in_luma_samples == 512


def test_decode_hevc_refuses(tile0):
    stream = tile0[0]
    with pytest.raises(ValueError, match="backend"):
        HeicDecoder.decode_hevc(stream, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="entropy"):
        HeicDecoder.decode_hevc(stream, entropy="gpu", device="cpu")
    with pytest.raises(ValueError, match="SPS"):
        HeicDecoder.decode_hevc(b"\x00\x00\x01\x40\x01", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            HeicDecoder.decode_hevc(stream)


def _have_x265():
    try:
        return x265enc.available()
    except Exception:
        return False


def test_decode_hevc_device_gen_matches_heif_tpu_on_x265():
    """The 32x32 stream of heif_tpu's own device-gen decode test, through
    the port vs heif_tpu (Pallas generator, interpret mode) and libde265."""
    if not _have_x265():
        pytest.skip("libx265 unavailable")
    from heif_tpu.models.decoder import HeicDecoder as Ref

    rng = np.random.default_rng(9)
    y = np.full((32, 32), 120, np.uint8)
    y[:16, :16] = rng.integers(0, 256, (16, 16))
    cb = np.full((16, 16), 90, np.uint8)
    cr = np.full((16, 16), 150, np.uint8)
    stream = x265enc.encode_i_frame(y, cb, cr, qp=28,
                                    options={"wpp": "0", "ctu": "16"})
    want = oracle.decode_hevc_annexb(stream)
    ref = Ref.decode_hevc(stream, backend="ref", entropy="device-gen")
    for backend in ("torch", "ref"):
        got = HeicDecoder.decode_hevc(stream, backend=backend,
                                      entropy="device-gen", device="cpu")
        for c, k in enumerate(("Y", "Cb", "Cr")):
            np.testing.assert_array_equal(got[k], want[c], err_msg=k)
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def _cli(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "heif_tpu_torch", *map(str, args)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_probe_and_decode_annexb_tile(tile0, tile0_file, tmp_path):
    out = _cli("probe", tile0_file)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout)
    assert info["format"] == "annexb" and info["coded"] == [512, 512]
    assert info["wpp"] and not info["tiles_enabled"]
    npz = tmp_path / "x.npz"
    out = _cli("decode", tile0_file, "--device", "cpu", "-o", npz)
    assert out.returncode == 0, out.stderr
    got = np.load(npz)
    for c, k in enumerate(("Y", "Cb", "Cr")):
        np.testing.assert_array_equal(got[k], tile0[1][c], err_msg=k)


def test_cli_probe_container_matches_heif_tpu(capsys):
    from heif_tpu import cli as ref_cli

    path = ROOT / "tests" / "assets" / "halfmoonbay.heic"
    assert cli.main(["probe", str(path)]) == 0
    ours = capsys.readouterr().out
    assert ref_cli.main(["probe", str(path)]) == 0
    assert json.loads(ours) == json.loads(capsys.readouterr().out)


def test_cli_raw_input_detection(tile0):
    stream = tile0[0]
    assert cli.is_annexb(stream)
    assert cli.is_annexb(b"\x00\x00\x01" + stream[4:])
    # a corrupt container is not raw input, whatever bytes 4-8 hold
    assert not cli.is_annexb(b"\x00\x00\x00\x18ftyp")
    assert not cli.is_annexb(b"\x12\x34\x56\x78abcd")
    assert not cli.is_annexb(b"\x00\x00")


@pytest.mark.parametrize("flag", [["--item", "3"], ["--isolate-errors"],
                                  ["--mesh", "2"]])
def test_cli_refuses_container_options_on_raw_input(tile0_file, flag, capsys):
    assert cli.main(["decode", str(tile0_file), "--device", "cpu", *flag]) == 2
    err = capsys.readouterr().err
    assert flag[0] in err and "raw Annex-B" in err


def test_cli_refuses_device_gen_on_container(capsys):
    path = ROOT / "tests" / "assets" / "halfmoonbay.heic"
    assert cli.main(["decode", str(path), "--device", "cpu",
                     "--entropy", "device-gen"]) == 2
    assert "--entropy device-gen" in capsys.readouterr().err


def test_cli_garbage_input_goes_to_the_container_reader(tmp_path):
    bad = tmp_path / "bad.heic"
    bad.write_bytes(b"\x12\x34\x56\x78" * 16)
    with pytest.raises(Exception) as exc:
        cli.main(["decode", str(bad), "--device", "cpu"])
    assert "Annex" not in str(exc.value)


def test_cli_mesh_on_container_is_not_ported(tmp_path):
    """--mesh on a container goes to the sharded decode: N CPU shards with
    --device cpu (equal to the one-batch decode), the first N CUDA cards
    otherwise (RuntimeError where fewer exist)."""
    from heif_tpu.utils.heif_mux import mux_heic
    from heif_tpu.utils.hevc_synth import synthesize_tiled_intra_stream

    path = tmp_path / "tiles.heic"
    path.write_bytes(mux_heic([synthesize_tiled_intra_stream(
        96, 64, (2, 2), seed=5)]))
    outs = []
    for mesh in (["--mesh", "2"], []):
        dst = tmp_path / f"out{len(mesh)}.npz"
        assert cli.main(["decode", str(path), "--device", "cpu", *mesh,
                         "-o", str(dst)]) == 0
        outs.append(np.load(dst))
    for k in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["decode", str(path), "--mesh", "2"])


def test_new_modules_run_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        import heif_tpu_torch
        from heif_tpu_torch import cli
        from heif_tpu_torch.models import decoder
        from heif_tpu_torch.ops import cabac, cabac_gen
        from heif_tpu_torch.tables import CabacTables
        from heif_tpu_torch.utils import annexb
        CabacTables.build()
        w = torch.zeros((1, 8, 128), dtype=torch.int32)
        c0 = torch.zeros((1, 136, 128), dtype=torch.int32)
        t = torch.full((1, 8, 128), 3, dtype=torch.int32)
        ev, dbg, st = cabac_gen.gen(w, t, c0, 4, debug=True)
        assert ev.shape == (1, 4, 128) and not ev.any()
        assert not [m for m in sys.modules if m.startswith("jax.")]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
