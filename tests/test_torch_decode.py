"""heif_tpu_torch packer copy, batched slice and decode entry vs heif_tpu.

- pack_batch / schedule_hints: the port's numpy copy must equal
  heif_tpu.ops.batch's, field by field, so drift in the copy is caught;
- reconstruct_batch(device="cpu") vs heif_tpu.ops.batch.reconstruct_batch
  (JAX, CPU) on two halfmoonbay tiles and on synthetic batches;
- the port imports and reconstructs with jax made unimportable;
- HeicDecoder.decode(device="cpu") on small containers (x265 8-bit,
  Main-10, 4:0:0, a 2x2 grid at CTB 64, a tiles-enabled picture, an
  all-PCM picture with a conformance window, a corrupt grid tile) vs
  heif_tpu's decode; the full 48-tile flagship decode under `slow`.
Tolerance 0 throughout.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from heif_tpu import native
from heif_tpu.cabac.syntax import TileSyntaxDecoder
from heif_tpu.container.reader import HeifReader
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.models.decoder import HeicDecoder as RefDecoder
from heif_tpu.ops import batch as JB
from heif_tpu.utils.heif_mux import mux_heic
from heif_tpu_torch.utils.profiling import DecodeStats
from heif_tpu_torch import HeicDecoder
from heif_tpu_torch.ops import batch as TB
from heif_tpu_torch.utils.synthetic import synthetic_batch

ROOT = Path(__file__).resolve().parent.parent
TILES = (1, 24)


def _flagship(data: bytes, tiles):
    r = HeifReader(data)
    rec = r.read().hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    slices = [
        sl.parse_slice_header(
            sl.split_length_prefixed_nals(r.get_item_data(t), 4)[0], sps, pps)
        for t in tiles
    ]
    if native.available():
        sts = native.decode_tiles_parallel(sps, pps, slices)
    else:
        sts = [TileSyntaxDecoder(sps, pps, ps).decode() for ps in slices]
    return sts, sps, pps, slices


def _batches(kind, halfmoonbay_bytes):
    if kind == "flagship":
        return _flagship(halfmoonbay_bytes, TILES)
    if kind == "synthetic8":
        return synthetic_batch(n=2, size=64, height=96, bd=8, pcm=False,
                               seed=21)
    return synthetic_batch(n=2, size=64, bd=10, pcm=True, seed=22)


def _assert_same(a, b, path="plan"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# --------------------------------------------------------------------------
# the host packer copy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["flagship", "synthetic8", "synthetic10pcm"])
def test_pack_batch_copy_matches_heif_tpu(halfmoonbay_bytes, kind):
    sts, sps, pps, slices = _batches(kind, halfmoonbay_bytes)
    got = TB.pack_batch(sts, sps, pps, slices)
    want = JB.pack_batch(sts, sps, pps, slices)
    for f in dataclasses.fields(JB.BatchPlan):
        _assert_same(getattr(got, f.name), getattr(want, f.name), f.name)
    assert TB.CLASSES == JB.CLASSES


def test_pack_batch_copy_shape_overrides(halfmoonbay_bytes):
    sts, sps, pps, slices = _flagship(halfmoonbay_bytes, TILES)
    n_steps, caps = JB._chunk_shapes(sts, len(sts))
    got = TB.pack_batch(sts, sps, pps, slices, n_steps=n_steps,
                        class_caps=caps)
    want = JB.pack_batch(sts, sps, pps, slices, n_steps=n_steps,
                         class_caps=caps)
    for f in dataclasses.fields(JB.BatchPlan):
        _assert_same(getattr(got, f.name), getattr(want, f.name), f.name)
    with pytest.raises(ValueError):
        TB.pack_batch(sts, sps, pps, slices, n_steps=[64, 64, 64])


@pytest.mark.parametrize("ptype,mss,wpp", [(0, 0, False), (3, 0, False),
                                           (0, 8, True), (1, 4, False)])
def test_schedule_hints_copy_matches(ptype, mss, wpp):
    sps, pps, _ = synthetic_batch(n=1, size=64)[1:4]
    pps.entropy_coding_sync_enabled_flag = wpp
    rec = type("Rec", (), {"parallelism_type": ptype,
                           "min_spatial_segmentation_idc": mss})()
    for n_tiles in (1, 48):
        assert TB.schedule_hints(rec, sps, pps, n_tiles) == JB.schedule_hints(
            rec, sps, pps, n_tiles)
    assert TB.schedule_hints(None, sps, pps, 4) == JB.schedule_hints(
        None, sps, pps, 4)


# --------------------------------------------------------------------------
# the batched slice
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["flagship", "synthetic8", "synthetic10pcm"])
def test_reconstruct_batch_matches_jax(halfmoonbay_bytes, kind):
    sts, sps, pps, slices = _batches(kind, halfmoonbay_bytes)
    stats = DecodeStats()
    got = TB.reconstruct_batch(TB.pack_batch(sts, sps, pps, slices), "cpu",
                               stats=stats)
    want = JB.reconstruct_batch(JB.pack_batch(sts, sps, pps, slices))
    for c in range(3):
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c])
    assert {"h2d", "residual", "intra", "deblock", "sao", "d2h"} <= set(
        stats.stages)


def test_port_runs_without_jax():
    """With jax unimportable the port imports and reconstructs."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import heif_tpu_torch
        from heif_tpu_torch.ops import batch as TB
        from heif_tpu_torch.utils.synthetic import synthetic_batch
        planes = TB.reconstruct_batch(
            TB.pack_batch(*synthetic_batch(n=2, size=64, bd=10)), "cpu")
        assert [p.shape for p in planes] == [(2, 64, 64), (2, 32, 32),
                                             (2, 32, 32)]
        assert not [m for m in sys.modules if m.startswith("jax.")]
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported(line: str) -> list[str]:
    """Module names an import statement brings in."""
    words = line.replace(",", " ").replace("(", " ").split()
    if words[0] == "import":
        return [w for w in words[1:] if w != "as"]
    return [words[1]] + [f"{words[1]}.{w}" for w in words[3:] if w != "as"]


def test_port_sources_never_import_jax():
    """No import in the port names jax or a heif_tpu module that imports
    it at module level (ops.batch, ops.jax_recon, ops.pallas_*, parallel)."""
    banned = ("jax", "heif_tpu.ops.batch", "heif_tpu.ops.jax_recon",
              "heif_tpu.ops.pallas", "heif_tpu.parallel")
    for path in (ROOT / "heif_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                for mod in _imported(s):
                    assert not mod.startswith(banned), f"{path}: {s}"


# --------------------------------------------------------------------------
# the decode entry on small containers
# --------------------------------------------------------------------------


def _x265_planes(rng, h, w, bd=8):
    mx = (1 << bd) - 1
    y = rng.integers(0, mx + 1, (h, w), np.int32)
    y = (y + np.roll(y, 1, 0) + np.roll(y, 1, 1) + np.roll(y, 2, 1)) // 4
    cb = rng.integers(mx // 4, 3 * mx // 4, (h // 2, w // 2), np.int32)
    cr = rng.integers(mx // 4, 3 * mx // 4, (h // 2, w // 2), np.int32)
    dt = np.uint8 if bd == 8 else np.uint16
    return y.astype(dt), cb.astype(dt), cr.astype(dt)


def _container(kind):
    from heif_tpu.utils import hevc_synth, x265enc

    rng = np.random.default_rng(len(kind))
    if kind == "tiles":
        return mux_heic([hevc_synth.synthesize_tiled_intra_stream(
            96, 64, (2, 2), seed=3)])
    if kind == "pcm_window":
        y = rng.integers(0, 256, (64, 96)).astype(np.uint8)
        cb = rng.integers(0, 256, (32, 48)).astype(np.uint8)
        cr = rng.integers(0, 256, (32, 48)).astype(np.uint8)
        return mux_heic([hevc_synth.synthesize_pcm_stream(
            y, cb, cr, conf_win=(2, 1, 3, 0))])
    bd = 10 if kind == "main10" else 8
    if not x265enc.available(bd):
        pytest.skip(f"{bd}-bit libx265 unavailable")
    if kind == "mono":
        y, _, _ = _x265_planes(rng, 128, 192)
        return mux_heic([x265enc.encode_i_frame(y, None, None, qp=28,
                                                csp="i400")])
    if kind == "grid":
        streams = [x265enc.encode_i_frame(*_x265_planes(rng, 64, 96), qp=30)
                   for _ in range(4)]
        return mux_heic(streams, grid=(2, 2, 2 * 96 - 8, 2 * 64 - 6), irot=1)
    return mux_heic([x265enc.encode_i_frame(
        *_x265_planes(rng, 128, 192, bd), qp=24 if bd == 10 else 28,
        bit_depth=bd)])


@pytest.mark.parametrize(
    "kind", ["8bit", "main10", "mono", "grid", "tiles", "pcm_window"])
def test_decode_container_matches_heif_tpu(kind):
    heic = _container(kind)
    stats = DecodeStats()
    got = HeicDecoder.decode(heic, device="cpu", stats=stats)
    want = RefDecoder.decode(heic, backend="ref")
    assert dataclasses.asdict(got["info"]) == dataclasses.asdict(want["info"])
    for k in ("Y", "Cb", "Cr"):
        if want[k] is None:
            assert got[k] is None
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert stats.tiles >= 1 and stats.megapixels > 0
    assert {"entropy", "pack", "intra", "stitch"} <= set(stats.stages)


def test_decode_isolates_a_corrupt_tile():
    heic = _container("grid")
    r = HeifReader(heic)
    heif = r.read()
    tids = heif.item_ids_referencing(heif.primary_item_id(), "dimg")
    payload = r.get_item_data(tids[1])
    off = heic.find(payload)
    bad = bytearray(heic)
    bad[off : off + 4] = b"\xff\xff\xff\xff"  # absurd NAL length
    stats = DecodeStats()
    got = HeicDecoder.decode(bytes(bad), device="cpu", apply_rotation=False,
                             isolate_tile_errors=True, stats=stats)
    want = RefDecoder.decode(bytes(bad), backend="ref", apply_rotation=False,
                             isolate_tile_errors=True)
    assert stats.tile_errors == 1 and 1 in stats.errors
    for k in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["Y"][:64, 96 : 2 * 96] == 128).all()
    with pytest.raises(Exception):
        HeicDecoder.decode(bytes(bad), device="cpu")


def test_decode_refuses_what_it_cannot_do(halfmoonbay_bytes):
    if torch.cuda.device_count() < 2:
        # a mesh of CUDA devices that do not exist
        with pytest.raises(RuntimeError, match="CUDA"):
            HeicDecoder.decode(halfmoonbay_bytes, mesh_devices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            HeicDecoder.decode(halfmoonbay_bytes)
    assert dataclasses.asdict(HeicDecoder.probe(halfmoonbay_bytes)) == (
        dataclasses.asdict(RefDecoder.probe(halfmoonbay_bytes)))


@pytest.mark.slow
def test_flagship_decode_cpu_matches_heif_tpu(halfmoonbay_bytes):
    """All 48 tiles through the port's CPU path vs heif_tpu's JAX path."""
    got = HeicDecoder.decode(halfmoonbay_bytes, device="cpu")
    want = RefDecoder.decode(halfmoonbay_bytes, backend="jax")
    for k in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(got[k], want[k])
