"""heif_tpu_torch multi-device tile split vs heif_tpu, tolerance 0.

- decode_grid_sharded and decode_grid_sharded_streamed over a mesh of
  two CPU devices equal reconstruct_tiles on uneven tile counts;
- HeicDecoder.decode(mesh_devices=N, device="cpu") on a grid and on a
  tiles-enabled picture equals heif_tpu's decode(backend="ref");
- decode_burst_sharded in one process over a CPU mesh, in one gloo
  process through `python -m heif_tpu_torch.parallel.distributed`, and
  in two gloo processes (rank 0 checks the planes against heif_tpu);
- init_distributed without its environment, BurstResult, make_mesh.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from heif_tpu import native
from heif_tpu.cabac.syntax import TileSyntaxDecoder
from heif_tpu.models.decoder import HeicDecoder as RefDecoder
from heif_tpu.utils import hevc_synth
from heif_tpu.utils.heif_mux import mux_heic
from heif_tpu_torch.utils.profiling import DecodeStats
from heif_tpu_torch import HeicDecoder
from heif_tpu_torch.ops import batch as TB
from heif_tpu_torch.parallel import distributed as D
from heif_tpu_torch.parallel import pipeline as P

ROOT = Path(__file__).resolve().parent.parent
ENV_NAMES = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
             "JAX_NUM_PROCESSES", "NUM_PROCESSES", "JAX_PROCESS_ID",
             "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _pcm_grid() -> bytes:
    """2x2 grid of 64x64 all-PCM tiles, cropped to 120x122."""
    rng = np.random.default_rng(17)
    streams = []
    for _ in range(4):
        y = rng.integers(0, 256, (64, 64)).astype(np.uint8)
        cb = rng.integers(0, 256, (32, 32)).astype(np.uint8)
        cr = rng.integers(0, 256, (32, 32)).astype(np.uint8)
        streams.append(hevc_synth.synthesize_pcm_stream(y, cb, cr))
    return mux_heic(streams, grid=(2, 2, 2 * 64 - 8, 2 * 64 - 6))


def _x265_grid() -> bytes:
    from heif_tpu.utils import x265enc

    if not x265enc.available(8):
        pytest.skip("8-bit libx265 unavailable")
    rng = np.random.default_rng(4)
    streams = []
    for _ in range(4):
        y = rng.integers(0, 256, (64, 96), np.int32)
        y = (y + np.roll(y, 1, 0) + np.roll(y, 1, 1) + np.roll(y, 2, 1)) // 4
        cb = rng.integers(64, 192, (32, 48), np.int32)
        cr = rng.integers(64, 192, (32, 48), np.int32)
        streams.append(x265enc.encode_i_frame(
            y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8),
            qp=30))
    return mux_heic(streams, grid=(2, 2, 2 * 96 - 8, 2 * 64 - 6), irot=1)


def _tiles_picture() -> bytes:
    return mux_heic([hevc_synth.synthesize_tiled_intra_stream(
        96, 64, (2, 2), seed=3)])


@pytest.fixture(scope="module")
def flagship3(halfmoonbay_bytes):
    """Three flagship tiles: syntaxes, sps, pps, slices, one-batch stacks."""
    from test_torch_overlap import _parse

    sps, pps, slices = _parse(halfmoonbay_bytes, 3)
    if native.available():
        sts = native.decode_tiles_parallel(sps, pps, slices)
    else:
        sts = [TileSyntaxDecoder(sps, pps, ps).decode() for ps in slices]
    tiles = TB.reconstruct_tiles(sts, sps, pps, slices, device="cpu")
    return sts, sps, pps, slices, [np.stack([t[c] for t in tiles])
                                   for c in range(3)]


@pytest.mark.parametrize("path", ["grid", "streamed"])
def test_sharded_matches_reconstruct_tiles(flagship3, path):
    sts, sps, pps, slices, want = flagship3
    mesh = P.make_mesh(devices=["cpu", "cpu"])
    if path == "grid":
        got = P.decode_grid_sharded(sts, sps, pps, slices, mesh=mesh)
    else:
        got = P.decode_grid_sharded_streamed(sps, pps, slices, mesh=mesh,
                                             chunk=3)
    for c in range(3):
        assert got[c].shape == want[c].shape
        np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("kind,n", [("grid", 2), ("grid", 3), ("tiles", 2)])
def test_decode_on_a_mesh_matches_heif_tpu(kind, n):
    heic = _x265_grid() if kind == "grid" else _tiles_picture()
    stats = DecodeStats()
    got = HeicDecoder.decode(heic, device="cpu", mesh_devices=n, stats=stats)
    want = RefDecoder.decode(heic, backend="ref")
    assert dataclasses.asdict(got["info"]) == dataclasses.asdict(want["info"])
    for k in ("Y", "Cb", "Cr"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert stats.n_devices == n and len(stats.scheduler["mesh"]) == n
    assert {"entropy", "sharded", "stitch"} <= set(stats.stages)


def test_burst_sharded_one_process_cpu_mesh():
    heic = _pcm_grid()
    outs, res = D.decode_burst_sharded(
        [heic, heic], mesh=P.make_mesh(devices=["cpu"] * 3))
    want = RefDecoder.decode(heic, backend="ref", apply_rotation=False)
    assert (res.images, res.tiles, res.n_devices, res.n_processes) == (
        2, 8, 3, 1)
    for out in outs:
        for k in ("Y", "Cb", "Cr"):
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(procs, timeout=120):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ENV_NAMES}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_distributed_module_one_gloo_process(tmp_path):
    """torchrun's variables, a group of one: the module entry decodes and
    writes the planes, equal to heif_tpu."""
    heic = _pcm_grid()
    src, dst = tmp_path / "grid.heic", tmp_path / "out.npz"
    src.write_bytes(heic)
    env = _clean_env(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                     WORLD_SIZE="1", RANK="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "heif_tpu_torch.parallel.distributed",
         str(src), "--device", "cpu", "-o", str(dst)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    (out,) = _run([proc])
    assert proc.returncode == 0, out[-4000:]
    assert '"n_processes": 1' in out and '"tiles": 4' in out
    got = np.load(dst)
    want = RefDecoder.decode(heic, backend="ref", apply_rotation=False)
    for k in ("Y", "Cb", "Cr"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


_TWO_PROC_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    sys.modules["jax"] = None  # the port runs without JAX
    sys.path.insert(0, sys.argv[3])
    from test_torch_sharded import _pcm_grid
    from heif_tpu.models.decoder import HeicDecoder as RefDecoder
    from heif_tpu_torch.parallel import distributed as D

    pid, port = int(sys.argv[1]), sys.argv[2]
    assert D.init_distributed(coordinator_address=f"localhost:{port}",
                              num_processes=2, process_id=pid)
    mesh = D.make_global_mesh()
    assert [d.type for d in mesh] == ["cpu", "cpu"]
    heic = _pcm_grid()
    outs, res = D.decode_burst_sharded([heic, heic], mesh=mesh)
    assert res.n_processes == 2 and res.n_devices == 2
    assert res.images == 2 and res.tiles == 8
    if pid == 0:
        del sys.modules["jax"]  # heif_tpu's decode imports it
        want = RefDecoder.decode(heic, backend="ref", apply_rotation=False)
        for out in outs:
            for k in ("Y", "Cb", "Cr"):
                assert np.array_equal(out[k], want[k]), k
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"proc{pid} OK", flush=True)
""")


def test_two_process_gloo_burst(tmp_path):
    """Two processes form a gloo group on localhost; each decodes its
    shard of a 2x2 PCM grid, the planes meet by all_gather, and rank 0
    holds them against heif_tpu's host reference."""
    script = tmp_path / "worker.py"
    script.write_text(_TWO_PROC_WORKER)
    port = str(_free_port())
    env = _clean_env(JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), port,
             str(Path(__file__).parent)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    outs = _run(procs)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out[-4000:]}"
        assert f"proc{pid} OK" in out


def test_init_distributed_without_env_is_a_noop(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    assert D.init_distributed() is False
    if not torch.cuda.is_available():
        # no group: the global mesh is make_mesh's, which needs CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            D.make_global_mesh()


def test_burst_result_math():
    r = D.BurstResult(images=2, tiles=96, megapixels=24.4, wall_s=2.0,
                      n_devices=8)
    assert r.mp_per_s == pytest.approx(12.2)
    assert r.mp_per_s_per_chip == pytest.approx(1.525)
    assert r.scaling_efficiency(1.525) == pytest.approx(1.0)
    assert r.scaling_efficiency(0.0) == 0.0
    d = r.as_dict()
    assert d["n_devices"] == 8 and d["images"] == 2
    assert D.BurstResult().mp_per_s == 0.0


def test_make_mesh_and_shards():
    assert P.make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        P.make_mesh(3, devices=["cpu", "cpu"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA"):
            P.make_mesh(2)
    assert P.shard_bounds(3, 2) == [(0, 2), (2, 3)]
    assert P.shard_bounds(4, 3) == [(0, 2), (2, 4), (4, 4)]
    assert P.shard_bounds(1, 2) == [(0, 1), (1, 1)]
