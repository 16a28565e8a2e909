"""Multi-process decode: torch.distributed process groups and sharded
bursts (port of heif_tpu/parallel/distributed.py).

One process per device. Each rank entropy-decodes and reconstructs its
own contiguous shard of every image's tiles on its local device; the
decoded planes reach every rank by one all_gather per plane, padded to
ceil(n/d)·d tiles and trimmed, as the reference pads. No other traffic
exists. Backends: nccl on CUDA, gloo on the CPU.

Without a process group everything degenerates to one process:
init_distributed() is a no-op without its environment variables, and
decode_burst_sharded runs the in-process sharded decode over a mesh.

    # one process per card, torchrun's variables (or JAX_* as for heif_tpu)
    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \\
        python -m heif_tpu_torch.parallel.distributed IMAGE.heic -o out.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.parallel.pipeline import (
    decode_grid_sharded_streamed,
    make_mesh,
    shard_bounds,
)


def _env(*names):
    for name in names:
        v = os.environ.get(name)
        if v:
            return v
    return None


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join a torch.distributed process group.

    Arguments default from the environment: the reference's
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID (or
    COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID), else torchrun's
    MASTER_ADDR:MASTER_PORT / WORLD_SIZE / RANK. Without an address, a
    process count and an id it does nothing and returns False. Unlike
    the reference, a group of one process is initialised too (True), so
    the collective path runs on a one-card host. backend: nccl when CUDA
    is available, gloo otherwise; under nccl the rank's card (rank modulo
    the local card count) becomes the current device. Returns True when
    a group is (or already was) initialised.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    addr = coordinator_address or _env(
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    if addr is None and _env("MASTER_ADDR"):
        addr = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT') or 29500}"
    nproc = num_processes or int(
        _env("JAX_NUM_PROCESSES", "NUM_PROCESSES", "WORLD_SIZE") or 0)
    pid = process_id
    if pid is None:
        pid = int(_env("JAX_PROCESS_ID", "PROCESS_ID", "RANK") or -1)
    if not addr or nproc < 1 or pid < 0:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=nproc, rank=pid)
    return True


def _group():
    """(rank, world size) of the initialised process group, or None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def make_global_mesh(n_devices: int | None = None) -> list:
    """One device per rank of the process group, as each rank names its
    own (cuda:rank modulo the local card count under nccl, the CPU under
    gloo); without a group, make_mesh(n_devices)."""
    import torch.distributed as dist

    g = _group()
    if g is None:
        return make_mesh(n_devices)
    world = g[1]
    if dist.get_backend() == "nccl":
        count = torch.cuda.device_count()
        return [torch.device("cuda", r % count) for r in range(world)]
    return [torch.device("cpu")] * world


@dataclass
class BurstResult:
    """Multi-image burst decode stats (copy of heif_tpu's)."""

    images: int = 0
    tiles: int = 0
    megapixels: float = 0.0
    wall_s: float = 0.0
    n_devices: int = 1
    n_processes: int = 1
    per_image_s: list = field(default_factory=list)

    @property
    def mp_per_s(self) -> float:
        return self.megapixels / self.wall_s if self.wall_s else 0.0

    @property
    def mp_per_s_per_chip(self) -> float:
        return self.mp_per_s / max(self.n_devices, 1)

    def scaling_efficiency(self, single_chip_mp_s: float) -> float:
        """Throughput per chip relative to a 1-chip run of the same work."""
        if not single_chip_mp_s:
            return 0.0
        return self.mp_per_s_per_chip / single_chip_mp_s

    def as_dict(self) -> dict:
        return {
            "images": self.images,
            "tiles": self.tiles,
            "megapixels": round(self.megapixels, 2),
            "wall_s": round(self.wall_s, 4),
            "mp_per_s": round(self.mp_per_s, 2),
            "mp_per_s_per_chip": round(self.mp_per_s_per_chip, 2),
            "n_devices": self.n_devices,
            "n_processes": self.n_processes,
        }


def decode_rank_shard(sps, pps, slices, mesh: list) -> list:
    """This rank's contiguous shard of the tiles, decoded on its mesh
    device by the overlapped path, then all_gathered: [Y, Cb, Cr] numpy
    stacks of all N tiles on every rank. Each rank sends ceil(n/d) tiles
    (zero tiles past its real ones), as bytes: nccl has no int16."""
    import torch.distributed as dist

    rank, world = _group()
    dev = mesh[rank]
    n = len(slices)
    lo, hi = shard_bounds(n, world)[rank]
    s = -(-n // world)
    th, tw = sps.pic_height_in_luma_samples, sps.pic_width_in_luma_samples
    dims = [(th, tw), (th // 2, tw // 2), (th // 2, tw // 2)]
    dt = B.out_dtype(sps.bit_depth_y, sps.bit_depth_c)
    chunks = []
    if hi > lo:
        chunks = B.decode_reconstruct_overlapped(
            sps, pps, slices[lo:hi], readback=False, device=dev)
    out = []
    for c, (h, w) in enumerate(dims):
        mine = torch.zeros((s, h, w), dtype=dt, device=dev)
        if chunks:
            mine[: hi - lo] = torch.cat([ch[c] for ch in chunks])
        sent = mine.view(torch.uint8)
        parts = [torch.empty_like(sent) for _ in range(world)]
        dist.all_gather(parts, sent)
        full = torch.cat(parts).view(dt)[:n]
        out.append(B.host_view(full.cpu()))
    return out


def _parse(data: bytes):
    from heif_tpu_torch.container.reader import HeifReader, parse_grid_config
    from heif_tpu_torch.hevc import params
    from heif_tpu_torch.hevc import slice as sl
    from heif_tpu_torch.hevc.rbsp import remove_emulation_prevention

    r = HeifReader(data)
    heif = r.read()
    rec = heif.hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    primary = heif.primary_item_id()
    grid = parse_grid_config(r.get_item_data(primary))
    tile_ids = heif.item_ids_referencing(primary, "dimg")
    slices = [
        sl.parse_slice_header(
            sl.split_length_prefixed_nals(r.get_item_data(t), 4)[0], sps, pps)
        for t in tile_ids
    ]
    return sps, pps, grid, slices


def _stitch(p, grid, th, tw, oh, ow):
    return (
        p.reshape(grid.rows, grid.columns, th, tw)
        .transpose(0, 2, 1, 3)
        .reshape(grid.rows * th, grid.columns * tw)[:oh, :ow]
    )


def decode_burst_sharded(images: list, mesh: list | None = None,
                         repeats: int = 1) -> tuple:
    """Decode a burst of grid HEIC images with tiles sharded over the
    mesh: over the ranks of the process group when one is initialised
    (decode_rank_shard; mesh defaults to make_global_mesh()), else over
    the devices of this process (decode_grid_sharded_streamed). Returns
    (list of {"Y", "Cb", "Cr"} canvases of the last repeat, cropped to
    the grid output size and not rotated, BurstResult)."""
    g = _group()
    mesh = mesh or make_global_mesh()
    if g is not None and len(mesh) != g[1]:
        raise ValueError(f"mesh of {len(mesh)} devices for {g[1]} ranks")
    res = BurstResult(n_devices=len(mesh),
                      n_processes=1 if g is None else g[1])
    parsed = [_parse(data) for data in images]
    outs = []
    t0 = time.perf_counter()
    for _ in range(repeats):
        outs = []
        for sps, pps, grid, slices in parsed:
            ti0 = time.perf_counter()
            if g is None:
                y, cb, cr = decode_grid_sharded_streamed(
                    sps, pps, slices, mesh=mesh)
            else:
                y, cb, cr = decode_rank_shard(sps, pps, slices, mesh)
            res.per_image_s.append(time.perf_counter() - ti0)
            th = sps.pic_height_in_luma_samples
            tw = sps.pic_width_in_luma_samples
            oh, ow = grid.output_height, grid.output_width
            outs.append({
                "Y": _stitch(y, grid, th, tw, oh, ow),
                "Cb": _stitch(cb, grid, th // 2, tw // 2, oh // 2, ow // 2),
                "Cr": _stitch(cr, grid, th // 2, tw // 2, oh // 2, ow // 2),
            })
            res.images += 1
            res.tiles += len(slices)
            res.megapixels += ow * oh / 1e6
    res.wall_s = time.perf_counter() - t0
    return outs, res


def main(argv=None) -> int:
    """Burst decode of grid images on this process group (see the module
    docstring). Rank 0 prints the BurstResult as JSON and, with -o,
    writes the first image's planes to an .npz."""
    import torch.distributed as dist

    p = argparse.ArgumentParser(
        prog="python -m heif_tpu_torch.parallel.distributed",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("images", nargs="+")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (nccl, one card a rank) or cpu (gloo)")
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("-o", "--output", help=".npz of the first image's planes")
    args = p.parse_args(argv)
    init_distributed(backend="nccl" if args.device == "cuda" else "gloo")
    try:
        if _group() is None and args.device == "cpu":
            mesh = make_mesh(devices=["cpu"])
        else:
            mesh = make_global_mesh()
        datas = []
        for path in args.images:
            with open(path, "rb") as f:
                datas.append(f.read())
        outs, res = decode_burst_sharded(datas, mesh=mesh,
                                         repeats=args.repeats)
        if _group() is None or dist.get_rank() == 0:
            print(json.dumps(res.as_dict()))
            if args.output:
                np.savez(args.output, **outs[0])
    finally:
        if _group() is not None:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
