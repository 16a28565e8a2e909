"""Multi-device tile-parallel reconstruction (port of
heif_tpu/parallel/pipeline.py).

HEIF grid tiles are independent pictures, so the split is over tiles. A
mesh is a list of torch devices; the tiles are cut into contiguous
shards, one per device (ceil(n/d) tiles each, the last shards shorter or
empty), and each shard runs the single-device batch path (pack_batch ->
plan_to_device -> core) on its own device. Every shard is queued before
any is collected. The only communication is the gather of the decoded
planes: in one process it is each shard's D2H plus a host concat (the
reference's gather=False on one host); across processes it is a
torch.distributed all_gather (parallel/distributed.py).

The reference packs tile-uniform arrays (pack_uniform) for one
shard_map program (_shard_core). Nothing here is compiled per shape and
pack_batch is tile-aware, so each shard packs at its own shape with the
batch packer, and tiles-enabled pictures decode on a mesh too.
"""

from __future__ import annotations

import contextlib

import torch

from heif_tpu_torch.device import resolve_device
from heif_tpu_torch.ops import batch as B


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """The first n_devices CUDA devices (all of them for None) as a list
    of torch.device; raises RuntimeError if fewer exist. devices: an
    explicit mesh instead, such as ["cpu", "cpu"] (each entry goes
    through resolve_device)."""
    if devices is not None:
        mesh = [resolve_device(d) for d in devices]
        if not mesh or (n_devices is not None and n_devices != len(mesh)):
            raise ValueError(
                f"devices={list(devices)!r} does not make a mesh of "
                f"{n_devices} devices")
        return mesh
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else n_devices
    if n < 1 or n > count:
        raise RuntimeError(
            f"a mesh of {n} CUDA devices was requested but {count} exist "
            "(pass devices=[...] for an explicit mesh, e.g. ['cpu', 'cpu'])")
    return [torch.device("cuda", i) for i in range(n)]


def shard_bounds(n: int, d: int) -> list:
    """Contiguous [lo, hi) tile ranges of n tiles over d devices: ceil(n/d)
    tiles each, as the reference pads n to a multiple of d."""
    s = -(-n // d)
    return [(min(i * s, n), min((i + 1) * s, n)) for i in range(d)]


def on_device(dev: torch.device):
    """Make dev the current CUDA device (kernels launch on its current
    stream); a no-op for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def reconstruct_sharded(syntaxes, sps, pps, slices, mesh: list) -> list:
    """Queue each device's shard of the tiles on it. Returns, per mesh
    device, its [y, cb, cr] device planes in batch.out_dtype, or None
    where its shard is empty. Nothing waits for the devices."""
    out = []
    for dev, (lo, hi) in zip(mesh, shard_bounds(len(syntaxes), len(mesh))):
        if lo == hi:
            out.append(None)
            continue
        with on_device(dev):
            bp = B.pack_batch(syntaxes[lo:hi], sps, pps, slices[lo:hi])
            out.append(B.device_planes(bp, dev))
    return out


def _collect(shards: list, rb: B.Readback) -> None:
    for planes in shards:
        if planes is not None:
            rb.submit(planes)


def decode_grid_sharded(syntaxes, sps, pps, slices, mesh: list | None = None):
    """Sharded decode of a tile batch over the mesh (default: every CUDA
    device). Returns [Y, Cb, Cr] stacked numpy planes of all N tiles."""
    mesh = mesh or make_mesh()
    rb = B.Readback()
    _collect(reconstruct_sharded(syntaxes, sps, pps, slices, mesh), rb)
    return B.stack_chunks(rb.drain())


def decode_grid_sharded_streamed(sps, pps, slices, mesh: list | None = None,
                                 chunk: int | None = None, entropy_fn=None):
    """Sharded decode in chunks of a multiple of the device count
    (default two tiles a device): host entropy of chunk k+1 runs on a
    worker thread while chunk k is split over the mesh (batch.run_chunks),
    and each shard's readback overlaps the later chunks. Returns [Y, Cb,
    Cr] stacked numpy planes of all N tiles."""
    mesh = mesh or make_mesh()
    d = len(mesh)
    if entropy_fn is None:
        hints = B.schedule_hints(None, sps, pps, len(slices))
        entropy_fn = B.default_entropy(sps, pps, hints)
    chunk = 2 * d if chunk is None else chunk
    chunk = max(d, -(-chunk // d) * d)
    chunks = [slices[lo : lo + chunk] for lo in range(0, len(slices), chunk)]
    rb = B.Readback()
    B.run_chunks(
        chunks, entropy_fn,
        lambda i, syn, sl: _collect(
            reconstruct_sharded(syn, sps, pps, sl, mesh), rb),
    )
    return B.stack_chunks(rb.drain())
