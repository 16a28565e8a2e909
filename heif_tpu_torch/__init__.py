"""heif_tpu_torch — the PyTorch / CUDA port of the heif_tpu decode engine.

The JAX package `heif_tpu` is the reference: every stage here must give
the same samples, bit for bit, on the same input. This package imports
nothing of `heif_tpu`: it holds its own copies of the JAX-free host
layers (container, HEVC headers, CABAC entropy, the native C++ entropy
library, the numpy reference reconstruction) and everything that ran on
JAX.

Layering (host -> device), mirroring heif_tpu:
  cli.py            python -m heif_tpu_torch: probe / decode / verify /
                    bench; raw Annex-B input goes to decode_hevc
  models/decoder.py HeicDecoder.decode / decode_hevc / probe
  container/, hevc/, cabac/
                    copies of heif_tpu's container reader, HEVC header
                    parse and Python CABAC decoder (trace, envelope)
  native/           the C++ entropy decoder, built into build/ (ctypes)
  device.py         explicit device selection (no silent CPU fallback)
  tables.py         spec constant tables as nn.Module buffers
                    (ReconTables, CabacTables)
  ops/batch.py      host packer (numpy) + the batched device core
  ops/recon.py      residual, reference sources, plain intra walk,
                    deblocking, SAO (plain PyTorch)
  ops/ref_recon.py  the host numpy reference reconstruction (backend="ref")
                    with its spec tables, ops/ref_tables.py
  ops/intra.py      the intra-walk wrappers: CUDA kernel on a CUDA
                    tensor, plain walk on a CPU tensor
  ops/cabac.py      CABAC tape replay (whole-stream and windowed): host
                    packers, plain engines, kernel wrappers
  ops/cabac_gen.py  the residual request generator (device-gen entropy):
                    host packers, event scatter, plain generator, wrapper
  csrc/intra.cu     the hand-written CUDA intra kernels (sm_90a)
  csrc/cabac.cu     the CUDA replay kernels; csrc/cabac_gen.cu the CUDA
                    generator; csrc/cabac_engine.cuh their shared
                    arithmetic decoder
  ops/_build.py     nvcc build + ctypes binding of csrc/
  utils/annexb.py   Annex-B streams from HEIF tiles

Nothing here imports jax.
"""

from heif_tpu_torch.models.decoder import HeicDecoder

__all__ = ["HeicDecoder"]
__version__ = "0.1.0"
