"""heif_tpu_torch — the PyTorch / CUDA port of the heif_tpu decode engine.

The JAX package `heif_tpu` is the reference: every stage here must give
the same samples, bit for bit, on the same input. The JAX-free host
layers (container, HEVC headers, CABAC entropy, the native C++ entropy
library, the numpy reference reconstruction) are imported from
`heif_tpu` unchanged; this package holds everything that ran on JAX.

Layering (host -> device), mirroring heif_tpu:
  device.py         explicit device selection (no silent CPU fallback)
  tables.py         spec constant tables as nn.Module buffers
  ops/batch.py      host packer (numpy) + the batched device core
  ops/recon.py      residual, reference sources, plain intra walk,
                    deblocking, SAO (plain PyTorch)
  ops/intra.py      the intra-walk wrappers: CUDA kernel on a CUDA
                    tensor, plain walk on a CPU tensor
  csrc/intra.cu     the hand-written CUDA intra kernels (sm_90a)
  ops/_build.py     nvcc build + ctypes binding of csrc/
  models/decoder.py HeicDecoder.decode / probe

Nothing here imports jax.
"""

from heif_tpu_torch.models.decoder import HeicDecoder

__all__ = ["HeicDecoder"]
__version__ = "0.1.0"
