"""cabac layer of the port (copy of heif_tpu/cabac; imports nothing at
package import)."""
