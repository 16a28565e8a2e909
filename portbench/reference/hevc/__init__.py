"""hevc layer of the port (copy of heif_tpu/hevc; imports nothing at
package import)."""
