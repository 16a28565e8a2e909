"""container layer of the port (copy of heif_tpu/container; imports nothing at
package import)."""
