"""The benchmark of heif_tpu_torch (see BENCHMARK.json and
portbench/run.py). Nothing here imports jax, jaxlib, flax or heif_tpu."""
