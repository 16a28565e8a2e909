"""The benchmark's plain reference decoder: a frozen copy of the port's
pure-Python decode path (heif_tpu_torch's container/, hevc/, cabac/ — the
Python CABAC twin —, ops/ref_recon.py and ops/ref_tables.py), logic
unchanged, its imports pointed here, plus image.py, its own crop, grid
stitch and irot rotation. It imports neither JAX nor either decoder
package, so a change to the program never changes the yardstick; its
tests hold it against libde265 (portbench/tests/test_reference.py).
Module docstrings below still speak of the port, whose copies these are.
"""
