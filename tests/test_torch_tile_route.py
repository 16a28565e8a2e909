"""The port's counterpart of heif_tpu's one-tile route
(ops.jax_recon.reconstruct_tile_jax, which only heif_tpu's own tests
call): ops.batch.reconstruct_tiles with a batch of one tile, bit-exact
on a flagship tile built as tests/test_jax_recon.py builds it. No
separate per-tile route is ported."""

import numpy as np

from heif_tpu.cabac.syntax import TileSyntaxDecoder
from heif_tpu.container.reader import HeifReader
from heif_tpu.hevc import params
from heif_tpu.hevc import slice as sl
from heif_tpu.hevc.rbsp import remove_emulation_prevention
from heif_tpu.ops import pack as P
from heif_tpu.ops.jax_recon import reconstruct_tile_jax
from heif_tpu_torch.ops.batch import reconstruct_tiles

TILE_ID = 1  # item id, the first of tests/test_jax_recon.py's tiles


def test_batch_of_one_matches_reconstruct_tile_jax(halfmoonbay_bytes):
    r = HeifReader(halfmoonbay_bytes)
    rec = r.read().hevc_configuration_record()
    sps = params.parse_sps(
        remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:]))
    pps = params.parse_pps(
        remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:]))
    nal = sl.split_length_prefixed_nals(r.get_item_data(TILE_ID), 4)[0]
    ps = sl.parse_slice_header(nal, sps, pps)
    st = TileSyntaxDecoder(sps, pps, ps).decode()
    want = reconstruct_tile_jax(P.pack_tile(st, sps, pps, ps.header), sps,
                                ps.header)
    (got,) = reconstruct_tiles([st], sps, pps, [ps], device="cpu")
    for c, name in enumerate(("Y", "Cb", "Cr")):
        assert got[c].dtype == np.asarray(want[c]).dtype, name
        np.testing.assert_array_equal(got[c], np.asarray(want[c]),
                                      err_msg=name)
