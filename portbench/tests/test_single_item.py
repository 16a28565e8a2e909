"""Single-item configurations: single1080's committed files are what its
configuration and manifest say, and a burst of single-item images runs
through the harness on the CPU (portbench.run.run_cell, the look for a
card skipped) with `correct` true and no process left behind."""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

from portbench import inputs
from portbench.reference import image as ref_image
from portbench.reference.hevc import params
from portbench.reference.hevc.rbsp import remove_emulation_prevention
from portbench.run import load_cell, run_cell
from portbench.tests.conftest import ROOT, bench

SEED = 2**32 + 15
CONFIG = ROOT / "portbench" / "configs" / "single1080.json"


def test_single1080_files_share_one_sps_and_pps_with_ctb64_and_wpp():
    cfg = json.loads(CONFIG.read_text())
    manifest = json.loads((ROOT / "portbench" / "assets" / "single1080"
                           / "MANIFEST.json").read_text())
    files = inputs.load_assets(cfg)  # checks each sha256
    assert len(files) == cfg["geometry"]["pictures"] == len(manifest) == 16
    assert sum(map(len, files)) == cfg["bytes"] < 10 * 2**20
    for entry, data in zip(cfg["assets"], files):
        name = entry["file"].rsplit("/", 1)[1]
        assert manifest[name]["sha256"] == hashlib.sha256(data).hexdigest()
    pics = [ref_image.parse(d) for d in files]
    assert len({(p.sps_nal, p.pps_nal) for p in pics}) == 1
    assert len(set(p.tiles[0] for p in pics)) == 16
    for p in pics:
        assert (len(p.tiles), p.out_w, p.out_h, p.angle) == (1, 1920, 1080, 0)
    sps = params.parse_sps(remove_emulation_prevention(pics[0].sps_nal[2:]))
    pps = params.parse_pps(remove_emulation_prevention(pics[0].pps_nal[2:]))
    ctb = 1 << (sps.log2_min_luma_coding_block_size_minus3 + 3
                + sps.log2_diff_max_min_luma_coding_block_size)
    assert ctb == cfg["geometry"]["ctb_size"] == 64
    assert pps.entropy_coding_sync_enabled_flag and not pps.tiles_enabled_flag
    assert sps.sample_adaptive_offset_enabled_flag
    assert (sps.chroma_format_idc, sps.bit_depth_luma_minus8) == (1, 0)


def small_spec(config: dict) -> dict:
    spec = load_cell("single1080.burst64", bench())
    spec["config"] = config
    spec["traffic"] = dict(spec["traffic"], distinct_images=8,
                           images_per_call=4, warmup_calls=1,
                           retain_calls=2)
    return spec


def test_single_item_burst_is_correct_on_the_cpu(single_config):
    out = run_cell(small_spec(single_config), SEED, seconds=1.0,
                   trace=False, device="cpu", processes=2)
    assert out["correct"], out["checks"]
    assert out["checks"]["checked_images"]["value"] == 8
    assert out["checks"]["mismatched_samples"]["value"] == 0
    assert out["metrics"]["mp_s"]["value"] > 0


CHILD = """
import glob, json, os, sys
from portbench.run import run_cell
spec = json.loads(sys.argv[1])
out = run_cell(spec, int(sys.argv[2]), seconds=0.5, trace=False,
               device="cpu", processes=2)
kids = []
for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
    with open(path) as f:
        kids += f.read().split()
print(json.dumps({"correct": out["correct"], "children": kids}))
"""


def test_no_process_outlives_the_reference_pool(single_config):
    """The reference's spawn pool starts multiprocessing's resource
    tracker; once the check is done, the run has no child process."""
    p = subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(small_spec(single_config)),
         str(SEED)], cwd=ROOT, capture_output=True, text=True, timeout=600,
        start_new_session=True)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "children": []}, p.stderr[-2000:]
