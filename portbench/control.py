"""The control of the comparison that decides `correct`: the reference put
in the program's place, one precision step down, has to come out as not
correct.

The configurations state the HEVC specification's 16-bit coefficient
levels (TransCoeffLevel); the control clips them to int8, the step a
change that ships the levels in fewer bytes would take, then
reconstructs exactly. Its answers for as many images as a run of the
cell compares (the traffic's retain_calls calls), drawn from the seed,
go through the same judge as the program's:

    python3 -m portbench.control --workload flagship.decode \
        --seeds 11,12,13

prints one JSON line a seed with the readings that decide `correct`.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

from portbench import inputs, judge
from portbench.run import ROOT, load_cell

LEVEL_BITS = 8


def readings(spec: dict, seed: int, level_bits: int = LEVEL_BITS,
             processes: int | None = None, caches=(None, None)) -> dict:
    """The judge's tallies of the control's answers on the cell's images
    of `seed`. caches: two dicts that keep the exact and the control
    tiles across seeds (the tiles are the same; their order is not)."""
    traffic = spec["traffic"]
    images = inputs.make_images(inputs.load_assets(spec["config"]), seed,
                                traffic["distinct_images"])
    n = min(len(images), traffic["retain_calls"] * traffic["images_per_call"])
    picked = random.Random(seed).sample(range(len(images)), n)
    exact = judge.Reference(images, processes=processes, cache=caches[0])
    control = judge.Reference(images, level_bits=level_bits,
                              processes=processes, cache=caches[1])
    kind = "image" if traffic["entry"] == "decode" else "tiles"
    answers = [(k, kind, control.image(k) if kind == "image"
                else control.tiles(k)) for k in picked]
    tally = judge.judge(exact, answers)
    tally["correct"] = (tally["mismatched_samples"] == 0
                        and tally["missing_answers"] == 0)
    return tally


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--level-bits", type=int, default=LEVEL_BITS)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = load_cell(args.workload, bench)
    caches = ({}, {})
    for seed in map(int, args.seeds.split(",")):
        out = readings(spec, seed, args.level_bits, caches=caches)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "level_bits": args.level_bits, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
