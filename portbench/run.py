"""Run one cell of the benchmark of heif_tpu_torch (BENCHMARK.json) and
print its result as one JSON line, last on standard output:

    python3 -m portbench.run --workload flagship.decode --seed 7 \
        --seconds 40 --trace 0

The cell names a configuration (portbench/configs/<name>.json: its
source images and their sha256, read by portbench.inputs) and a traffic
mix (portbench/traffic/<name>.json, read by portbench.loop). Set-up
makes the cell's images from --seed, loads the program and warms it up;
the window then drives the traffic for --seconds; then the reference
(portbench.reference, in worker processes) decodes every distinct tile
of the images, and the answers of the calls drawn from the seed are
compared with it, sample for sample.
--trace 0 reports the cell's end-to-end metrics; --trace 1 runs the
window under torch.profiler, with the program's DecodeStats on, and
reports its per-layer metrics (portbench/metrics/<name>.py).

Exits 3 without the cards the cell asks for, and 4 if jax, jaxlib, flax
or heif_tpu were imported, in both cases printing no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "heif_tpu")
LAUNCH_COUNTERS = {  # kernel: (module of heif_tpu_torch.ops, counter keys)
    "residual_kernel": ("residual", ("residual",)),
    "ref_sources_kernel": ("refsrc", ("ref_sources",)),
    "intra_walk": ("intra", ("luma", "chroma")),
    "deblock_kernel": ("loopfilter", ("deblock",)),
    "sao_kernel": ("loopfilter", ("sao",)),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str, bench: dict) -> dict:
    """The workload `name` of BENCHMARK.json with its configuration,
    traffic mix and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m["name"] for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in e2e
                                  else [])]
    return {
        "cell": cell,
        "config": json.loads((ROOT / cfg["file"]).read_text()),
        "traffic": json.loads((ROOT / "portbench" / "traffic"
                               / f"{cell['traffic']}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": per_layer,
        "units": {m["name"]: m["unit"]
                  for m in bench["end_to_end"] + bench["per_layer"]},
    }


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def launches() -> dict:
    import importlib

    out = {}
    for kernel, (mod, keys) in LAUNCH_COUNTERS.items():
        counter = importlib.import_module(f"heif_tpu_torch.ops.{mod}").LAUNCHES
        out[kernel] = sum(counter[k] for k in keys)
    return out


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card, which the
    roofline's peak assumes at 700 W."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else "?"


def host_answers(kind: str, answer):
    """An answer as numpy: a decode's planes as they are; a burst image's
    chunks of device tensors as a list of [Y, Cb, Cr] tile planes."""
    if kind == "image":
        return answer
    tiles = []
    for chunk in answer:
        host = [p.cpu().numpy() for p in chunk]
        tiles += [[h[i] for h in host] for i in range(host[0].shape[0])]
    return tiles


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             processes: int | None = None) -> dict:
    """One run of a cell (load_cell's dict): the result line's dict."""
    import torch

    from portbench import inputs, judge, loop
    from portbench import metrics as M
    from portbench import trace as T
    from portbench.reference import image as ref_image

    cuda = torch.device(device).type == "cuda"
    marks = {"imports": time.perf_counter() - t_start}
    source = inputs.load_assets(spec["config"])
    images = inputs.make_images(source, seed,
                                spec["traffic"]["distinct_images"])
    mps = [p.out_w * p.out_h / 1e6 for p in map(ref_image.parse, images)]
    runner = loop.Loop(spec["traffic"], images, mps, device, seed)
    marks["inputs"] = time.perf_counter() - t_start
    runner.warm_up()
    if cuda:
        torch.cuda.synchronize()
    run = M.Run(setup_s=time.perf_counter() - t_start)
    marks["warm_up"] = run.setup_s

    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    before = launches()
    stats_factory = None
    if trace:
        from heif_tpu_torch.utils.profiling import DecodeStats

        stats_factory = DecodeStats
    prof = T.profiler() if trace else None
    if prof is not None:
        prof.start()
    failed = runner.window(seconds, run, stats_factory, trace)
    if prof is not None:
        prof.stop()
    after = launches()
    run.launches = {k: after[k] - before[k] for k in after}
    peak_total = peak_window = None
    if cuda:
        run.peak_window_bytes = peak_window = torch.cuda.max_memory_allocated()
        peak_total = max(peak_window, setup_peak)
    found = forbidden_modules()
    if found:
        log(f"modules loaded that the benchmark forbids: {found}")
        raise SystemExit(4)
    if prof is not None:
        run.trace = T.summarize(prof)
        del prof

    answers = [(k, runner.kind, host_answers(runner.kind, a))
               for item in runner.reservoir.items for k, a in item]
    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = judge.Reference(images, processes=processes)
    tally = judge.judge(ref, answers)
    marks["check_s"] = time.perf_counter() - t_check
    if trace:
        run.kernel_bytes = {}
        for k, n in run.done.items():
            for name, b in ref.kernel_bytes(k).items():
                run.kernel_bytes[name] = run.kernel_bytes.get(name, 0) + n * b

    names = spec["per_layer"] if trace else spec["end_to_end"]
    values = {n: M.read(n, run) for n in names}
    units = spec["units"]
    checks = {
        "failed_images": {"value": failed, "max": 0},
        "checked_images": {"value": tally["checked_images"], "min": 1},
        "missing_answers": {"value": tally["missing_answers"], "max": 0},
        "mismatched_samples": {"value": tally["mismatched_samples"],
                               "max": 0},
    }
    correct = all(c["value"] <= c.get("max", c["value"])
                  and c["value"] >= c.get("min", c["value"])
                  for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": spec["cell"]["chips"],
           "memory_peak_bytes": peak_total or 0}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    out = {
        "correct": correct,
        "attempted": run.images + failed,
        "failed": failed,
        "metrics": {n: {"value": v, "unit": units[n]}
                    for n, v in values.items() if v is not None},
        "device": dev,
    }
    if trace and run.trace is not None:
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    lat = sorted(run.latencies_s)
    log(f"# set-up ends (s since start) and the check's s: {marks}; window {run.window_s:.3f} "
        f"s, {run.calls} calls, {run.images} images; call latency ms min "
        f"{1e3 * lat[0]:.1f} median {1e3 * lat[len(lat) // 2]:.1f} max "
        f"{1e3 * lat[-1]:.1f}; max_abs_err {tally['max_abs_err']}; launches "
        f"{run.launches}; peak_window_bytes {peak_window}")
    if trace and run.trace is not None:
        log(f"# kernels (events, s) {run.trace['kernels']}; kernel bytes "
            f"{run.kernel_bytes}; card (name, power limit) {card_line()}")
    for name, c in checks.items():
        rule = f"<= {c['max']}" if "max" in c else f">= {c['min']}"
        log(f"check {name} {c['value']} {rule}")
    return out



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = load_cell(args.workload, bench)
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))

    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this host has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
