#!/usr/bin/env python3
"""The two readings that a cell's limits are set from, on the card at
the cell's own size (never part of a benchmark run):

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3
        [--control 1] [--out FILE]

For each seed, in one process: the cell's set-up and one call of its
timed path, then the plain reference in float64 and, with ``--control
1``, the control (the reference in the next precision below the
configuration's: float32 with TF32 operands). Prints one JSON line a
seed: the program's numbers against the reference (the lower reading)
and the control's (the upper reading), with the card's name and power
limit and the seconds of each part. With ``--look 1`` also where the
two part: the reference's own solve in float32 against float64, and the
program's dirty image, PSF and exact residual against the reference's.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import main  # noqa: E402


def reading(p, seed, device, control, look=False):
    import torch
    unit = p["unit"]
    t = {}
    t0 = time.perf_counter()
    state = unit.setup(p["cfg"], p["traffic"], seed, device)
    t["setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    unprobe = unit.probe(state)
    n, out = unit.call(state)
    out.update(unprobe())
    if device.type == "cuda":
        torch.cuda.synchronize()
    t["call"] = time.perf_counter() - t0
    inputs = {"cols": state["cols"]}
    dds = state["dds"] if look else None
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    obs = unit.observe(inputs, p["cfg"], device)
    ref = unit.reference(obs, p["cfg"], p["traffic"])
    t["reference"] = time.perf_counter() - t0
    line = dict(seed=seed, units=n, program=unit.compare(out, ref),
                diag=unit.diagnose(out, ref))
    if control:
        t0 = time.perf_counter()
        ctl = unit.reference(obs, p["cfg"], p["traffic"], control=True)
        line["control"] = unit.compare(ctl, ref)
        if "rms" in ctl:
            line["control_rms"] = ctl["rms"]
        if hasattr(unit, "final_gaps"):
            line["control_final"] = unit.final_gaps(ctl, ref)
        t["control"] = time.perf_counter() - t0
    if look:
        t0 = time.perf_counter()
        line["look"] = unit.look(dds, out, obs, ref, p["cfg"], p["traffic"],
                                 device)
        t["look"] = time.perf_counter() - t0
    line["seconds"] = t
    return line


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--look", type=int, default=0,
                    help="1: where the program and the reference part")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    p = main.parts(args.workload)
    card = main.power_limit()
    for s in args.seeds.split(","):
        line = dict(reading(p, int(s), device, args.control, args.look),
                    workload=args.workload, card=card)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(run())
