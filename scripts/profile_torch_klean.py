#!/usr/bin/env python3
"""Where the time of pfb_tpu_torch's klean path goes on the card.

    python3 scripts/profile_torch_klean.py [--out FILE]

Simulates chip_smoke.py's observation (64 antennas, 128 integrations, 8
channels, 2048^2 x 8 bands), grids it as its pg path does (Briggs 0) and
runs chip_smoke.py's klean (backend="pg", plane_block=4, 3 major
iterations) three times after a warm-up run:

1. with stage timers, host clock ending in a synchronise: building the
   exact-residual operator (the blocked plans), its applications, the
   Clark minor cycles and the PCG flux mop;
2. under cProfile: the host functions with the most cumulative time;
3. under torch.profiler: device busy (the union of kernel and copy
   intervals) against wall time, and device time by kernel name.

Prints one JSON object (and writes it to ``--out`` when given). Needs a
CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _timed(fn, acc, key, sync):
    """fn with its host seconds (ending in a synchronise) added to
    acc[key] and its calls counted."""
    def wrapper(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sync()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        acc[key + "_calls"] = acc.get(key + "_calls", 0) + 1
        return out
    return wrapper


def _busy_seconds(events):
    """Union of the device intervals (kernels and copies) in seconds."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pfb_tpu_torch.workers import klean as kl
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init

    dev = torch.device("cuda")
    work = ROOT / "build" / "profile_klean"
    work.mkdir(parents=True, exist_ok=True)
    truth = cs.simulate(work)
    xds = _init(ms=truth["ms"], precision="single", channels_per_image=1,
                write=False, device=dev)
    dds = _grid(xdsi=xds, write=False, device=dev, **cs.GRID_PG)

    def run():
        return kl._klean(ddsi=[dict(ds) for ds in dds], write=False,
                         device=dev, verbose=0, **cs.KLEAN)

    run()  # warm-up: kernel library, cuFFT plans, caching allocator

    # 1. stage timers
    stages = {}
    sync = torch.cuda.synchronize
    orig = (kl.clark, kl.pcg_psf, kl.make_hessian_dds)

    def make_hessian_timed(*a, **k):
        h = _timed(orig[2], stages, "residual_operator_build", sync)(*a, **k)
        return _timed(h, stages, "residual_apply", sync)

    kl.clark = _timed(orig[0], stages, "clark", sync)
    kl.pcg_psf = _timed(orig[1], stages, "pcg_mop", sync)
    kl.make_hessian_dds = make_hessian_timed
    try:
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        stages["klean_wall"] = time.perf_counter() - t0
    finally:
        kl.clark, kl.pcg_psf, kl.make_hessian_dds = orig

    # 2. host functions
    import cProfile
    import pstats
    cp = cProfile.Profile()
    cp.enable()
    run()
    sync()
    cp.disable()
    st = pstats.Stats(cp)
    host = sorted(((v[3], f"{Path(k[0]).name}:{k[1]}:{k[2]}")
                   for k, v in st.stats.items()), reverse=True)
    host = [dict(fn=name, cumulative_s=t) for t, name in host[:25]]

    # 3. profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if getattr(e, "device_type", None) is not None
                  and e.device_type.name == "CUDA"]
    busy = _busy_seconds(dev_events)
    by_name = {}
    for e in dev_events:
        r = by_name.setdefault(e.name, [0.0, 0])
        r[0] += (e.time_range.end - e.time_range.start) * 1e-3
        r[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = dict(device=smi, stages_s=stages, host_cumulative=host,
               profiled_wall_s=wall,
               device_busy_s=busy, idle_share=1.0 - busy / wall,
               device_ms_by_kernel=[dict(name=n[:120], ms=v[0], count=v[1])
                                    for n, v in top])
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
