"""The benchmark's run: one cell, one seed.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (counted in ``setup_s`` from the process's start): import, load
the kernels from the checkout's build cache (the first run in a
checkout compiles them), make the cell's observation from the seed, and
the unit's set-up and warm-up. The window then runs whole units back
to back and ends at the first unit boundary after ``--seconds``; its
rate is its whole time over all the work it finished. With ``--trace
1`` the same window runs under torch.profiler with the benchmark's
spans, and the line carries the cell's per-layer metrics. After the
window the program's state is freed and the first finished unit (with
what the unit's ``probe`` kept of it) is compared with the plain
reference; each number compared is printed beside its limit. The last
line of standard output is one JSON object.
"""

import argparse
import gc
import json
import os
import sys
import time

from harness import registry
from harness.trace import Spans, read_profile

GIB = 2.0 ** 30
FORBIDDEN = ("jax", "jaxlib", "flax", "pfb_tpu")


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def launch_counters():
    """The port's launch counters by kernel (chip_smoke.py:counters)."""
    from pfb_tpu_torch.ops.cfft import (fftx_c2c, fftx_c2c_cluster,
                                        fftx_c2c_rows)
    from pfb_tpu_torch.ops.pgridder import pg_degrid, pg_fold, pg_spread
    from pfb_tpu_torch.ops.psf import (psf_convolve_full, psf_convolve_h,
                                       psf_convolve_h_cg)
    return {"K1": psf_convolve_h, "K2": psf_convolve_h_cg, "K3": fftx_c2c,
            "K3c": fftx_c2c_cluster, "K3r": fftx_c2c_rows, "K4": pg_spread,
            "K5": pg_fold, "K6": pg_degrid, "K11": psf_convolve_full}


def device_info(torch, count):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parts(workload, root=registry.ROOT, bench=registry.BENCH):
    """Everything a run of ``workload`` reads, found by name."""
    cell = registry.cell(workload, root)
    traffic = registry.data("traffic", cell["traffic"], bench)
    return dict(
        cell=cell, cfg=registry.data("configs", cell["config"], bench),
        traffic=traffic, limits=registry.data("limits", workload, bench),
        unit=registry.module("units", traffic["unit"], bench),
        end_to_end=registry.end_to_end(workload, root),
        per_layer=[(m, registry.module("metrics", m["name"], bench))
                   for m in registry.per_layer(workload, root)])


def run_cell(p, seed, seconds, trace, device, t_start):
    """Set-up, window, reading and check of one cell (``parts``) on
    ``device``. Returns (metrics, extra, numbers): the metrics of the
    run's kind, window facts, and the compared numbers with their
    limits."""
    import torch
    cfg, traffic, unit = p["cfg"], p["traffic"], p["unit"]
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    state = unit.setup(cfg, traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = launch_counters()
    spans = Spans(sync)
    undo = unit.instrument(spans) if trace else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    calls, units, first = 0, 0, None
    while True:
        # the first call's intermediate answers are kept for the check
        unprobe = unit.probe(state) if first is None else None
        n, out = unit.call(state)
        sync()
        if unprobe is not None:
            out.update(unprobe())
        calls += 1
        units += n
        if first is None:
            first = out
        del out
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    if undo is not None:
        undo()
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    extra = dict(calls=calls, units=units, window_s=window_s,
                 setup_s=setup_s, memory_peak_bytes=max(peak, setup_peak))
    if not trace:
        e2e = {m["name"]: m for m in p["end_to_end"]}
        values = {"setup_s": setup_s, "peak_gib": peak / GIB,
                  traffic["rate_metric"]: window_s / units}
        metrics = {n: {"value": values[n], "unit": m["unit"]}
                   for n, m in e2e.items()}
    else:
        t_read = time.perf_counter()
        busy, by_kernel, device_ops, idle = read_profile(
            prof, span_names=set(spans.seconds))
        del prof
        extra["trace_read_s"] = time.perf_counter() - t_read
        ctx = dict(spans=spans, launches=launches, by_kernel=by_kernel,
                   busy_s=busy, window_s=window_s, units=units,
                   calls=calls)
        for m, reader in p["per_layer"]:
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra.update(busy_s=busy,
                     breakdown={"device_ops": device_ops,
                                "idle_gaps": idle})
    # the program's state goes before the reference runs; the inputs
    # the harness made stay
    inputs = {"cols": state["cols"]}
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    got = unit.check(inputs, first, cfg, traffic, device)
    extra["reference_s"] = time.perf_counter() - t_ref
    numbers = {k: (got[k], lim) for k, lim in p["limits"].items()}
    return metrics, extra, numbers


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(registry.ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    cell = registry.cell(args.workload)
    chips = int(cell["chips"])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    metrics, extra, numbers = run_cell(parts(args.workload), args.seed,
                                       args.seconds, args.trace, device,
                                       t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    correct = all(v <= lim for v, lim in numbers.values())
    dev = dict(device_info(torch, chips),
               memory_peak_bytes=int(extra["memory_peak_bytes"]))
    if args.trace:
        dev.update(busy_s=extra["busy_s"], window_s=extra["window_s"])
    read = (f"; trace read {extra['trace_read_s']:.1f} s" if args.trace
            else "")
    print(f"card: {power_limit()}; set-up {extra['setup_s']:.1f} s; window "
          f"{extra['window_s']:.3f} s, {extra['calls']} calls, "
          f"{extra['units']} units; reference {extra['reference_s']:.1f} s"
          f"{read}", file=sys.stderr)
    line = {"correct": correct, "attempted": extra["calls"],
            "failed": 0 if correct else 1, "metrics": metrics,
            "device": dev}
    if args.trace:
        line["breakdown"] = extra["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
