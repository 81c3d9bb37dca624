#!/usr/bin/env python3
"""Spread-capacity lab on the card (counterpart of
scripts/wl_capacity_ab.py, L3).

    python3 scripts/torch_capacity_lab.py [--reps 10] [--out FILE]
    python3 scripts/torch_capacity_lab.py --device cpu

On the TPU lab's observation (125,000 rows x 8 channels from
default_rng(0), uv scale 1000 m, w a tenth of it, 0.9-1.1 GHz, 1024^2,
epsilon 1e-5, w gridding) it times, each as the CUDA-event median of
``reps`` calls after a warm-up:

- ``_spread_fold`` (K4 + K5 with the visibility packing and the compact
  slots, ops/pgridder.py) on ``pgrid_plan(capacity=128, 256, 512)``
  (wl_capacity_ab.py:146-160), with K4 and K5 alone beside it: time,
  entries, and microseconds per entry and per visibility;
- K4 alone through ``pack_entries`` at pair width P = 1 and 2 on the
  capacity-128 plan (wl_capacity_ab.py:121 ``probe(P)``, the pallas_call
  of the paired-entry probe; P C visibilities a step, every step on its
  first entry's tile, so a pair that straddles two tiles is gridded
  wrong: a timing probe, as on the TPU).

Each probe is checked against the plain spread on the same packed
operands (<= 1e-5 of max). One JSON line per measurement, each with the
card's name and power limit, then a summary line (also written to
``--out``). ``--device cpu`` rehearses the script with the plain versions
at a small size (3,000 rows x 4 channels, 128^2).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from torch_kernel_lab import card, cuda_ms  # noqa: E402

TOL = 1e-5
EPSILON = 1e-5


def observation(nrow, nchan, seed=0):
    """(uvw, freq, cell, rng) of wl_capacity_ab.py's observation: the
    cell samples the longest baseline at the highest frequency twice."""
    import numpy as np
    rng = np.random.default_rng(seed)
    uvw = rng.normal(scale=1000.0, size=(nrow, 3))
    uvw[:, 2] *= 0.1
    freq = np.linspace(0.9e9, 1.1e9, nchan)
    umax = np.abs(uvw[:, :2]).max() * freq[-1] / 299792458.0
    cell = 1.0 / (2.0 * umax * 2.0)
    return uvw, freq, cell, rng


def plan(obs, nx, capacity, dev):
    import torch

    from pfb_tpu_torch.ops.pgridder import pgrid_plan
    uvw, freq, cell, _ = obs
    return pgrid_plan(uvw, freq, nx=nx, ny=nx, cellx=cell, celly=cell,
                      epsilon=EPSILON, do_wgridding=True, capacity=capacity,
                      dtype=torch.float32, device=dev)


def packed_vis(p, vr, vi):
    """The plan's (entries, 2, C) visibilities (ops/pgridder.py:
    _spread_fold's packing, no weights or shift)."""
    import torch
    ix = p["idx"].long()
    vr, vi = vr.reshape(-1), vi.reshape(-1)
    return torch.stack([vr[ix] * p["pm"], vi[ix] * p["pm"]],
                       dim=1).contiguous()


def spread_bound(p, pos, pm, nslots):
    """(bound_ms, bound_by) of a spread of ``pos``/``pm`` (chip_smoke.py's
    spread_work and bound)."""
    from chip_smoke import bound, spread_work
    k, nw = p["k"], p["nw"]
    return bound(*spread_work(pos[:, 2], pm != 0, k, nw, nslots,
                              p["txs"] + k, p["tys"] + k))


def probe(p, vis, P, reps, dev, smi):
    """K4 through pack_entries at pair width P: the record (time, steps,
    us per step and per visibility, error against the plain spread)."""
    from pfb_tpu_torch.ops import pgridder as pg
    k = p["k"]
    pk = pg.pack_entries(p["pos"], vis, p["tid"], p["pm"], P, ntx=p["ntx"],
                         nty=p["nty"], txs=p["txs"], tys=p["tys"], k=k)
    kw = dict(beta=p["beta"], k=k, nw=p["nw"], Thx=p["txs"] + k,
              Thy=p["tys"] + k)
    sl = pk["slots"]
    out = pg.pg_spread(pk["pos"], pk["vis"], sl, **kw)
    ref = pg.pg_spread_plain(pk["pos"], pk["vis"], sl, **kw)
    live = sl["live"]
    err = float((out[:, :, live] - ref[:, :, live]).abs().max()
                / ref[:, :, live].abs().max())
    del out, ref
    ms = cuda_ms(lambda: pg.pg_spread(pk["pos"], pk["vis"], sl, **kw), reps,
                 dev)
    steps = pk["pos"].shape[0]
    nvis = int((pk["pm"] != 0).sum())
    bms, bby = spread_bound(p, pk["pos"], pk["pm"], int(live.sum()))
    return dict(lab="capacity", name=f"probe P={P} (K4 on pack_entries)",
                C=P * p["C"], steps=steps, slots=int(live.sum()),
                visibilities=nvis, ms=ms, reps=reps,
                us_per_step=1e3 * ms / steps, us_per_vis=1e3 * ms / nvis,
                rel_err=err, tol=TOL, bound_ms=bms, bound_by=bby, card=smi)


def capacity_case(obs, nx, cap, vr, vi, reps, dev, smi):
    """_spread_fold at one capacity, with K4 and K5 alone."""
    from pfb_tpu_torch.ops import pgridder as pg
    p = plan(obs, nx, cap, dev)
    k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
    st = dict(beta=p["beta"], k=k, nw=nw, ntx=p["ntx"], nty=p["nty"],
              txs=txs, tys=tys, C=p["C"], x0=p["x0"], y0=p["y0"], Nx=p["Nx"],
              Ny=p["Ny"])
    args = (p["tid"], p["pos"], p["idx"], p["pm"], p["uvw_d"], p["freq_d"])
    ms_sf = cuda_ms(lambda: pg._spread_fold(vr, vi, None, *args, **st),
                    reps, dev)
    vis = packed_vis(p, vr, vi)
    slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"], txs,
                              tys, k)
    skw = dict(beta=p["beta"], k=k, nw=nw, Thx=txs + k, Thy=tys + k)
    ms_k4 = cuda_ms(lambda: pg.pg_spread(p["pos"], vis, slots, **skw), reps,
                    dev)
    Y = pg.pg_spread(p["pos"], vis, slots, **skw).reshape(
        2 * nw, slots["NS"], txs + k, tys + k)
    ms_k5 = cuda_ms(lambda: pg.pg_fold(Y, slots, ntx=p["ntx"], nty=p["nty"],
                                       txs=txs, tys=tys, k=k, Nx=p["Nx"],
                                       Ny=p["Ny"]), reps, dev)
    ne = p["nentries"]
    nvis = int((p["pm"] != 0).sum())
    bms, bby = spread_bound(p, p["pos"], p["pm"], int(slots["live"].sum()))
    rec = dict(lab="capacity", name=f"_spread_fold capacity {cap}",
               C=p["C"], entries=ne, slots=int(slots["live"].sum()),
               visibilities=nvis, nw=nw, k=k, tiles=[txs, tys],
               ms=ms_sf, k4_ms=ms_k4, k5_ms=ms_k5, reps=reps,
               us_per_entry=1e3 * ms_sf / ne, us_per_vis=1e3 * ms_sf / nvis,
               k4_us_per_entry=1e3 * ms_k4 / ne,
               k4_us_per_vis=1e3 * ms_k4 / nvis, k4_bound_ms=bms,
               k4_bound_by=bby, card=smi)
    return rec, p, vis


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script with the plain versions")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if dev.type == "cpu":
        torch.set_num_threads(1)
        nrow, nchan, nx, reps = 3000, 4, 128, 1
    else:
        nrow, nchan, nx, reps = 125_000, 8, 1024, args.reps
    smi = card(dev)
    obs = observation(nrow, nchan)
    rng = obs[3]
    vr = torch.as_tensor(rng.normal(size=(nrow, nchan)).astype("float32"),
                         device=dev)
    vi = torch.as_tensor(rng.normal(size=(nrow, nchan)).astype("float32"),
                         device=dev)
    recs = []
    for cap in (128, 256, 512):
        rec, p, vis = capacity_case(obs, nx, cap, vr, vi, reps, dev, smi)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
        if cap == 128:
            p128, vis128 = p, vis
    for P in (1, 2):
        rec = probe(p128, vis128, P, reps, dev, smi)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    errs = [r["rel_err"] for r in recs if "rel_err" in r]
    summary = dict(lab="capacity", nrow=nrow, nchan=nchan, nx=nx,
                   epsilon=EPSILON, card=smi,
                   spread_fold_ms={r["C"]: r["ms"] for r in recs[:3]},
                   k4_ms={r["C"]: r["k4_ms"] for r in recs[:3]},
                   probe_ms={r["name"]: r["ms"] for r in recs[3:]},
                   max_rel_err=max(errs), tol=TOL,
                   ok=all(e <= TOL for e in errs))
    line = json.dumps(summary)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
