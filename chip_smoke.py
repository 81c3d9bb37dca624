#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (pfb_tpu_torch) runs its
imaging paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the hand-written kernels from pfb_tpu_torch/csrc (one
     nvcc per source, in parallel), and say which host plan builder runs;
  3. wgrid path: simulate a 64-antenna, 128-integration, 8-channel
     observation (2.06 M visibilities, random point sources from a fixed
     seed), then init -> grid(backend="wgrid", 2048^2, PSF 4096^2) ->
     spotless(engine="pallas", backend="wgrid", 3 major iterations), with
     every kernel's launch count reset just before and read just after;
  4. kernel vs plain for that path: the PSF-convolution kernel (K1) with
     the transfer function of the grid phase's PSF, complex and its real
     even part; the c2c kernel (K3) on the image and PSF w-plane stacks;
  5. checks of the wgrid path: launches > 0 inside grid and spotless,
     kernel errors within tolerance, the MFS residual rms after the last
     major iteration below the dirty rms, the brightest simulated sources
     recovered at their pixels;
  6. pg path, same observation: init -> grid(backend="pg", robustness=0,
     2048^2, PSF 4096^2) -> spotless(engine="pallas", backend="pg", 3 major
     iterations), counts reset just before and read just after; the plans'
     w planes and tiles;
  7. kernel vs plain for the pg gridder: spread (K4) and fold (K5) on one
     dataset's image plan and PSF plan, degrid (K6) on the image plan with
     the w-plane grids of the pg path's model; and the pg dirty image
     against the wgrid dirty image of the same dataset and weights
     (max|diff| <= 1e-4 max|wgrid|);
  8. checks of the pg path, as in 5, with K4 and K5 launched in grid and
     spotless and K6 in spotless.
Kernel tolerance: max|kernel - plain| <= 1e-5 max|plain|, with
CUDA-event medians of both.

Exits non-zero (and prints no result line) when there is no CUDA device,
when the package is not beside this script, or when any phase fails.
The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

TOL = 1e-5
XTOL = 1e-4  # pg against wgrid dirty image
NX = 2048
SIM = dict(nant=64, ntime=128, nchan=8, nsource=20, extent=4000.0,
           seed=7, gains=False)
GRID = dict(backend="wgrid", nx=NX, ny=NX, epsilon=1e-5, robustness=None,
            psf=True, residual=False)
SPOT = dict(engine="pallas", backend="wgrid", epsilon=1e-5,
            bases="self,db1,db2", nlevels=3, niter=3, pd_maxit=100)
GRID_PG = dict(GRID, backend="pg", robustness=0.0)
SPOT_PG = dict(SPOT, backend="pg")


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps=5):
    """Median CUDA-event time of fn() in milliseconds (one warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from pfb_tpu_torch.ops.cfft import fftx_c2c
    from pfb_tpu_torch.ops.pgridder import pg_degrid, pg_fold, pg_spread
    from pfb_tpu_torch.ops.psf import psf_convolve_h
    return {"K1": psf_convolve_h, "K3": fftx_c2c, "K4": pg_spread,
            "K5": pg_fold, "K6": pg_degrid}


def simulate(workdir, nx=NX, sim=SIM):
    """The simulated observation (an npz measurement set) and its truth;
    field of view of exactly nx cells, so the true model sits on the
    grid's pixels."""
    import numpy as np

    from pfb_tpu_torch.utils.ms import simulate_ms
    from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs
    t0 = time.perf_counter()
    obs = simulate_obs(nant=sim["nant"], ntime=sim["ntime"],
                       nchan=sim["nchan"], seed=sim["seed"],
                       extent=sim["extent"])
    _, cell = image_size_for(obs, fov_deg=1.0)
    fov = (nx + 0.5) * np.rad2deg(cell)
    ms = str(Path(workdir) / "sim.npz")
    model_true, Ix, Iy, nx_sim, cell_rad, _ = simulate_ms(
        ms, fov_deg=fov, **sim)
    need(nx_sim == nx, f"simulated model is {nx_sim}^2, not {nx}^2")
    return dict(ms=ms, model_true=model_true, Ix=Ix, Iy=Iy,
                cell_rad=cell_rad, nvis=obs.uvw.shape[0] * sim["nchan"],
                t_simulate=time.perf_counter() - t0)


def main_path(truth, device, grid=GRID, spot=SPOT):
    """_init -> _grid -> _spotless on ``device``; returns a dict of
    results, stage times and, per stage, every kernel's launches (counts
    set to 0 just before the path and read after each stage)."""
    import numpy as np
    import torch

    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    from pfb_tpu_torch.workers.spotless import _spotless

    cnt = counters()
    res = {"t": {}, "launches": {}}
    for fn in cnt.values():
        fn.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xds = _init(ms=truth["ms"], precision="single", channels_per_image=1,
                write=False, device=device)
    res["t"]["init"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    dds = _grid(xdsi=xds, write=False, device=device, **grid)
    sync(device)
    res["t"]["grid"] = time.perf_counter() - t0
    res["launches"]["grid"] = {k: fn.launches for k, fn in cnt.items()}

    dirty_mfs = sum(ds["DIRTY"] for ds in dds) / \
        sum(float(ds["WSUM"][0]) for ds in dds)
    res["dirty_rms"] = float(np.std(dirty_mfs))
    stats = {}
    t0 = time.perf_counter()
    model, residual = _spotless(ddsi=dds, write=False, device=device,
                                stats=stats, verbose=0, **spot)
    sync(device)
    if device.type == "cuda":
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["t"]["spotless"] = time.perf_counter() - t0
    res["launches"]["spotless"] = {
        k: fn.launches - res["launches"]["grid"][k] for k, fn in cnt.items()}
    res.update(stats=stats, model=model, residual=residual, dds=dds,
               xds=xds)
    return res


def wgrid_planes(dds, nx, epsilon):
    """(nw image, nw PSF) of the w-stacking plans of the first dataset."""
    import torch

    from pfb_tpu_torch.ops.wgridder import _plan
    ds = dds[0]
    uvw = torch.as_tensor(ds["UVW"])
    freq = torch.as_tensor(ds["FREQ"])
    c = float(ds["cell_rad"])
    nw_img = _plan(uvw, freq, nx, nx, c, c, 0.0, 0.0, epsilon, True, 2.0)[4]
    nw_psf = _plan(uvw, freq, 2 * nx, 2 * nx, c, c, 0.0, 0.0, epsilon,
                   True, 2.0)[4]
    return nw_img, nw_psf


def _fft2_pruned_plain(xr, xi, Nx, Ny, inverse, pruned_in, pruned_out):
    """Plain counterpart of ops.cfft.fft2_c2c_pruned on any device."""
    from pfb_tpu_torch.ops.cfft import fftx_c2c_plain
    P = xr.shape[0]
    yr, yi = fftx_c2c_plain(xr, xi, N=Nx, inverse=inverse,
                            in_rolled=pruned_in, out_rolled=pruned_out)
    nrow, ncol = yr.shape[-2:]
    yr, yi = fftx_c2c_plain(yr.reshape(P * nrow, ncol, 1),
                            yi.reshape(P * nrow, ncol, 1), N=Ny,
                            inverse=inverse, in_rolled=pruned_in,
                            out_rolled=pruned_out)
    return yr.reshape(P, nrow, -1), yi.reshape(P, nrow, -1)


def _record(name, shape, out, ref, fk, fp, timing):
    """One kernel-against-plain comparison (and CUDA-event times)."""
    import numpy as np
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    r = dict(name=name, shape=list(shape), max_abs_err=err,
             rel_err=err / scale, tol=TOL, ok=bool(err <= TOL * scale))
    if timing:
        # alternate plain and kernel so both see the same clocks
        r["plain_ms"] = cuda_ms(fp)
        r["ms"] = cuda_ms(fk)
        r["plain_ms"] = 0.5 * (r["plain_ms"] + cuda_ms(fp))
    r["max_abs_err"] = float(np.float64(r["max_abs_err"]))
    return r


def kernel_checks(dds, nx, nw_img, nw_psf, device, timing=True):
    """K1 and K3 against their plain versions on the same inputs; returns
    one record per comparison."""
    import torch

    from pfb_tpu_torch.ops.cfft import fft2_c2c_pruned
    from pfb_tpu_torch.ops.psf import (prep_h, psf_convolve_h,
                                       psf_convolve_h_plain)
    from pfb_tpu_torch.workers.cubes import dds2cubes

    recs = []
    nband = max(ds["bandid"] for ds in dds) + 1
    psf = dds2cubes(dds, nband)[3]
    psf_t = torch.as_tensor(psf, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((nband, nx, nx), generator=g, device=device)
    # complex H, then the even part (real H) of the same PSF
    for mode in (False, True):
        hr, hi = prep_h(psf_t, nx, nx, torch.float32, real_transfer=mode)
        out = psf_convolve_h(x, hr, hi)
        ref = psf_convolve_h_plain(x, hr, hi)
        recs.append(_record(
            f"K1 psf_convolve_h {'real' if hi is None else 'complex'}-H",
            x.shape, out, ref, lambda: psf_convolve_h(x, hr, hi),
            lambda: psf_convolve_h_plain(x, hr, hi), timing))
        del hr, hi, out, ref
    del psf_t

    N = 2 * nx
    cases = [("K3 fft2 pruned_out inverse (image grids)", nw_img, N, True,
              False, True),
             ("K3 fft2 pruned_in forward (image grids)", nw_img, N, False,
              True, False),
             ("K3 fft2 pruned_out inverse (PSF grids, 4 planes)",
              min(4, nw_psf), 2 * N, True, False, True)]
    for name, P, Ng, inv, pin, pout in cases:
        nin = Ng // 2 if pin else Ng
        xr = torch.randn((P, nin, nin), generator=g, device=device)
        xi = torch.randn((P, nin, nin), generator=g, device=device)
        kw = dict(Nx=Ng, Ny=Ng, inverse=inv)
        yr, yi = fft2_c2c_pruned(xr, xi, pruned_in=pin, pruned_out=pout,
                                 **kw)
        rr, ri = _fft2_pruned_plain(xr, xi, Ng, Ng, inv, pin, pout)
        out = torch.complex(yr, yi)
        ref = torch.complex(rr, ri)
        del yr, yi, rr, ri
        recs.append(_record(
            name, (P, nin, nin), out, ref,
            lambda: fft2_c2c_pruned(xr, xi, pruned_in=pin,
                                    pruned_out=pout, **kw),
            lambda: _fft2_pruned_plain(xr, xi, Ng, Ng, inv, pin, pout),
            timing))
        del out, ref, xr, xi
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return recs


def pg_plans(ds, nx, epsilon, device):
    """The pg plans of one dataset's image (nx^2) and PSF ((2 nx)^2), as
    _grid makes them (rows padded to the row bucket)."""
    import numpy as np

    from pfb_tpu_torch.ops.gridder import row_bucket
    from pfb_tpu_torch.ops.pgridder import pgrid_plan
    uvw = np.asarray(ds["UVW"], np.float64)
    uvw = np.pad(uvw, ((0, row_bucket(uvw.shape[0]) - uvw.shape[0]),
                       (0, 0)))
    c = float(ds["cell_rad"])
    return [pgrid_plan(uvw, ds["FREQ"], nx=n, ny=n, cellx=c, celly=c,
                       epsilon=epsilon, device=device)
            for n in (nx, 2 * nx)]


def plan_summary(p):
    return dict(k=p["k"], nw=p["nw"], Nx=p["Nx"], tiles=[p["txs"], p["tys"]],
                ntiles=p["ntx"] * p["nty"], entries=p["nentries"])


def pg_kernel_checks(res, nx, epsilon, device, timing=True):
    """K4, K5 (alone and chained) on one dataset's image and PSF plans
    with its weighted visibilities, K6 on the image plan with the w-plane
    grids of the pg path's band-0 model; returns (records, plans)."""
    import torch

    from pfb_tpu_torch.ops import pgridder as pg
    from pfb_tpu_torch.ops.wgridder import _image_to_grid

    ds, xds0 = res["dds"][0], res["xds"][0]
    plans = pg_plans(ds, nx, epsilon, device)
    recs = []
    for label, p in zip(("image", "PSF"), plans):
        k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
        Thx, Thy = txs + k, tys + k
        nrow = ds["UVW"].shape[0]
        vis = torch.as_tensor(xds0["VIS"]).to(device)
        if label == "PSF":
            vis = torch.ones_like(vis)
        w = torch.zeros((p["nrow"], p["nchan"]), dtype=p["rdtype"],
                        device=device)
        w[:nrow] = torch.as_tensor(ds["WEIGHT"] * ds["MASK"]).to(w)
        vr = torch.zeros_like(w)
        vi = torch.zeros_like(w)
        vr[:nrow], vi[:nrow] = vis.real.to(w), vis.imag.to(w)
        ix = p["idx"].long()
        vr, vi = (vr * w).reshape(-1), (vi * w).reshape(-1)
        vis = torch.stack([vr[ix] * p["pm"], vi[ix] * p["pm"]],
                          dim=1).contiguous()
        slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"],
                                  txs, tys, k)
        skw = dict(beta=p["beta"], k=k, nw=nw, Thx=Thx, Thy=Thy)
        fkw = dict(nty=p["nty"], txs=txs, tys=tys, k=k, Nx=p["Nx"],
                   Ny=p["Ny"])
        shape = (2 * nw, slots["NS"], Thx, Thy)

        def spread_k():
            return pg.pg_spread(p["pos"], vis, slots, **skw).reshape(shape)

        def spread_p():
            return pg.pg_spread_plain(p["pos"], vis, slots,
                                      **skw).reshape(shape)

        def fold_k(Y):
            return pg.pg_fold(Y, slots, ntx=p["ntx"], **fkw)

        def fold_p(Y):
            return pg.pg_fold_plain(Y, slots, **fkw)

        Yk, Yp = spread_k(), spread_p().contiguous()
        live = slots["live"]  # the kernel writes live slots only
        recs.append(_record(f"K4 pg_spread ({label} plan)", shape,
                            Yk[:, live], Yp[:, live], spread_k, spread_p,
                            timing))
        del Yk
        Gk, Gp = fold_k(Yp), fold_p(Yp)
        recs.append(_record(f"K5 pg_fold ({label} plan)", Gp.shape, Gk, Gp,
                            lambda: fold_k(Yp), lambda: fold_p(Yp), timing))
        del Gk, Gp, Yp
        Gk, Gp = fold_k(spread_k()), fold_p(spread_p())
        recs.append(_record(f"K4+K5 grids ({label} plan)", Gp.shape, Gk, Gp,
                            None, None, False))
        del Gk, Gp, vis, slots
        if device.type == "cuda":
            torch.cuda.empty_cache()

    p = plans[0]
    model = torch.as_tensor(res["model"][0], dtype=p["rdtype"],
                            device=device)
    gr, gi = _image_to_grid(model, nx, nx, p["cellx"], p["celly"], p["k"],
                            p["beta"], p["Nx"], p["Ny"], p["nw"] > 1,
                            p["nw"], float(p["w0"]), float(p["dw"]), False)
    gr, gi = gr.contiguous(), gi.contiguous()
    dkw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
               tys=p["tys"], nty=p["nty"])

    def degrid_k():
        return pg.pg_degrid(gr, gi, p["pos"], p["tid"], **dkw)

    def degrid_p():
        return pg.pg_degrid_plain(gr, gi, p["pos"], p["tid"], **dkw)

    recs.append(_record("K6 pg_degrid (image plan, model grids)",
                        (p["nentries"], 2, p["C"]), degrid_k(), degrid_p(),
                        degrid_k, degrid_p, timing))
    return recs, plans


def pg_cross_check(res, nx, epsilon, device):
    """max|pg - wgrid| / max|wgrid| of one dataset's dirty image, same
    visibilities and weights, both float32 on ``device``."""
    import torch

    from pfb_tpu_torch.ops.pgridder import vis2dirty_pg
    from pfb_tpu_torch.ops.wgridder import vis2dirty_wgrid
    ds, xds0 = res["dds"][0], res["xds"][0]
    rdt = torch.float32 if device.type == "cuda" else torch.float64
    uvw = torch.as_tensor(ds["UVW"]).to(device)
    freq = torch.as_tensor(ds["FREQ"]).to(device)
    vis = torch.as_tensor(xds0["VIS"]).to(device)
    vis = vis.to(torch.complex64 if rdt == torch.float32 else
                 torch.complex128)
    wgt = torch.as_tensor(ds["WEIGHT"] * ds["MASK"]).to(device, rdt)
    c = float(ds["cell_rad"])
    kw = dict(nx=nx, ny=nx, cellx=c, celly=c, epsilon=epsilon)
    a = vis2dirty_pg(uvw, freq, vis, wgt=wgt, **kw)
    b = vis2dirty_wgrid(uvw, freq, vis, wgt=wgt, **kw)
    return float((a - b).abs().max() / b.abs().max())


def source_checks(res, truth, nbright=3):
    """The brightest true sources: model flux at their pixels, and the
    model's local maximum (5x5) there."""
    import numpy as np
    true_mfs = truth["model_true"].sum(axis=0)
    model_mfs = res["model"].sum(axis=0)
    flux = true_mfs[truth["Ix"], truth["Iy"]]
    out = []
    for s in np.argsort(flux)[::-1][:nbright]:
        i, j = int(truth["Ix"][s]), int(truth["Iy"][s])
        win = model_mfs[max(i - 2, 0):i + 3, max(j - 2, 0):j + 3]
        out.append(dict(pixel=[i, j], true=float(flux[s]),
                        model=float(model_mfs[i, j]),
                        local_max=bool(model_mfs[i, j] > 0
                                       and model_mfs[i, j] >= win.max())))
    return out


def report_path(tag, res, truth, nx):
    """Print a path's stage times, memory, residuals and launches; check
    its image and return its source records."""
    import numpy as np
    st = res["stats"]
    print(f"[{tag}] stage seconds " + json.dumps(
        {k: round(v, 3) for k, v in res["t"].items()}))
    print(f"[{tag}] peak device memory {res['peak_mem_gb']:.2f} GiB")
    print(f"[{tag}] hessnorm {st['hessnorm']:.6e}, engine {st['engine']}; "
          f"dirty MFS rms {res['dirty_rms']:.6e}")
    for k, (r, m, n) in enumerate(zip(st["rms"], st["rmax"],
                                      st["pd_iters"])):
        print(f"[{tag}] major {k + 1}: MFS residual rms {r:.6e}, "
              f"peak {m:.6e}, pd iters {n}")
    print(f"[{tag}] launches " + json.dumps(res["launches"]))
    srcs = source_checks(res, truth)
    for s in srcs:
        print(f"[{tag}] source {s}")
    need(all(np.isfinite(v) for v in st["rms"]) and
         np.isfinite(res["model"]).all(), f"{tag}: non-finite model/residual")
    need(res["model"].shape == (len(res["dds"]), nx, nx),
         f"{tag}: model shape {res['model'].shape}")
    need(st["rms"][-1] < res["dirty_rms"],
         f"{tag}: residual rms {st['rms'][-1]} not below dirty rms "
         f"{res['dirty_rms']}")
    need(all(s["local_max"] for s in srcs),
         f"{tag}: bright sources not recovered at their pixels: {srcs}")
    return srcs


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "pfb_tpu_torch" / "__init__.py").exists():
        print("FAIL: pfb_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    device = torch.device("cuda")

    try:
        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        print(smi_line)
        print(f"[device] {torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

        # 2. build
        from pfb_tpu_torch import kernels, native
        t0 = time.perf_counter()
        kernels.library()
        print(f"[build] {time.perf_counter() - t0:.1f} s "
              f"(nvcc {kernels.build_seconds()} s); plan builder: "
              f"{native.builder()}")

        # 3. wgrid path
        workdir = root / "build" / "chip_smoke"
        workdir.mkdir(parents=True, exist_ok=True)
        truth = simulate(workdir)
        print(f"[main] simulate {truth['t_simulate']:.3f} s (host)")
        res = main_path(truth, device)
        nw_img, nw_psf = wgrid_planes(res["dds"], NX, GRID["epsilon"])
        print(f"[main] {truth['nvis']} visibilities, image {NX}^2 x "
              f"{len(res['dds'])} bands, PSF {2 * NX}^2; w planes: image "
              f"{nw_img}, PSF {nw_psf}")
        srcs = report_path("main", res, truth, NX)
        launches = {k: res["launches"]["grid"][k]
                    + res["launches"]["spotless"][k] for k in counters()}

        # 4. kernel vs plain (K1, K3)
        recs = kernel_checks(res["dds"], NX, nw_img, nw_psf, device)
        for r in recs:
            print("[kernel] " + json.dumps(r))

        # 5. checks of the wgrid path
        lw = res["launches"]
        need(lw["spotless"]["K1"] > 0, "K1 never launched on the main path")
        need(lw["grid"]["K3"] > 0, "K3 never launched inside _grid")
        need(lw["spotless"]["K3"] > 0, "K3 never launched inside _spotless")
        del res, srcs
        torch.cuda.empty_cache()

        # 6. pg path
        rpg = main_path(truth, device, grid=GRID_PG, spot=SPOT_PG)
        report_path("pg", rpg, truth, NX)
        for k in launches:
            launches[k] += rpg["launches"]["grid"][k] + \
                rpg["launches"]["spotless"][k]
        lp = rpg["launches"]

        # 7. kernel vs plain (K4, K5, K6), pg against wgrid
        pg_recs, plans = pg_kernel_checks(rpg, NX, GRID_PG["epsilon"],
                                          device)
        for name, p in zip(("image", "PSF"), plans):
            print(f"[pg] {name} plan " + json.dumps(plan_summary(p)))
        del plans
        for r in pg_recs:
            print("[kernel] " + json.dumps(r))
        recs += pg_recs
        xerr = pg_cross_check(rpg, NX, GRID_PG["epsilon"], device)
        print(f"[pg] dirty image pg vs wgrid (dataset 0, same weights): "
              f"max|diff|/max|wgrid| = {xerr:.3e} (bound {XTOL})")

        # 8. checks
        for k in ("K4", "K5"):
            need(lp["grid"][k] > 0, f"{k} never launched inside pg _grid")
            need(lp["spotless"][k] > 0,
                 f"{k} never launched inside pg _spotless")
        need(lp["spotless"]["K6"] > 0, "K6 never launched inside _spotless")
        bad = [r["name"] for r in recs if not r["ok"]]
        need(not bad, f"kernel disagrees with its plain version: {bad}")
        need(xerr <= XTOL, f"pg vs wgrid dirty {xerr} > {XTOL}")

        def worst(prefix):
            return max(r["max_abs_err"] for r in recs
                       if r["name"].startswith(prefix))

        def first(prefix, key):
            return next(r[key] for r in recs
                        if r["name"].startswith(prefix) and key in r)

        table = [("K1", "psf_convolve_h", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:877"),
                 ("K3", "fftx_c2c", "cfft.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K4", "pg_spread", "pg_grid.cu",
                  "pfb_tpu/ops/pgridder.py:330"),
                 ("K5", "pg_fold", "pg_fold.cu",
                  "pfb_tpu/ops/pgridder.py:511"),
                 ("K6", "pg_degrid", "pg_degrid.cu",
                  "pfb_tpu/ops/pgridder.py:848")]
        kern = {"kernels": [
            {"name": name, "route": "cuda",
             "source": f"pfb_tpu_torch/csrc/{src}", "replaces": rep,
             "launches": launches[k], "max_abs_err": worst(k + " "),
             "ms": first(k + " ", "ms"),
             "plain_ms": first(k + " ", "plain_ms")}
            for k, name, src, rep in table]}
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(smi_line)
    print(json.dumps(kern))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
