#!/usr/bin/env python3
"""Where the time of one primal-dual iteration of pfb_tpu_torch's
space-sharded spotless goes on the card, against the one-device one.

    python3 scripts/profile_torch_dist.py [--nx 2048] [--nband 8]
        [--nspace 4] [--reps 20] [--out FILE]

At chip_smoke.py's dist-path shapes (8 bands of 2048^2 on a (2, 4) mesh
of virtual shards of one card, bases self,db1,db2, 3 levels, a Gaussian
PSF with a complex transfer function) it times, each as the median of
``reps`` calls after a warm-up, host clock ending in a synchronise:

- the PSF matvec: K1 on the whole cube, and the space-sharded K10 with
  its four all-to-alls;
- the SARA analysis + synthesis: psi_dot + psi_hdot on the whole cube,
  and the halo-exchange pair on the shards;
- one whole iteration of each solver (primal_dual_dist on a (2, 1) mesh,
  primal_dual_space_dist on the (2, nspace) mesh, tol 0), so the rest
  (dual update, sums over the shards, elementwise passes) is the
  difference.

It also runs one space-sharded iteration under torch.profiler and
reports the device's busy time (the union of kernel and copy intervals)
against the wall time. Prints one JSON object (and writes it to
``--out`` when given). Needs a CUDA device; ``--device cpu`` rehearses
it at a small ``--nx`` with the plain versions (no profile).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def median_s(fn, reps, sync):
    fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def busy_fraction(fn, sync):
    """(device busy seconds, wall seconds) of one call of fn under
    torch.profiler: the union of the kernel and copy intervals."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    iv = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events()
                if e.device_type.name == "CUDA" and e.time_range.end >
                e.time_range.start)
    busy, end = 0.0, None
    for a, b in iv:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6, wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--nband", type=int, default=8)
    ap.add_argument("--nspace", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script with the plain versions")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pfb_tpu_torch.ops.psf import prep_h, prep_h_space, psf_convolve_h
    from pfb_tpu_torch.ops.psi import make_psi, psi_dot, psi_hdot
    from pfb_tpu_torch.parallel.dist import (hessian_psf_space_dist,
                                             primal_dual_dist,
                                             primal_dual_space_dist)
    from pfb_tpu_torch.parallel.dwt_halo import (halo_psi_dot,
                                                 halo_psi_hdot,
                                                 make_halo_plan)
    from pfb_tpu_torch.parallel.mesh import along, make_mesh, shard

    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    nb, nx, ns = args.nband, args.nx, args.nspace
    x1 = torch.arange(2 * nx, device=dev) - nx
    r2 = (x1[:, None] ** 2 + x1[None, :] ** 2).float()
    psf = torch.stack([0.4 * torch.exp(-0.5 * r2 / (2.0 + 0.1 * b) ** 2)
                       for b in range(nb)])
    psf[:, nx, nx] += 0.6
    psf[:, nx + 3, nx + 1] += 0.02
    hr, hi = prep_h(psf, nx, nx, torch.float32)
    hsr, hsi = prep_h_space(psf, nx, nx, ns, torch.float32)
    del psf, r2
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((nb, nx, nx), generator=g, device=dev)
    data = torch.rand((nb, nx, nx), generator=g, device=dev)
    psi = make_psi(nx, nx, ("self", "db1", "db2"), 3)
    mesh = make_mesh(nband=2, nspace=ns, devices=[dev] * 2 * ns)
    band = make_mesh(nband=2, nspace=1, devices=[dev] * 2)
    spec = ("band", "space", None)
    xs = shard(x, mesh, spec)
    hs = [shard(h, mesh, spec) for h in (hsr, hsi)]
    qy = -(-psi.Nymax // ns)
    plan = make_halo_plan(psi, ns, qy)
    space_mv = hessian_psf_space_dist(mesh, method="pallas")
    out = {"nx": nx, "nband": nb, "nspace": ns, "reps": args.reps}
    t = {}
    t["matvec K1"] = median_s(lambda: psf_convolve_h(x, hr, hi),
                              args.reps, sync)
    t["matvec K10 space"] = median_s(lambda: space_mv(xs, *hs), args.reps,
                                     sync)
    t["psi dot+hdot one device"] = median_s(
        lambda: psi_hdot(psi_dot(x, psi), psi), args.reps, sync)
    t["psi dot+hdot halo"] = median_s(
        lambda: along(mesh, "space", lambda p, d: halo_psi_hdot(p, d, plan),
                      along(mesh, "space",
                            lambda p, d: halo_psi_dot(p, d, plan),
                            xs.parts)), args.reps, sync)
    kw = dict(nu=psi.nbasis, tol=0.0, maxit=1, positivity=1)
    v0 = torch.zeros((nb, psi.nbasis, psi.Nymax, psi.Nxmax), device=dev)
    w = torch.ones((psi.nbasis, psi.Nymax, psi.Nxmax), device=dev)
    pd_b = primal_dual_dist(band, psi, engine="pallas", **kw)
    pd_s = primal_dual_space_dist(mesh, psi, engine="pallas", **kw)
    hb = [shard(h, band, ("band", None, None)) for h in (hr, hi)]
    xb = shard(x, band, ("band", None, None))
    db = shard(data, band, ("band", None, None))
    vb = shard(v0, band, ("band", None, None, None))
    ds = shard(data, mesh, spec)
    vs = shard(v0, mesh, ("band", None, "space", None))
    t["pd iteration band (2, 1)"] = median_s(
        lambda: pd_b(xb, vb, db, tuple(hb), w, 1e-3, 50.0), args.reps, sync)
    t["pd iteration space (2, %d)" % ns] = median_s(
        lambda: pd_s(xs, vs, ds, tuple(hs), w, 1e-3, 50.0), args.reps, sync)
    out["seconds"] = t
    if dev.type == "cuda":
        busy, wall = busy_fraction(
            lambda: pd_s(xs, vs, ds, tuple(hs), w, 1e-3, 50.0), sync)
        out["space_iteration_profiled"] = dict(
            device_busy_s=busy, wall_s=wall, idle_share=1.0 - busy / wall)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
