#!/usr/bin/env python3
"""Per-stage timing lab for pfb_tpu_torch's PSF-convolution kernels on
the card (counterpart of scripts/wl_kernel_lab.py's k1 / k2 / k3).

    python3 scripts/torch_kernel_lab.py [--nband 8] [--nx 2048,4096]
        [--reps 10] [--device cuda] [--out FILE]
    python3 scripts/torch_kernel_lab.py --digest [--root DIR]
    python3 scripts/torch_kernel_lab.py --minblocks 1,2,3,4 [--out FILE]
    python3 scripts/torch_kernel_lab.py --fold [--root DIR]
    python3 scripts/torch_kernel_lab.py --spread [--root DIR]
    python3 scripts/torch_kernel_lab.py --degrid [--root DIR]
    python3 scripts/torch_kernel_lab.py --degrid-rungs
    python3 scripts/torch_kernel_lab.py --degrid-const NAME=V1,V2
    python3 scripts/torch_kernel_lab.py --offroute [--root DIR]
    python3 scripts/torch_kernel_lab.py --cols-short [--root DIR]
    python3 scripts/torch_kernel_lab.py --cols-const NAME=V1,V2
    python3 scripts/torch_kernel_lab.py --rows-times [--root DIR]
    python3 scripts/torch_kernel_lab.py --rows-const NAME=V1,V2
    python3 scripts/torch_kernel_lab.py --lengths [--root DIR]
    python3 scripts/torch_kernel_lab.py --long [--root DIR]
    python3 scripts/torch_kernel_lab.py --short [--root DIR]
    python3 scripts/torch_kernel_lab.py --cols-tiny [--root DIR]
    python3 scripts/torch_kernel_lab.py --two-pass [--root DIR] [--out FILE]
    python3 scripts/torch_kernel_lab.py --spills [--out FILE]

At (8, nx^2) with a (2nx)^2 PSF for each nx of ``--nx`` (a delta 1.0 at
the centre and 0.05 at +5, +3, as wl_kernel_lab.py builds it; complex
transfer function) it times, each as the CUDA-event median of ``reps``
calls after a warm-up:

- K15's two column transforms on the v3 row layout (NXH = NX/2 + N1x
  rows): v3_cols_fwd and v3_cols_inv;
- the rows stage on those NXH rows against the NXH-row H
  (psf_stage_rows), wl_kernel_lab.py's ``_k2v_kernel`` case;
- K1's three stages as K10's entries at one space shard
  (psf_stage_cols_fwd, psf_stage_rows, psf_stage_cols_inv), K1 whole
  (psf_convolve_h) and K1's plain version (psf_convolve_h_plain, cuFFT);
- where the column route holds (ops/psf.py:cols_route, NX >= 2048), the
  cluster column kernels themselves (csrc/psf_cols.cu): the forward (two
  real columns as one complex line), the inverse, and both skeletons
  (loads, exchange, separation or Hermitian part, stores; the FFT
  compiled out);
- for context, the rows stage on K1's rows as three torch.fft calls
  (fft, the product with H, ifft, crop; no one call computes it);
- the library calls of the column stages: torch.fft.rfft(x, n=NX,
  dim=-2), torch.fft.fft(x, n=NX, dim=-2)[:, :NXH] and
  torch.fft.irfft(w[:, :NX/2 + 1], n=NX, dim=-2)[:, :nx].

It checks the three stages chained against K1 whole (<= 1e-5 of max)
and reports the sum of the stage times against K1's. It prints one JSON
line per stage, each with its bound (``chip_smoke.py:bound``: each input
read once and each output written once over 3.35 TB/s, or the FP32
operations over 67 TFLOP/s) and the card's name and power limit, a
summary line per size, then a last summary line (also written to
``--out``).

``--digest`` prints the sha256 of K1's, K2's, K3's, K10's, K11's,
K12's, K15's, the fold's (K8's entry), the spreads' (K4, K7) and the
degrids' (K6, K9) outputs
on fixed seeded inputs, with the
pfb_tpu_torch found under ``--root`` (default: this repo), so two trees
can be compared bit for bit on one card: the lengths below 4096 (K1, K10
and K11 on ``line_fft_kernel``), K1 and K10 at NX = 4096, K11 at 6144,
K12 and K15 at 8192 (the column stages' cluster route since it exists),
K1 and K10's rows stage at NY = 4096 and K11 at 6144 (the rows stage's
register route since it exists), the fold on three tile geometries, K2
on the column stages' cluster route (NX = 4096) and on the line kernels
(2048), the spreads K4 (k = 7 and 9) and K7 on seeded plans, and the
degrids K6 (k = 7 and 9) and K9 on seeded plans and grids.
``--root`` also times another tree's kernels (one from before the cluster
column kernels times the rest), so two trees compare in one call.
``--device cpu`` rehearses the timing at a small ``--nx`` with the plain
versions.

``--fold`` times the folds K5 (pg_fold) and K8 (pg_fold_gs) of the tree
at ``--root`` at the shapes chip_smoke.py gives them (FOLD_SHAPES: their
plans' tiles and live-slot counts, the live tiles drawn from a seed),
beside chip_smoke.py's fold_library (a zero fill, then index_add_), one
JSON line a shape; run it with and without ``--root`` in one call to
compare two trees.

``--spread`` times the spreads K4 (pg_spread) and K7 (pg_spread_gs) of
the tree at ``--root`` at the shapes chip_smoke.py gives them
(:func:`spread_cases`: the pg path's image and PSF plans, the klean
path's and the flagship's largest w block), with the slots' chains
(entries a slot: longest and mean) and the bound; where the tree has the
spread lab (``pg_stream.pg_spread_lab``, ``csrc/lab_spread.cu``), both
designs (the lists of ``csrc/pg_grid.cu`` and the earlier scan) with
each one's skeletons and the split of its time into FMAs, scan, factors,
loads and barriers (:func:`spread_times`), and whether each design's
grids equal the shipped spread's bit for bit.

``--degrid`` times the degrids K6 (pg_degrid) and K9 (pg_degrid_gs) of
the tree at ``--root`` at the shapes chip_smoke.py gives them
(:func:`degrid_cases`: the pg path's image plan, the klean path's and
the flagship's largest w block) with the bound; where the tree has the
degrid lab (``pg_stream.pg_degrid_lab``, ``csrc/lab_degrid.cu``), every
design of ``csrc/pg_degrid.cu`` (the staged window, the lanes along the
taps and the earlier thread a visibility) with each one's skeletons (the
factors alone, the grid loads alone, the sums on register data), and
whether each design's output equals the shipped degrid's bit for bit.

``--degrid-rungs`` times every design of the degrid lab and the degrid
as the paths call it on plans forced to the tile ladder's rungs with
the longer tiles (:func:`rung_cases`), where the window design's shared
memory lets three, two or one of its blocks on an SM: the times that set
K6 / K9's choice between the window and the taps or the thread design.

``--degrid-const NAME=V1,V2`` probes a constant of the degrid: copies of
pfb_tpu_torch under ``build/lab_degrid/<NAME>/<value>/`` with
``csrc/pg_degrid.cu``'s ``constexpr int NAME`` set to each value (for
example the block sizes ``kTapsThreads`` and ``kWinThreads``), built at
once, then this tree, each copy and this tree again timed by
``--degrid`` in child processes.

``--offroute`` times the kernels of the tree at ``--root`` at the
lengths 2048-5120 (:func:`offroute_times`: K3's x and y passes, the PSF
column stages and rows stage, K11 where v3 does not hold), each with the
route its call took (the launch counters it moved), the bound and the
library call or plain version: run it with and without ``--root`` in one
call to compare two trees.

``--cols-short`` times the cluster column kernels of the tree at
``--root`` at the lengths below 4096, on the route's clusters
(:func:`cols_short_times`: K3c's x pass of the 2-D transforms at (9,
2048^2), (10, 2560^2) and (9, 3072^2), both directions, and the PSF
column stages psf_cols_fwd / _inv at (8, NX/2, NX/2)), beside torch.fft;
``--cols-const kShortClusters=2,4`` builds copies of the package with
``csrc/psf_cols.cuh``'s ``constexpr int NAME`` set to each value (and,
for ``kShortClusters``, its mirror ops/cfft.py:_SHORT_C with it) under
``build/lab_cols/<NAME>/<value>/`` and times them by ``--cols-short``, as
``--degrid-const`` does: the readings that set the route's C below 4096.

``--rows-times`` times the register row kernels of the tree at ``--root``
at the nine lengths 2048-12288 of R2 = 8-48 (:func:`rows_times`: K3r's y
pass and K10br's rows stage, K1's shapes); ``--rows-const NAME=V1,V2`` builds copies of
the package with ``csrc/rows_fft.cuh``'s ``constexpr int NAME`` set to
each value (``kShortRowThreads``: the threads of a block at N = 2048)
under ``build/lab_rows/<NAME>/<value>/`` and times them by
``--rows-times``, as ``--degrid-const`` does.

``--lengths`` times the tree at ``--root`` at the row lengths of the
128-aligned images whose R2 = N / 256 had no register instance before
(2304-16384: K3's y pass through fftx_c2c and the
PSF rows stage through psf_stage_rows) and fftx_c2c at 18432 and 32768
(the PSF grids of 4608^2 and 8192^2 images), each with the route its call
took, torch.fft and the bound; a call that raises is recorded with what
it raised. Run it with and without ``--root`` in one call to compare two
trees.

``--long`` times the tree at ``--root`` above 16384 (:func:`long_times`:
the x pass and the y pass at 18432, 24576 and 32768, both directions,
each call's route beside the four-step, the lab's one-pass designs K3cl
and K3fr, K3cl's skeleton and torch.fft; K3c alone and its skeleton at
the four-step's second stage). ``--device cpu`` rehearses it at 1024.

``--two-pass`` builds a copy of the package under
``build/lab_two_pass/pairs/`` whose row kernels take stage 2 in two
register passes at every pair R2 (:data:`TWO_PASS_ROWS_MID`, which
replaces ``csrc/rows_fft.cuh:rows_mid`` there), builds it, this tree and
the tree at ``--root`` at once, and times ``--root``, this tree, the
copy, the copy, this tree and ``--root`` by ``--rows-times``, then this
tree, the copy, the copy and this tree by ``--lengths``.

``--spills`` needs nvcc but no card: the row kernels' sources of this
tree and of the two-pass copy compiled side by side with ptxas's report
and line info, each row kernel instance's registers and spill bytes and
its local loads and stores (``nvdisasm -g``) by source line.

``--minblocks 1,2,3,4`` probes the cluster column kernels' register
budget: for each value, a copy of pfb_tpu_torch under
``build/lab_minblocks/<value>/`` with ``csrc/psf_cols.cu``'s
``kColsMinBlocks`` (blocks an SM the registers are budgeted for) set to
it, all built at once; then this tree, each copy and this tree again, one
child process each (``--cols-times --root DIR``), time psf_cols_fwd and
psf_cols_inv at K1's (8, 2048^2) and (8, 4096^2) and at one K10 shard
of the (2, 4) mesh, (4, 2048, 512) -> 2052 rows, and at the short
lengths' (8, 1024^2), (8, 1280^2) and (8, 1536^2), beside rfft / irfft
and (at the shard) K10's own entries. Each is timed two ways: as
``chip_smoke.py`` times it (the median of single calls, each between two
CUDA events; on an idle stream the wrapper's host time before the launch
falls between them) and back to back (``reps`` calls between two events,
divided by ``reps``: the host runs ahead and the card's time alone is
left where a call takes longer on the card than on the host).
"""

import argparse
import hashlib
import itertools
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def cuda_ms(fn, reps, dev):
    """Median time of fn() in milliseconds after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    import time

    import torch
    fn()
    ts = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
    return sorted(ts)[len(ts) // 2]


def back_to_back_ms(fn, reps, dev):
    """Milliseconds a call of fn() when ``reps`` calls run back to back
    between two CUDA events (after one warm-up); the host clock on the
    CPU."""
    import time

    import torch
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps, dev):
    """Milliseconds a call of fn() when it is captured once in a CUDA graph
    and the graph replayed ``reps`` times back to back between two CUDA
    events: the device's time with no host work between launches (None on
    the CPU, or where fn cannot be captured)."""
    import torch
    if dev.type != "cuda":
        return None
    try:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        g.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            g.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    except RuntimeError:
        return None


def card(dev):
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def digest(dev):
    """sha256 of K1 (complex and real H), K3 (full, in_rolled and
    out_rolled, strided and contiguous lines, each length's default lines
    per block; the contiguous lines at 4096 and 12288 take K3r), K10's
    three stages and K11 on fixed seeded inputs at lengths below 4096;
    then K1 and K10's column stages at NX = 4096, K11 at 6144, K12 and K15
    at 8192; then K1 and K10's rows stage at NY = 4096 and K11 at 6144
    (the rows stage's register route since it exists); then the fold (K5
    and K8's kernel) on three tile geometries."""
    import torch

    from pfb_tpu_torch.ops import pallas_fft as pf
    from pfb_tpu_torch.ops.cfft import fftx_c2c
    from pfb_tpu_torch.ops.psf import (prep_h, psf_convolve_full,
                                       psf_convolve_h, psf_stage_cols_fwd,
                                       psf_stage_cols_inv, psf_stage_rows)
    nb, nx = 2, 1024
    NX = 2 * nx
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((nb, nx, nx), generator=g, device=dev)
    psf = torch.randn((nb, NX, NX), generator=g, device=dev)
    out = {}
    for rt in (False, True):
        hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=rt)
        out[f"K1 {'real' if rt else 'complex'}-H"] = psf_convolve_h(x, hr,
                                                                    hi)
    rows = nx + 2  # nx + 1 padded to two space shards
    z = psf_stage_cols_fwd(x[..., :nx // 2].contiguous(), NX, rows)
    out["K10a"] = torch.cat(z)
    zr = torch.randn((nb, rows // 2, nx), generator=g, device=dev)
    zi = torch.randn((nb, rows // 2, nx), generator=g, device=dev)
    out["K10b"] = torch.cat(psf_stage_rows(zr, zi, hr[:, :rows // 2].contiguous()))
    w = [torch.randn((nb, rows, nx // 2), generator=g, device=dev)
         for _ in range(2)]
    out["K10c"] = psf_stage_cols_inv(*w, nx, NX, NX)
    N15 = 3 * nx // 2
    Hr, Hi = (torch.randn((nb, N15, N15), generator=g, device=dev)
              for _ in range(2))
    out["K11"] = psf_convolve_full(x, Hr, Hi)
    for N, L in ((2048, 128), (8192, 16), (960, 1), (16384, 2), (4096, 1),
                 (12288, 1)):
        for mode in ("full", "in_rolled", "out_rolled"):
            nin = N // 2 if mode == "in_rolled" else N
            zr, zi = (torch.randn((2, nin, L), generator=g, device=dev)
                      for _ in range(2))
            y = fftx_c2c(zr, zi, N=N, inverse=mode == "out_rolled",
                         in_rolled=mode == "in_rolled",
                         out_rolled=mode == "out_rolled")
            out[f"K3 {N} L={L} {mode}"] = torch.cat(y)
    # the column stages' cluster route: NX >= 4096
    del x, psf, Hr, Hi, w, zr, zi
    nx = 2048
    NX = 2 * nx
    x = torch.randn((nb, nx, 512), generator=g, device=dev)
    psf = torch.randn((nb, NX, 1024), generator=g, device=dev)
    hr, hi = prep_h(psf, nx, 512, torch.float32, real_transfer=False)
    out["K1 complex-H NX=4096"] = psf_convolve_h(x, hr, hi)
    rows = nx + 4  # nx + 1 padded to four space shards
    out["K10a NX=4096"] = torch.cat(psf_stage_cols_fwd(
        x[..., :128].contiguous(), NX, rows))
    w = [torch.randn((nb, rows, 128), generator=g, device=dev)
         for _ in range(2)]
    out["K10c NX=4096"] = psf_stage_cols_inv(*w, nx, NX, 1024)
    Hr, Hi = (torch.randn((1, 6144, 256), generator=g, device=dev)
              for _ in range(2))
    out["K11 NX=6144"] = psf_convolve_full(
        torch.randn((1, 3072, 128), generator=g, device=dev), Hr, Hi)
    del x, psf, hr, hi, Hr, Hi, w
    # the rows stage's register route: NY >= 4096
    x = torch.randn((nb, 64, 2048), generator=g, device=dev)
    psf = torch.randn((nb, 128, 4096), generator=g, device=dev)
    hr, hi = prep_h(psf, 64, 2048, torch.float32, real_transfer=False)
    out["K1 complex-H NY=4096"] = psf_convolve_h(x, hr, hi)
    zr, zi = (torch.randn((nb, 65, 2048), generator=g, device=dev)
              for _ in range(2))
    out["K10b NY=4096"] = torch.cat(psf_stage_rows(zr, zi, hr, hi))
    Hr, Hi = (torch.randn((1, 64, 6144), generator=g, device=dev)
              for _ in range(2))
    out["K11 NY=6144"] = psf_convolve_full(
        torch.randn((1, 32, 3072), generator=g, device=dev), Hr, Hi)
    del x, psf, hr, hi, Hr, Hi, zr, zi
    n = 4096
    x1 = torch.randn((n, 256), generator=g, device=dev)
    p1 = torch.randn((1, 2 * n, 512), generator=g, device=dev)
    hr, hi = prep_h(p1, n, 256, torch.float32, real_transfer=False)
    out["K12 NX=8192"] = pf.psf_convolve_pallas_v3(x1, hr[0], hi[0], n, 256)
    z15 = pf.v3_cols_fwd(x1[None], n)
    out["K15a NX=8192"] = torch.cat(z15)
    w15 = [torch.randn(z15[0].shape, generator=g, device=dev)
           for _ in range(2)]
    out["K15b NX=8192"] = pf.v3_cols_inv(*w15, n)
    # the fold (K5 / K8's kernel): the paths' tiles, even k and tiles (N %
    # 4 == 0) and an N off both, a third of the tiles live
    from pfb_tpu_torch.ops.pg_stream import pg_fold_gs
    for N, txs, tys, k in ((4096, 25, 121, 7), (1000, 24, 124, 8),
                           (998, 25, 121, 7)):
        ntx, nty = -(-N // txs), -(-N // tys)
        tile = torch.randperm(ntx * nty, generator=g, device=dev)
        tile = tile[:ntx * nty // 3]
        tslot = torch.full((ntx * nty,), -1, dtype=torch.int32, device=dev)
        tslot[tile] = torch.arange(tile.numel(), dtype=torch.int32,
                                   device=dev)
        Y = torch.randn((4, tile.numel(), txs + k, tys + k), generator=g,
                        device=dev)
        out[f"K8 fold N={N} tiles {txs}x{tys} k={k}"] = pg_fold_gs(
            Y, tslot, ntx=ntx, nty=nty, txs=txs, tys=tys, k=k, Nx=N, Ny=N)
    # K2 on the cluster route (NX = 4096) and on the line kernels (2048)
    from pfb_tpu_torch.ops.psf import psf_convolve_h_cg
    for nx in (2048, 1024):
        x, r = (torch.randn((nb, nx, 256), generator=g, device=dev)
                for _ in range(2))
        beta = torch.rand((nb, 1, 1), generator=g, device=dev)
        psf = torch.randn((nb, 2 * nx, 512), generator=g, device=dev)
        hr, hi = prep_h(psf, nx, 256, torch.float32, real_transfer=False)
        out[f"K2 NX={2 * nx}"] = torch.cat([
            v.reshape(-1) for v in psf_convolve_h_cg(x, r, beta, hr, hi)])
        del x, r, psf, hr, hi
    # the spreads K4 (k = 7, the compiled rows, and k = 9) and K7 on
    # seeded plans: the slots with entries (the kernels write no other)
    from pfb_tpu_torch.ops import pg_stream as pgs
    from pfb_tpu_torch.ops import pgridder as pg
    from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs
    obs = simulate_obs(nant=16, ntime=24, nchan=4, seed=0)
    _, cell = image_size_for(obs, fov_deg=1.0)
    kw = dict(nx=512, ny=512, cellx=cell, celly=cell, dtype=torch.float32,
              device=dev)
    for eps in (1e-5, 1e-7):
        p = pg.pgrid_plan(obs.uvw, obs.freq, epsilon=eps, **kw)
        k, txs, tys = p["k"], p["txs"], p["tys"]
        slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"],
                                  txs, tys, k)
        vis = (torch.randn((p["nentries"], 2, p["C"]), generator=g,
                           device=dev) * p["pm"][:, None]).contiguous()
        Y = pg.pg_spread(p["pos"], vis, slots, beta=p["beta"], k=k,
                         nw=p["nw"], Thx=txs + k, Thy=tys + k)
        out[f"K4 spread k={k}"] = Y[:, :, slots["live"]]
    bp = pgs.pgrid_plan_wblocked(obs.uvw, obs.freq, epsilon=1e-5,
                                 plane_block=2, **kw)
    p0 = bp["p0"]
    vis = (torch.randn((bp["NEg"] + 1, 2, p0["C"]), generator=g,
                       device=dev) * bp["gpm"][:, None]).contiguous()
    ys = []
    for b in range(bp["nblocks"]):
        ct = bp["count"][b]
        Y = pgs.pg_spread_gs(bp["pos"], vis, bp["gmap"][b, :int(
            bp["nelive"][b])], bp["start"][b], ct, woff=int(bp["woff"][b, 0]),
            beta=p0["beta"], k=p0["k"], B=bp["B"], Thx=p0["txs"] + p0["k"],
            Thy=p0["tys"] + p0["k"])
        ys.append(Y[:, :, ct > 0].reshape(-1))
    out["K7 spread"] = torch.cat(ys)
    # the degrids K6 (k = 7, the compiled taps, and k = 9) and K9 (every
    # live block added into one seeded accumulator) on seeded grids, with
    # a generator of their own (the keys above stay those of trees before
    # these)
    gd = torch.Generator(device=dev).manual_seed(13)
    for eps in (1e-5, 1e-7):
        p = pg.pgrid_plan(obs.uvw, obs.freq, epsilon=eps, **kw)
        gr, gi = (torch.randn((p["nw"], p["Nx"], p["Ny"]), generator=gd,
                              device=dev) for _ in range(2))
        out[f"K6 degrid k={p['k']}"] = pg.pg_degrid(
            gr, gi, p["pos"], p["tid"], beta=p["beta"], k=p["k"],
            nw=p["nw"], txs=p["txs"], tys=p["tys"], nty=p["nty"])
    acc = torch.randn((bp["NEg"] + 1, 2, p0["C"]), generator=gd,
                      device=dev)
    for b in range(bp["nblocks"]):
        ne = int(bp["nelive"][b])
        if not ne:
            continue
        gr, gi = (torch.randn((bp["B"], p0["Nx"], p0["Ny"]), generator=gd,
                              device=dev) for _ in range(2))
        pgs.pg_degrid_gs(gr, gi, bp["pos"], bp["utid"], bp["gmap"][b, :ne],
                         acc, woff=int(bp["woff"][b, 0]), beta=p0["beta"],
                         k=p0["k"], B=bp["B"], txs=p0["txs"], tys=p0["tys"],
                         nty=p0["nty"])
    out["K9 degrid"] = acc
    return {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
            for k, v in out.items()}


def lab_size(nb, nx, reps, dev, smi):
    """The stages at (nb, nx^2) in (2nx)^2: one JSON line each, then the
    size's summary (returned)."""
    import torch

    from pfb_tpu_torch.ops import psf as ops
    from pfb_tpu_torch.ops.pallas_fft import (v3_cols_fwd, v3_cols_inv,
                                              v3_rows)
    from pfb_tpu_torch.ops.psf import (prep_h, prep_h_full, psf_convolve_h,
                                       psf_convolve_h_plain,
                                       psf_stage_cols_fwd,
                                       psf_stage_cols_inv, psf_stage_rows)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, fft_flops
    ny = nx
    NX = NY = 2 * nx
    NXH = v3_rows(NX)
    psf = torch.zeros((nb, NX, NY), device=dev)
    psf[:, nx, ny] = 1.0
    psf[:, nx + 5, ny + 3] = 0.05
    hr, hi = prep_h(psf, nx, ny, torch.float32, real_transfer=False)
    Hr, Hi = prep_h_full(psf, torch.float32)
    hxr, hxi = Hr[:, :NXH].contiguous(), Hi[:, :NXH].contiguous()
    del psf, Hr, Hi
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((nb, nx, ny), generator=g, device=dev)
    zr0 = torch.randn((nb, NXH, ny), generator=g, device=dev)
    zi0 = torch.randn((nb, NXH, ny), generator=g, device=dev)
    z1 = psf_stage_cols_fwd(x, NX, nx + 1)
    w1 = psf_stage_rows(*z1, hr, hi)
    chained = psf_stage_cols_inv(*w1, nx, NX, NY)
    whole = psf_convolve_h(x, hr, hi)
    err = float((chained - whole).abs().max() / whole.abs().max())
    del chained, whole
    wc = torch.complex(zr0[:, :NX // 2 + 1], zi0[:, :NX // 2 + 1])

    def cols(rows):
        """(bytes, operations) of a column stage between the (nb, nx, ny)
        image and ``rows`` spectrum rows: a real line of NX a column."""
        return (4.0 * nb * ny * (nx + 2 * rows),
                nb * fft_flops(NX, ny, real=True))

    def rows_stage(rows):
        """A rows stage on ``rows`` complex rows with a complex H of NY
        columns: z read and written (4 floats), H read (2 NY a row); a
        forward and inverse line of NY and the product with H a row."""
        return (4.0 * nb * rows * (4 * ny + 2 * NY),
                fft_flops(NY, 2 * nb * rows) + 6.0 * nb * rows * NY)

    k1 = (4.0 * (2 * x.numel() + hr.numel() + hi.numel()),
          nb * (fft_flops(NX, 2 * nx, real=True) + fft_flops(NY, 2 * (nx + 1))
                + 6.0 * (nx + 1) * NY))
    # K15's column transforms where the v3 factor rule holds (not at
    # 1280^2 or 1536^2)
    stages = [
        ("K15 forward v3_cols_fwd", (nb, nx, ny),
         lambda: v3_cols_fwd(x, nx), cols(NXH)),
        ("rows stage psf_stage_rows on NXH rows, complex H", (nb, NXH, ny),
         lambda: psf_stage_rows(zr0, zi0, hxr, hxi), rows_stage(NXH)),
        ("K15 inverse v3_cols_inv", (nb, NXH, ny),
         lambda: v3_cols_inv(zr0, zi0, nx), cols(NXH))
    ] if ops.v3_supported(nx, ny) else []
    stages += [
        ("K1 stage 1 psf_stage_cols_fwd", (nb, nx, ny),
         lambda: psf_stage_cols_fwd(x, NX, nx + 1), cols(nx + 1)),
        ("K1 stage 2 psf_stage_rows, complex H", (nb, nx + 1, ny),
         lambda: psf_stage_rows(*z1, hr, hi), rows_stage(nx + 1)),
        ("K1 stage 3 psf_stage_cols_inv", (nb, nx + 1, ny),
         lambda: psf_stage_cols_inv(*w1, nx, NX, NY), cols(nx + 1)),
        ("K1 whole psf_convolve_h, complex H", (nb, nx, ny),
         lambda: psf_convolve_h(x, hr, hi), k1),
        ("K1 plain psf_convolve_h_plain, complex H", (nb, nx, ny),
         lambda: psf_convolve_h_plain(x, hr, hi), k1),
    ]
    # the cluster column kernels, in a tree that has them (``--root`` may
    # name one from before them)
    if hasattr(ops, "cols_route") and ops.cols_route(NX, ny):
        stages += [
            ("cluster forward psf_cols_fwd", (nb, nx, ny),
             lambda: ops.psf_cols_fwd(x, NX, nx + 1), cols(nx + 1)),
            ("cluster forward skeleton", (nb, nx, ny),
             lambda: ops.psf_cols_fwd(x, NX, nx + 1, skeleton=True),
             cols(nx + 1)),
            ("cluster inverse psf_cols_inv", (nb, nx + 1, ny),
             lambda: ops.psf_cols_inv(*w1, nx, NX), cols(nx + 1)),
            ("cluster inverse skeleton", (nb, nx + 1, ny),
             lambda: ops.psf_cols_inv(*w1, nx, NX, skeleton=True),
             cols(nx + 1))]
    # K2, the CG-fused K1, on p_prev = x, r and beta from the seed; its
    # stages alone where the tree has them (psf_cg_stages)
    r2 = torch.randn((nb, nx, ny), generator=g, device=dev)
    beta = torch.rand((nb, 1, 1), generator=g, device=dev)
    k2 = (k1[0] + 4.0 * 2 * x.numel(), k1[1] + 6.0 * x.numel())
    stages += [
        ("K2 whole psf_convolve_h_cg, complex H", (nb, nx, ny),
         lambda: ops.psf_convolve_h_cg(x, r2, beta, hr, hi), k2),
        ("K2 plain psf_convolve_h_cg_plain, complex H", (nb, nx, ny),
         lambda: ops.psf_convolve_h_cg_plain(x, r2, beta, hr, hi), k2)]
    if hasattr(ops, "psf_cg_stages") and dev.type == "cuda":
        p2, c2, _ = ops.psf_convolve_h_cg(x, r2, beta, hr, hi)
        k2_vs_k1 = bool(torch.equal(c2, psf_convolve_h(p2, hr, hi)))
        del p2, c2
        bufs = ops.psf_cg_stages(x, r2, beta, hr, hi)
        stages += [(f"K2 stage {i + 1}", (nb, nx, ny),
                    lambda s=1 << i: ops.psf_cg_stages(x, r2, beta, hr, hi,
                                                       s, bufs), w)
                   for i, w in enumerate(((cols(nx + 1)[0] + 8.0 * x.numel(),
                                           cols(nx + 1)[1]),
                                          rows_stage(nx + 1),
                                          (cols(nx + 1)[0] + 4.0 * x.numel(),
                                           cols(nx + 1)[1])))]
    else:
        k2_vs_k1 = None
    # for context, not a one-call library: the rows stage as three calls
    zc1 = torch.complex(*z1)
    hc1 = torch.complex(hr, hi)
    stages += [
        ("rows stage as three calls ifft(fft(z, n=NY) * H)[..., :ny]",
         (nb, nx + 1, ny),
         lambda: torch.fft.ifft(torch.fft.fft(zc1, n=NY, dim=-1) * hc1,
                                dim=-1)[..., :ny], rows_stage(nx + 1)),
        ("library stage 1 torch.fft.rfft(x, n=NX, dim=-2)", (nb, nx, ny),
         lambda: torch.fft.rfft(x, n=NX, dim=-2), cols(nx + 1)),
        ("library stage 1 torch.fft.fft(x, n=NX, dim=-2)[:, :NXH]",
         (nb, nx, ny), lambda: torch.fft.fft(x, n=NX, dim=-2)[:, :NXH],
         cols(NXH)),
        ("library stage 3 torch.fft.irfft(w[:, :NX/2+1], n=NX, "
         "dim=-2)[:, :nx]", (nb, NX // 2 + 1, ny),
         lambda: torch.fft.irfft(wc, n=NX, dim=-2)[:, :nx],
         cols(NX // 2 + 1)),
    ]
    ms = {}
    for name, shape, fn, work in stages:
        ms[name] = cuda_ms(fn, reps, dev)
        bms, bby = bound(*work)
        print(json.dumps({"stage": name, "nx": nx, "shape": list(shape),
                          "ms": ms[name], "reps": reps, "bound_ms": bms,
                          "bound_by": bby, "card": smi}), flush=True)
    k1 = ms["K1 whole psf_convolve_h, complex H"]
    split = sum(v for k, v in ms.items() if k.startswith("K1 stage"))
    return {"nband": nb, "nx": nx, "NX": NX, "NXH": NXH, "card": smi,
            "package": str(Path(ops.__file__).parents[1]),
            "chained_vs_k1_rel_err": err, "tol": TOL, "k1_ms": k1,
            "k1_plain_ms": ms["K1 plain psf_convolve_h_plain, complex H"],
            "k1_stage_sum_ms": split, "stage_sum_over_k1": split / k1,
            "k2_ms": ms["K2 whole psf_convolve_h_cg, complex H"],
            "k2_conv_bitwise_k1_of_p": k2_vs_k1,
            "ok": err <= TOL and k2_vs_k1 is not False}


# (label, nq, N, txs, tys, k, live tiles): the folds chip_smoke.py times
# (K5 on the pg path's image and PSF plans, K8 on the klean path's and
# the flagship's blocks), with their plans' tiles and live-slot counts
FOLD_SHAPES = (("K5 pg_fold image plan", 20, 4096, 25, 121, 7, 442),
               ("K5 pg_fold PSF plan", 26, 8192, 25, 249, 7, 781),
               ("K8 pg_fold_gs klean block", 8, 4096, 25, 121, 7, 552),
               ("K8 pg_fold_gs flagship block", 8, 8192, 25, 121, 7, 3327))


def fold_times(reps, dev, smi, root, shapes=FOLD_SHAPES):
    """--fold: K5 and K8 of the tree at ``root`` at ``shapes``, the live
    tiles drawn from a seed, beside chip_smoke.py's fold_library (a zero
    fill, then index_add_) and the zero fill of the grids alone (the
    writes' floor), with the bound and the kernel's error against the
    library; one JSON line a case."""
    import torch

    from pfb_tpu_torch.ops.pg_stream import pg_fold_gs
    from pfb_tpu_torch.ops.pgridder import pg_fold
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, fold_library, fold_work
    for label, nq, N, txs, tys, k, nlive in shapes:
        ntx, nty = -(-N // txs), -(-N // tys)
        Thx, Thy = txs + k, tys + k
        g = torch.Generator().manual_seed(nq + N)
        tile = torch.randperm(ntx * nty, generator=g)[:nlive]
        tslot = torch.full((ntx * nty,), -1, dtype=torch.int32)
        tslot[tile] = torch.arange(nlive, dtype=torch.int32)
        tslot, tile = tslot.to(dev), tile.to(dev)
        Y = torch.randn((nq, nlive, Thx, Thy), generator=g).to(dev)
        kw = dict(ntx=ntx, nty=nty, txs=txs, tys=tys, k=k, Nx=N, Ny=N)
        live = torch.ones(nlive, dtype=torch.bool, device=dev)
        if label.startswith("K5"):
            slots = dict(tslot=tslot, NS=nlive, tile=tile, live=live)

            def fn():
                return pg_fold(Y, slots, **kw)
        else:
            def fn():
                return pg_fold_gs(Y, tslot, **kw)
        flib = fold_library(Y, tile, live, nty, txs, tys, k, N, N)
        ref = flib().reshape(nq, N, N)
        err = float((fn() - ref).abs().max() / ref.abs().max())
        del ref
        bms, bby = bound(*fold_work(nq, nlive, Thx, Thy, ntx * nty, N, N))
        grid = torch.empty((nq, N, N), device=dev)
        print(json.dumps({
            "probe": "fold", "root": str(root), "case": label,
            "shape": [nq, N, N], "tiles": [txs, tys], "k": k,
            "live": nlive, "ms": cuda_ms(fn, reps, dev),
            "library_ms": cuda_ms(flib, reps, dev),
            "zero_fill_ms": cuda_ms(grid.zero_, reps, dev), "bound_ms": bms,
            "bound_by": bby, "rel_err_vs_library": err, "card": smi}),
            flush=True)
        del Y, flib, grid
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def lab_plans(dev):
    """The pg plans chip_smoke.py times its spreads and degrids on, built
    as it builds them: the pg path's image and PSF plans of dataset 0 (its
    2.06 M-visibility observation, channel 0, 2048^2), then the w-blocked
    plans (plane_block 4) of the klean path's dataset and of the flagship
    operator (bench.py's 1 M rows x 8 channels, 4096^2), each with its
    largest w block. Yields (label, plan, block): block None for the pg
    plans."""
    import numpy as np

    from pfb_tpu_torch.ops.gridder import make_hessian_dds
    from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FLAGSHIP, NX, SIM, pg_plans
    obs = simulate_obs(nant=SIM["nant"], ntime=SIM["ntime"],
                       nchan=SIM["nchan"], seed=SIM["seed"],
                       extent=SIM["extent"])
    _, cell = image_size_for(obs, fov_deg=1.0, srf=2.0)
    _, cell = image_size_for(obs, fov_deg=(NX + 0.5) * np.rad2deg(cell),
                             srf=2.0)
    nrow = obs.uvw.shape[0]
    one = np.ones((nrow, 1), np.float32)
    ds = dict(UVW=obs.uvw, FREQ=obs.freq[:1], WEIGHT=one, MASK=one,
              bandid=0, cell_rad=cell)
    for label, p in zip(("image plan", "PSF plan"),
                        pg_plans(ds, NX, 1e-5, dev)):
        yield label, p, None
        del p
    rng = np.random.default_rng(FLAGSHIP["seed"])
    uvw = rng.normal(scale=1000.0, size=(FLAGSHIP["nrow"], 3))
    uvw[:, 2] *= 0.1
    freq = np.linspace(0.9e9, 1.1e9, FLAGSHIP["nchan"])
    umax = np.abs(uvw[:, :2]).max() * freq[-1] / 299792458.0
    ones = np.ones((FLAGSHIP["nrow"], FLAGSHIP["nchan"]), np.float32)
    fds = dict(UVW=uvw, FREQ=freq, WEIGHT=ones, MASK=ones, bandid=0,
               cell_rad=1.0 / (2.0 * umax * 2.0))
    for label, d, nx in (("klean block", ds, NX),
                         ("flagship block", fds, FLAGSHIP["nx"])):
        bp = make_hessian_dds([d], 1, 1.0, nx, nx, backend="pg",
                              epsilon=1e-5, plane_block=4, use_beam=False,
                              device=dev).plans[0]
        b = int(bp["nelive"].argmax())
        yield f"{label} ({b} of {bp['nblocks']})", bp, b
        del bp


def spread_cases(dev):
    """The spreads chip_smoke.py times (:func:`lab_plans`): K4 on the pg
    path's image and PSF plans, K7 on the largest w block of the klean
    path's plan and of the flagship operator's. Values are seeded normals
    (the time does not depend on them). Yields (label, kw, work, slots):
    the spread's keyword operands (``pg_spread_lab``'s), its (bytes,
    operations) and K4's compact slots (None for K7)."""
    import torch

    from pfb_tpu_torch.ops.pgridder import _compact_slots
    sys.path.insert(0, str(ROOT))
    from chip_smoke import spread_work
    g = torch.Generator(device=dev).manual_seed(0)
    for label, p, b in lab_plans(dev):
        if b is None:
            k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
            slots = _compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"],
                                   txs, tys, k)
            vis = (torch.randn((p["nentries"], 2, p["C"]), generator=g,
                               device=dev) * p["pm"][:, None]).contiguous()
            kw = dict(pos=p["pos"], vis=vis, start=slots["start"],
                      count=slots["count"], beta=p["beta"], k=k, nw=nw,
                      Thx=txs + k, Thy=tys + k)
            work = spread_work(p["pos"][:, 2] if nw > 1 else None,
                               p["pm"] != 0, k, nw,
                               int(slots["live"].sum()), txs + k, tys + k)
            yield f"K4 {label}", kw, work, slots
            del kw, vis, slots
            continue
        p0, B = p["p0"], p["B"]
        k, txs, tys = p0["k"], p0["txs"], p0["tys"]
        ne = int(p["nelive"][b])
        gmap = p["gmap"][b, :ne].contiguous()
        woff = int(p["woff"][b, 0])
        st, ct = p["start"][b].contiguous(), p["count"][b].contiguous()
        vis = (torch.randn((p["NEg"] + 1, 2, p0["C"]), generator=g,
                           device=dev) * p["gpm"][:, None]).contiguous()
        kw = dict(pos=p["pos"], vis=vis, start=st, count=ct,
                  beta=p0["beta"], k=k, nw=B, Thx=txs + k, Thy=tys + k,
                  gmap=gmap, woff=woff)
        gl = gmap.long()
        work = spread_work(p["pos"][gl, 2] - woff, p["gpm"][gl] != 0, k, B,
                           int((ct > 0).sum()), txs + k, tys + k)
        yield f"K7 {label}", kw, work, None
        del kw, vis


def degrid_cases(dev):
    """The degrids chip_smoke.py times (:func:`lab_plans`): K6 on the pg
    path's image plan, K9 on the largest w block of the klean path's plan
    and of the flagship operator's, each on seeded normal grids (the time
    does not depend on them). Yields (label, kw, work): the degrid's
    keyword operands (``pg_degrid_lab``'s; K9's with a zero accumulator)
    and its (bytes, operations)."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import degrid_work
    g = torch.Generator(device=dev).manual_seed(1)
    for label, p, b in lab_plans(dev):
        if label == "PSF plan":
            continue
        if b is None:
            k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
            gr = torch.randn((nw, p["Nx"], p["Ny"]), generator=g,
                             device=dev, dtype=p["pos"].dtype)
            gi = torch.randn(gr.shape, generator=g, device=dev,
                             dtype=gr.dtype)
            kw = dict(gr=gr, gi=gi, pos=p["pos"], tid=p["tid"],
                      beta=p["beta"], k=k, nw=nw, txs=txs, tys=tys,
                      nty=p["nty"])
            live = p["pm"] != 0
            ntiles = int(torch.unique(p["tid"][live.any(dim=1)]).numel())
            work = degrid_work(p["pos"][:, 2] if nw > 1 else None, live, k,
                               nw, ntiles, txs + k, tys + k, p["Nx"],
                               p["Ny"])
            yield f"K6 {label}", kw, work
            del kw, gr, gi
            continue
        p0, B = p["p0"], p["B"]
        k, txs, tys = p0["k"], p0["txs"], p0["tys"]
        gmap = p["gmap"][b, :int(p["nelive"][b])].contiguous()
        woff = int(p["woff"][b, 0])
        gr = torch.randn((B, p0["Nx"], p0["Ny"]), generator=g, device=dev,
                         dtype=p["pos"].dtype)
        gi = torch.randn(gr.shape, generator=g, device=dev, dtype=gr.dtype)
        kw = dict(gr=gr, gi=gi, pos=p["pos"], tid=p["utid"], gmap=gmap,
                  acc=torch.zeros((p["NEg"] + 1, 2, p0["C"]), device=dev,
                                  dtype=gr.dtype),
                  woff=woff, beta=p0["beta"], k=k, nw=B, txs=txs, tys=tys,
                  nty=p0["nty"])
        gl = gmap.long()
        work = degrid_work(p["pos"][gl, 2] - woff, p["gpm"][gl] != 0, k, B,
                           int((p["count"][b] > 0).sum()), txs + k, tys + k,
                           p0["Nx"], p0["Ny"], accumulate=True)
        yield f"K9 {label}", kw, work
        del kw, gr, gi


def spread_times(reps, dev, smi, root):
    """--spread: at each of :func:`spread_cases`, the spread of the tree
    at ``root`` as the paths call it (pg_spread / pg_spread_gs), then,
    with the chains of its slots (chip_smoke.py:chains) and, where the
    tree has the lab entry (pg_spread_lab), both designs with each one's
    split (chip_smoke.py:spread_parts): one JSON line a case. The split
    takes the differences of consecutive skeletons: the FMAs, the scan
    (the earlier design's per-warp walk of all C visibilities; the
    lists' ballots over the list and the hits' loop), the factors, the
    loads (for the lists, with the compaction) and the barriers with the
    launch."""
    import torch

    from pfb_tpu_torch.ops import pg_stream as pgs
    from pfb_tpu_torch.ops import pgridder as pg
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, chains, spread_parts
    lab = getattr(pgs, "pg_spread_lab", None)
    for label, kw, work, slots in spread_cases(dev):
        if slots is None:
            def shipped():
                return pgs.pg_spread_gs(
                    kw["pos"], kw["vis"], kw["gmap"], kw["start"],
                    kw["count"], woff=kw["woff"], beta=kw["beta"],
                    k=kw["k"], B=kw["nw"], Thx=kw["Thx"], Thy=kw["Thy"])
        else:
            def shipped():
                return pg.pg_spread(kw["pos"], kw["vis"], slots,
                                    beta=kw["beta"], k=kw["k"],
                                    nw=kw["nw"], Thx=kw["Thx"],
                                    Thy=kw["Thy"])
        bms, bby = bound(*work)
        rec = {"probe": "spread", "root": str(root), "case": label,
               "k": kw["k"], "planes": kw["nw"], "C": kw["pos"].shape[-1],
               "tile": [kw["Thx"], kw["Thy"]], **chains(kw["count"]),
               "ms": cuda_ms(shipped, reps, dev), "bound_ms": bms,
               "bound_by": bby, "card": smi}
        if lab is not None and dev.type == "cuda":
            ref = shipped()
            live = kw["count"] > 0
            for design in pgs.SPREAD_DESIGNS:
                got = lab(design=design, **kw)
                rec[design] = dict(
                    spread_parts(kw, design, reps),
                    bitwise_shipped=bool(torch.equal(got[:, :, live],
                                                     ref[:, :, live])))
                del got
            del ref
        print(json.dumps(rec), flush=True)
        del kw, slots
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def degrid_times(reps, dev, smi, root):
    """--degrid: at each of :func:`degrid_cases`, the degrid of the tree
    at ``root`` as the paths call it (pg_degrid / pg_degrid_gs) with its
    bound, then, where the tree has the lab entry (pg_degrid_lab), each
    design's kernel and skeletons (chip_smoke.py:degrid_parts: the
    factors alone, the grid loads alone, the sums on register data) and
    whether its output equals the shipped degrid's bit for bit: one JSON
    line a case."""
    import torch

    from pfb_tpu_torch.ops import pg_stream as pgs
    from pfb_tpu_torch.ops import pgridder as pg
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound
    lab = getattr(pgs, "pg_degrid_lab", None)
    for label, kw, work in degrid_cases(dev):
        dkw = dict(beta=kw["beta"], k=kw["k"], txs=kw["txs"],
                   tys=kw["tys"], nty=kw["nty"])
        if "gmap" in kw:
            def shipped(acc):
                return pgs.pg_degrid_gs(
                    kw["gr"], kw["gi"], kw["pos"], kw["tid"], kw["gmap"],
                    acc, woff=kw["woff"], B=kw["nw"], **dkw)
            ref = shipped(torch.zeros_like(kw["acc"]))
        else:
            def shipped(acc=None):
                return pg.pg_degrid(kw["gr"], kw["gi"], kw["pos"],
                                    kw["tid"], nw=kw["nw"], **dkw)
            ref = shipped()
        acc = kw.get("acc")
        bms, bby = bound(*work)
        rec = {"probe": "degrid", "root": str(root), "case": label,
               "k": kw["k"], "planes": kw["nw"], "C": kw["pos"].shape[-1],
               "entries": (kw["gmap"] if "gmap" in kw
                           else kw["tid"]).numel(),
               "tile": [kw["txs"] + kw["k"], kw["tys"] + kw["k"]],
               "ms": cuda_ms(lambda: shipped(acc), reps, dev),
               "bound_ms": bms, "bound_by": bby, "card": smi}
        if lab is not None and dev.type == "cuda":
            from chip_smoke import degrid_parts
            for design in pgs.DEGRID_DESIGNS:
                got = lab(design=design, **dict(
                    kw, **({} if acc is None else
                           {"acc": torch.zeros_like(acc)})))
                rec[design] = dict(degrid_parts(kw, design, reps),
                                   bitwise_shipped=bool(torch.equal(got,
                                                                    ref)))
                del got
        print(json.dumps(rec), flush=True)
        del kw, ref, acc
        if dev.type == "cuda":
            torch.cuda.empty_cache()




# The tile ladder's rungs over the default tiles (ops/pgridder.py:
# _auto_tiles) with the longer tile_v, which its cost model gives sparse
# uv coverage.
LADDER_RUNGS = ((16, 128), (48, 128))
SPARSE = dict(nant=32, ntime=64, nchan=1)


def rung_cases(dev):
    """The degrids at the tile ladder's rungs of :data:`LADDER_RUNGS`,
    where a tile window is (32, 256) and (64, 256) at k = 7, (40, 256)
    and (72, 256) at k = 9: K6 on a sparse observation (:data:`SPARSE`,
    31,744 visibilities at 2048^2, which the cost model puts on the
    largest rung at k = 7, though the plans apply the ladder only from
    2^18 visibilities) and on the pg path's image plan (dataset 0, channel 0),
    and K9 on the largest w block (plane_block 4) of both observations'
    w-blocked plans, all with their tiles forced there; each at k = 7 and
    9 (epsilon 1e-5 and 1e-7), on seeded normal grids. Yields (label, kw)
    as :func:`degrid_cases` does."""
    import numpy as np
    import torch

    from pfb_tpu_torch.ops import pg_stream as pgs
    from pfb_tpu_torch.ops.mmgridder import _tile_geometry
    from pfb_tpu_torch.ops.pgridder import _grid_setup, pgrid_plan
    from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs
    sys.path.insert(0, str(ROOT))
    from chip_smoke import NX, SIM
    g = torch.Generator(device=dev).manual_seed(2)
    for name, sim in (("sparse", SPARSE), ("dense", SIM)):
        obs = simulate_obs(nant=sim["nant"], ntime=sim["ntime"],
                           nchan=sim["nchan"], seed=SIM["seed"],
                           extent=SIM["extent"])
        _, cell = image_size_for(obs, fov_deg=1.0, srf=2.0)
        _, cell = image_size_for(obs, fov_deg=(NX + 0.5) * np.rad2deg(cell),
                                 srf=2.0)
        uvw, freq = np.asarray(obs.uvw, np.float64), obs.freq[:1]
        geo = dict(nx=NX, ny=NX, cellx=cell, celly=cell, device=dev)
        Nx, Ny = _grid_setup(NX, NX, cell, cell, 2.0)
        for (eps, k), (du, dv) in itertools.product(
                ((1e-5, 7), (1e-7, 9)), LADDER_RUNGS):
            txs, tys = _tile_geometry(Nx, Ny, k)
            tu, tv = txs + du, tys + dv
            p = pgrid_plan(uvw, freq, epsilon=eps, tile_u=tu, tile_v=tv,
                           **geo)
            assert (p["k"], p["txs"], p["tys"]) == (k, tu, tv), \
                (name, p["k"], p["txs"], p["tys"])
            gr = torch.randn((p["nw"], Nx, Ny), generator=g, device=dev)
            yield f"K6 {name} k={k} +{du}", dict(
                gr=gr, gi=torch.randn_like(gr), pos=p["pos"],
                tid=p["tid"], beta=p["beta"], k=k, nw=p["nw"], txs=tu,
                tys=tv, nty=p["nty"])
            del p, gr
            bp = pgs.pgrid_plan_wblocked(uvw, freq, epsilon=eps,
                                         plane_block=4, tile_u=tu,
                                         tile_v=tv, **geo)
            p0, B = bp["p0"], bp["B"]
            b = int(bp["nelive"].argmax())
            gr = torch.randn((B, Nx, Ny), generator=g, device=dev)
            yield f"K9 {name} k={k} +{du} ({b} of {bp['nblocks']})", dict(
                gr=gr, gi=torch.randn_like(gr), pos=bp["pos"],
                tid=bp["utid"],
                gmap=bp["gmap"][b, :int(bp["nelive"][b])].contiguous(),
                acc=torch.zeros((bp["NEg"] + 1, 2, p0["C"]), device=dev),
                woff=int(bp["woff"][b, 0]), beta=p0["beta"], k=k, nw=B,
                txs=tu, tys=tv, nty=p0["nty"])
            del bp, gr


def degrid_rungs(reps, dev, smi):
    """--degrid-rungs: at each of :func:`rung_cases`, every design of the
    degrid lab (the kernel alone) and the degrid as the paths call it
    (pg_degrid / pg_degrid_gs: "shipped"), with the entries, the live
    visibilities and whether each one's output equals the thread design's
    bit for bit: one JSON line a case."""
    import torch

    from pfb_tpu_torch.ops import pg_stream as pgs
    from pfb_tpu_torch.ops import pgridder as pg

    def shipped(gr, gi, pos, tid, *, nw, gmap=None, acc=None, woff=0,
                **dkw):
        if gmap is None:
            return pg.pg_degrid(gr, gi, pos, tid, nw=nw, **dkw)
        return pgs.pg_degrid_gs(gr, gi, pos, tid, gmap, acc, woff=woff,
                                B=nw, **dkw)

    for label, kw in rung_cases(dev):
        acc = kw.get("acc")
        fresh = {} if acc is None else {"acc": torch.zeros_like(acc)}
        ref = pgs.pg_degrid_lab(design="thread", **dict(kw, **fresh))
        live = kw["pos"][(kw["gmap"].long() if "gmap" in kw else
                          slice(None)), 0] > -kw["k"]
        rec = {"probe": "degrid rungs", "case": label, "k": kw["k"],
               "planes": kw["nw"], "C": kw["pos"].shape[-1],
               "entries": (kw["gmap"] if "gmap" in kw
                           else kw["tid"]).numel(),
               "visibilities": int(live.sum()),
               "tile": [kw["txs"] + kw["k"], kw["tys"] + kw["k"]],
               "card": smi}
        for design in pgs.DEGRID_DESIGNS:
            try:
                got = pgs.pg_degrid_lab(design=design, **dict(kw, **fresh))
            except RuntimeError as err:  # a window past the card's room
                torch.cuda.synchronize()
                rec[design] = str(err)
                continue
            rec[design] = dict(
                ms=cuda_ms(lambda d=design: pgs.pg_degrid_lab(
                    design=d, **kw), reps, dev),
                bitwise_thread=bool(torch.equal(got, ref)))
            del got
        rec["shipped"] = dict(
            ms=cuda_ms(lambda: shipped(**kw), reps, dev),
            bitwise_thread=bool(torch.equal(shipped(**dict(kw, **fresh)),
                                            ref)))
        print(json.dumps(rec), flush=True)
        del kw, ref, acc
        torch.cuda.empty_cache()


def _route(fn):
    """The launch counters that one call of fn() moved (the kernels it
    ran), read from the wrappers of the tree imported."""
    from pfb_tpu_torch.ops import cfft, psf
    cnt = {"K3": cfft.fftx_c2c, "K3c": cfft.fftx_c2c_cluster,
           "K3r": cfft.fftx_c2c_rows, "K10ac": psf.psf_cols_fwd,
           "K10cc": psf.psf_cols_inv, "K10br": psf.psf_rows,
           "K1": psf.psf_convolve_h, "K2": psf.psf_convolve_h_cg,
           "K11": psf.psf_convolve_full}
    # the routes above 16384 (a tree before them has none of them)
    for k, name in (("K3f", "fftx_c2c_four"), ("K3xl", "fftx_c2c_cols_long"),
                    ("K3yl", "fftx_c2c_rows_long"),
                    ("K3cl", "fftx_c2c_cluster_long"),
                    ("K3fr", "fftx_c2c_four_rows")):
        if hasattr(cfft, name):
            cnt[k] = getattr(cfft, name)
    # the PSF line kernels' counters (a tree before them has none: its
    # line route shows only as the absence of the others)
    for name in ("psf_cols_line", "psf_rows_line"):
        if hasattr(psf, name):
            cnt[name] = getattr(psf, name)
    before = {k: f.launches for k, f in cnt.items()}
    fn()
    return {k: f.launches - before[k] for k, f in cnt.items()
            if f.launches != before[k]}


# the lengths below the cluster and row routes' first floors (2048-5120):
# K3's x and y passes of (P, N^2) planes, the PSF column stages and rows
# stage at NX = NY, K11 where v3 does not hold (1280^2 in 2560^2, 1536^2
# in 3072^2, 3072^2 in 4608^2)
OFFROUTE_PASSES = ((9, 2048), (10, 2560), (9, 3072))
OFFROUTE_STAGES = (2048, 2560, 3072, 4608, 5120)
OFFROUTE_K11 = ((8, 1280, 2560), (8, 1536, 3072), (2, 3072, 4608))


def offroute_times(reps, dev, smi, root):
    """--offroute: the kernels of the tree at ``root`` at the lengths
    2048-5120, each call's route (the launch counters it moved), the bound
    (chip_smoke.py:bound) and the library call, one JSON line a case:
    K3's x pass (fftx_c2c on a (P, nin, N) stack) and y pass (on the
    (P nrow, nin, 1) row stack) of the pruned 2-D transforms, inverse
    out_rolled and forward in_rolled, beside torch.fft on the zero-padded
    stack; the PSF column stages (psf_stage_cols_fwd / _inv at (8, NX/2,
    NX/2)) beside rfft / irfft; the rows stage (psf_stage_rows on (8, NY/2
    + 1, NY/2) rows, complex H) beside its plain version; K11
    (psf_convolve_full, random complex H) beside its plain version."""
    import torch

    from pfb_tpu_torch.ops.cfft import fftx_c2c
    from pfb_tpu_torch.ops.psf import (psf_convolve_full,
                                       psf_convolve_full_plain,
                                       psf_stage_cols_fwd,
                                       psf_stage_cols_inv, psf_stage_rows,
                                       psf_stage_rows_plain)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, conv_work, fft_flops, rows_work
    g = torch.Generator(device=dev).manual_seed(14)

    def line(case, shape, fn, work, **extra):
        bms, bby = bound(*work)
        rec = {"probe": "offroute", "root": str(root), "case": case,
               "shape": list(shape), "route": _route(fn),
               "ms": cuda_ms(fn, reps, dev), "bound_ms": bms,
               "bound_by": bby, "card": smi}
        rec.update({k: cuda_ms(f, reps, dev) for k, f in extra.items()})
        print(json.dumps(rec), flush=True)

    for P, N in OFFROUTE_PASSES:
        for inv, pin, pout in ((True, False, True), (False, True, False)):
            nin = N // 2 if pin else N
            nout = N // 2 if pout else N
            kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
            lib = torch.fft.ifft if inv else torch.fft.fft
            tag = "inverse out_rolled" if inv else "forward in_rolled"
            for axis, shape in (("x", (P, nin, nin)),
                                ("y", (P * nin, nin, 1))):
                xr, xi = (torch.randn(shape, generator=g, device=dev)
                          for _ in range(2))
                z = torch.zeros((shape[0], N, shape[2]),
                                dtype=torch.complex64, device=dev)
                z[:, :nin] = torch.complex(xr, xi)
                lines = shape[0] * shape[2]
                line(f"K3 {axis} pass {tag} ({P}, {N}^2)", shape,
                     lambda: fftx_c2c(xr, xi, **kw),
                     (8.0 * lines * (nin + nout), fft_flops(N, lines)),
                     library_ms=lambda: lib(z, dim=-2))
                del xr, xi, z
    nb = 8
    for NX in OFFROUTE_STAGES:
        nx = NX // 2
        x = torch.randn((nb, nx, nx), generator=g, device=dev)
        w = [torch.randn((nb, nx + 1, nx), generator=g, device=dev)
             for _ in range(2)]
        wc = torch.complex(*w)
        cols = (4.0 * nb * nx * (nx + 2 * (nx + 1)),
                nb * fft_flops(NX, nx, real=True))
        line(f"column stage 1 psf_stage_cols_fwd (8, {nx}^2) of {NX}",
             x.shape, lambda: psf_stage_cols_fwd(x, NX, nx + 1), cols,
             library_ms=lambda: torch.fft.rfft(x, n=NX, dim=-2))
        line(f"column stage 3 psf_stage_cols_inv (8, {nx + 1}, {nx}) of "
             f"{NX}", w[0].shape, lambda: psf_stage_cols_inv(*w, nx, NX, NX),
             cols, library_ms=lambda: torch.fft.irfft(wc, n=NX, dim=-2))
        hr, hi = (torch.randn((nb, nx + 1, NX), generator=g, device=dev)
                  for _ in range(2))
        line(f"rows stage psf_stage_rows (8, {nx + 1}, {nx}) of {NX}, "
             "complex H", w[0].shape, lambda: psf_stage_rows(*w, hr, hi),
             rows_work(nb, nx + 1, nx, NX, "complex"),
             plain_ms=lambda: psf_stage_rows_plain(*w, hr, hi))
        del x, w, wc, hr, hi
        torch.cuda.empty_cache()
    for nb, nx, NX in OFFROUTE_K11:
        x = torch.randn((nb, nx, nx), generator=g, device=dev)
        hr, hi = (torch.randn((nb, NX, NX), generator=g, device=dev)
                  for _ in range(2))
        line(f"K11 psf_convolve_full ({nb}, {nx}^2) in {NX}^2, random H",
             x.shape, lambda: psf_convolve_full(x, hr, hi),
             conv_work(nb, nx, nx, NX, NX, hr.numel(), True),
             plain_ms=lambda: psf_convolve_full_plain(x, hr, hi))
        del x, hr, hi
        torch.cuda.empty_cache()


def cols_short_times(reps, dev, smi, root):
    """--cols-short: the cluster column kernels of the tree at ``root``
    at the lengths below 4096, on that tree's clusters
    (ops/cfft.py:cluster_shape), beside torch.fft; one JSON line a
    case."""
    import torch

    from pfb_tpu_torch.ops.cfft import cluster_shape, fftx_c2c_cluster
    from pfb_tpu_torch.ops.psf import psf_cols_fwd, psf_cols_inv
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, fft_flops
    g = torch.Generator(device=dev).manual_seed(15)

    def line(case, shape, N, fn, work, lib):
        bms, bby = bound(*work)
        C, W = cluster_shape(N)
        rec = {"probe": "cols-short", "root": str(root), "case": case,
               "shape": list(shape), "C": C, "W": W,
               "route": _route(fn), "ms": cuda_ms(fn, reps, dev),
               "library_ms": cuda_ms(lib, reps, dev), "bound_ms": bms,
               "bound_by": bby, "card": smi}
        print(json.dumps(rec), flush=True)

    for P, N in OFFROUTE_PASSES:
        for inv, pin, pout in ((True, False, True), (False, True, False)):
            nin = N // 2 if pin else N
            nout = N // 2 if pout else N
            kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
            xr, xi = (torch.randn((P, nin, nin), generator=g, device=dev)
                      for _ in range(2))
            z = torch.zeros((P, N, nin), dtype=torch.complex64, device=dev)
            z[:, :nin] = torch.complex(xr, xi)
            lib = torch.fft.ifft if inv else torch.fft.fft
            line(f"K3c x pass {'inverse out_rolled' if inv else 'forward '
                              'in_rolled'} ({P}, {N}^2)", xr.shape, N,
                 lambda: fftx_c2c_cluster(xr, xi, **kw),
                 (8.0 * P * nin * (nin + nout), P * fft_flops(N, nin)),
                 lambda: lib(z, dim=-2))
            del xr, xi, z
    nb = 8
    for NX in OFFROUTE_STAGES[:3]:
        nx = NX // 2
        x = torch.randn((nb, nx, nx), generator=g, device=dev)
        w = [torch.randn((nb, nx + 1, nx), generator=g, device=dev)
             for _ in range(2)]
        wc = torch.complex(*w)
        cols = (4.0 * nb * nx * (nx + 2 * (nx + 1)),
                nb * fft_flops(NX, nx, real=True))
        line(f"K10ac psf_cols_fwd (8, {nx}^2) of {NX}", x.shape, NX,
             lambda: psf_cols_fwd(x, NX, nx + 1), cols,
             lambda: torch.fft.rfft(x, n=NX, dim=-2))
        line(f"K10cc psf_cols_inv (8, {nx + 1}, {nx}) of {NX}", w[0].shape,
             NX, lambda: psf_cols_inv(*w, nx, NX), cols,
             lambda: torch.fft.irfft(wc, n=NX, dim=-2))
        del x, w, wc
        torch.cuda.empty_cache()


# the row kernels' first nine lengths (R2 = 8, 10, 12, 16, 18, 20, 24, 32
# and 48)
ROWS_TIMES_LENGTHS = (2048, 2560, 3072, 4096, 4608, 5120, 6144, 8192, 12288)


def rows_times(reps, dev, smi, root):
    """--rows-times: K3r (the y pass of (P, N^2) planes, inverse out_rolled
    and forward in_rolled) and K10br (psf_rows at K1's (8, NY/2 + 1, NY/2)
    rows, complex H) of the tree at ``root`` at ROWS_TIMES_LENGTHS,
    beside torch.fft (for K10br three calls, for context: no one call
    computes it); one JSON line a case."""
    import torch

    from pfb_tpu_torch.ops.cfft import fftx_c2c_rows
    from pfb_tpu_torch.ops.psf import psf_rows
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, fft_flops, rows_work
    src = Path(root) / "pfb_tpu_torch" / "csrc" / "rows_fft.cuh"
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);",
                             src.read_text()))
    g = torch.Generator(device=dev).manual_seed(16)

    def line(case, shape, fn, work, lib, key="library_ms"):
        bms, bby = bound(*work)
        print(json.dumps({
            "probe": "rows", "root": str(root), "consts": consts,
            "case": case, "shape": list(shape), "ms": cuda_ms(fn, reps, dev),
            key: cuda_ms(lib, reps, dev), "bound_ms": bms, "bound_by": bby,
            "card": smi}), flush=True)

    for N in ROWS_TIMES_LENGTHS:
        P = 9
        for inv, pin, pout in ((True, False, True), (False, True, False)):
            nin = N // 2 if pin else N
            nout = N // 2 if pout else N
            rows = P * nin
            xr, xi = (torch.randn((rows, nin, 1), generator=g, device=dev)
                      for _ in range(2))
            z = torch.zeros((rows, N), dtype=torch.complex64, device=dev)
            z[:, :nin] = torch.complex(xr, xi)[..., 0]
            lib = torch.fft.ifft if inv else torch.fft.fft
            line(f"K3r y pass {'inverse out_rolled' if inv else 'forward '
                               'in_rolled'} ({P}, {N}^2)", xr.shape,
                 lambda: fftx_c2c_rows(xr, xi, N=N, inverse=inv,
                                       in_rolled=pin, out_rolled=pout),
                 (8.0 * rows * (nin + nout), fft_flops(N, rows)),
                 lambda: lib(z, dim=-1))
            del xr, xi, z
        nb, ny = 8, N // 2
        zr, zi = (torch.randn((nb, ny + 1, ny), generator=g, device=dev)
                  for _ in range(2))
        hr, hi = (torch.randn((nb, ny + 1, N), generator=g, device=dev)
                  for _ in range(2))
        zc, hc = torch.complex(zr, zi), torch.complex(hr, hi)
        line(f"K10br psf_rows (8, {ny + 1}, {ny}) of {N}, complex H",
             zr.shape, lambda: psf_rows(zr, zi, hr, hi),
             rows_work(nb, ny + 1, ny, N, "complex"),
             lambda: torch.fft.ifft(torch.fft.fft(zc, n=N, dim=-1) * hc,
                                    dim=-1)[..., :ny], key="three_calls_ms")
        del zr, zi, hr, hi, zc, hc
        torch.cuda.empty_cache()


def lengths_times(reps, dev, smi, root):
    """--lengths: the tree at ``root`` at the row lengths whose R2 = N /
    256 (9, 15, 25, 27, 30, 36, 40, 45, 50, 54, 60, 64) were the last to
    get register instances and at the lengths above 16384 (chip_smoke.py's NEW_ROW_LENGTHS and FOUR_LENGTHS), each
    call's route (the launch counters it moved), its bound and torch.fft,
    one JSON line a case: K3's y pass through fftx_c2c on the rows the x
    pass of P planes leaves (chip_smoke.py's row_planes), inverse
    out_rolled and forward in_rolled; the PSF rows stage through
    K10's entry (psf_stage_rows on (8, NY/2 + 1, NY/2) rows, complex H;
    three torch.fft calls for context); where the row kernel takes the
    y pass, its skeleton (loads, transposes and stores, the arithmetic
    compiled out) beside it; fftx_c2c above 16384 on one
    plane, its x pass and the y pass of the rows that leaves, both
    directions, where a tree without a route there records what it
    raised."""
    import torch

    from pfb_tpu_torch.ops import cfft
    from pfb_tpu_torch.ops.psf import psf_stage_rows
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (FOUR_LENGTHS, NEW_ROW_LENGTHS, bound, fft_flops,
                            row_planes, rows_work)
    g = torch.Generator(device=dev).manual_seed(19)

    def line(case, shape, fn, work, **extra):
        bms, bby = bound(*work)
        rec = {"probe": "lengths", "root": str(root), "case": case,
               "shape": list(shape), "bound_ms": bms, "bound_by": bby,
               "card": smi}
        try:
            rec["route"] = _route(fn)
            rec["ms"] = cuda_ms(fn, reps, dev)
        except (RuntimeError, ValueError) as e:
            rec["raised"] = f"{type(e).__name__}: {e}"
        rec.update({k: cuda_ms(f, reps, dev) for k, f in extra.items()})
        print(json.dumps(rec), flush=True)

    def passes(N, axes):
        for inv, pin, pout in ((True, False, True), (False, True, False)):
            nin = N // 2 if pin else N
            nout = N // 2 if pout else N
            kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
            lib = torch.fft.ifft if inv else torch.fft.fft
            tag = "inverse out_rolled" if inv else "forward in_rolled"
            # the x pass of (P, nin, nin) planes; the y pass of the rows
            # the x pass leaves, P N/2 (out_rolled) or P N (in_rolled)
            rows = N if pin else N // 2
            for axis, shape in axes((nin, nin), (rows, nin, 1)):
                xr, xi = (torch.randn(shape, generator=g, device=dev)
                          for _ in range(2))
                z = torch.zeros((shape[0], N, shape[2]),
                                dtype=torch.complex64, device=dev)
                z[:, :nin] = torch.complex(xr, xi)
                lines = shape[0] * shape[2]
                # the row kernel's load/transpose/store skeleton beside it
                extra = {"skeleton_ms": lambda: cfft.fftx_c2c_rows(
                    xr, xi, skeleton=True, **kw)} \
                    if cfft.row_route(N, shape[2]) else {}
                line(f"fftx_c2c {axis} pass {tag} N={N}", shape,
                     lambda: cfft.fftx_c2c(xr, xi, **kw),
                     (8.0 * lines * (nin + nout), fft_flops(N, lines)),
                     library_ms=lambda: lib(z, dim=-2), **extra)
                del xr, xi, z
                torch.cuda.empty_cache()

    for N in NEW_ROW_LENGTHS:
        P = row_planes(N)
        passes(N, lambda x, y: (("y", (P * y[0],) + y[1:]),))
        nb, ny = 8, N // 2
        zr, zi = (torch.randn((nb, ny + 1, ny), generator=g, device=dev)
                  for _ in range(2))
        hr, hi = (torch.randn((nb, ny + 1, N), generator=g, device=dev)
                  for _ in range(2))
        zc, hc = torch.complex(zr, zi), torch.complex(hr, hi)
        line(f"rows stage psf_stage_rows (8, {ny + 1}, {ny}) of {N}, "
             "complex H", zr.shape, lambda: psf_stage_rows(zr, zi, hr, hi),
             rows_work(nb, ny + 1, ny, N, "complex"),
             three_calls_ms=lambda: torch.fft.ifft(
                 torch.fft.fft(zc, n=N, dim=-1) * hc, dim=-1)[..., :ny])
        del zr, zi, hr, hi, zc, hc
        torch.cuda.empty_cache()
    for N in FOUR_LENGTHS:
        passes(N, lambda x, y: (("x", (1,) + x), ("y", y)))


# the PSF grids of the 4608^2, 6144^2 and 8192^2 images; the four-step's
# second stage at the first and last (K3c at N / 8 on 8 N columns)
LONG_LENGTHS = (18432, 24576, 32768)
LONG_STAGE2 = ((2304, 147456), (4096, 131072))


def long_times(reps, dev, smi, root, lengths=LONG_LENGTHS,
               stage2=LONG_STAGE2):
    """--long: the tree at ``root`` above 16384, one JSON line a case. At
    each of ``lengths`` the x pass of one plane and the y pass of the
    rows it leaves, inverse out_rolled ((1, N, N), N/2 rows of N) and
    forward in_rolled ((1, N/2, N/2), N rows of N/2): fftx_c2c with the
    route it took, and on the same inputs, where the tree has them, the
    four-step (fftx_c2c_four: K3f, then K3c at N / 8; the route before
    K3xl and K3yl), the lab's one-pass designs (K3cl for the x pass, with
    its skeleton, K3fr for rows), torch.fft along the axis and the bound.
    Then K3c alone at the four-step's second stage, (1, N/8, 8 N)
    inverse out_rolled at ``stage2``, beside its skeleton (the loads, the
    exchange and the stores with the FFT passes compiled out): what holds
    K3c there. A call that raises is recorded with what it raised."""
    import torch

    from pfb_tpu_torch.ops import cfft
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, fft_flops
    g = torch.Generator(device=dev).manual_seed(21)

    def timed(fn):
        try:
            return cuda_ms(fn, reps, dev)
        except (RuntimeError, ValueError) as e:
            return f"{type(e).__name__}: {e}"

    def lab(name, **kw):
        f = getattr(cfft, name, None)
        return None if f is None else (lambda: f(**kw))

    for N in lengths:
        for inv, pin, pout in ((True, False, True), (False, True, False)):
            nin = N // 2 if pin else N
            nout = N // 2 if pout else N
            kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
            fft = torch.fft.ifft if inv else torch.fft.fft
            tag = "inverse out_rolled" if inv else "forward in_rolled"
            for axis, shape in (("x", (1, nin, nin)),
                                ("y", (N if pin else N // 2, nin, 1))):
                xr, xi = (torch.randn(shape, generator=g, device=dev)
                          for _ in range(2))
                lines = shape[0] * shape[2]
                bms, bby = bound(8.0 * lines * (nin + nout),
                                 fft_flops(N, lines))
                rec = {"probe": "long", "root": str(root), "card": smi,
                       "case": f"{axis} pass {tag} N={N}",
                       "shape": list(shape), "bound_ms": bms,
                       "bound_by": bby}
                try:
                    rec["route"] = _route(lambda: cfft.fftx_c2c(xr, xi, **kw))
                except (RuntimeError, ValueError) as e:
                    rec["raised"] = f"{type(e).__name__}: {e}"
                else:
                    rec["ms"] = timed(lambda: cfft.fftx_c2c(xr, xi, **kw))
                extra = {"four_step_ms": lab("fftx_c2c_four", xr=xr, xi=xi,
                                             **kw)}
                if axis == "x":
                    extra["k3cl_ms"] = lab("fftx_c2c_cluster_long", xr=xr,
                                           xi=xi, **kw)
                    extra["k3cl_skeleton_ms"] = lab(
                        "fftx_c2c_cluster_long", xr=xr, xi=xi, skeleton=True,
                        **kw)
                else:
                    extra["k3fr_ms"] = lab("fftx_c2c_four_rows", xr=xr,
                                           xi=xi, **kw)
                for k, f in extra.items():
                    if f is not None:
                        rec[k] = timed(f)
                        torch.cuda.empty_cache()
                z = torch.zeros((shape[0], N, shape[2]),
                                dtype=torch.complex64, device=dev)
                z[:, cfft._rolled_index(N, dev) if pin else slice(None)] = \
                    torch.complex(xr, xi)
                rec["library_ms"] = timed(lambda: fft(z, dim=-2))
                print(json.dumps(rec), flush=True)
                del xr, xi, z
                torch.cuda.empty_cache()
    for M, L in stage2:
        xr, xi = (torch.randn((1, M, L), generator=g, device=dev)
                  for _ in range(2))
        kw = dict(N=M, inverse=True, out_rolled=True)
        bms, bby = bound(8.0 * L * (M + M // 2), fft_flops(M, L))
        print(json.dumps({
            "probe": "long", "root": str(root), "card": smi,
            "case": f"K3c at the four-step's second stage, inverse "
                    f"out_rolled, N = {M}", "shape": [1, M, L],
            "bound_ms": bms, "bound_by": bby,
            "ms": timed(lambda: cfft.fftx_c2c_cluster(xr, xi, **kw)),
            "skeleton_ms": timed(lambda: cfft.fftx_c2c_cluster(
                xr, xi, skeleton=True, **kw))}), flush=True)
        del xr, xi
        torch.cuda.empty_cache()


# the lengths below 2048 that a 128-aligned image's grids and PSF Hessian
# take (N = 2 nx for nx = 128-768, and the PSF grids' 4 nx up to 384^2),
# and K1's two shapes at them: the 512^2 and 768^2 images' PSF Hessians
SHORT_LENGTHS = (256, 512, 768, 1024, 1280, 1536)
SHORT_K1 = ((8, 512, 1024), (8, 768, 1536))


def short_times(reps, dev, smi, root, lengths=SHORT_LENGTHS, k1=SHORT_K1):
    """--short: the tree at ``root`` at the lengths below 2048, each call's
    route (the launch counters it moved), its bound (chip_smoke.py:bound)
    and the library call, one JSON line a case: K3's x pass (fftx_c2c on
    (9, nin, nin) planes) and y pass (on the (9 nrow, nin, 1) rows that
    pass leaves), inverse out_rolled and forward in_rolled, beside
    torch.fft and the line kernel (fftx_c2c_lab, line_fft_kernel whatever
    the routes say); the PSF column stages (psf_stage_cols_fwd / _inv at
    (8, NX/2, NX/2)) beside rfft / irfft, and the rows stage
    (psf_stage_rows on (8, NY/2 + 1, NY/2) rows, complex H) beside three
    torch.fft calls, each beside the line kernels of ops/psf.py:
    psf_line_lab where the tree has it; K1 (psf_convolve_h, random
    complex H) at ``k1``'s (nb, nx, NX) beside its plain version. A tree
    whose routes stop at 2048 runs the line kernels on every case. Each
    single call's CUDA-event time (``ms``, ``line_ms``, ...) holds the
    launch and the wrapper's host work; ``graph_ms`` / ``line_graph_ms``
    are the same calls replayed from a CUDA graph (graph_ms), the
    device's time alone."""
    import torch

    from pfb_tpu_torch.ops import psf
    from pfb_tpu_torch.ops.cfft import fftx_c2c, fftx_c2c_lab
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, conv_work, fft_flops, rows_work
    g = torch.Generator(device=dev).manual_seed(20)
    lab = getattr(psf, "psf_line_lab", None)

    def line(case, shape, fn, work, **extra):
        bms, bby = bound(*work)
        rec = {"probe": "short", "root": str(root), "case": case,
               "shape": list(shape), "route": _route(fn),
               "ms": cuda_ms(fn, reps, dev), "bound_ms": bms,
               "bound_by": bby, "card": smi,
               "graph_ms": graph_ms(fn, reps, dev)}
        rec.update({k: cuda_ms(f, reps, dev) for k, f in extra.items()
                    if f is not None})
        if extra.get("line_ms") is not None:
            rec["line_graph_ms"] = graph_ms(extra["line_ms"], reps, dev)
        print(json.dumps(rec), flush=True)

    P = 9
    for N in lengths:
        for inv, pin, pout in ((True, False, True), (False, True, False)):
            nin = N // 2 if pin else N
            nout = N // 2 if pout else N
            kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
            lib = torch.fft.ifft if inv else torch.fft.fft
            tag = "inverse out_rolled" if inv else "forward in_rolled"
            rows = N if pin else N // 2
            for axis, shape in (("x", (P, nin, nin)),
                                ("y", (P * rows, nin, 1))):
                xr, xi = (torch.randn(shape, generator=g, device=dev)
                          for _ in range(2))
                z = torch.zeros((shape[0], N, shape[2]),
                                dtype=torch.complex64, device=dev)
                z[:, :nin] = torch.complex(xr, xi)
                lines = shape[0] * shape[2]
                line(f"K3 {axis} pass {tag} ({P}, {N}^2)", shape,
                     lambda: fftx_c2c(xr, xi, **kw),
                     (8.0 * lines * (nin + nout), fft_flops(N, lines)),
                     library_ms=lambda: lib(z, dim=-2),
                     line_ms=lambda: fftx_c2c_lab(xr, xi, **kw))
                del xr, xi, z
                torch.cuda.empty_cache()
    nb = 8
    for NX in lengths:
        nx = NX // 2
        x = torch.randn((nb, nx, nx), generator=g, device=dev)
        w = [torch.randn((nb, nx + 1, nx), generator=g, device=dev)
             for _ in range(2)]
        wc = torch.complex(*w)
        cols = (4.0 * nb * nx * (nx + 2 * (nx + 1)),
                nb * fft_flops(NX, nx, real=True))
        line(f"column stage 1 psf_stage_cols_fwd (8, {nx}^2) of {NX}",
             x.shape, lambda: psf.psf_stage_cols_fwd(x, NX, nx + 1), cols,
             library_ms=lambda: torch.fft.rfft(x, n=NX, dim=-2),
             line_ms=lab and (lambda: lab(1, x, NX=NX, rows=nx + 1)))
        line(f"column stage 3 psf_stage_cols_inv (8, {nx + 1}, {nx}) of "
             f"{NX}", w[0].shape,
             lambda: psf.psf_stage_cols_inv(*w, nx, NX, NX), cols,
             library_ms=lambda: torch.fft.irfft(wc, n=NX, dim=-2),
             line_ms=lab and (lambda: lab(3, *w, NX=NX, nx=nx, NY=NX)))
        hr, hi = (torch.randn((nb, nx + 1, NX), generator=g, device=dev)
                  for _ in range(2))
        hc = torch.complex(hr, hi)
        line(f"rows stage psf_stage_rows (8, {nx + 1}, {nx}) of {NX}, "
             "complex H", w[0].shape,
             lambda: psf.psf_stage_rows(*w, hr, hi),
             rows_work(nb, nx + 1, nx, NX, "complex"),
             three_calls_ms=lambda: torch.fft.ifft(
                 torch.fft.fft(wc, n=NX, dim=-1) * hc, dim=-1)[..., :nx],
             line_ms=lab and (lambda: lab(2, *w, NX=NX, hr=hr, hi=hi)))
        del x, w, wc, hr, hi, hc
        torch.cuda.empty_cache()
    for nb, nx, NX in k1:
        x = torch.randn((nb, nx, nx), generator=g, device=dev)
        hr, hi = (torch.randn((nb, nx + 1, NX), generator=g, device=dev)
                  for _ in range(2))
        line(f"K1 psf_convolve_h ({nb}, {nx}^2) in {NX}^2, random complex "
             "H", x.shape, lambda: psf.psf_convolve_h(x, hr, hi),
             conv_work(nb, nx, nx, NX, NX, hr.numel(), True),
             plain_ms=lambda: psf.psf_convolve_h_plain(x, hr, hi))
        del x, hr, hi
        torch.cuda.empty_cache()


def cols_tiny_times(reps, dev, smi, root):
    """--cols-tiny: the cluster column kernels of the tree at ``root``
    at the lengths below 2048 (K3c's x pass of (9, N^2) inverse
    out_rolled and forward in_rolled, K10ac / K10cc at (8, NX/2, NX/2)),
    on that tree's clusters (ops/cfft.py:cluster_shape), beside
    torch.fft, each single call's time and its CUDA-graph replay's
    (graph_ms); one JSON line a case (--cols-const kTinyClusters=1,2 times
    one tree a value)."""
    import torch

    from pfb_tpu_torch.ops.cfft import cluster_shape, fftx_c2c_cluster
    from pfb_tpu_torch.ops.psf import psf_cols_fwd, psf_cols_inv
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, fft_flops
    g = torch.Generator(device=dev).manual_seed(21)

    def line(case, shape, N, fn, work, lib):
        bms, bby = bound(*work)
        C, W = cluster_shape(N)
        rec = {"probe": "cols-tiny", "root": str(root), "case": case,
               "shape": list(shape), "C": C, "W": W,
               "route": _route(fn), "ms": cuda_ms(fn, reps, dev),
               "graph_ms": graph_ms(fn, reps, dev),
               "library_ms": cuda_ms(lib, reps, dev), "bound_ms": bms,
               "bound_by": bby, "card": smi}
        print(json.dumps(rec), flush=True)

    for N in SHORT_LENGTHS:
        for inv, pin, pout in ((True, False, True), (False, True, False)):
            nin = N // 2 if pin else N
            nout = N // 2 if pout else N
            kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
            xr, xi = (torch.randn((9, nin, nin), generator=g, device=dev)
                      for _ in range(2))
            z = torch.zeros((9, N, nin), dtype=torch.complex64, device=dev)
            z[:, :nin] = torch.complex(xr, xi)
            lib = torch.fft.ifft if inv else torch.fft.fft
            line(f"K3c x pass {'inverse out_rolled' if inv else 'forward '
                              'in_rolled'} (9, {N}^2)", xr.shape, N,
                 lambda: fftx_c2c_cluster(xr, xi, **kw),
                 (8.0 * 9 * nin * (nin + nout), 9 * fft_flops(N, nin)),
                 lambda: lib(z, dim=-2))
            del xr, xi, z
        nx = N // 2
        x = torch.randn((8, nx, nx), generator=g, device=dev)
        w = [torch.randn((8, nx + 1, nx), generator=g, device=dev)
             for _ in range(2)]
        wc = torch.complex(*w)
        cols = (4.0 * 8 * nx * (nx + 2 * (nx + 1)),
                8 * fft_flops(N, nx, real=True))
        line(f"K10ac psf_cols_fwd (8, {nx}^2) of {N}", x.shape, N,
             lambda: psf_cols_fwd(x, N, nx + 1), cols,
             lambda: torch.fft.rfft(x, n=N, dim=-2))
        line(f"K10cc psf_cols_inv (8, {nx + 1}, {nx}) of {N}", w[0].shape,
             N, lambda: psf_cols_inv(*w, nx, N), cols,
             lambda: torch.fft.irfft(wc, n=N, dim=-2))
        del x, w, wc
        torch.cuda.empty_cache()


MINB_RE = re.compile(r"constexpr int kColsMinBlocks = (\d+);")


COLS_SHAPES = ((8, 2048, 2048, 2049), (8, 4096, 4096, 4097),
               (4, 2048, 512, 2052), (8, 1024, 1024, 1025),
               (8, 1280, 1280, 1281), (8, 1536, 1536, 1537))


def cols_times(reps, dev, smi, root, shapes=COLS_SHAPES):
    """--cols-times: the cluster column kernels of the tree at ``root``
    at (nb, nx, L, rows) of ``shapes``, both timers, one JSON line a
    case."""
    import torch

    from pfb_tpu_torch.ops import psf as ops
    src = Path(ops.__file__).parents[1] / "csrc" / "psf_cols.cu"
    minb = int(MINB_RE.search(src.read_text()).group(1))
    g = torch.Generator(device=dev).manual_seed(0)
    for nb, nx, L, rows in shapes:
        NX = 2 * nx
        x = torch.randn((nb, nx, L), generator=g, device=dev)
        w = [torch.randn((nb, rows, L), generator=g, device=dev)
             for _ in range(2)]
        wc = torch.complex(w[0][:, :nx + 1], w[1][:, :nx + 1])
        cases = [("psf_cols_fwd", lambda: ops.psf_cols_fwd(x, NX, rows)),
                 ("psf_cols_inv", lambda: ops.psf_cols_inv(*w, nx, NX)),
                 ("rfft", lambda: torch.fft.rfft(x, n=NX, dim=-2)),
                 ("irfft", lambda: torch.fft.irfft(wc, n=NX, dim=-2))]
        if rows > nx + 1:  # the shard: K10's entries on the same kernels
            cases += [("psf_stage_cols_fwd",
                       lambda: ops.psf_stage_cols_fwd(x, NX, rows)),
                      ("psf_stage_cols_inv",
                       lambda: ops.psf_stage_cols_inv(*w, nx, NX, NX))]
        for name, fn in cases:
            print(json.dumps({
                "probe": "cols", "root": str(root), "minblocks": minb,
                "shape": [nb, nx, L, rows], "case": name,
                "ms_one_call": cuda_ms(fn, reps, dev),
                "ms_back_to_back": back_to_back_ms(fn, 2 * reps, dev),
                "card": smi}), flush=True)
        del x, w, wc
        torch.cuda.empty_cache()


# the Python mirrors of the probed constants: (module of pfb_tpu_torch,
# name), set in a copy along with the constant
MIRRORS = {"kShortClusters": ("ops/cfft.py", "_SHORT_C"),
           "kTinyClusters": ("ops/cfft.py", "_TINY_C")}


def _set_once(path, pattern, repl):
    """Replace the one match of ``pattern`` in the file at ``path``."""
    text, n = re.subn(pattern, repl, path.read_text())
    if n != 1:
        raise RuntimeError(f"{pattern} not found once in {path}")
    path.write_text(text)


def const_probe(source, name, values, base, flag, reps):
    """Copies of pfb_tpu_torch under ``base/<value>/`` with the constant
    ``constexpr int name`` of ``csrc/<source>`` (and its Python mirror in
    :data:`MIRRORS`) set to each value, built at once, then this tree,
    each copy and this tree again timed by the lab's ``flag``
    (--cols-times, --degrid) in child processes. Returns the lines'
    records."""
    roots = []
    for v in values:
        d = base / str(v)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "pfb_tpu_torch", d / "pfb_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        _set_once(d / "pfb_tpu_torch" / "csrc" / source,
                  rf"constexpr int {name} = \d+;",
                  f"constexpr int {name} = {v};")
        if name in MIRRORS:
            module, py = MIRRORS[name]
            _set_once(d / "pfb_tpu_torch" / module, rf"(?m)^{py} = \d+",
                      f"{py} = {v}")
        roots.append(d)
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from pfb_tpu_torch import kernels; kernels.build()", str(d)])
        for d in [ROOT] + roots]
    if any(b.wait() for b in builds):
        raise RuntimeError("a build of the probe's trees failed")
    recs = []
    for d in [ROOT] + roots + [ROOT]:
        res = subprocess.run(
            [sys.executable, __file__, flag, "--reps", str(reps), "--root",
             str(d)], capture_output=True, text=True, check=True)
        print(res.stdout, end="", flush=True)
        recs += [json.loads(v) for v in res.stdout.splitlines()]
    return recs


# csrc/rows_fft.cuh's stage 2 (rows_mid) with every pair R2 in two
# register passes through each thread's own slots of the line: RB DFTs
# of RA in place (the stage twiddles on load, W_R2^{n2 k1} on store), then
# RA DFTs of RB into registers in output order; dft_pair's operations
# with RA or RB values at a time beside the R2 outputs. The design the
# rows kernels measured against and did not take (PERF.md).
TWO_PASS_ROWS_MID = """// Stage 2 with every pair R2 in two register passes (the lab's copy)
template <int R2>
__device__ __forceinline__ void mid_two_pass(float2* sm, const float2* T2,
                                             bool inv, float2* u) {
  constexpr int RA = pair_ra(R2), RB = R2 / RA;
  const float sg = inv ? -1.f : 1.f;
  const int t = threadIdx.x;
#pragma unroll
  for (int n2 = 0; n2 < RB; ++n2) {
    float2 a[RA];
#pragma unroll
    for (int n1 = 0; n1 < RA; ++n1) {
      const int q = RB * n1 + n2;
      a[n1] = sm[rpad(t + kRowBflies * q)];
      if (q > 0) {
        const float2 w = __ldg(&T2[(q - 1) * 16]);
        a[n1] = cmul(a[n1], make_float2(w.x, sg * w.y));
      }
    }
    reg_dft<RA>(a, inv);
#pragma unroll
    for (int k1 = 0; k1 < RA; ++k1) {
      if (n2 > 0 && k1 > 0) a[k1] = cmul(a[k1], wroot<R2>(n2 * k1, inv));
      sm[rpad(t + kRowBflies * (RB * k1 + n2))] = a[k1];
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < RA; ++k1) {
    float2 b[RB];
#pragma unroll
    for (int n2 = 0; n2 < RB; ++n2)
      b[n2] = sm[rpad(t + kRowBflies * (RB * k1 + n2))];
    reg_dft<RB>(b, inv);
#pragma unroll
    for (int k2 = 0; k2 < RB; ++k2) u[k1 + RA * k2] = b[k2];
  }
}

template <int R2, int T, int S, bool kFFT>
__device__ __forceinline__ void rows_mid(float2* sm, const float2* TW,
                                         bool inv) {
  constexpr int NF = S * kRowBflies;
  constexpr int B2 = (NF + T - 1) / T;
  static_assert(S > 1 || B2 * T == kRowBflies, "T divides 256");
  constexpr bool kTwo = kFFT && S == 1 && B2 == 1 && pair_ra(R2) > 0;
  const float sg = inv ? -1.f : 1.f;
  float2 u[B2][R2];
  if constexpr (kTwo) {
    mid_two_pass<R2>(sm, TW + 15 + (threadIdx.x & 15), inv, u[0]);
  } else {
#pragma unroll
    for (int b = 0; b < B2; ++b) {
      const int f = threadIdx.x + T * b;
      if (NF % T && f >= NF) continue;
      const int s = S > 1 ? f / kRowBflies : 0;
      const int base = s * kRowBflies * R2, t = f - s * kRowBflies;
#pragma unroll
      for (int q = 0; q < R2; ++q)
        u[b][q] = sm[rpad(base + t + kRowBflies * q)];
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < B2; ++b) {
    const int f = threadIdx.x + T * b;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / kRowBflies : 0;
    const int base = s * kRowBflies * R2, t = f - s * kRowBflies;
    if constexpr (kFFT && !kTwo) {
      const float2* T2 = TW + 15 + (t & 15);
#pragma unroll
      for (int q = 1; q < R2; ++q) {
        const float2 w = __ldg(&T2[(q - 1) * 16]);
        u[b][q] = cmul(u[b][q], make_float2(w.x, sg * w.y));
      }
      reg_dft<R2>(u[b], inv);
    }
    const int o = base + (t >> 4) * 16 * R2 + (t & 15);
#pragma unroll
    for (int q = 0; q < R2; ++q) sm[rpad(o + 16 * q)] = u[b][q];
  }
}

"""


def two_pass_copy():
    """A copy of pfb_tpu_torch under ``build/lab_two_pass/pairs/`` whose
    rows_mid is :data:`TWO_PASS_ROWS_MID`. Returns its root."""
    d = ROOT / "build" / "lab_two_pass" / "pairs"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / "pfb_tpu_torch", d / "pfb_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _set_once(d / "pfb_tpu_torch" / "csrc" / "rows_fft.cuh",
              r"(?s)// Stage 2, radix R2 at Ns = 16.*?(?=// Stage 3's input)",
              lambda m: TWO_PASS_ROWS_MID)
    return d


def two_pass_probe(reps, root, out):
    """--two-pass: :func:`two_pass_copy` built at once with this tree and
    the tree at ``root``; then ``root`` (when another tree), this tree,
    the copy, the copy, this tree and ``root`` timed by --rows-times, and
    this tree, the copy, the copy and this tree by --lengths, in child
    processes. Returns the lines' records."""
    two = two_pass_copy()
    refs = [] if Path(root).resolve() == ROOT else [Path(root)]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from pfb_tpu_torch import kernels; kernels.build()", str(d)])
        for d in refs + [ROOT, two]]
    if any(b.wait() for b in builds):
        raise RuntimeError("a build of the probe's trees failed")
    turn = [ROOT, two, two, ROOT]
    recs = []
    for flag, roots in (("--rows-times", refs + turn + refs),
                        ("--lengths", turn)):
        for d in roots:
            res = subprocess.run(
                [sys.executable, __file__, flag, "--reps", str(reps),
                 "--root", str(d)], capture_output=True, text=True,
                check=True)
            print(res.stdout, end="", flush=True)
            recs += [json.loads(v) for v in res.stdout.splitlines()]
    if out:
        Path(out).write_text("".join(json.dumps(r) + "\n" for r in recs))
    return recs


ROW_SOURCES = ("cfft_rows.cu", "psf_rows.cu", "psf_rows_mid.cu",
               "psf_rows_long.cu")


def _ptxas_rows(log):
    """Registers and spill bytes of the row kernels in a ptxas -v log,
    by mangled name."""
    found, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if ("rows_fft_kernel" in m.group(1) or
                                 "psf_rows_fused_kernel" in m.group(1)) \
                else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            found.setdefault(cur, {})["spill_bytes"] = [int(m.group(1)),
                                                        int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            found.setdefault(cur, {})["registers"] = int(m.group(1))
            cur = None
    return found


def _local_by_line(sass):
    """nvdisasm -g's local stores and loads (STL, LDL) by function and
    source line."""
    found, func, loc = {}, None, None
    for line in sass.splitlines():
        m = re.search(r"\.text\.(_Z\w+)", line)
        if m:
            func, loc = m.group(1), None
            continue
        m = re.search(r'//## File "([^"]+)", line (\d+)', line)
        if m:
            loc = f"{Path(m.group(1)).name}:{m.group(2)}"
            continue
        m = re.search(r"\b(STL|LDL)\b", line)
        if m and func:
            key = f"{m.group(1)} {loc}"
            found.setdefault(func, {})
            found[func][key] = found[func].get(key, 0) + 1
    return found


def spills(out):
    """--spills: ROW_SOURCES of this tree and of :func:`two_pass_copy`
    compiled to cubins at once with ptxas -v and line info; one JSON line
    a row kernel instance that spills or has R2 >= 45: its template
    arguments (N, R2, MINB, then the kernel's flags), registers, spill
    bytes (stores, loads) and local loads and stores by source line.
    Returns the records."""
    sys.path.insert(0, str(ROOT))
    from pfb_tpu_torch import kernels
    flags = [f for f in kernels.NVCC_FLAGS if f != "-shared"]
    trees = {"this": ROOT, "two_pass": two_pass_copy()}
    work = ROOT / "build" / "lab_spills"
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    for tree, d in trees.items():
        for src in ROW_SOURCES:
            cub = work / f"{tree}.{src}.cubin"
            jobs.append((tree, src, cub, subprocess.Popen(
                [kernels._nvcc(), *flags, "-Xptxas", "-v", "-lineinfo",
                 "-cubin", "-o", str(cub),
                 str(d / "pfb_tpu_torch" / "csrc" / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    nvdisasm = str(Path(kernels._nvcc()).with_name("nvdisasm"))
    recs = []
    for tree, src, cub, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {tree} {src}:\n{log}")
        sass = subprocess.run([nvdisasm, "-g", "-c", str(cub)],
                              capture_output=True, text=True,
                              check=True).stdout
        local = _local_by_line(sass)
        for name, rec in sorted(_ptxas_rows(log).items()):
            args = [int(a or b) for a, b in
                    re.findall(r"Li(\d+)E|Lb(\d)E", name)]
            r = {"probe": "spills", "tree": tree, "source": src,
                 "kernel": "psf_rows_fused_kernel" if "psf_rows" in name
                 else "rows_fft_kernel", "args": args, **rec,
                 "local_by_line": local.get(name, {})}
            if r.get("spill_bytes", [0, 0]) != [0, 0] or args[1] >= 45:
                print(json.dumps(r), flush=True)
            recs.append(r)
    if out:
        Path(out).write_text("".join(json.dumps(r) + "\n" for r in recs))
    return recs


def minblocks(values, reps, out):
    """--minblocks: :func:`const_probe` of kColsMinBlocks (psf_cols.cu)
    by --cols-times. Returns the lines' records."""
    recs = const_probe("psf_cols.cu", "kColsMinBlocks", values,
                       ROOT / "build" / "lab_minblocks", "--cols-times",
                       reps)
    if out:
        Path(out).write_text("".join(json.dumps(r) + "\n" for r in recs))
    return recs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nband", type=int, default=8)
    ap.add_argument("--nx", default="2048,4096",
                    help="image sizes, comma-separated")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script with the plain versions")
    ap.add_argument("--digest", action="store_true")
    ap.add_argument("--root", default=str(ROOT),
                    help="directory holding the pfb_tpu_torch to import")
    ap.add_argument("--minblocks",
                    help="kColsMinBlocks values to probe, comma-separated")
    ap.add_argument("--cols-times", action="store_true",
                    help="time the column kernels of --root (a child of "
                    "--minblocks)")
    ap.add_argument("--fold", action="store_true",
                    help="time the folds K5 and K8 of --root")
    ap.add_argument("--spread", action="store_true",
                    help="time the spreads K4 and K7 of --root, with the "
                    "lab's designs and skeletons where it has them")
    ap.add_argument("--degrid", action="store_true",
                    help="time the degrids K6 and K9 of --root, with the "
                    "lab's designs and skeletons where it has them")
    ap.add_argument("--degrid-rungs", action="store_true",
                    help="time every degrid design at the tile ladder's "
                    "largest rung")
    ap.add_argument("--degrid-const",
                    help="NAME=V1,V2: a constant of csrc/pg_degrid.cu and "
                    "the values to probe")
    ap.add_argument("--offroute", action="store_true",
                    help="time the kernels of --root at the lengths "
                    "2048-5120, with each call's route")
    ap.add_argument("--cols-short", action="store_true",
                    help="time the cluster column kernels of --root below "
                    "4096")
    ap.add_argument("--cols-tiny", action="store_true",
                    help="time the cluster column kernels of --root below "
                    "2048")
    ap.add_argument("--cols-const",
                    help="NAME=V1,V2: a constant of csrc/psf_cols.cuh and "
                    "the values to probe")
    ap.add_argument("--short", action="store_true",
                    help="time K3's passes, the PSF stages and K1 of --root "
                    "below 2048 beside the line kernels and torch.fft")
    ap.add_argument("--rows-times", action="store_true",
                    help="time the register row kernels of --root at "
                    "2048-12288 (R2 = 8-48)")
    ap.add_argument("--lengths", action="store_true",
                    help="time --root's row passes and rows stage at the "
                    "lengths of the images R2 = 9-64 and fftx_c2c above "
                    "16384, with each call's route")
    ap.add_argument("--long", action="store_true",
                    help="time --root's passes above 16384 beside the "
                    "four-step, the lab's one-pass designs and torch.fft, "
                    "and K3c's split at the four-step's second stage")
    ap.add_argument("--rows-const",
                    help="NAME=V1,V2: a constant of csrc/rows_fft.cuh and "
                    "the values to probe")
    ap.add_argument("--two-pass", action="store_true",
                    help="time a copy with stage 2 of the row kernels in "
                    "two register passes beside this tree")
    ap.add_argument("--spills", action="store_true",
                    help="registers, spills and local loads and stores by "
                    "source line of the row kernels, this tree and the "
                    "two-pass copy (nvcc, no card)")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.spills:
        spills(args.out)
        return 0
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    smi = card(dev)
    if args.digest:
        print(json.dumps({"card": smi, "root": args.root,
                          "digest": digest(dev)}))
        return 0
    if args.fold:
        fold_times(args.reps, dev, smi, args.root)
        return 0
    if args.spread:
        spread_times(args.reps, dev, smi, args.root)
        return 0
    if args.degrid:
        degrid_times(args.reps, dev, smi, args.root)
        return 0
    if args.degrid_rungs:
        degrid_rungs(args.reps, dev, smi)
        return 0
    if args.offroute:
        offroute_times(args.reps, dev, smi, args.root)
        return 0
    if args.cols_short:
        cols_short_times(args.reps, dev, smi, args.root)
        return 0
    if args.short:
        short_times(args.reps, dev, smi, args.root)
        return 0
    if args.cols_tiny:
        cols_tiny_times(args.reps, dev, smi, args.root)
        return 0
    if args.cols_const:
        name, values = args.cols_const.split("=")
        const_probe("psf_cols.cuh", name, [int(v) for v in values.split(",")],
                    ROOT / "build" / "lab_cols" / name,
                    "--cols-tiny" if name.startswith("kTiny")
                    else "--cols-short", args.reps)
        return 0
    if args.rows_times:
        rows_times(args.reps, dev, smi, args.root)
        return 0
    if args.lengths:
        lengths_times(args.reps, dev, smi, args.root)
        return 0
    if args.long:
        if dev.type == "cuda":
            long_times(args.reps, dev, smi, args.root)
        else:
            long_times(args.reps, dev, smi, args.root, lengths=(1024,),
                       stage2=((128, 1024),))
        return 0
    if args.two_pass:
        two_pass_probe(args.reps, args.root, args.out)
        return 0
    if args.rows_const:
        name, values = args.rows_const.split("=")
        const_probe("rows_fft.cuh", name, [int(v) for v in values.split(",")],
                    ROOT / "build" / "lab_rows" / name, "--rows-times",
                    args.reps)
        return 0
    if args.degrid_const:
        name, values = args.degrid_const.split("=")
        const_probe("pg_degrid.cu", name, [int(v) for v in values.split(",")],
                    ROOT / "build" / "lab_degrid" / name, "--degrid",
                    args.reps)
        return 0
    if args.cols_times:
        cols_times(args.reps, dev, smi, args.root)
        return 0
    if args.minblocks:
        if dev.type != "cuda":
            print("--minblocks needs a CUDA device", file=sys.stderr)
            return 1
        minblocks([int(v) for v in args.minblocks.split(",")], args.reps,
                  args.out)
        return 0
    sizes = []
    for nx in (int(v) for v in str(args.nx).split(",")):
        sizes.append(lab_size(args.nband, nx, args.reps, dev, smi))
        print(json.dumps(sizes[-1]), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    summary = {"card": smi, "root": args.root, "sizes": sizes,
               "ok": all(z["ok"] for z in sizes)}
    line = json.dumps(summary)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
