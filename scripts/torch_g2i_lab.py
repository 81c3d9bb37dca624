#!/usr/bin/env python3
"""Grid-to-image / x-pass lab on the card (counterpart of
scripts/wl_g2i_lab.py, L2): where does the w-plane transform's time go?

    python3 scripts/torch_g2i_lab.py [--reps 10] [--out FILE]
    python3 scripts/torch_g2i_lab.py --floor [--reps 10] [--out FILE]
    python3 scripts/torch_g2i_lab.py [--floor] --device cpu

Every time is the CUDA-event median of ``reps`` calls after a warm-up,
printed as one JSON line with its bound (``chip_smoke.py:bound``: bytes
over 3.35 TB/s, FP32 operations over 67 TFLOP/s, bf16 tensor-core
operations over 989 TFLOP/s) and the card's name and power limit; a
summary line ends each run (also written to ``--out``).

main (wl_g2i_lab.py:main and pass1_variants), at (9, 2048^2) and (4,
8192^2), inverse transforms of random grids:
- K3's x pass (fftx_c2c, out_rolled: the cluster column kernel at N >=
  4096, ops/cfft.py:cluster_route), the x pass before it
  (line_fft_kernel, fftx_c2c_lab at its own S), the cluster kernel
  (fftx_c2c_cluster, also at 2048 where the route does not take it) and
  its load/exchange/store skeleton with the FFT passes compiled out (the
  pattern's floor, as the first-pass cut is the line kernel's); the
  cluster pass's error against the plain transform is gated at 1e-5 of
  max;
- the transpose pair of the half
  planes (``transpose(-1, -2).contiguous()``, plain torch as XLA's was),
  fft2_c2c_pruned whole, the phasor-screen accumulation alone (the loop of
  ops/wgridder.py:309-312) and _grid_to_image whole;
- the lines-per-block sweep of K3's x pass (fftx_c2c_lab, S in {1, 2, 4,
  8} at 2048 and {1, 2} at 8192: the lane-block sweep's counterpart);
- the library calls torch.fft.ifft(dim=-2) (the x pass) and
  torch.fft.ifft2;
- K3's y pass (the contiguous rows a 2-D transform's x pass leaves) of
  (4, 8192^2) inverse out_rolled and of (4, 4096^2 -> 8192^2) forward
  in_rolled: the row kernel K3r (fftx_c2c_rows), its load/transpose/store
  skeleton with the radix arithmetic compiled out, the line kernel
  before it (fftx_c2c_lab), and torch.fft along the zero-padded rows;
  K3r's error against its plain version is gated at 1e-5 of max;
- the x-pass variants at (4, 8192^2) (wl_g2i_lab.py:170, the pallas_call
  of ``run``): K3 whole (k_full); the plan cut to its first radix pass
  (k_stage1's counterpart: a Stockham pass, not the four-step stage 1);
  K3 on contiguous lines of the pre-transposed stack (k_notr); the strip
  copy skeleton of re and im (k_skel, ops/memlab.py); the split-precision
  x pass (k_3x, ops/cfft.py:fftx_c2c_split), whose error against the
  FP32 K3 and against a float64 transform of the same input is reported
  (wl_g2i_lab.py:259, ``once``).

--floor (wl_g2i_lab.py:memcpy_variants and pair_ilp_probe):
- the copy probes of one (4, 8192^2) stack (ops/memlab.py): strip
  (f_single, :300), rows at S = 64, 128, 256 (f_row, :323), relayout
  (f_split, :357) and batched (f_batch, :380), each checked against
  slicing;
- the paired-entry spread probe (pair_ilp_probe, :466): K4 through
  pack_entries at P = 2 on scripts/torch_capacity_lab.py's observation
  (125,000 rows x 8 channels, 1024^2, epsilon 1e-5), checked against the
  plain spread.

``--device cpu`` rehearses either section with the plain versions at
N = 256 (main; the y pass at 4096 on 8 rows) and 256 (copies), 3,000
rows x 4 channels at 128^2 (probe).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from torch_kernel_lab import card, cuda_ms  # noqa: E402

SPLIT_TOL = 1e-5  # split, cluster and row passes against their plain versions


class Lab:
    """Times callables and prints one JSON line each."""

    def __init__(self, dev, reps, smi):
        self.dev, self.reps, self.smi = dev, reps, smi
        self.ms = {}

    def time(self, name, shape, fn, work=(0.0, 0.0, 0.0), **extra):
        from chip_smoke import bound
        ms = cuda_ms(fn, self.reps, self.dev)
        bms, bby = bound(*work)
        rec = dict(lab="g2i", name=name, shape=list(shape), ms=ms,
                   reps=self.reps, bound_ms=bms, bound_by=bby,
                   card=self.smi, **extra)
        print(json.dumps(rec), flush=True)
        self.ms[name] = ms
        return ms


def xpass_work(P, N, nout):
    """(bytes, FP32 operations) of an x pass of P (N, N) planes: re and
    im read once, nout rows of each written once; N lines of length N."""
    from chip_smoke import fft_flops
    return 8.0 * P * N * (N + nout), P * fft_flops(N, N)


def screen(ir, ii, c, s, cd, sd):
    """The phasor-screen accumulation of ops/wgridder.py:309-312."""
    import torch
    img = torch.zeros_like(c)
    for p_ in range(ir.shape[0]):
        img = img + ir[p_] * c - ii[p_] * s
        c, s = c * cd - s * sd, s * cd + c * sd
    return img


def cluster_passes(lab, gr, gi, N, tag):
    """The cluster column kernel's x pass (inverse, out_rolled), the
    line kernel's beside it in the same run, and the cluster kernel's
    skeleton; returns the error of the cluster pass against the plain
    transform (max over re and im / max)."""
    from pfb_tpu_torch.ops.cfft import (cluster_shape, fftx_c2c_cluster,
                                        fftx_c2c_lab, fftx_c2c_plain)
    kw = dict(N=N, inverse=True, out_rolled=True)
    xw = xpass_work(gr.shape[0], N, N // 2)
    C, W = cluster_shape(N)
    pr, pi = fftx_c2c_plain(gr, gi, **kw)
    scale = float(max(pr.abs().max(), pi.abs().max()))
    lab.time(f"{tag} x pass line kernel (fftx_c2c_lab, K3 before the "
             "cluster kernel)", gr.shape,
             lambda: fftx_c2c_lab(gr, gi, **kw), xw)
    yr, yi = fftx_c2c_cluster(gr, gi, **kw)
    err = float(max((yr - pr).abs().max(), (yi - pi).abs().max())) / scale
    del yr, yi, pr, pi
    lab.time(f"{tag} x pass cluster C={C} W={W}", gr.shape,
             lambda: fftx_c2c_cluster(gr, gi, **kw), xw,
             rel_err_vs_plain=err)
    lab.time(f"{tag} x pass cluster skeleton C={C} W={W} (no FFT passes)",
             gr.shape,
             lambda: fftx_c2c_cluster(gr, gi, skeleton=True, **kw),
             (xw[0], 0.0))
    return err


def main_case(lab, P, N, sweep):
    """wl_g2i_lab.py:case at (P, N^2) planes (nx = N/2); returns the
    cluster pass's error against the plain transform."""
    import torch

    from chip_smoke import fft_flops
    from pfb_tpu_torch.ops.cfft import fft2_c2c_pruned, fftx_c2c, fftx_c2c_lab
    from pfb_tpu_torch.ops.wgridder import _grid_to_image, gi_consts
    dev = lab.dev
    nx = N // 2
    g = torch.Generator(device=dev).manual_seed(N)
    gr = torch.randn((P, N, N), generator=g, device=dev)
    gi = torch.randn((P, N, N), generator=g, device=dev)
    tag = f"{N}^2 P={P}"
    xw = xpass_work(P, N, nx)
    lab.time(f"{tag} x pass K3 fftx_c2c (out_rolled)", gr.shape,
             lambda: fftx_c2c(gr, gi, N=N, inverse=True, out_rolled=True),
             xw)
    err = cluster_passes(lab, gr, gi, N, tag)
    half_r = torch.randn((P, nx, N), generator=g, device=dev)
    half_i = torch.randn((P, nx, N), generator=g, device=dev)
    lab.time(f"{tag} transpose pair (half planes)", half_r.shape,
             lambda: (half_r.transpose(-1, -2).contiguous(),
                      half_i.transpose(-1, -2).contiguous()),
             (16.0 * half_r.numel(), 0.0))
    del half_r, half_i
    lab.time(f"{tag} fft2_c2c_pruned (pruned_out)", gr.shape,
             lambda: fft2_c2c_pruned(gr, gi, Nx=N, Ny=N, inverse=True,
                                     pruned_out=True),
             (8.0 * P * (N * N + nx * nx), P * fft_flops(N, N + nx)))
    consts = gi_consts(nx, nx, 1e-5, 1e-5, 7, 2.3, N, N, True, 0.1, 0.0,
                       0.0, rdtype=torch.float32, device=dev)
    nm1 = consts["nm1"]
    c0, s0 = torch.cos(0.3 * nm1), torch.sin(0.3 * nm1)
    cd, sd = torch.cos(0.01 * nm1), torch.sin(0.01 * nm1)
    ir = torch.randn((P, nx, nx), generator=g, device=dev)
    ii = torch.randn((P, nx, nx), generator=g, device=dev)
    # planes read once, 4 screens read and the image written once; 10
    # operations a pixel and plane
    lab.time(f"{tag} phasor-screen accumulation", ir.shape,
             lambda: screen(ir, ii, c0, s0, cd, sd),
             (4.0 * (2 * P + 5) * nx * nx, 10.0 * P * nx * nx))
    del ir, ii
    lab.time(f"{tag} _grid_to_image", gr.shape,
             lambda: _grid_to_image(gr, gi, nx, nx, 1e-5, 1e-5, 7, 2.3, N, N,
                                    True, P, -0.5, 0.1, False,
                                    consts=consts),
             (8.0 * P * N * N + 4.0 * nx * nx,
              P * fft_flops(N, N + nx) + 10.0 * P * nx * nx))
    for S in sweep:
        lab.time(f"{tag} x pass fftx_c2c_lab S={S}", gr.shape,
                 lambda S=S: fftx_c2c_lab(gr, gi, N=N, inverse=True,
                                          out_rolled=True, S=S), xw)
    z = torch.complex(gr, gi)
    lab.time(f"{tag} library torch.fft.ifft(dim=-2)", z.shape,
             lambda: torch.fft.ifft(z, dim=-2), (16.0 * z.numel(),
                                                 P * fft_flops(N, N)))
    lab.time(f"{tag} library torch.fft.ifft2", z.shape,
             lambda: torch.fft.ifft2(z), (16.0 * z.numel(),
                                          P * fft_flops(N, 2 * N)))
    return err


def ypass_case(lab, N, inverse, rows):
    """K3's y pass on ``rows`` contiguous rows of length N (inverse:
    out_rolled from N; forward: in_rolled from N/2): K3r, its skeleton,
    the line kernel and torch.fft; returns K3r's error against its plain
    version (max over re and im / max)."""
    import torch

    from chip_smoke import fft_flops
    from pfb_tpu_torch.ops.cfft import (fftx_c2c_lab, fftx_c2c_rows,
                                        fftx_c2c_rows_plain)
    dev = lab.dev
    kw = dict(N=N, inverse=inverse, in_rolled=not inverse,
              out_rolled=inverse)
    nin = N if inverse else N // 2
    nout = N // 2 if inverse else N
    g = torch.Generator(device=dev).manual_seed(N + inverse)
    xr = torch.randn((rows, nin, 1), generator=g, device=dev)
    xi = torch.randn((rows, nin, 1), generator=g, device=dev)
    tag = f"y pass {rows} rows of {N} {'inverse' if inverse else 'forward'}"
    work = (8.0 * rows * (nin + nout), fft_flops(N, rows))
    yr, yi = fftx_c2c_rows(xr, xi, **kw)
    pr, pi = fftx_c2c_rows_plain(xr, xi, **kw)
    err = float(max((yr - pr).abs().max(), (yi - pi).abs().max())) / \
        float(max(pr.abs().max(), pi.abs().max()))
    del yr, yi, pr, pi
    lab.time(f"{tag} K3r fftx_c2c_rows", xr.shape,
             lambda: fftx_c2c_rows(xr, xi, **kw), work,
             rel_err_vs_plain=err)
    lab.time(f"{tag} K3r skeleton (no radix arithmetic)", xr.shape,
             lambda: fftx_c2c_rows(xr, xi, skeleton=True, **kw),
             (work[0], 0.0))
    lab.time(f"{tag} line kernel (fftx_c2c_lab, K3 before K3r)", xr.shape,
             lambda: fftx_c2c_lab(xr, xi, **kw), work)
    z = torch.zeros((rows, N), dtype=torch.complex64, device=dev)
    z[:, :nin] = torch.complex(xr[..., 0], xi[..., 0])
    lib = torch.fft.ifft if inverse else torch.fft.fft
    lab.time(f"{tag} library torch.fft.{'i' * inverse}fft(dim=-1)", z.shape,
             lambda: lib(z, dim=-1), work)
    lab.time(f"{tag} K3r fftx_c2c_rows (again)", xr.shape,
             lambda: fftx_c2c_rows(xr, xi, **kw), work)
    return err


def split_errors(yr, yi, kr, ki, xr, xi, N):
    """max|split - ref| / max|ref| over both components, against the FP32
    K3 output (kr, ki) and against a float64 torch.fft of the same input
    (one plane at a time)."""
    import torch

    from pfb_tpu_torch.ops.cfft import _rolled_index

    def rel(a, b):
        return float(max((a[0] - b[0]).abs().max(),
                         (a[1] - b[1]).abs().max())
                     / max(b[0].abs().max(), b[1].abs().max()))
    e32 = rel((yr, yi), (kr, ki))
    num = den = 0.0
    rows = _rolled_index(N, xr.device)
    for p in range(xr.shape[0]):
        z = torch.complex(xr[p].double(), xi[p].double())
        ref = (torch.fft.ifft(z, dim=0) * N)[rows]
        num = max(num, float((yr[p] - ref.real).abs().max()),
                  float((yi[p] - ref.imag).abs().max()))
        den = max(den, float(ref.real.abs().max()),
                  float(ref.imag.abs().max()))
        del z, ref
    return e32, num / den


def pass1_variants(lab, P, N):
    """wl_g2i_lab.py:pass1_variants at (P, N^2)."""
    import torch

    from pfb_tpu_torch.ops import memlab
    from pfb_tpu_torch.ops.cfft import (_factor, fftx_c2c, fftx_c2c_lab,
                                        fftx_c2c_split, fftx_c2c_split_plain)
    dev = lab.dev
    g = torch.Generator(device=dev).manual_seed(0)
    xr = torch.randn((P, N, N), generator=g, device=dev)
    xi = torch.randn((P, N, N), generator=g, device=dev)
    kw = dict(N=N, inverse=True, out_rolled=True)
    tag = f"{N}^2 P={P} pass1"
    xw = xpass_work(P, N, N // 2)
    lab.time(f"{tag} full K3", xr.shape, lambda: fftx_c2c(xr, xi, **kw), xw)
    lab.time(f"{tag} first radix pass only (npass=1)", xr.shape,
             lambda: fftx_c2c_lab(xr, xi, npass=1, **kw),
             (xw[0], 0.0))
    tr, ti = (a.transpose(-1, -2).contiguous().view(P * N, N, 1)
              for a in (xr, xi))
    lab.time(f"{tag} no transpose: K3 on contiguous lines of the "
             "pre-transposed stack", tr.shape,
             lambda: fftx_c2c(tr, ti, **kw), xw)
    del tr, ti
    lab.time(f"{tag} memcpy skeleton: strip copy of re and im", xr.shape,
             lambda: memlab.lab_copy("strip", xr, xi), (xw[0], 0.0))
    N1, N2 = _factor(N)
    K2 = N2 // 2
    # 9 bf16 products per complex product (Karatsuba's 3, split 3 ways)
    tc = 9 * 2.0 * P * (N2 * N1 * N1 * N + K2 * N2 * N1 * N)
    yr, yi = fftx_c2c_split(xr, xi, **kw)
    pr, pi = fftx_c2c_split_plain(xr, xi, **kw)
    scale = float(max(pr.abs().max(), pi.abs().max()))
    e_plain = float(max((yr - pr).abs().max(), (yi - pi).abs().max())) / \
        scale
    del pr, pi
    kr, ki = fftx_c2c(xr, xi, **kw)
    e32, e64 = split_errors(yr, yi, kr, ki, xr, xi, N)
    k64 = split_errors(kr, ki, kr, ki, xr, xi, N)[1]
    del yr, yi, kr, ki
    lab.time(f"{tag} split bf16x3 (fftx_c2c_split)", xr.shape,
             lambda: fftx_c2c_split(xr, xi, **kw), (xw[0], 0.0, tc),
             rel_err_vs_plain=e_plain, tol=SPLIT_TOL,
             rel_err_vs_fp32_k3=e32, rel_err_vs_float64=e64,
             fp32_k3_rel_err_vs_float64=k64)
    z = torch.complex(xr, xi)
    lab.time(f"{tag} library torch.fft.ifft(dim=-2)", z.shape,
             lambda: torch.fft.ifft(z, dim=-2), (16.0 * z.numel(), xw[1]))
    return dict(split_rel_err_vs_plain=e_plain, split_rel_err_vs_fp32_k3=e32,
                split_rel_err_vs_float64=e64,
                fp32_k3_rel_err_vs_float64=k64)


def floor_section(lab, P, N, probe_size):
    """wl_g2i_lab.py:memcpy_variants and pair_ilp_probe."""
    import torch

    from pfb_tpu_torch.ops import memlab
    from torch_capacity_lab import observation, packed_vis, plan, probe
    dev = lab.dev
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((P, N, N), generator=g, device=dev)
    work = (4.0 * P * N * N * 1.5, 0.0)
    exact = True
    cases = [("strip", None), ("rows", 64), ("rows", 128), ("rows", 256),
             ("relayout", 128), ("batched", None)]
    for mode, S in cases:
        S = memlab.default_S(mode, N) if S is None else S
        y = memlab.lab_copy(mode, x, S=S)[0]
        ok = bool(torch.equal(y, memlab.lab_copy_plain(mode, x)[0]))
        exact = exact and ok
        del y
        lab.time(f"{N}^2 P={P} copy {mode} S={S}", x.shape,
                 lambda mode=mode, S=S: memlab.lab_copy(mode, x, S=S), work,
                 exact=ok)
    del x
    nrow, nchan, nx = probe_size
    obs = observation(nrow, nchan)
    rng = obs[3]
    vr, vi = (torch.as_tensor(rng.normal(size=(nrow, nchan)).astype(
        "float32"), device=dev) for _ in range(2))
    p = plan(obs, nx, 128, dev)
    rec = probe(p, packed_vis(p, vr, vi), 2, lab.reps, dev, lab.smi)
    rec["lab"] = "g2i"
    print(json.dumps(rec), flush=True)
    lab.ms[rec["name"]] = rec["ms"]
    return dict(copies_exact=exact, probe_rel_err=rec["rel_err"],
                ok=exact and rec["rel_err"] <= rec["tol"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--floor", action="store_true",
                    help="the copy probes and the paired-entry probe")
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
    cpu = dev.type == "cpu"
    if cpu:
        torch.set_num_threads(1)
    lab = Lab(dev, 1 if cpu else args.reps, card(dev))
    if args.floor:
        summary = floor_section(lab, 2 if cpu else 4, 256 if cpu else 8192,
                                (3000, 4, 128) if cpu else
                                (125_000, 8, 1024))
        summary["section"] = "floor"
    else:
        cases = [(2, 256, (1, 2, 8))] if cpu else \
            [(9, 2048, (1, 2, 4, 8)), (4, 8192, (1, 2))]
        cerr = 0.0
        for P, N, sweep in cases:
            cerr = max(cerr, main_case(lab, P, N, sweep))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        # the y passes of (4, 8192^2) inverse and (4, 4096^2 -> 8192^2)
        # forward: 4 x 4096 and 4 x 8192 rows
        rerr = 0.0
        for inverse in (True, False):
            rows = 8 if cpu else 4 * (8192 // 2 if inverse else 8192)
            rerr = max(rerr, ypass_case(lab, 4096 if cpu else 8192, inverse,
                                        rows))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        summary = pass1_variants(lab, 2 if cpu else 4, 256 if cpu else 8192)
        summary.update(section="main", tol=SPLIT_TOL,
                       cluster_rel_err_vs_plain=cerr,
                       rows_rel_err_vs_plain=rerr,
                       ok=summary["split_rel_err_vs_plain"] <= SPLIT_TOL
                       and cerr <= SPLIT_TOL and rerr <= SPLIT_TOL)
    summary.update(lab="g2i", card=lab.smi, ms=lab.ms)
    line = json.dumps(summary)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
