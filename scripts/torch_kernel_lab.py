#!/usr/bin/env python3
"""Per-stage timing lab for pfb_tpu_torch's PSF-convolution kernels on
the card (counterpart of scripts/wl_kernel_lab.py's k1 / k2 / k3).

    python3 scripts/torch_kernel_lab.py [--nband 8] [--nx 4096]
        [--reps 10] [--device cuda] [--out FILE]
    python3 scripts/torch_kernel_lab.py --digest [--root DIR]

At (8, 4096^2) with an 8192^2 PSF (a delta 1.0 at the centre and 0.05
at +5, +3, as wl_kernel_lab.py builds it; complex transfer function) it
times, each as the CUDA-event median of ``reps`` calls after a warm-up:

- K15's two column transforms on the v3 row layout (NXH = NX/2 + N1x
  rows): v3_cols_fwd and v3_cols_inv;
- the rows stage on those NXH rows against the NXH-row H
  (psf_stage_rows), wl_kernel_lab.py's ``_k2v_kernel`` case;
- K1's three stages as K10's entries at one space shard
  (psf_stage_cols_fwd, psf_stage_rows, psf_stage_cols_inv) and K1 whole
  (psf_convolve_h);
- one library call per column stage: torch.fft.fft(x, n=NX,
  dim=-2)[:, :NXH] and torch.fft.irfft(w[:, :NX/2 + 1], n=NX,
  dim=-2)[:, :nx].

It checks the three stages chained against K1 whole (<= 1e-5 of max)
and reports the sum of the stage times against K1's. It prints one JSON
line per stage, each with its bound (``chip_smoke.py:bound``: each input
read once and each output written once over 3.35 TB/s, or the FP32
operations over 67 TFLOP/s) and the card's name and power limit, then a
summary line (also written to ``--out``). It adds no lever: at NX = 8192
the line kernel already runs one line per block (``line_launch`` in
csrc/fft_lines.cuh), so no larger lines-per-block value fits without a
redesign of the kernel.

``--digest`` prints the sha256 of K1's, K3's, K10's and K11's outputs on
fixed seeded inputs, with the pfb_tpu_torch found under ``--root`` (default:
this repo), so two trees can be compared bit for bit on one card.
``--device cpu`` rehearses the timing at a small ``--nx`` with the plain
versions.
"""

import argparse
import hashlib
import json
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
    per block), K10's three stages and K11 on fixed seeded inputs."""
    import torch

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
    for N, L in ((2048, 128), (8192, 16), (960, 1), (16384, 2)):
        for mode in ("full", "in_rolled", "out_rolled"):
            nin = N // 2 if mode == "in_rolled" else N
            zr, zi = (torch.randn((2, nin, L), generator=g, device=dev)
                      for _ in range(2))
            y = fftx_c2c(zr, zi, N=N, inverse=mode == "out_rolled",
                         in_rolled=mode == "in_rolled",
                         out_rolled=mode == "out_rolled")
            out[f"K3 {N} L={L} {mode}"] = torch.cat(y)
    return {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
            for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nband", type=int, default=8)
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script with the plain versions")
    ap.add_argument("--digest", action="store_true")
    ap.add_argument("--root", default=str(ROOT),
                    help="directory holding the pfb_tpu_torch to import")
    ap.add_argument("--out")
    args = ap.parse_args()
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

    from pfb_tpu_torch.ops.pallas_fft import (v3_cols_fwd, v3_cols_inv,
                                              v3_rows)
    from pfb_tpu_torch.ops.psf import (prep_h, prep_h_full, psf_convolve_h,
                                       psf_stage_cols_fwd,
                                       psf_stage_cols_inv, psf_stage_rows)
    nb, nx = args.nband, args.nx
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

    sys.path.insert(0, str(ROOT))
    from chip_smoke import bound, fft_flops

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
    stages = [
        ("K15 forward v3_cols_fwd", (nb, nx, ny),
         lambda: v3_cols_fwd(x, nx), cols(NXH)),
        ("rows stage psf_stage_rows on NXH rows, complex H", (nb, NXH, ny),
         lambda: psf_stage_rows(zr0, zi0, hxr, hxi), rows_stage(NXH)),
        ("K15 inverse v3_cols_inv", (nb, NXH, ny),
         lambda: v3_cols_inv(zr0, zi0, nx), cols(NXH)),
        ("K1 stage 1 psf_stage_cols_fwd", (nb, nx, ny),
         lambda: psf_stage_cols_fwd(x, NX, nx + 1), cols(nx + 1)),
        ("K1 stage 2 psf_stage_rows, complex H", (nb, nx + 1, ny),
         lambda: psf_stage_rows(*z1, hr, hi), rows_stage(nx + 1)),
        ("K1 stage 3 psf_stage_cols_inv", (nb, nx + 1, ny),
         lambda: psf_stage_cols_inv(*w1, nx, NX, NY), cols(nx + 1)),
        ("K1 whole psf_convolve_h, complex H", (nb, nx, ny),
         lambda: psf_convolve_h(x, hr, hi), k1),
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
        ms[name] = cuda_ms(fn, args.reps, dev)
        bms, bby = bound(*work)
        print(json.dumps({"stage": name, "shape": list(shape),
                          "ms": ms[name], "reps": args.reps,
                          "bound_ms": bms, "bound_by": bby, "card": smi}),
              flush=True)
    k1 = ms["K1 whole psf_convolve_h, complex H"]
    split = sum(v for k, v in ms.items() if k.startswith("K1 stage"))
    summary = {"nband": nb, "nx": nx, "NX": NX, "NXH": NXH, "card": smi,
               "chained_vs_k1_rel_err": err, "tol": TOL,
               "k1_ms": k1, "k1_stage_sum_ms": split,
               "stage_sum_over_k1": split / k1, "ok": err <= TOL}
    line = json.dumps(summary)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
