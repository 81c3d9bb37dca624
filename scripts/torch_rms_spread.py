#!/usr/bin/env python3
"""The K11 path's (or the pg path's) MFS residual rms under a
rounding-only change of its PSF operator, on the card.

    python3 scripts/torch_rms_spread.py [--root DIR] [--runs kernel,plain]
        [--device cuda] [--nx 3072] [--path k11 | pg]

chip_smoke.py's K11 path (the pg field at 3072^2 with its 6144^2 PSF:
init, grid, then spotless with K11, ``ops/psf.py:psf_convolve_full``,
through primal_dual_hostloop) runs with the pfb_tpu_torch and the
chip_smoke.py found under ``--root`` (default: this repo), once for each
entry of ``--runs``:

- ``kernel``: K11 as the package ships it;
- ``plain``: K11's plain version (``psf_convolve_full_plain``, torch.fft
  in float32) in its place.

The two operators compute the same function to 1e-5 of max|plain| (the
kernel-vs-plain gate), so the spread of the rms between the runs is what
rounding alone does to the path's result: the yardstick for a tree whose
kernels change that rms. Run it with ``--root`` on another tree in the
same call to read both trees' ``kernel`` rms on one card. Each run prints
one JSON line with the card's name and power limit, the root, the run's
K11 launches and the MFS residual rms after each major cycle.
``--device cpu --nx 128`` rehearses the script (the path's operator
takes K1 there, so the runs agree).

``--path pg`` runs chip_smoke.py's pg path instead (srf 2, robustness 0;
default ``--nx 1024``, the quick-look path of phase 26, whose 2048^2 PSF
takes K1, ``ops/psf.py:psf_convolve_h``), with K1 as shipped
(``kernel``) and K1's plain version (``psf_convolve_h_plain``) in its
place (``plain``); the records then carry K1's launches.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card(dev):
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def plain_entry(plain):
    """A plain version in the signature and with the launch counter of
    the kernel entry it stands in for."""
    def entry(*args):
        entry.launches += 1
        return plain(*args)
    entry.launches = 0
    return entry


# path: (kernel entry of ops/psf.py, its plain version, its counter in
# chip_smoke.py, srf, grid of chip_smoke.py)
PATHS = {"k11": ("psf_convolve_full", "psf_convolve_full_plain", "K11", 3.0,
                 "GRID_K11"),
         "pg": ("psf_convolve_h", "psf_convolve_h_plain", "K1", 2.0,
                "GRID_PG")}


def spread(root, dev, nx, runs, sim=None, path="k11"):
    """The K11 path (or the pg path) of the tree at ``root`` once per entry
    of ``runs``; returns one record each."""
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    import chip_smoke as cs
    from pfb_tpu_torch.ops import psf

    name, plain, key, srf, grid = PATHS[path]
    smi = card(dev)
    workdir = Path(root).resolve() / "build" / "rms_spread"
    workdir.mkdir(parents=True, exist_ok=True)
    kw = {} if sim is None else {"sim": sim}
    truth = cs.simulate(workdir, nx=nx, srf=srf, **kw)
    grid = dict(getattr(cs, grid), nx=nx, ny=nx)
    shipped = getattr(psf, name)
    recs = []
    for run in runs:
        setattr(psf, name, plain_entry(getattr(psf, plain))
                if run == "plain" else shipped)
        try:
            res = cs.main_path(truth, dev, grid=grid, spot=cs.SPOT_PG)
        finally:
            setattr(psf, name, shipped)
        st = res["stats"]
        recs.append({"card": smi, "root": str(root), "run": run, "nx": nx,
                     "path": path,
                     f"{key.lower()}_launches":
                         res["launches"]["spotless"][key],
                     "dirty_rms": res["dirty_rms"],
                     "rms": [float(r) for r in st["rms"]],
                     "seconds": {k: round(v, 3) for k, v in res["t"].items()}})
        print(json.dumps(recs[-1]), flush=True)
        del res
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return recs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT),
                    help="directory holding chip_smoke.py and pfb_tpu_torch")
    ap.add_argument("--runs", default="kernel,plain",
                    help="kernel and/or plain, comma-separated, in order")
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the script at a small --nx")
    ap.add_argument("--nx", type=int, help="image size (default: "
                    "chip_smoke.py's NX_K11, or 1024 with --path pg)")
    ap.add_argument("--path", default="k11", choices=sorted(PATHS),
                    help="k11: the 3072^2 path on K11; pg: the pg path on "
                    "K1")
    args = ap.parse_args()
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    runs = args.runs.split(",")
    if not set(runs) <= {"kernel", "plain"}:
        print(f"unknown run in {args.runs}", file=sys.stderr)
        return 1
    nx = args.nx
    if nx is None and args.path == "pg":
        nx = 1024
    elif nx is None:
        sys.path.insert(0, str(Path(args.root).resolve()))
        import chip_smoke
        nx = chip_smoke.NX_K11
    spread(args.root, dev, nx, runs, path=args.path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
