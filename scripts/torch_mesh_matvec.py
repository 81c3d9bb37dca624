#!/usr/bin/env python3
"""Why fluxmop's space-sharded model can equal its single program's bit
for bit: its two PCG Hessians on one seeded cube, and torch.fft.rfft2
against its 1-D passes.

    python3 scripts/torch_mesh_matvec.py [--device cuda] [--nband 8]
        [--nx 2048] [--shards 4]

On a seeded float32 cube (nband, nx, nx), with a seeded PSF of
(nband, 2 nx, 2 nx) (``ops/fft.py:make_psfhat``), a beam in [0.5, 1] and
chip_smoke.py's fluxmop sigmainv, it applies
``workers/fluxmop.py:_psf_hessian_maybe_space``'s two Hessians: the
single program's (torch.fft.rfft2 / irfft2 on the whole padded cube)
and the (1, shards) virtual space mesh's (row r2c, all-to-all, column
c2c, product, inverses). It also compares torch.fft.rfft2 of the padded
cube with its row rfft then column fft. It prints one JSON line with
the card's name and power limit (nvidia-smi), each pair's bit-for-bit
equality and max|diff| / max, and the Hessians' routes. The defaults
are chip_smoke.py phase 27's shapes; ``--device cpu --nx 128``
rehearses it.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nband", type=int, default=8)
    ap.add_argument("--nx", type=int, default=2048)
    ap.add_argument("--shards", type=int, default=4)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from pfb_tpu_torch.ops.fft import make_psfhat
    from pfb_tpu_torch.workers.fluxmop import _psf_hessian_maybe_space

    device = torch.device(a.device)
    nb, nx, npsf = a.nband, a.nx, 2 * a.nx
    g = torch.Generator(device=device).manual_seed(27)
    x = torch.randn((nb, nx, nx), generator=g, device=device)
    psf = torch.randn((nb, npsf, npsf), generator=g, device=device)
    ph = make_psfhat(psf)
    del psf
    bm = 0.5 + 0.5 * torch.rand((nb, nx, nx), generator=g, device=device)
    hkw = dict(bm=bm, psfhat=ph, lastsize=npsf, sigmainv=1e-4,
               band_chunk=None, nband=nb, nx=nx)
    A1, r1 = _psf_hessian_maybe_space(space_shards=0, devices=None, **hkw)
    As, rs = _psf_hessian_maybe_space(space_shards=a.shards,
                                      devices=[device] * a.shards, **hkw)
    pad = torch.nn.functional.pad(x, (0, npsf - nx, 0, npsf - nx))
    out = {"routes": [r1, rs], "shape": [nb, nx, nx], "psf": npsf}
    for key, (p, q) in (("matvec", (As(x), A1(x))),
                        ("rfft2", (torch.fft.fft(torch.fft.rfft(pad),
                                                 dim=-2),
                                   torch.fft.rfft2(pad)))):
        out[key + "_bitwise"] = bool(torch.equal(p, q))
        out[key + "_rel"] = float((p - q).abs().max() / q.abs().max())
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
