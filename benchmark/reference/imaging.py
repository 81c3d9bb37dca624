"""Plain imaging products from a measurement set's columns: Stokes I
visibilities and weights, the cell, uv counts, Briggs weights, and the
dirty image and PSF through the reference NUFFT (float64 unless the
control asks for less).

Conventions of the system being measured (pfb-imaging's), restated:
- Stokes I from two linear or circular hands: V = (V0 + V3) / 2 and
  weight w0 + w3, flagged samples weight 0;
- cell = 1 / (2 uv_max f_max / c) / super-resolution factor, uv_max the
  largest |u| or |v| in metres;
- one image band per channel here (the configurations image one channel
  a band);
- uv counts: each visibility's k = 6 ES stencil (beta 2.3) on the
  (nx, ny) uv grid u_cell = 1 / (nx cell), umax = |-1/(2 cell) -
  u_cell/2|, taps off the grid dropped; Briggs weights 1 / (1 + counts
  ssq), ssq = (5 10^-robust)^2 / (sum counts^2 / sum counts), looked up
  in the visibility's cell floor((u f/c + umax) / u_cell);
- DIRTY and PSF are R.H of weight x vis and of weight, both over the
  total weight sum.
"""

import numpy as np
import torch

from reference.nufft import LIGHTSPEED, Plan


def good_even_size(n):
    """Smallest even 5-smooth integer >= n."""
    def smooth(m):
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        return m == 1

    m = max(n, 2)
    while not (m % 2 == 0 and smooth(m)):
        m += 1
    return m


def stokes_i(ms):
    """Per channel: dict(uvw, freq, vis, wgt) float64 / complex128
    numpy, the weight 0 where flagged."""
    data = np.asarray(ms["DATA"])
    w = np.asarray(ms["WEIGHT_SPECTRUM"], np.float64)
    flag = np.asarray(ms["FLAG"]).any(axis=-1)
    vis = 0.5 * (data[..., 0] + data[..., -1])
    wgt = np.where(flag, 0.0, w[..., 0] + w[..., -1])
    vis = np.where(flag, 0.0, vis)
    freq = np.asarray(ms["FREQ"], np.float64)
    return [dict(uvw=np.asarray(ms["UVW"], np.float64),
                 freq=freq[c:c + 1], vis=vis[:, c:c + 1],
                 wgt=wgt[:, c:c + 1]) for c in range(freq.size)]


def cell_of(ms, srf):
    uv_max = np.abs(np.asarray(ms["UVW"])[:, :2]).max()
    f_max = np.asarray(ms["FREQ"]).max()
    return 1.0 / (2 * uv_max * f_max / LIGHTSPEED) / srf


def _uv_cells(nx, ny, cell):
    u_cell = 1.0 / (nx * cell)
    v_cell = 1.0 / (ny * cell)
    return (u_cell, abs(-0.5 / cell - u_cell / 2.0), v_cell,
            abs(-0.5 / cell - v_cell / 2.0))


def counts(uvw, freq, wgt, nx, ny, cell, device, k=6, beta=2.3):
    u_cell, umax, v_cell, vmax = _uv_cells(nx, ny, cell)
    uvw = torch.as_tensor(uvw, device=device)
    s = torch.as_tensor(freq, device=device)[None, :] / LIGHTSPEED
    ug = ((uvw[:, 0:1] * s + umax) / u_cell).reshape(-1)
    vg = ((uvw[:, 1:2] * s + vmax) / v_cell).reshape(-1)
    live = (torch.as_tensor(wgt, device=device) > 0).reshape(-1)
    ug, vg = ug[live], vg[live]
    offs = torch.arange(-(k // 2), k // 2, device=device)
    xi = torch.round(ug).long()[:, None] + offs
    yi = torch.round(vg).long()[:, None] + offs

    def phi(t):
        x = t / (k // 2)
        return torch.where(x.abs() <= 1.0, torch.exp(beta * k * (torch.sqrt(
            torch.clamp((1 - x) * (1 + x), min=0.0)) - 1.0)),
            torch.zeros_like(x))

    cx = phi(xi - ug[:, None] + 0.5)
    cy = phi(yi - vg[:, None] + 0.5)
    ok = ((xi >= 0) & (xi < nx))[:, :, None] & \
        ((yi >= 0) & (yi < ny))[:, None, :]
    flat = xi[:, :, None] * ny + yi[:, None, :]
    out = torch.zeros(nx * ny, dtype=torch.float64, device=device)
    out.index_add_(0, flat[ok], (cx[:, :, None] * cy[:, None, :])[ok])
    return out.reshape(nx, ny)


def briggs(cnt, uvw, freq, nx, ny, cell, robust):
    """Per-visibility imaging weights (rows x channels)."""
    dev = cnt.device
    u_cell, umax, v_cell, vmax = _uv_cells(nx, ny, cell)
    ssq = (5.0 * 10.0 ** (-robust)) ** 2 / ((cnt ** 2).sum() / cnt.sum())
    cmod = 1.0 + cnt * ssq
    uvw = torch.as_tensor(uvw, device=dev)
    s = torch.as_tensor(freq, device=dev)[None, :] / LIGHTSPEED
    iu = torch.floor((uvw[:, 0:1] * s + umax) / u_cell).long()
    iv = torch.floor((uvw[:, 1:2] * s + vmax) / v_cell).long()
    return 1.0 / cmod[iu.clamp(0, nx - 1), iv.clamp(0, ny - 1)]


class Observation:
    """The reference's view of an observation imaged at (nx, ny), PSF
    (nx_psf, ny_psf): per band the weighted visibilities and the image
    plan, the dirty and PSF cubes over the weight sum."""

    def __init__(self, ms, nx, srf, robust, psf_oversize=2.0, support=7,
                 device="cpu", psf=True):
        self.nx = self.ny = nx
        self.cell = cell_of(ms, srf)
        self.nx_psf = good_even_size(int(psf_oversize * nx))
        self.device = device
        self.bands = []
        wsum = 0.0
        for ds in stokes_i(ms):
            wgt = torch.as_tensor(ds["wgt"], device=device)
            if robust is not None:
                cnt = counts(ds["uvw"], ds["freq"], ds["wgt"], nx, nx,
                             self.cell, device)
                wgt = wgt * briggs(cnt, ds["uvw"], ds["freq"], nx, nx,
                                   self.cell, robust)
            wsum += float(wgt.sum())
            self.bands.append(dict(
                uvw=ds["uvw"], freq=ds["freq"], wgt=wgt,
                vis=torch.as_tensor(ds["vis"], device=device),
                plan=Plan(ds["uvw"], ds["freq"], nx, nx, self.cell,
                          k=support, device=device)))
        self.wsum = wsum
        self.support = support
        self.dirty = torch.stack([b["plan"].adjoint(b["wgt"] * b["vis"])
                                  for b in self.bands]) / wsum
        self.psf = None
        if psf:
            cubes = []
            for b in self.bands:
                plan = Plan(b["uvw"], b["freq"], self.nx_psf, self.nx_psf,
                            self.cell, k=support, device=device)
                cubes.append(plan.adjoint(b["wgt"].to(torch.complex128)))
                del plan
            self.psf = torch.stack(cubes) / wsum

    def hessian(self, x, rnd=None):
        """R.H W R x / wsum per band, x (nband, nx, ny); ``rnd`` rounds
        the operator's inputs and outputs (the control)."""
        rnd = rnd or (lambda t: t)
        out = []
        for j, b in enumerate(self.bands):
            v = b["plan"].forward(rnd(x[j]).to(torch.float64))
            out.append(rnd(b["plan"].adjoint(b["wgt"].reshape(-1) * v)))
        return torch.stack(out) / self.wsum


def from_config(cols, cfg, device):
    """The :class:`Observation` of a configuration's columns."""
    return Observation(cols, cfg["nx"], cfg["srf"], cfg["robustness"],
                       cfg["psf_oversize"], support=cfg["reference_support"],
                       device=device)
