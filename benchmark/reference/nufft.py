"""Plain w-stacking NUFFT in float64: the reference measurement operator.

Written from the definition, not from the program under test:

- pixel centres l_i = (i - nx//2) cell, m_j likewise, n - 1 from
  ``nterm``;
- degrid (R):  V_k = sum_lm I(l, m) e^{-2 pi i (u l + v m + w (n - 1))}
  with u, v, w in wavelengths;
- grid (R.H):  I(l, m) = sum_k wgt_k Re[V_k e^{+2 pi i (...)}].

Both run on an oversampled (2 nx, 2 ny) grid with the "exponential of
semicircle" kernel phi(t) = exp(beta k (sqrt(1 - (2t/k)^2) - 1)) in u,
v and w (w planes dw = 1 / (2 sigma |n - 1|max) apart), and divide by
the kernel's continuous Fourier transform in l, m and n - 1. Each w
plane is gridded, transformed and screened on its own, with the
visibilities sorted by w so that a plane's are one contiguous slice: a
plane of the grid is all the memory a transform holds.
"""

import math

import numpy as np
import torch

LIGHTSPEED = 299792458.0
# (support, beta): support 7 reaches a few 1e-6 of the exact DFT at
# sigma 2, support 9 a few 1e-8 (measured against the exact DFT in
# benchmark/tests/test_bench_reference.py)
KERNELS = {7: 2.30, 9: 2.25}


def nterm(ll, mm):
    eps = ll ** 2 + mm ** 2
    return -eps / (torch.sqrt(1.0 - eps) + 1.0)


def es(t, beta, k):
    """phi(t) on |t| <= k/2, 0 outside."""
    x = t / (k / 2.0)
    arg = torch.clamp(1.0 - x * x, min=0.0)
    return torch.where(x.abs() <= 1.0,
                       torch.exp(beta * k * (torch.sqrt(arg) - 1.0)),
                       torch.zeros_like(x))


def es_ft(xi, beta, k, nquad=96):
    """int phi(t) cos(2 pi t xi) dt by Gauss-Legendre on [0, k/2]."""
    xq, wq = np.polynomial.legendre.leggauss(nquad)
    xq = torch.as_tensor(0.5 * (xq + 1.0) * (k / 2.0), dtype=torch.float64,
                         device=xi.device)
    wq = torch.as_tensor(wq * (k / 4.0), dtype=torch.float64,
                         device=xi.device)
    wc = wq * es(xq, beta, k)
    flat = xi.reshape(-1).to(torch.float64)
    out = torch.empty_like(flat)
    step = 1 << 18
    for i in range(0, flat.numel(), step):
        out[i:i + step] = 2.0 * (wc * torch.cos(
            (2.0 * math.pi) * flat[i:i + step, None] * xq)).sum(-1)
    return out.reshape(xi.shape)


class Plan:
    """One dataset's visibilities (rows x channels, flattened) against
    an (nx, ny) image of cell ``cell``: kernel taps, w planes and the
    image-side corrections, all float64 on ``device``."""

    def __init__(self, uvw, freq, nx, ny, cell, k=7, sigma=2.0,
                 device="cpu"):
        f64 = torch.float64
        uvw = torch.as_tensor(np.asarray(uvw), dtype=f64, device=device)
        freq = torch.as_tensor(np.asarray(freq), dtype=f64, device=device)
        self.k, self.beta = k, KERNELS[k]
        self.nx, self.ny = nx, ny
        self.Nx, self.Ny = int(sigma * nx), int(sigma * ny)
        self.device = device
        s = freq[None, :] / LIGHTSPEED
        u = (uvw[:, 0:1] * s).reshape(-1)
        v = (uvw[:, 1:2] * s).reshape(-1)
        w = (uvw[:, 2:3] * s).reshape(-1)
        self.nvis = u.numel()
        li = (torch.arange(nx, dtype=f64, device=device) - nx // 2) * cell
        mi = (torch.arange(ny, dtype=f64, device=device) - ny // 2) * cell
        n1 = nterm(li[:, None], mi[None, :])
        self.n1 = n1
        n1min = float(n1.min())
        dw = 1.0 / (2.0 * sigma * abs(n1min))
        wmin, wmax = float(w.min()), float(w.max())
        self.nw = int(math.ceil((wmax - wmin) / dw)) + k + 1
        self.w0 = wmin - (k / 2.0) * dw
        self.dw = dw
        wpos = (w - self.w0) / dw
        order = torch.argsort(wpos)
        self.order = order
        self.wpos = wpos[order]
        self.xg = (u * cell * self.Nx)[order]
        self.yg = (v * cell * self.Ny)[order]
        kb = (self.beta, self.k)
        sx = torch.arange(nx, dtype=f64, device=device) - nx // 2
        sy = torch.arange(ny, dtype=f64, device=device) - ny // 2
        self.corr = es_ft(sx / self.Nx, *kb)[:, None] * \
            es_ft(sy / self.Ny, *kb)[None, :] * es_ft(n1 * dw, *kb)
        ko = (k - 1) // 2
        self.offs = torch.arange(-ko, k - ko, device=device)
        # the slice of sorted visibilities whose w taps reach plane p
        lo = torch.searchsorted(self.wpos, torch.arange(
            self.nw, dtype=f64, device=device) - k / 2.0, right=True)
        hi = torch.searchsorted(self.wpos, torch.arange(
            self.nw, dtype=f64, device=device) + k / 2.0, right=True)
        self.bounds = list(zip(lo.tolist(), hi.tolist()))
        ix = torch.remainder(torch.arange(nx, device=device) - nx // 2,
                             self.Nx)
        iy = torch.remainder(torch.arange(ny, device=device) - ny // 2,
                             self.Ny)
        self.ix, self.iy = ix, iy

    def _taps(self, p, lo, hi):
        """Flat grid indices (n, k, k) and weights of plane p's taps."""
        k, beta = self.k, self.beta
        x, y = self.xg[lo:hi], self.yg[lo:hi]
        cw = es(p - self.wpos[lo:hi], beta, k)
        xi = torch.round(x).long()[:, None] + self.offs
        yi = torch.round(y).long()[:, None] + self.offs
        cu = es(xi - x[:, None], beta, k) * cw[:, None]
        cv = es(yi - y[:, None], beta, k)
        idx = torch.remainder(xi, self.Nx)[:, :, None] * self.Ny + \
            torch.remainder(yi, self.Ny)[:, None, :]
        return idx.reshape(-1), (cu[:, :, None] * cv[:, None, :]).reshape(
            hi - lo, -1)

    def _screen(self, p, sign):
        ph = (sign * 2.0 * math.pi) * (self.w0 + p * self.dw) * self.n1
        return torch.polar(torch.ones_like(ph), ph)

    def adjoint(self, vis):
        """R.H of complex (rows x channels) visibilities, weights
        applied by the caller: the (nx, ny) float64 image."""
        vs = vis.reshape(-1).to(torch.complex128)[self.order]
        img = torch.zeros((self.nx, self.ny), dtype=torch.complex128,
                          device=self.device)
        grid = torch.empty(self.Nx * self.Ny, dtype=torch.complex128,
                           device=self.device)
        for p, (lo, hi) in enumerate(self.bounds):
            if hi <= lo:
                continue
            grid.zero_()
            idx, val = self._taps(p, lo, hi)
            grid.index_add_(0, idx, (val * vs[lo:hi, None]).reshape(-1))
            plane = torch.fft.ifft2(grid.view(self.Nx, self.Ny)) * \
                (self.Nx * self.Ny)
            img += plane[self.ix[:, None], self.iy[None, :]] * \
                self._screen(p, +1.0)
        return img.real / self.corr

    def forward(self, image):
        """R of an (nx, ny) image: complex (rows x channels) float64."""
        img = image.to(torch.float64) / self.corr
        out = torch.zeros(self.nvis, dtype=torch.complex128,
                          device=self.device)
        full = torch.zeros((self.Nx, self.Ny), dtype=torch.complex128,
                           device=self.device)
        for p, (lo, hi) in enumerate(self.bounds):
            if hi <= lo:
                continue
            full[self.ix[:, None], self.iy[None, :]] = img * \
                self._screen(p, -1.0)
            g = torch.fft.fft2(full).reshape(-1)
            idx, val = self._taps(p, lo, hi)
            out[lo:hi] += (g[idx].view(hi - lo, -1) * val).sum(-1)
        res = torch.empty_like(out)
        res[self.order] = out
        return res


def dft_adjoint(uvw, freq, vis, nx, ny, cell):
    """The exact R.H by direct summation (for tests at small sizes)."""
    f64 = torch.float64
    uvw = torch.as_tensor(np.asarray(uvw), dtype=f64)
    s = torch.as_tensor(np.asarray(freq), dtype=f64)[None, :] / LIGHTSPEED
    u = (uvw[:, 0:1] * s).reshape(-1)
    v = (uvw[:, 1:2] * s).reshape(-1)
    w = (uvw[:, 2:3] * s).reshape(-1)
    li = (torch.arange(nx, dtype=f64) - nx // 2) * cell
    mi = (torch.arange(ny, dtype=f64) - ny // 2) * cell
    ll, mm = torch.meshgrid(li, mi, indexing="ij")
    n1 = nterm(ll, mm)
    ph = 2.0 * math.pi * (u[:, None] * ll.reshape(-1) + v[:, None] *
                          mm.reshape(-1) + w[:, None] * n1.reshape(-1))
    vis = torch.as_tensor(vis).reshape(-1).to(torch.complex128)
    return (vis[:, None] * torch.polar(torch.ones_like(ph), ph)).real.sum(
        0).reshape(nx, ny)
