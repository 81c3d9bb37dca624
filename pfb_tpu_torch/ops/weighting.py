"""uv-cell sampling density and Briggs/robust imaging weights
(counterpart of pfb_tpu/ops/weighting.py, host counts path).

Grid convention of the reference (pfb/utils/weighting.py:48-55):
    u_cell = 1/(nx*cellx);  umax = |-1/(2 cellx) - u_cell/2|
    ug = (u*f/c + umax)/u_cell
ES-kernel stencil k=6, beta=2.3. The counts are a once-per-run host
pass (native C++ or numpy); the weights are a gather on the device.

Unlike the JAX package's numpy path, which multiplies each tap by the
mask value, both paths here count a visibility when its mask is
nonzero, as the native builder and the reference's numba kernel do.
"""

import numpy as np
import torch

from pfb_tpu_torch.native import pg_counts_native
from pfb_tpu_torch.ops.dft import LIGHTSPEED


def _uv_cells(nx, ny, cellx, celly):
    u_cell = 1.0 / (nx * cellx)
    umax = np.abs(-1.0 / cellx / 2.0 - u_cell / 2.0)
    v_cell = 1.0 / (ny * celly)
    vmax = np.abs(-1.0 / celly / 2.0 - v_cell / 2.0)
    return u_cell, umax, v_cell, vmax


def compute_counts_numpy(uvw, freq, mask, nx, ny, cellx, celly, k=6,
                         row_chunk=65536):
    """The numpy twin of the native counts: a chunked flat-index
    np.bincount over the (row, chan, k, k) stencil values; out-of-grid
    taps are dropped."""
    uvw = np.asarray(uvw)
    freq = np.asarray(freq)
    live = np.asarray(mask) != 0
    u_cell, umax, v_cell, vmax = _uv_cells(nx, ny, cellx, celly)
    normfreq = freq / LIGHTSPEED
    counts = np.zeros(nx * ny, np.float64)
    ko2 = k // 2
    offs = np.arange(-ko2, ko2)

    def es(x):
        arg = np.maximum((1.0 - x) * (1.0 + x), 0.0)
        return np.where(np.abs(x) <= 1.0,
                        np.exp(2.3 * k * (np.sqrt(arg) - 1.0)), 0.0)

    nrow = uvw.shape[0]
    for r0 in range(0, nrow, row_chunk):
        sl = slice(r0, min(r0 + row_chunk, nrow))
        ug = (uvw[sl, 0:1] * normfreq[None, :] + umax) / u_cell
        vg = (uvw[sl, 1:2] * normfreq[None, :] + vmax) / v_cell
        m = live[sl].astype(np.float64)
        if k:
            u_idx = np.round(ug).astype(np.int64)
            v_idx = np.round(vg).astype(np.int64)
            x_idx = u_idx[..., None] + offs
            xval = es((x_idx - ug[..., None] + 0.5) / ko2)
            y_idx = v_idx[..., None] + offs
            yval = es((y_idx - vg[..., None] + 0.5) / ko2)
            vals = (m[..., None, None] * xval[..., :, None]
                    * yval[..., None, :])
            xi = np.broadcast_to(x_idx[..., :, None], vals.shape)
            yi = np.broadcast_to(y_idx[..., None, :], vals.shape)
            ok = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)).ravel()
            flat = xi.ravel()[ok] * ny + yi.ravel()[ok]
            counts += np.bincount(flat, weights=vals.ravel()[ok],
                                  minlength=nx * ny)
        else:
            u_idx = np.floor(ug).astype(np.int64)
            v_idx = np.floor(vg).astype(np.int64)
            ok = ((u_idx >= 0) & (u_idx < nx) & (v_idx >= 0)
                  & (v_idx < ny)).ravel()
            flat = u_idx.ravel()[ok] * ny + v_idx.ravel()[ok]
            counts += np.bincount(flat, weights=m.ravel()[ok],
                                  minlength=nx * ny)
    return counts.reshape(nx, ny)


def compute_counts_host(uvw, freq, mask, nx, ny, cellx, celly, k=6):
    """(nx, ny) float64 uv counts on the host: the native builder when
    it is built, else :func:`compute_counts_numpy`."""
    nat = pg_counts_native(uvw, freq, mask, nx, ny, cellx, celly, k=k)
    if nat is not None:
        return nat
    return compute_counts_numpy(uvw, freq, mask, nx, ny, cellx, celly, k=k)


def counts_to_weights(counts, uvw, freq, nx, ny, cellx, celly, robust):
    """Counts -> per-visibility imaging weights (tensors on one device).
    robust > -2 applies Briggs weighting 1/(1 + counts*ssq) with
    ssq = (5*10^-robust)^2 / ((counts^2).sum()/counts.sum()); robust <= -2
    is natural-by-cell (1/counts). Visibilities in empty cells, or all of
    them when the counts are all zero, get weight 0."""
    dtype = counts.dtype
    u_cell, umax, v_cell, vmax = _uv_cells(nx, ny, cellx, celly)
    if robust > -2.0:
        numsqrt = 5.0 * 10.0 ** (-robust)
        avgW = (counts ** 2).sum() / counts.sum()
        counts_mod = 1.0 + counts * (numsqrt * numsqrt / avgW)
    else:
        counts_mod = counts
    normfreq = freq / LIGHTSPEED
    u_idx = torch.floor((uvw[:, 0:1] * normfreq[None, :] + umax)
                        / u_cell).long()
    v_idx = torch.floor((uvw[:, 1:2] * normfreq[None, :] + vmax)
                        / v_cell).long()
    c = counts_mod[u_idx.clamp(0, nx - 1), v_idx.clamp(0, ny - 1)]
    w = torch.where(c != 0, 1.0 / torch.where(c == 0, torch.ones_like(c),
                                              c), torch.zeros_like(c))
    w = torch.where((counts != 0).any(), w, torch.zeros_like(w))
    return w.to(dtype)


def filter_extreme_counts(counts, level=10.0, nbox=None):
    """Clamp near-empty uv cells to avoid upweighting them (host numpy;
    reference pfb/utils/weighting.py:186-215). nbox=None: occupied cells
    below median/level are raised to it. nbox=N: each occupied cell is
    compared with the mean of the occupied cells in its N x N
    neighbourhood; cells below local_mean/level are raised to it, and
    cells with fewer than N occupied neighbours are zeroed."""
    counts = np.asarray(counts).copy()
    ix, iy = np.where(counts > 0)
    if ix.size == 0:
        return counts
    if nbox is None:
        cnts = counts[ix, iy]
        med = np.median(cnts)
        counts[ix, iy] = np.maximum(cnts, med / level)
        return counts
    occ = (counts > 0).astype(np.float64)

    def box_sum(a, n):
        c = np.cumsum(np.cumsum(a, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        h = n // 2
        nx, ny = a.shape
        i0 = np.clip(np.arange(nx) - h, 0, nx)
        i1 = np.clip(np.arange(nx) + n - h, 0, nx)
        j0 = np.clip(np.arange(ny) - h, 0, ny)
        j1 = np.clip(np.arange(ny) + n - h, 0, ny)
        return c[i1][:, j1] - c[i0][:, j1] - c[i1][:, j0] + c[i0][:, j0]

    nocc = box_sum(occ, nbox)
    tot = box_sum(counts.astype(np.float64), nbox)
    with np.errstate(invalid="ignore", divide="ignore"):
        local_mean = np.where(nocc > 0, tot / np.maximum(nocc, 1), 0.0)
    sel = counts > 0
    too_isolated = sel & (nocc < nbox)
    low = sel & ~too_isolated & (counts < local_mean / level)
    counts[low] = local_mean[low]
    counts[too_isolated] = 0.0
    return counts
