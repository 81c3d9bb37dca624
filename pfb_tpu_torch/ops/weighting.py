"""uv-cell sampling density and Briggs/robust imaging weights
(counterpart of pfb_tpu/ops/weighting.py, host counts path).

Grid convention of the reference (pfb/utils/weighting.py:48-55):
    u_cell = 1/(nx*cellx);  umax = |-1/(2 cellx) - u_cell/2|
    ug = (u*f/c + umax)/u_cell
ES-kernel stencil k=6, beta=2.3. The workers take the counts from a
once-per-run host pass (native C++ or numpy); :func:`compute_counts` is
the same sum on a device, for callers whose data lives there. The
weights are a gather on the device.

Unlike the JAX package's numpy path, which multiplies each tap by the
mask value, every path here counts a visibility when its mask is
nonzero, as the native builder and the reference's numba kernel do. Every
path drops the taps outside [0, nx) x [0, ny), those below the low edge
included, where the JAX package's device path wraps them onto the far
edge.
"""

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.native import pg_counts_native
from pfb_tpu_torch.ops.dft import LIGHTSPEED

# visibilities a chunk of compute_counts: at k = 6 (36 taps each) a
# chunk's index and value tensors take some 300 MB
_COUNTS_VIS = 1 << 18


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


def compute_counts_host(uvw, freq, mask, nx, ny, cellx, celly, k=6,
                        row_chunk=65536):
    """(nx, ny) float64 uv counts on the host: the native builder when
    it is built, else :func:`compute_counts_numpy` over ``row_chunk``
    rows at a time."""
    nat = pg_counts_native(uvw, freq, mask, nx, ny, cellx, celly, k=k)
    if nat is not None:
        return nat
    return compute_counts_numpy(uvw, freq, mask, nx, ny, cellx, celly, k=k,
                                row_chunk=row_chunk)


def _es(x, k):
    arg = torch.clamp((1.0 - x) * (1.0 + x), min=0.0)
    return torch.where(x.abs() <= 1.0,
                       torch.exp(2.3 * k * (torch.sqrt(arg) - 1.0)),
                       torch.zeros_like(x))


def compute_counts(uvw, freq, mask, nx, ny, cellx, celly, k=6, device=None):
    """(nx, ny) uv counts on ``device`` (the card when there is one):
    the ES stencil (k = 6) or the nearest cell (k = 0) of every
    visibility whose mask is nonzero, summed by ``index_add_`` over flat
    cell indices, a chunk of rows at a time. Tensors or numpy arrays;
    computes in the dtype of uvw promoted to at least float32, so float64
    uvw gives float64 counts."""
    dev = as_device(device)
    uvw = torch.as_tensor(uvw, device=dev)
    dtype = torch.promote_types(uvw.dtype, torch.float32)
    uvw = uvw.to(dtype)
    normfreq = torch.as_tensor(freq, device=dev).to(dtype) / LIGHTSPEED
    live = torch.as_tensor(mask, device=dev) != 0
    u_cell, umax, v_cell, vmax = map(float, _uv_cells(nx, ny, cellx, celly))
    counts = torch.zeros(nx * ny, dtype=dtype, device=dev)
    ko2 = k // 2
    offs = torch.arange(-ko2, ko2, device=dev)
    nrow = uvw.shape[0]
    step = max(1, _COUNTS_VIS // max(1, normfreq.numel()))
    for r0 in range(0, nrow, step):
        ug = (uvw[r0:r0 + step, 0:1] * normfreq[None, :] + umax) / u_cell
        vg = (uvw[r0:r0 + step, 1:2] * normfreq[None, :] + vmax) / v_cell
        m = live[r0:r0 + step].to(dtype)
        if k:
            xi = torch.round(ug).long()[..., None] + offs  # (row, chan, k)
            yi = torch.round(vg).long()[..., None] + offs
            xval = _es((xi - ug[..., None] + 0.5) / ko2, k)
            yval = _es((yi - vg[..., None] + 0.5) / ko2, k)
            vals = m[..., None, None] * xval[..., :, None] \
                * yval[..., None, :]
            ok = ((xi >= 0) & (xi < nx))[..., :, None] & \
                ((yi >= 0) & (yi < ny))[..., None, :]
            flat = xi[..., :, None] * ny + yi[..., None, :]
        else:
            xi = torch.floor(ug).long()
            yi = torch.floor(vg).long()
            vals = m
            ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
            flat = xi * ny + yi
        # taps off the grid add 0 to cell 0 (no compaction, no sync)
        counts.index_add_(0, torch.where(ok, flat, 0).reshape(-1),
                          torch.where(ok, vals, 0.0).reshape(-1))
    return counts.reshape(nx, ny)


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
