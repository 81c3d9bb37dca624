"""ES-kernel w-stacking (de)gridder (counterpart of
pfb_tpu/ops/wgridder.py).

Type-1/type-2 NUFFT on an oversampled uv grid with the "exponential of
semicircle" kernel C(x) = exp(beta k (sqrt(1 - x^2) - 1)), |x| <= 1,
w-stacking for the non-coplanar term, and grid correction by the
kernel's Fourier transform in l, m and n-1. Conventions identical to
ops/dft.py.

The spread is ``index_add_`` on the flattened (nw*Nx*Ny) grid, the
interpolation a gather plus a reduction over the k^3 stencil. Both keep
the JAX package's two plane-transform branches:

- float64 (the CPU parity path): exact per-plane w-screen phases and
  ``torch.fft``;
- float32: the phasor-rotation recurrence for the w screen, with the
  plane transforms on ops/cfft.py (the hand-written kernel on CUDA) when
  the layout is sigma=2 and 128-aligned, else ``torch.fft``.
"""

import math

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.ops.cfft import cfft_supported, fft2_c2c_pruned
from pfb_tpu_torch.ops.dft import LIGHTSPEED, nterm
from pfb_tpu_torch.utils.profiling import count

# the longest grid side whose w planes _grid_to_image transforms in one
# call; above it (the PSF grids of images from 4608^2) wchunk planes a call
_CFFT_STACK_N = 16384
# (support k, beta, max relative error vs the exact DFT at sigma=2):
# the calibration table of the JAX package (scripts/calibrate_beta.py).
_BETA_TABLE = (
    (4, 2.40, 1.5e-02),
    (5, 2.25, 1.6e-04),
    (7, 2.30, 2.5e-06),
    (9, 2.25, 4.0e-08),
    (11, 2.27, 5.0e-10),
    (13, 2.30, 6.0e-12),
)

# stencil entries (rows * chans * k^3) per spread/interp chunk
_ENTRIES_PER_CHUNK = 1 << 22


def kernel_params(epsilon):
    """(support k, beta): the smallest calibrated support whose
    measured error clears ``epsilon`` with a 2x margin."""
    for k, beta, err in _BETA_TABLE:
        if err <= 0.5 * epsilon:
            return k, beta
    return _BETA_TABLE[-1][0], _BETA_TABLE[-1][1]


def es_kernel(x, beta, k):
    arg = torch.clamp(1.0 - x * x, min=0.0)
    return torch.where(x.abs() <= 1.0,
                       torch.exp(beta * k * (torch.sqrt(arg) - 1.0)),
                       torch.zeros_like(x))


def _es_kernel_ft(theta, beta, k, nquad=64):
    """Continuous Fourier transform of the ES kernel by Gauss-Legendre
    quadrature (real, even), evaluated in float64 in chunks."""
    xq, wq = np.polynomial.legendre.leggauss(nquad)
    xq = 0.5 * (xq + 1.0) * (k / 2.0)
    wq = wq * (k / 4.0)
    xq = torch.as_tensor(xq, dtype=torch.float64, device=theta.device)
    wq = torch.as_tensor(wq, dtype=torch.float64, device=theta.device)
    wc = wq * es_kernel(xq / (k / 2.0), beta, k)
    flat = theta.reshape(-1).to(torch.float64)
    out = torch.empty_like(flat)
    step = max(1, (1 << 24) // nquad)
    for i in range(0, flat.numel(), step):
        ph = (2.0 * math.pi) * flat[i:i + step, None] * xq
        out[i:i + step] = 2.0 * (wc * torch.cos(ph)).sum(-1)
    return out.reshape(theta.shape)


def _grid_setup(nx, ny, cellx, celly, sigma):
    N_x = int(sigma * nx)
    N_y = int(sigma * ny)
    N_x += N_x % 2
    N_y += N_y % 2
    return N_x, N_y


def _w_params(uvw, freq, nm1_min, sigma, k):
    """w-stacking plane setup (host side)."""
    wsigned = np.asarray(uvw[:, 2])[:, None] * \
        (np.asarray(freq)[None, :] / LIGHTSPEED)
    wmin = wsigned.min()
    wmax = wsigned.max()
    dnmax = abs(nm1_min)
    if dnmax == 0 or wmax == wmin:
        return 1, float(wmin), 1.0
    dw = 1.0 / (2.0 * sigma * dnmax)
    nw = int(np.ceil((wmax - wmin) / dw)) + k + 1
    w0 = wmin - (k / 2.0) * dw
    return nw, float(w0), float(dw)


def _nm1_min(nx, ny, cellx, celly, x0, y0):
    l = (np.arange(nx) - nx // 2) * cellx + x0
    m = (np.arange(ny) - ny // 2) * celly + y0
    eps_max = max(abs(l.min()), l.max()) ** 2 + \
        max(abs(m.min()), m.max()) ** 2
    return -eps_max / (np.sqrt(max(1.0 - eps_max, 0.0)) + 1.0)


def _plan(uvw, freq, nx, ny, cellx, celly, x0, y0, epsilon,
          do_wgridding, sigma):
    k, beta = kernel_params(epsilon)
    Nx, Ny = _grid_setup(nx, ny, cellx, celly, sigma)
    if do_wgridding:
        nw, w0, dw = _w_params(uvw.detach().cpu().numpy(),
                               freq.detach().cpu().numpy(),
                               _nm1_min(nx, ny, cellx, celly, x0, y0),
                               sigma, k)
    else:
        nw, w0, dw = 1, 0.0, 1.0
    return k, beta, Nx, Ny, nw, w0, dw


def _centre_shift(uvw, freq, x0, y0, sign):
    """e^{sign 2 pi i (u x0 + v y0)} per (row, chan)."""
    scale = freq / LIGHTSPEED
    ph = (uvw[:, 0:1] * x0 + uvw[:, 1:2] * y0) * scale[None, :]
    ph = sign * 2.0 * math.pi * (ph - torch.round(ph))
    return torch.complex(torch.cos(ph), torch.sin(ph))


def _stencil(uvw_c, scale, cellx, celly, k, beta, Nx, Ny, do_w, nw, w0,
             dw):
    """Flat grid indices and kernel weights of every (row, chan) stencil
    entry: (R, nchan, k^3) (w on) or (R, nchan, k^2)."""
    ko2 = k / 2.0
    korig = (k - 1) // 2
    offs = torch.arange(-korig, k - korig, device=uvw_c.device)
    ul = uvw_c[:, 0:1] * scale[None, :] * cellx * Nx
    vl = uvw_c[:, 1:2] * scale[None, :] * celly * Ny
    xi = torch.round(ul).long()[..., None] + offs
    yi = torch.round(vl).long()[..., None] + offs
    cu = es_kernel((xi - ul[..., None]) / ko2, beta, k)
    cv = es_kernel((yi - vl[..., None]) / ko2, beta, k)
    xim = torch.remainder(xi, Nx)
    yim = torch.remainder(yi, Ny)
    R, nchan = ul.shape
    if do_w:
        wl = uvw_c[:, 2:3] * scale[None, :]
        wpos = (wl - w0) / dw
        pi = torch.round(wpos).long()[..., None] + offs
        cw = es_kernel((pi - wpos[..., None]) / ko2, beta, k)
        pic = torch.clamp(pi, 0, nw - 1)
        val = (cw[..., :, None, None] * cu[..., None, :, None]
               * cv[..., None, None, :])
        idx = (pic[..., :, None, None] * (Nx * Ny)
               + xim[..., None, :, None] * Ny + yim[..., None, None, :])
    else:
        val = cu[..., :, None] * cv[..., None, :]
        idx = xim[..., :, None] * Ny + yim[..., None, :]
    return idx.reshape(R, nchan, -1), val.reshape(R, nchan, -1)


def _row_step(nchan, k, do_w):
    return max(1, _ENTRIES_PER_CHUNK // (nchan * k ** (3 if do_w else 2)))


def _spread(uvw, freq, vis_w, cellx, celly, k, beta, Nx, Ny, do_w, nw,
            w0, dw):
    """Scatter vis_w = wgt * mask * vis onto the (nw, Nx, Ny) grid
    stack; returns (gr, gi) in the real dtype of vis_w."""
    nrow, nchan = vis_w.shape
    rdtype = vis_w.real.dtype
    scale = freq / LIGHTSPEED
    grid = torch.zeros((2, nw * Nx * Ny), dtype=rdtype,
                       device=vis_w.device)
    step = _row_step(nchan, k, do_w)
    for r0 in range(0, nrow, step):
        sl = slice(r0, r0 + step)
        idx, val = _stencil(uvw[sl], scale, cellx, celly, k, beta, Nx,
                            Ny, do_w, nw, w0, dw)
        v = vis_w[sl]
        src = torch.stack([(val * v.real[..., None]).reshape(-1),
                           (val * v.imag[..., None]).reshape(-1)])
        grid.index_add_(1, idx.reshape(-1), src.to(rdtype))
    return grid[0].view(nw, Nx, Ny), grid[1].view(nw, Nx, Ny)


def _interp(gr, gi, uvw, freq, cellx, celly, k, beta, Nx, Ny, do_w, nw,
            w0, dw):
    """Gather the (nw, Nx, Ny) grid stack at the visibilities; complex
    (nrow, nchan) in the grids' dtype."""
    nrow = uvw.shape[0]
    nchan = freq.shape[0]
    scale = freq / LIGHTSPEED
    fr, fi = gr.reshape(-1), gi.reshape(-1)
    outr, outi = [], []
    step = _row_step(nchan, k, do_w)
    for r0 in range(0, nrow, step):
        idx, val = _stencil(uvw[r0:r0 + step], scale, cellx, celly, k,
                            beta, Nx, Ny, do_w, nw, w0, dw)
        outr.append((fr[idx] * val).sum(-1))
        outi.append((fi[idx] * val).sum(-1))
    cdt = torch.complex128 if gr.dtype == torch.float64 else \
        torch.complex64
    return torch.complex(torch.cat(outr), torch.cat(outi)).to(cdt)


def _resolve_cfft(fft_engine, rdtype, nx, ny, Nx, Ny, is_cuda):
    """Whether the plane transforms run on ops/cfft.py (the kernel on
    CUDA, its plain version on the CPU): float32 sigma=2 128-aligned
    layouts, always for fft_engine="cfft", on CUDA for "auto" (where the
    JAX package picks its Pallas kernel on the TPU). Otherwise
    torch.fft."""
    ok = (rdtype == torch.float32 and Nx == 2 * nx and Ny == 2 * ny
          and nx % 128 == 0 and ny % 128 == 0 and cfft_supported(Nx)
          and cfft_supported(Ny))
    if fft_engine == "mm" or not ok:
        return False
    if fft_engine == "cfft":
        return True
    return is_cuda


def gi_consts(nx, ny, cellx, celly, k, beta, Nx, Ny, do_w, dw, x0=0.0,
              y0=0.0, rdtype=torch.float32, device=None):
    """Grid-correction and w-screen constants shared by
    :func:`_grid_to_image` and :func:`_image_to_grid` (computed in
    float64, stored in ``rdtype``, on ``device``; None means the card
    when there is one)."""
    device = as_device(device)
    f64 = torch.float64
    li = torch.arange(nx, dtype=f64, device=device) - nx // 2
    mi = torch.arange(ny, dtype=f64, device=device) - ny // 2
    cx = _es_kernel_ft(li / Nx, beta, k).to(rdtype)
    cy = _es_kernel_ft(mi / Ny, beta, k).to(rdtype)
    llg, mmg = torch.meshgrid(li * cellx + x0, mi * celly + y0,
                              indexing="ij")
    nm1 = nterm(llg, mmg).to(rdtype)
    out = dict(cx=cx, cy=cy, nm1=nm1)
    if do_w:
        nq = 24 if rdtype == torch.float32 else 64
        out["cw"] = _es_kernel_ft(nm1 * dw, beta, k, nquad=nq).to(rdtype)
        if rdtype == torch.float32:
            tpi = torch.tensor(2.0 * math.pi, dtype=rdtype, device=device)
            out["cd"] = torch.cos(tpi * dw * nm1)
            out["sd"] = torch.sin(tpi * dw * nm1)
    return out


def _phasor0(consts, w0):
    """(cos, sin) of 2 pi w0 (n-1) in the working dtype (the start of
    the float32 phasor-rotation recurrence). Its 2 pi goes to the device
    by a blocking copy, counted under ``sync.pg.phasor``
    (utils/profiling.py)."""
    nm1 = consts["nm1"]
    count("sync.pg.phasor")
    tpi = torch.tensor(2.0 * math.pi, dtype=nm1.dtype, device=nm1.device)
    return torch.cos(tpi * w0 * nm1), torch.sin(tpi * w0 * nm1)


def _plane_images(grp, gip, nx, ny):
    """Unnormalised inverse 2D DFT of a plane batch, rolled and cropped
    to the centre (nx, ny) image."""
    N = grp.shape[-2] * grp.shape[-1]
    full = torch.fft.ifft2(torch.complex(grp, gip)) * N
    full = torch.roll(full, (nx // 2, ny // 2), dims=(-2, -1))
    full = full[..., :nx, :ny]
    return full.real, full.imag


def _plane_grids(pr, pi, Nx, Ny):
    """Embed (P, nx, ny) image planes at (i - nx//2) mod N and forward
    2D DFT -> (P, Nx, Ny) real/imag grids."""
    nx, ny = pr.shape[-2:]
    ix = torch.remainder(torch.arange(nx, device=pr.device) - nx // 2, Nx)
    iy = torch.remainder(torch.arange(ny, device=pr.device) - ny // 2, Ny)
    full = torch.zeros(pr.shape[:-2] + (Nx, Ny),
                       dtype=torch.complex128 if pr.dtype == torch.float64
                       else torch.complex64, device=pr.device)
    full[..., ix[:, None], iy[None, :]] = torch.complex(pr, pi)
    g = torch.fft.fft2(full)
    return g.real, g.imag


def _grid_to_image(gr, gi, nx, ny, cellx, celly, k, beta, Nx, Ny, do_w,
                   nw, w0, dw, divide_by_n, x0=0.0, y0=0.0, wchunk=4,
                   fft_engine="auto", consts=None):
    rdtype = gr.dtype
    use_cfft = _resolve_cfft(fft_engine, rdtype, nx, ny, Nx, Ny,
                             gr.is_cuda)
    if consts is None:
        consts = gi_consts(nx, ny, cellx, celly, k, beta, Nx, Ny, do_w, dw,
                           x0, y0, rdtype=rdtype, device=gr.device)
    cx, cy, nm1 = consts["cx"], consts["cy"], consts["nm1"]

    if do_w:
        img = torch.zeros((nx, ny), dtype=rdtype, device=gr.device)
        if rdtype == torch.float32:
            # phasor-rotation recurrence: two cos/sin images, then
            # 4 mul + 2 add per plane (drift ~nw * 2^-24)
            c, s = _phasor0(consts, w0)
            cd, sd = consts["cd"], consts["sd"]
            if use_cfft:
                # the whole stack in one call, or wchunk planes a call
                # above 16384, where a plane of the grid is 2.7-8.6 GB
                step = nw if max(Nx, Ny) <= _CFFT_STACK_N else wchunk
                batches = (fft2_c2c_pruned(gr[p:p + step], gi[p:p + step],
                                           Nx=Nx, Ny=Ny, inverse=True,
                                           pruned_out=True)
                           for p in range(0, nw, step))
            else:
                batches = (_plane_images(gr[p:p + wchunk],
                                         gi[p:p + wchunk], nx, ny)
                           for p in range(0, nw, wchunk))
            for ir, ii in batches:
                for p_ in range(ir.shape[0]):
                    img = img + ir[p_] * c - ii[p_] * s
                    c, s = c * cd - s * sd, s * cd + c * sd
        else:
            wp = w0 + dw * torch.arange(nw, dtype=rdtype, device=gr.device)
            for p in range(0, nw, wchunk):
                ir, ii = _plane_images(gr[p:p + wchunk], gi[p:p + wchunk],
                                       nx, ny)
                ph = (2.0 * math.pi) * wp[p:p + wchunk, None, None] * \
                    nm1[None]
                img = img + (ir * torch.cos(ph)
                             - ii * torch.sin(ph)).sum(0)
        img = img / consts["cw"]
    elif use_cfft:
        ir, _ = fft2_c2c_pruned(gr[:1], gi[:1], Nx=Nx, Ny=Ny, inverse=True,
                                pruned_out=True)
        img = ir[0]
    else:
        img, _ = _plane_images(gr[0], gi[0], nx, ny)

    out = img / (cx[:, None] * cy[None, :])
    if divide_by_n:
        out = out / (nm1 + 1.0)
    return out


def _image_to_grid(image, nx, ny, cellx, celly, k, beta, Nx, Ny, do_w, nw,
                   w0, dw, divide_by_n, x0=0.0, y0=0.0, wchunk=4,
                   fft_engine="auto", consts=None):
    """(nx, ny) image -> (gr, gi) (nw, Nx, Ny) grid stack."""
    rdtype = image.dtype
    use_cfft = _resolve_cfft(fft_engine, rdtype, nx, ny, Nx, Ny,
                             image.is_cuda)
    if consts is None:
        consts = gi_consts(nx, ny, cellx, celly, k, beta, Nx, Ny, do_w, dw,
                           x0, y0, rdtype=rdtype, device=image.device)
    cx, cy, nm1 = consts["cx"], consts["cy"], consts["nm1"]
    img = image / (cx[:, None] * cy[None, :])
    if divide_by_n:
        img = img / (nm1 + 1.0)

    if not do_w:
        zero = torch.zeros_like(img)[None]
        if use_cfft:
            return fft2_c2c_pruned(img[None], zero, Nx=Nx, Ny=Ny,
                                   inverse=False, pruned_in=True)
        return _plane_grids(img[None], zero, Nx, Ny)

    img = img / consts["cw"]
    if rdtype == torch.float32:
        # phase e^{-2 pi i w_p (n-1)} = (c_p, -s_p) by rotation
        c, s = _phasor0(consts, w0)
        cd, sd = consts["cd"], consts["sd"]
        prs, pis = [], []
        for _ in range(nw):
            prs.append(img * c)
            pis.append(img * (-s))
            c, s = c * cd - s * sd, s * cd + c * sd
        prs, pis = torch.stack(prs), torch.stack(pis)
        if use_cfft:
            return fft2_c2c_pruned(prs, pis, Nx=Nx, Ny=Ny, inverse=False,
                                   pruned_in=True)
        parts = [_plane_grids(prs[p:p + wchunk], pis[p:p + wchunk], Nx, Ny)
                 for p in range(0, nw, wchunk)]
    else:
        wp = w0 + dw * torch.arange(nw, dtype=rdtype, device=image.device)
        parts = []
        for p in range(0, nw, wchunk):
            ph = (-2.0 * math.pi) * wp[p:p + wchunk, None, None] * nm1[None]
            parts.append(_plane_grids(img[None] * torch.cos(ph),
                                      img[None] * torch.sin(ph), Nx, Ny))
    return (torch.cat([a for a, _ in parts]),
            torch.cat([b for _, b in parts]))


def vis2dirty_wgrid(uvw, freq, vis, wgt=None, mask=None, *, nx, ny,
                    cellx, celly, x0=0.0, y0=0.0, epsilon=1e-7,
                    do_wgridding=True, sigma=2.0, divide_by_n=False,
                    double_accum=False, fft_engine="auto"):
    """R.H: visibilities -> dirty image via w-stacked ES gridding.
    ``vis`` may be complex or a (real, imag) pair. ``double_accum``
    spreads float32 visibilities into a float64 grid (the H100 has
    FP64), cast to float32 before the plane transforms."""
    if isinstance(vis, (tuple, list)):
        vis = torch.complex(vis[0], vis[1])
    rdtype = vis.real.dtype
    k, beta, Nx, Ny, nw, w0, dw = _plan(uvw, freq, nx, ny, cellx, celly,
                                        x0, y0, epsilon, do_wgridding,
                                        sigma)
    w = torch.ones(vis.shape, dtype=rdtype, device=vis.device) \
        if wgt is None else wgt
    if mask is not None:
        w = w * mask
    vis_w = vis * w
    if double_accum and rdtype == torch.float32:
        vis_w = vis_w.to(torch.complex128)
    if x0 or y0:
        vis_w = vis_w * _centre_shift(uvw, freq, x0, y0,
                                      +1.0).to(vis_w.dtype)
    do_w = do_wgridding and nw > 1
    gr, gi = _spread(uvw, freq, vis_w, cellx, celly, k, beta, Nx, Ny,
                     do_w, nw, w0, dw)
    del vis_w
    if gr.dtype != rdtype:
        g = torch.stack([gr, gi]).to(rdtype)
        del gr, gi
        gr, gi = g[0], g[1]
    return _grid_to_image(gr, gi, nx, ny, cellx, celly, k, beta, Nx, Ny,
                          do_w, nw, w0, dw, divide_by_n, x0, y0,
                          fft_engine=fft_engine)


def dirty2vis_wgrid(uvw, freq, image, cellx, celly, x0=0.0, y0=0.0, *,
                    epsilon=1e-7, do_wgridding=True, sigma=2.0,
                    divide_by_n=False, fft_engine="auto", split=False):
    """R: image -> visibilities (the adjoint chain of vis2dirty_wgrid,
    kernel e^{-2 pi i (...)})."""
    nx, ny = image.shape
    k, beta, Nx, Ny, nw, w0, dw = _plan(uvw, freq, nx, ny, cellx, celly,
                                        x0, y0, epsilon, do_wgridding,
                                        sigma)
    do_w = do_wgridding and nw > 1
    gr, gi = _image_to_grid(image, nx, ny, cellx, celly, k, beta, Nx, Ny,
                            do_w, nw, w0, dw, divide_by_n, x0, y0,
                            fft_engine=fft_engine)
    vis = _interp(gr, gi, uvw, freq, cellx, celly, k, beta, Nx, Ny, do_w,
                  nw, w0, dw)
    if x0 or y0:
        vis = vis * _centre_shift(uvw, freq, x0, y0, -1.0).to(vis.dtype)
    if split:
        return vis.real, vis.imag
    return vis
