"""Spectral-index fitting over image components (counterpart of
pfb_tpu/utils/spi.py; reference pfb/utils/spi.py, africanus
fit_spi_components): fit I(nu) = I0 (nu/nu0)^alpha per component by
weighted Gauss-Newton (log-linearised start + nonlinear refinement).

The JAX package vmaps one component's fit and scans its ``maxiter``
steps; here every component steps together, each step one batched
(ncomp, 2, 2) solve with the same 1e-12 ridge.
"""

import numpy as np
import torch

from pfb_tpu_torch.config import as_device


def fit_spi_components(data, weights, freqs, freq0, maxiter=100):
    """data (ncomp, nchan), weights (nchan,) or (ncomp, nchan).

    Returns (alpha, alpha_err, i0, i0_err) like africanus'
    fit_spi_components, as tensors on the device of ``data``.
    """
    data = torch.atleast_2d(torch.as_tensor(data))

    def tens(a):
        return torch.as_tensor(a, dtype=data.dtype).to(data.device)

    weights = tens(weights)
    if weights.ndim == 1:
        weights = weights[None].expand(data.shape)
    w = tens(freqs) / freq0
    logw = torch.log(w)
    ridge = 1e-12 * torch.eye(2, dtype=data.dtype, device=data.device)

    def normal(J, r):
        """(J^T W J + ridge, J^T W r) per component."""
        WJ = J * weights[..., None]
        return J.mT @ WJ + ridge, WJ.mT @ r[..., None]

    # initial guess from the weighted log-linear fit (positive part)
    A = torch.stack([torch.ones_like(logw), logw], dim=1).expand(
        data.shape + (2,))
    coef = torch.linalg.solve(*normal(A, torch.log(
        torch.clamp(data, min=1e-10))))[..., 0]
    logi0, alpha = coef[:, 0], coef[:, 1]

    def jacobian(logi0, alpha):
        """(model, J) with J the jacobian wrt (i0, alpha)."""
        wa = w[None] ** alpha[:, None]
        model = torch.exp(logi0)[:, None] * wa
        return model, torch.stack([wa, model * logw], dim=-1)

    for _ in range(maxiter):
        model, J = jacobian(logi0, alpha)
        d = torch.linalg.solve(*normal(J, data - model))[..., 0]
        i0 = torch.exp(logi0) + d[:, 0]
        alpha = alpha + d[:, 1]
        logi0 = torch.log(torch.clamp(i0, min=1e-10))
    i0 = torch.exp(logi0)
    # errors from the final Hessian
    _, J = jacobian(logi0, alpha)
    cov = torch.linalg.inv(normal(J, data)[0])
    return alpha, torch.sqrt(cov[:, 1, 1]), i0, torch.sqrt(cov[:, 0, 0])


def fit_spi(image_cube, freqs, freq0=None, threshold=0.0, rms=None,
            device=None):
    """SPI map over pixels above threshold (reference utils/spi.py),
    fitted on ``device`` (None means the card when there is one) in the
    cube's dtype; returns numpy maps."""
    nband, nx, ny = image_cube.shape
    if freq0 is None:
        freq0 = float(np.mean(freqs))
    device = as_device(device)
    mfs = image_cube.sum(axis=0)
    mask = mfs > threshold
    Ix, Iy = np.where(mask)
    comps = image_cube[:, Ix, Iy].T  # (ncomp, nchan)
    wgts = np.ones(nband) if rms is None else 1.0 / rms**2
    alpha, aerr, i0, ierr = fit_spi_components(
        torch.as_tensor(np.ascontiguousarray(comps)).to(device), wgts,
        np.asarray(freqs), freq0)
    alpha_map = np.full((nx, ny), np.nan)
    i0_map = np.full((nx, ny), np.nan)
    alpha_map[Ix, Iy] = alpha.cpu().numpy()
    i0_map[Ix, Iy] = i0.cpu().numpy()
    return alpha_map, i0_map
