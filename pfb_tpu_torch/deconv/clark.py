"""Clark CLEAN: active-set minor cycle with exact residual updates by
cube PSF convolution (counterpart of pfb_tpu/deconv/clark.py).

The JAX ``lax.while_loop``s are Python loops here; each iteration reads
its peak position and stopping tests from the device in one transfer.
Semantics are the JAX package's:

- inputs are normalised by wsum; ``wsums`` are the per-band weights with
  sum(wsums) == 1;
- outer tol = max(pf * IRmax, threshold); subminor threshold
  subth = subpf * IRmax; the active set is the pixels whose squared MFS
  residual exceeds subth^2, and subtraction is masked to it;
- the subminor loop runs while the active-set peak exceeds subth, at most
  ``submaxit`` times; after it the residual is refreshed as ID -
  PSF conv model (ops/fft.py:psf_convolve_cube);
- stall guard: stop after 5 consecutive outer iterations whose relative
  peak change is below 1e-4.
"""

import torch

from pfb_tpu_torch.deconv.hogbom import peak_of, psf_window
from pfb_tpu_torch.ops.fft import psf_convolve_cube


def _subminor(IR, PSF, mask, model, wsums, gamma, subth, submaxit):
    """Active-set peak-find/subtract loop on a copy of IR; returns the
    updated model (a new tensor)."""
    nband, nx, ny = IR.shape
    fsel = wsums > 0
    safe_wsums = torch.where(fsel, wsums, torch.ones_like(wsums))
    zero = torch.zeros((), dtype=IR.dtype, device=IR.device)
    model = model.clone()
    IR = IR.clone()
    pq, Amax = peak_of(IR, mask)
    pq, go = torch.stack([pq, (Amax > subth).long()]).tolist()
    k = 0
    while go and k < submaxit:
        p, q = divmod(pq, ny)
        xhat = IR[:, p, q].clone()
        model[:, p, q] += torch.where(fsel, gamma * xhat / safe_wsums, zero)
        IR -= torch.where(mask[None], gamma * xhat[:, None, None]
                          * psf_window(PSF, p, q, nx, ny), zero)
        pq, Amax = peak_of(IR, mask)
        pq, go = torch.stack([pq, (Amax > subth).long()]).tolist()
        k += 1
    return model


def clark(ID, PSF, PSFHAT, wsums, threshold=0.0, gamma=0.05, pf=0.05,
          maxit=50, subpf=0.5, submaxit=1000, band_chunk=None):
    """Returns (model, residual, status): status 0 on convergence, 1 on
    maxit/stall."""
    ny_psf = PSF.shape[-1]
    model = torch.zeros_like(ID)
    IR = ID
    _, IRmax = peak_of(IR)
    tol = torch.clamp(pf * IRmax, min=threshold)
    go = bool(IRmax > tol)
    k = stall = 0
    while go and k < maxit and stall < 5:
        subth = subpf * IRmax
        mask = torch.sum(IR, dim=0) ** 2 > subth ** 2
        model = _subminor(IR, PSF, mask, model, wsums, gamma, subth,
                          submaxit)
        IR = ID - psf_convolve_cube(model, PSFHAT, ny_psf,
                                    band_chunk=band_chunk)
        _, IRmax_n = peak_of(IR)
        stalled = torch.abs(IRmax - IRmax_n) / torch.abs(IRmax) < 1e-4
        st, go = torch.stack([stalled, IRmax_n > tol]).tolist()
        IRmax = IRmax_n
        stall = stall + 1 if st else 0
        k += 1
    status = int(k >= maxit or stall >= 5)
    return model, IR, status
