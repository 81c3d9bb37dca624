"""Hogbom CLEAN minor cycle (counterpart of pfb_tpu/deconv/hogbom.py).

The JAX ``lax.while_loop`` is a Python loop here; each iteration reads
its peak position and its two stopping tests from the device in one
transfer. Semantics are the JAX package's:

- the search image is the squared MFS residual (sum over bands)^2;
- per-band flux normalised by wsums = max(PSF, axis=(1, 2)); bands with
  wsums == 0 are skipped;
- tol = max(pf * initial peak, threshold);
- stall guard: stop after 5 consecutive iterations whose relative peak
  change is below 1e-7.

Requires a PSF of shape (nband, >= 2 nx, >= 2 ny) so that every PSF
window is in range.
"""

import torch


def peak_of(IR, mask=None):
    """(flat index, peak) of the squared MFS residual (masked), as 0-d
    tensors: argmax takes the first maximum, as jnp.argmax does."""
    IRsearch = torch.sum(IR, dim=0) ** 2
    if mask is not None:
        IRsearch = torch.where(mask, IRsearch, torch.zeros((), dtype=IR.dtype,
                                                           device=IR.device))
    pq = torch.argmax(IRsearch)
    return pq, torch.sqrt(IRsearch.reshape(-1)[pq])


def psf_window(PSF, p, q, nx, ny):
    """The (nband, nx, ny) PSF window centred on pixel (p, q)."""
    nx0, ny0 = PSF.shape[-2] // 2, PSF.shape[-1] // 2
    return PSF[:, nx0 - p:nx0 - p + nx, ny0 - q:ny0 - q + ny]


def hogbom(ID, PSF, threshold=0.0, gamma=0.1, pf=0.1, maxit=10000):
    """Returns (model, residual, status) with status 0 on convergence, 1
    on maxit/stall."""
    nband, nx, ny = ID.shape
    wsums = torch.amax(PSF, dim=(1, 2))
    fsel = wsums > 0
    safe_wsums = torch.where(fsel, wsums, torch.ones_like(wsums))
    zero = torch.zeros((), dtype=ID.dtype, device=ID.device)

    x = torch.zeros_like(ID)
    IR = ID.clone()
    pq, IRmax = peak_of(IR)
    tol = torch.clamp(pf * IRmax, min=threshold)
    pq, go = torch.stack([pq, (IRmax > tol).long()]).tolist()
    k = stall = 0
    while go and k < maxit and stall < 5:
        p, q = divmod(pq, ny)
        xhat = torch.where(fsel, IR[:, p, q] / safe_wsums, zero)
        x[:, p, q] += gamma * xhat
        IR = IR - gamma * xhat[:, None, None] * psf_window(PSF, p, q, nx, ny)
        pqn, IRmax_n = peak_of(IR)
        stalled = torch.abs(IRmax - IRmax_n) / torch.abs(IRmax) < 1e-7
        pq, st, go = torch.stack(
            [pqn, stalled.long(), (IRmax_n > tol).long()]).tolist()
        IRmax = IRmax_n
        stall = stall + 1 if st else 0
        k += 1
    status = int(k >= maxit or stall >= 5)
    return x, IR, status
