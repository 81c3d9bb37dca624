"""Stitch per-(time, band) dds datasets into (nband, ...) cubes.

Counterpart of pfb_tpu/workers/cubes.py (reference dds2cubes,
pfb/utils/misc.py:664-739): sums
DIRTY/RESIDUAL/PSF over datasets per band, normalises by the total wsum,
averages beams weighted by wsum, and carries MODEL/DUAL through.
"""

import numpy as np

from pfb_tpu_torch.workers.grid import psfhat_of


def dds2cubes(dds, nband, apparent=False, modelname="MODEL"):
    real_type = dds[0]["DIRTY"].dtype
    nx, ny = dds[0]["DIRTY"].shape
    dirty = np.zeros((nband, nx, ny), real_type)
    model = np.zeros((nband, nx, ny), real_type)
    have_resid = "RESIDUAL" in dds[0]
    residual = np.zeros((nband, nx, ny), real_type) if have_resid else None
    wsums = np.zeros(nband, real_type)
    have_psf = "PSF" in dds[0]
    if have_psf:
        nx_psf, ny_psf = dds[0]["PSF"].shape
        psf = np.zeros((nband, nx_psf, ny_psf), real_type)
        psfhat = np.zeros((nband, nx_psf, ny_psf // 2 + 1),
                          np.result_type(real_type, np.complex64))
    else:
        psf = psfhat = None
    mean_beam = np.zeros((nband, nx, ny), real_type)
    dual = None

    for ds in dds:
        b = ds["bandid"]
        beam = ds.get("BEAM", np.ones((nx, ny), real_type))
        wsum_b = ds["WSUM"][0]
        if apparent:
            dirty[b] += ds["DIRTY"]
            if have_resid:
                residual[b] += ds["RESIDUAL"]
        else:
            dirty[b] += ds["DIRTY"] * beam
            if have_resid:
                residual[b] += ds["RESIDUAL"] * beam
        if have_psf:
            psf[b] += ds["PSF"]
            psfhat[b] += psfhat_of(ds)
        if modelname in ds:
            model[b] = ds[modelname]
        if "DUAL" in ds:
            if dual is None:
                nbasis, nymax, nxmax = ds["DUAL"].shape
                dual = np.zeros((nband, nbasis, nymax, nxmax), real_type)
            dual[b] = ds["DUAL"]
        mean_beam[b] += beam * wsum_b
        wsums[b] += wsum_b

    wsum = wsums.sum()
    dirty /= wsum
    if have_resid:
        residual /= wsum
    if have_psf:
        psf /= wsum
        psfhat /= wsum
    for b in range(nband):
        if wsums[b]:
            mean_beam[b] /= wsums[b]
    return dirty, model, residual, psf, psfhat, mean_beam, wsums, dual


def write_deconv_fits(dds, output_filename, product, suffix, fits_mfs,
                      fits_cubes):
    """The deconvolution workers' FITS products, as the reference's
    spotless and klean write them: with an ``output_filename``, RESIDUAL
    (normalised by wsum) and MODEL as an MFS image (``fits_mfs``) and as
    per-band cubes (``fits_cubes``)."""
    if not (fits_mfs or fits_cubes) or output_filename is None:
        return
    from pfb_tpu_torch.utils.fits import dds2fits, dds2fits_mfs
    base = f"{output_filename}_{product.upper()}_{suffix}"
    if fits_mfs:
        dds2fits_mfs(dds, "RESIDUAL", base, norm_wsum=True)
        dds2fits_mfs(dds, "MODEL", base, norm_wsum=False)
    if fits_cubes:
        dds2fits(dds, "RESIDUAL", base, norm_wsum=True)
        dds2fits(dds, "MODEL", base, norm_wsum=False)
