"""restore worker: dds -> FITS products.

Counterpart of pfb_tpu/workers/restore.py (reference
pfb/workers/restore.py:20-248): products selected by letter flags —
(m)odel, (r)esidual, (d)irty, (i)mage = model convolved with the fitted
clean beam + residual, (c)lean beam, (f)ft of residual; capitals produce
per-band cubes, lower case MFS images. A host worker, as in the JAX
package (numpy FFTs, utils/misc.py's beam fit and convolution): it runs
no device code, so a ``device`` argument passes through ``kw`` unused.
"""

import numpy as np

from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.fits import add_beampars, save_fits, set_wcs
from pfb_tpu_torch.utils.misc import (Gaussian2D, convolve2gaussres,
                                      fitcleanbeam)
from pfb_tpu_torch.workers.cubes import dds2cubes


def _restore(ddsi=None, output_filename=None, product="I",
             suffix="main", outputs="mMrRiI", model_name="MODEL",
             residual_name="RESIDUAL", nband=None, overwrite=True,
             **kw):
    """Returns a dict of product name -> array; writes the selected
    FITS files."""
    if ddsi is None:
        dds_name = f"{output_filename}_{product.upper()}_{suffix}.dds"
        dds = dstore.read_store(dds_name)
    else:
        dds = ddsi

    freqs_out = np.unique([ds["freq_out"] for ds in dds])
    nband = freqs_out.size if nband is None else nband
    dirty, model, residual, psf, psfhat, beam, wsums, _ = dds2cubes(
        dds, nband, apparent=False, modelname=model_name)
    wsum = wsums.sum()
    if residual_name != "RESIDUAL" and residual_name in dds[0]:
        # alternative residual field, e.g. UPDATE after a fluxmop
        # (reference restore.yaml residual-name)
        residual = np.zeros_like(dirty)
        for ds in dds:
            residual[ds["bandid"]] += np.asarray(ds[residual_name])
        residual /= max(wsum, 1e-12)
    if residual is None:
        residual = dirty.copy()
    nx, ny = dirty.shape[-2:]

    cell_rad = dds[0]["cell_rad"]
    cell_deg = np.rad2deg(cell_rad)
    radec = [dds[0]["ra"], dds[0]["dec"]]
    ref_freq = float(np.mean(freqs_out))

    # clean beam from the PSF main lobe (reference restore.py)
    psf_mfs = psf.sum(axis=0) if psf is not None else None
    GaussPar = None
    GaussPars = None
    if psf is not None:
        GaussPar = fitcleanbeam(psf_mfs[None], level=0.5, pixsize=1.0)[0]
        GaussPars = fitcleanbeam(psf, level=0.5, pixsize=1.0)

    hdr_mfs = set_wcs(cell_deg, cell_deg, nx, ny, radec, ref_freq)
    hdr = set_wcs(cell_deg, cell_deg, nx, ny, radec, freqs_out)
    if GaussPar is not None:
        add_beampars(hdr_mfs, [GaussPar[0] * cell_deg,
                               GaussPar[1] * cell_deg, GaussPar[2]])

    base = f"{output_filename}_{product.upper()}_{suffix}"
    results = {}

    model_mfs = model.mean(axis=0)
    residual_mfs = residual.sum(axis=0)
    dirty_mfs = dirty.sum(axis=0)

    def put(letter, name, data_mfs, data_cube, header_mfs=hdr_mfs,
            header=hdr):
        if letter in outputs:
            save_fits(data_mfs, f"{base}.{name}_mfs.fits", header_mfs)
            results[f"{name}_mfs"] = data_mfs
        if letter.upper() in outputs:
            save_fits(data_cube, f"{base}.{name}.fits", header)
            results[name] = data_cube

    put("m", "model", model_mfs, model)
    put("r", "residual", residual_mfs, residual)
    put("d", "dirty", dirty_mfs, dirty)

    if ("i" in outputs or "I" in outputs) and GaussPar is not None:
        x = np.arange(-(nx // 2), nx - nx // 2)
        y = np.arange(-(ny // 2), ny - ny // 2)
        xx, yy = np.meshgrid(x, y, indexing="ij")
        image = convolve2gaussres(model, xx, yy, GaussPar,
                                  norm_kernel=False) + residual
        image_mfs = convolve2gaussres(model_mfs[None], xx, yy, GaussPar,
                                      norm_kernel=False)[0] + residual_mfs
        put("i", "image", image_mfs, image)

    if ("c" in outputs or "C" in outputs) and GaussPar is not None:
        x = np.arange(-(nx // 2), nx - nx // 2)
        y = np.arange(-(ny // 2), ny - ny // 2)
        xx, yy = np.meshgrid(x, y, indexing="ij")
        cpsf_mfs = Gaussian2D(xx, yy, GaussPar, normalise=False)
        cpsf = np.stack([Gaussian2D(xx, yy, gp, normalise=False)
                         for gp in GaussPars])
        put("c", "cpsf", cpsf_mfs, cpsf)

    if "f" in outputs or "F" in outputs:
        fres = np.fft.fftshift(np.fft.fft2(residual, axes=(-2, -1)),
                               axes=(-2, -1))
        put("f", "fft_residual_abs", np.abs(fres).sum(axis=0),
            np.abs(fres))
        put("f", "fft_residual_phase", np.angle(fres).sum(axis=0),
            np.angle(fres))

    return results
