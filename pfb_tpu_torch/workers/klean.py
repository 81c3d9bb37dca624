"""klean worker: single-scale CLEAN major cycle (counterpart of
pfb_tpu/workers/klean.py:_klean).

Clark minor cycles on the apparent-scale residual, the exact vis-space
residual of every major iteration through ``make_hessian_dds`` (the
w-plane-blocked pg engine with ``backend="pg", plane_block=N``), a
threshold of sigmathreshold * rms or an absolute one, the PCG flux mop
over the model support, the divergence guard, best-model tracking and
MODEL/RESIDUAL/MODEL_BEST writeback to the dds store for resume, and the
FITS products (``fits_mfs``, ``fits_cubes``) with an ``output_filename``.
"""

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.deconv.clark import clark
from pfb_tpu_torch.ops.gridder import make_hessian_dds
from pfb_tpu_torch.opt.pcg import pcg_psf
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.logging import get_logger
from pfb_tpu_torch.workers.cubes import dds2cubes, write_deconv_fits

log = get_logger("KLEAN")


def _klean(ddsi=None, output_filename=None, product="I", suffix="main",
           nband=None, niter=5, threshold=None, sigmathreshold=2.0,
           gamma=0.05, peak_factor=0.05, sub_peak_factor=0.5,
           minor_maxit=50, subminor_maxit=1000, mop_flux=True,
           mop_gamma=0.65, dirosion=1, cg_tol=1e-5, cg_maxit=100,
           cg_minit=10, cg_verbose=0, cg_report_freq=10, backtrack=True,
           backend="dft", engine="fft", epsilon=1e-7, do_wgridding=True,
           plane_block=0, mask=None, write=True, band_chunk=None, verbose=1,
           report_freq=1, fits_mfs=False, fits_cubes=False, device=None,
           stats=None, **kw):
    """Returns (model, residual_cube) as numpy arrays and writes back into
    the dds store. ``stats``, when a dict, receives per-major-iteration
    ``rms``, ``rmax`` and Clark ``status``."""
    device = as_device(device)
    dds_name = None
    if ddsi is None:
        dds_name = f"{output_filename}_{product.upper()}_{suffix}.dds"
        dds = dstore.read_store(dds_name)
    else:
        dds = ddsi
        if output_filename is not None:
            dds_name = f"{output_filename}_{product.upper()}_{suffix}.dds"
            if not dstore.store_exists(dds_name):
                dstore.write_store(dds_name, dds)

    freqs_out = np.unique([ds["freq_out"] for ds in dds])
    nband = freqs_out.size if nband is None else nband
    nx, ny = dds[0]["DIRTY"].shape

    # clean in apparent scale
    dirty, model, residual, psf, psfhat, _, wsums, _ = dds2cubes(
        dds, nband, apparent=True)
    dtype = torch.float64 if dirty.dtype == np.float64 else torch.float32
    wsum = wsums.sum()
    if residual is None:
        residual = dirty.copy()
    residual_mfs = residual.sum(axis=0)
    iter0 = int(dds[0].get("niters", 0))
    mask_im = np.ones((nx, ny), dirty.dtype) if mask is None else \
        mask.astype(dirty.dtype)

    def tens(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)

    rms = np.std(residual_mfs)
    rmax = np.abs(residual_mfs).max()
    best_rms, best_rmax = rms, rmax
    best_model = model.copy()
    diverge_count = 0
    thresholdf = sigmathreshold * rms if threshold is None else threshold
    if stats is not None:
        stats.update(rms=[], rmax=[], status=[])

    psfhat_t = tens(psfhat, torch.complex128 if dtype == torch.float64
                    else torch.complex64)
    psf_t = tens(psf)
    wsums_t = tens(wsums / wsum)

    # the exact-residual operator, built once for every major iteration
    hess = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                            plane_block=plane_block or None, backend=backend,
                            epsilon=epsilon, do_wgridding=do_wgridding,
                            device=device)

    def exact_residual(model):
        conv = hess(tens(model)).cpu().numpy()
        residual = dirty - conv
        residual_mfs = residual.sum(axis=0)
        tmp_mask = ~np.any(model, axis=0)
        rms = np.std(residual_mfs[tmp_mask]) if tmp_mask.any() else \
            np.std(residual_mfs)
        return residual, residual_mfs, rms, np.abs(residual_mfs).max()

    if verbose:
        log.info(f"klean iter {iter0}: peak residual = {rmax:.3e}, "
                 f"rms = {rms:.3e}")

    for k in range(iter0, iter0 + niter):
        x, _, status = clark(tens(mask_im * residual), psf_t, psfhat_t,
                             wsums_t, threshold=thresholdf, gamma=gamma,
                             pf=peak_factor, maxit=minor_maxit,
                             subpf=sub_peak_factor, submaxit=subminor_maxit,
                             band_chunk=band_chunk)
        model = model + x.cpu().numpy()

        rmsp = rms
        residual, residual_mfs, rms, rmax = exact_residual(model)
        if rms < best_rms:
            best_rms, best_rmax = rms, rmax
            best_model = model.copy()
        thresholdf = sigmathreshold * rms if threshold is None else \
            threshold

        # flux mop when stalled, converged or at the last iteration
        status |= k == iter0 + niter - 1
        status |= rmax <= thresholdf
        if mop_flux and status:
            mopmask = np.any(model, axis=0)
            if dirosion:
                from scipy import ndimage
                struct = ndimage.generate_binary_structure(2, dirosion)
                mopmask = ndimage.binary_dilation(mopmask, structure=struct)
                mopmask = ndimage.binary_erosion(mopmask, structure=struct)
            x0 = np.zeros_like(model)
            x0[:, mopmask] = residual_mfs[mopmask]
            mopmask_f = mopmask[None].astype(residual.dtype)
            x = pcg_psf(psfhat_t, tens(mopmask_f * residual), tens(x0),
                        beam=tens(np.broadcast_to(mopmask_f,
                                                  residual.shape)),
                        sigmainv=float(rmax), tol=cg_tol, maxit=cg_maxit,
                        minit=cg_minit, backtrack=backtrack,
                        verbosity=cg_verbose, report_freq=cg_report_freq)
            model = model + mop_gamma * x.cpu().numpy()

            rmsp = rms
            residual, residual_mfs, rms, rmax = exact_residual(model)
            if rms < best_rms:
                best_rms, best_rmax = rms, rmax
                best_model = model.copy()
            thresholdf = sigmathreshold * rms if threshold is None else \
                threshold

        if stats is not None:
            stats["rms"].append(float(rms))
            stats["rmax"].append(float(rmax))
            stats["status"].append(int(status))
        if verbose and (k + 1 - iter0) % max(report_freq, 1) == 0:
            log.info(f"klean iter {k + 1}: peak residual = {rmax:.3e}, "
                     f"rms = {rms:.3e}")

        if write and dds_name is not None:
            for i, ds in enumerate(dds):
                b = ds["bandid"]
                arrays = {"RESIDUAL": residual[b] * wsum,
                          "MODEL": model[b],
                          "MODEL_BEST": best_model[b]}
                attrs = {"niters": k + 1, "best_rms": float(best_rms),
                         "best_rmax": float(best_rmax),
                         "parametrisation": "id"}
                dstore.update_ds(dds_name, i, arrays, attrs)
                ds.update(arrays)
                ds.update(attrs)

        if rmax <= thresholdf:
            if verbose:
                log.info("klean: terminating, threshold reached")
            break
        if rms > rmsp:
            diverge_count += 1
            if diverge_count > 3:
                log.info("klean: algorithm diverging, terminating")
                break

    write_deconv_fits(dds, output_filename, product, suffix, fits_mfs,
                      fits_cubes)
    return model, residual
