"""fluxmop worker: standalone forward (PCG) step.

Counterpart of pfb_tpu/workers/fluxmop.py (reference
pfb/workers/fluxmop.py:21-270): solve A update = beam * mask * residual
with the image-space (PSF) or vis-space Hessian, add gamma * update to
the model, recompute the exact residual and write MODEL/MODELP/UPDATE/
RESIDUAL back (MODELP kept to revert on failure).

On ``device``: the exact residual runs ``make_hessian_dds`` (for
``backend="pg"`` the spread K4, the fold K5, the degrid K6 and the
transforms K3c / K3r by route); ``use_psf=True`` solves with
``pcg_bands`` on ``hessian_psf_cube`` (torch.fft, as the JAX package's
XLA path), ``use_psf=False`` with ``pcg`` on the vis-space Hessian.
"""

import numpy as np
import torch

from pfb_tpu_torch.config import as_device, to_host
from pfb_tpu_torch.ops.gridder import make_hessian_dds
from pfb_tpu_torch.ops.psf import hessian_psf_cube
from pfb_tpu_torch.opt.pcg import pcg, pcg_bands
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.logging import get_logger
from pfb_tpu_torch.utils.profiling import count, span, traced
from pfb_tpu_torch.workers.cubes import dds2cubes

log = get_logger("FLUXMOP")


@traced("fluxmop.call")
def _fluxmop(ddsi=None, output_filename=None, product="I",
             suffix="main", nband=None, mask=None, min_model=0.0,
             zero_model_outside_mask=False, use_psf=True, sigmainv=1e-5,
             gamma=0.9, cg_tol=1e-5, cg_maxit=150, cg_minit=10,
             cg_verbose=0, cg_report_freq=10,
             backtrack=True, model_name="MODEL", backend="dft",
             epsilon=1e-7, do_wgridding=True, write=True,
             band_chunk=None, verbose=1, fits_mfs=False,
             fits_cubes=False, space_shards=0, device=None, devices=None,
             stats=None, **kw):
    """Returns (model, residual) as numpy arrays. Writes back into the dds
    store. ``device`` None means the card when there is one; ``devices``
    (None: every visible CUDA device, or the CPU) are the devices of the
    ``space_shards`` mesh, and a list that repeats a device gives virtual
    shards on it. ``stats``, when a dict, receives ``hessian``: the PCG's
    Hessian, "psf", "psf space mesh (nb, ns)" or "vis".

    While a torch profiler runs (utils/profiling.py) the call is span
    ``fluxmop.call``, with children ``fluxmop.cubes``, ``.plan`` (its
    ``which``: "exact" for the residual's operator, "pcg" for the
    vis-space solve's, inside ``fluxmop.pcg``), ``.pcg``, ``.residual``
    and ``.host``."""
    device = as_device(device)
    with span("fluxmop.cubes"):
        dds_name = None
        if ddsi is None:
            dds_name = f"{output_filename}_{product.upper()}_{suffix}.dds"
            dds = dstore.read_store(dds_name)
        else:
            dds = ddsi
            if output_filename is not None:
                dds_name = \
                    f"{output_filename}_{product.upper()}_{suffix}.dds"
                if not dstore.store_exists(dds_name):
                    dstore.write_store(dds_name, dds)

        freqs_out = np.unique([ds["freq_out"] for ds in dds])
        nband = freqs_out.size if nband is None else nband
        dirty, model, residual, psf, psfhat, beam, wsums, _ = dds2cubes(
            dds, nband, apparent=False, modelname=model_name)
        dtype = torch.float64 if dirty.dtype == np.float64 else \
            torch.float32
        wsum = wsums.sum()
        if residual is None:
            residual = dirty.copy()
        nx, ny = dirty.shape[-2:]
        lastsize = dds[0]["PSF"].shape[-1]

    def tens(a, dt=dtype):
        a = np.ascontiguousarray(a)
        count("copy.h2d_bytes", a.nbytes)
        count("sync.h2d")
        return torch.as_tensor(a).to(device=device, dtype=dt)

    # exact-residual operator built once
    with span("fluxmop.plan", which="exact"):
        hess0 = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                                 backend=backend, epsilon=epsilon,
                                 do_wgridding=do_wgridding, device=device)

    def hess_exact(m):
        return to_host(hess0(tens(m)))

    # mask handling (reference fluxmop.py:126-156)
    with span("fluxmop.host"):
        if mask is None:
            mask_im = np.ones((nx, ny), dirty.dtype)
        elif isinstance(mask, str) and mask == "model":
            mask_im = np.any(model > min_model, axis=0).astype(dirty.dtype)
        else:
            mask_im = np.asarray(mask).astype(dirty.dtype)
            if zero_model_outside_mask:
                model[:, mask_im < 1] = 0
                residual = dirty - hess_exact(model)

    with span("fluxmop.pcg"):
        bm = tens(beam * mask_im[None])
        b = bm * tens(residual)

        if use_psf:
            ctype = torch.complex128 if dtype == torch.float64 else \
                torch.complex64
            A, route = _psf_hessian_maybe_space(
                bm, tens(psfhat, ctype), lastsize, sigmainv, band_chunk,
                nband, nx, space_shards, devices)
            update = pcg_bands(A, b, tol=cg_tol, maxit=cg_maxit,
                               minit=cg_minit, backtrack=backtrack,
                               verbosity=cg_verbose,
                               report_freq=cg_report_freq)
        else:
            with span("fluxmop.plan", which="pcg"):
                A = make_hessian_dds(dds, nband, wsum, nx, ny,
                                     sigmainv=np.sqrt(sigmainv),
                                     mask_image=mask_im, use_beam=False,
                                     backend=backend, epsilon=epsilon,
                                     do_wgridding=do_wgridding,
                                     device=device)
            update = pcg(A, b, tol=cg_tol, maxit=cg_maxit, minit=cg_minit,
                         backtrack=backtrack, verbosity=cg_verbose,
                         report_freq=cg_report_freq)
            route = "vis"
        if stats is not None:
            stats["hessian"] = route

        update = to_host(update)
    with span("fluxmop.host"):
        modelp = model.copy()
        model = model + gamma * update
    with span("fluxmop.residual"):
        residual = dirty - hess_exact(model)

    with span("fluxmop.host"):
        if verbose:
            rmfs = residual.sum(axis=0)
            log.info(f"fluxmop: peak residual = {np.abs(rmfs).max():.3e}, "
                     f"rms = {np.std(rmfs):.3e}")

        if write and dds_name is not None:
            for i, ds in enumerate(dds):
                bnd = ds["bandid"]
                arrays = {"RESIDUAL": residual[bnd] * wsum,
                          "MODEL": model[bnd],
                          "MODELP": modelp[bnd],
                          "UPDATE": update[bnd]}
                dstore.update_ds(dds_name, i, arrays)
                ds.update(arrays)

        # fits products (reference fluxmop.py fits-mfs/fits-cubes options)
        if (fits_mfs or fits_cubes) and output_filename is not None:
            from pfb_tpu_torch.utils.fits import dds2fits, dds2fits_mfs
            base = f"{output_filename}_{product.upper()}_{suffix}"
            for col, norm in (("RESIDUAL", True), ("MODEL", False),
                              ("UPDATE", False)):
                if fits_mfs:
                    dds2fits_mfs(dds, col, base, norm_wsum=norm)
                if fits_cubes:
                    dds2fits(dds, col, base, norm_wsum=norm)

    return model, residual


def _psf_hessian_maybe_space(bm, psfhat, lastsize, sigmainv, band_chunk,
                             nband, nx, space_shards, devices):
    """A for the PCG forward step: the single-program PSF Hessian, or,
    when ``space_shards`` > 1 and the device and shape conditions hold,
    the band- and space-sharded distributed-rFFT2 Hessian
    (parallel/dist.py:hessian_psf_space_dist, method "fft": no K10) over
    a (len(devices) // space_shards, space_shards) mesh. The PCG itself
    runs on the gathered cube: the JAX package's solve on arrays laid out
    ("band", "space", None) computes the same numbers, and the port's
    mesh is single-process. Returns (A, route), route "psf space mesh
    (nb, ns)" or "psf" (the single program, with a warning where
    ``space_shards`` > 1 could not be met)."""
    ns = int(space_shards) if space_shards else 0
    if ns > 1:
        from pfb_tpu_torch.parallel.mesh import default_devices
        devs = default_devices() if devices is None else \
            [torch.device(d) for d in devices]
        ndev = len(devs)
        nb_ax = max(1, ndev // ns)
        if ns * nb_ax <= ndev and nx % ns == 0 and nband % nb_ax == 0:
            from pfb_tpu_torch.parallel.dist import (hessian_psf_space_dist,
                                                     prep_psfhat_space)
            from pfb_tpu_torch.parallel.mesh import make_mesh
            log.info("fluxmop: space-sharding the PCG forward step "
                     "over a (%d band x %d space) mesh", nb_ax, ns)
            mesh = make_mesh(nband=nb_ax, nspace=ns,
                             devices=devs[:nb_ax * ns])
            hd = hessian_psf_space_dist(mesh, lastsize, sigmainv=0.0)
            php = prep_psfhat_space(psfhat, ns)

            def A(x):
                out = bm * hd(x * bm, php).gather(bm.device)
                return out + x * sigmainv if sigmainv else out

            return A, f"psf space mesh ({nb_ax}, {ns})"
        log.warning(
            "fluxmop: space-shards=%d incompatible with %d device(s), "
            "nx=%d, nband=%d — using the single-program Hessian",
            ns, ndev, nx, nband)

    def A(x):
        return hessian_psf_cube(x, psfhat, beam=bm, lastsize=lastsize,
                                sigmainv=sigmainv, band_chunk=band_chunk)

    return A, "psf"
