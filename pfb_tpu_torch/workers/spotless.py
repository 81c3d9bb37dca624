"""spotless worker: SARA wavelet-sparsity deconvolution (counterpart of
pfb_tpu/workers/spotless.py:_spotless).

Image-space PSF Hessian, power-method spectral norm, SARA dictionary,
per-major-iteration primal-dual backward step with positivity, exact
vis-space residual, l1 reweighting from ``l1reweight_from``, divergence
guard and MODEL/DUAL/RESIDUAL/MODEL_BEST writeback for resume.

``engine="pallas"`` routes as the JAX package does. On 128-aligned image
and PSF shapes it takes ops/psf.py:make_psf_convolve_pallas: where the
JAX package runs its v3 pipeline (psf = 2x image, v3_supported) that is
the kernel K1 with the fused power method and primal-dual solver; on
every other 128-aligned shape it is the general kernel K11 with the host
power method and ``primal_dual_hostloop``. Other shapes fall back to the
fft operator with a logged warning and still take
``primal_dual_hostloop``. ``_spotless_dist`` is not ported yet.
"""

from functools import partial

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.ops.gridder import make_hessian_dds
from pfb_tpu_torch.ops.psf import make_psf_convolve, make_psf_convolve_pallas
from pfb_tpu_torch.ops.psi import make_psi, psi_dot, psi_hdot
from pfb_tpu_torch.opt.power_method import (make_power_method_fused,
                                            power_method)
from pfb_tpu_torch.opt.primal_dual import (l1reweight_func,
                                           make_primal_dual_fused,
                                           primal_dual,
                                           primal_dual_hostloop)
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.logging import get_logger
from pfb_tpu_torch.utils.misc import fitcleanbeam
from pfb_tpu_torch.workers.cubes import dds2cubes

log = get_logger("SPOTLESS")


def _spotless(ddsi=None, output_filename=None, product="I",
              suffix="main", nband=None, niter=5, tol=5e-4,
              rmsfactor=1.0, init_factor=0.5, gamma=1.0,
              bases="self,db1,db2", nlevels=3, l1reweight_from=5,
              alpha=4.0, hessnorm=None, pm_tol=1e-5, pm_maxit=100,
              pm_verbose=0, pm_report_freq=100, pd_tol=1e-5, pd_maxit=500,
              pd_verbose=0, pd_report_freq=50, positivity=1,
              epsilon=1e-7, do_wgridding=True, backend="dft",
              engine="fft", plane_block=0, diverge_count=3, write=True,
              band_chunk=None, verbose=1, device=None, stats=None, **kw):
    """Returns (model, residual_cube) as numpy arrays and writes back
    into the dds store. ``stats``, when a dict, receives ``hessnorm``,
    ``engine`` (the operator that ran: "pallas" for the kernels, "fft"),
    ``pd_solver`` ("fused", "primal_dual_hostloop" or "primal_dual") and
    per-major-iteration ``rms``, ``rmax`` and ``pd_iters``."""
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
    nx_psf, ny_psf = dds[0]["PSF"].shape[-2:]

    dirty, model, residual, psf, psfhat, beam, wsums, dual = dds2cubes(
        dds, nband, apparent=False)
    dtype = torch.float64 if dirty.dtype == np.float64 else torch.float32
    wsum = wsums.sum()
    psf_mfs = psf.sum(axis=0)
    if not (psf_mfs.max() - 1.0) < 2 * epsilon:
        raise ValueError(f"PSF peak {psf_mfs.max()} is not 1 (reference "
                         "spotless.py:149)")
    if residual is None:
        residual = dirty.copy()
    residual_mfs = residual.sum(axis=0)
    iter0 = int(dds[0].get("niters", 0))

    def tens(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)

    aligned = nx % 128 == 0 and ny % 128 == 0 and nx_psf % 128 == 0 and \
        ny_psf % 128 == 0
    use_kernels = engine == "pallas" and aligned
    if use_kernels:
        # K1 where the JAX package runs v3, K11 elsewhere (no .apply)
        psf_convolve = make_psf_convolve_pallas(tens(psf), nx, ny)
    else:
        if engine == "pallas":
            log.warning(
                "engine='pallas' unsupported for shapes nx=%d ny=%d "
                "psf=%dx%d (needs 128-aligned); falling back to "
                "engine='fft' host-loop solvers", nx, ny, nx_psf, ny_psf)
        psf_convolve = make_psf_convolve(
            tens(psfhat, torch.complex128 if dtype == torch.float64
                 else torch.complex64), ny_psf, band_chunk=band_chunk)
    use_fused = hasattr(psf_convolve, "apply")
    # the JAX package's host loop for every engine="pallas" operator
    # without .apply (workers/spotless.py:206-215)
    pd_fn = primal_dual_hostloop if engine == "pallas" else primal_dual
    if stats is not None:
        stats.update(engine="pallas" if use_kernels else "fft",
                     pd_solver="fused" if use_fused else pd_fn.__name__,
                     rms=[], rmax=[], pd_iters=[])

    if hessnorm is None:
        gen = torch.Generator(device=device).manual_seed(42)
        if use_fused:
            pm = make_power_method_fused(psf_convolve.apply, tol=pm_tol,
                                         maxit=pm_maxit,
                                         verbosity=pm_verbose,
                                         report_freq=pm_report_freq)
            b0 = torch.randn((nband, nx, ny), generator=gen, dtype=dtype,
                             device=device)
            hessnorm, _ = pm(b0, psf_convolve.consts)
        else:
            hessnorm, _ = power_method(psf_convolve, (nband, nx, ny),
                                       tol=pm_tol, maxit=pm_maxit,
                                       generator=gen, dtype=dtype,
                                       device=device,
                                       verbosity=pm_verbose,
                                       report_freq=pm_report_freq)
        hessnorm = float(hessnorm) * 1.05  # reference spotless.py:193
    if stats is not None:
        stats["hessnorm"] = hessnorm
    if verbose:
        log.info(f"spotless: hessnorm = {hessnorm:.3e}")

    bases_t = tuple(bases.split(","))
    nbasis = len(bases_t)
    psi = make_psi(nx, ny, bases_t, nlevels)
    psiH = partial(psi_dot, psi=psi)
    psiF = partial(psi_hdot, psi=psi)

    GaussPar = fitcleanbeam(psf_mfs[None], level=0.5, pixsize=1.0)[0]
    pix_per_beam = GaussPar[0] * GaussPar[1] * np.pi / 4
    if verbose:
        log.info(f"spotless: pixels per beam = {pix_per_beam:.2f}")

    fsel = wsums > 0

    def coeff_rms(img_cube):
        tmp = img_cube.copy()
        tmp[fsel] *= wsum / wsums[fsel, None, None]
        coeffs = psiH(tens(tmp / pix_per_beam)).cpu().numpy()
        return np.std(coeffs.sum(axis=0), axis=(-1, -2))[:, None, None]

    rms_comps = coeff_rms(residual)

    if dual is None or dual.shape[1] != nbasis:
        dual = np.zeros((nband, nbasis, psi.Nymax, psi.Nxmax), dirty.dtype)
    if "L1WEIGHT" in dds[0]:
        l1weight = tens(np.asarray(dds[0]["L1WEIGHT"]))
    else:
        l1weight = torch.ones((nbasis, psi.Nymax, psi.Nxmax), dtype=dtype,
                              device=device)

    rms = np.std(residual_mfs)
    rmax = np.abs(residual_mfs).max()
    best_rms, best_rmax = rms, rmax
    best_model = model.copy()
    n_diverge = 0
    if verbose:
        log.info(f"spotless iter {iter0}: peak residual = {rmax:.3e}, "
                 f"rms = {rms:.3e}")

    hess = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                            backend=backend, epsilon=epsilon,
                            do_wgridding=do_wgridding,
                            plane_block=plane_block or None, device=device)

    if use_fused:
        pd_solve = make_primal_dual_fused(
            psf_convolve.apply, psiH, psiF, nbasis, rmsfactor, alpha=alpha,
            tol=pd_tol, maxit=pd_maxit, positivity=positivity, gamma=gamma,
            verbosity=pd_verbose, report_freq=pd_report_freq)

    dual_t = tens(dual)
    for k in range(iter0, iter0 + niter):
        modelp = model.copy()
        model_t = tens(model)
        data = tens(residual) + psf_convolve(model_t)
        rf = init_factor * rmsfactor if k == iter0 else rmsfactor
        do_rw = k + 1 - iter0 >= l1reweight_from

        if use_fused:
            rc = tens(rms_comps) if do_rw else \
                torch.ones((1, 1, 1), dtype=dtype, device=device)
            model_t, dual_t, l1weight, pd_iters = pd_solve(
                model_t, dual_t, data, l1weight, rf * rms, hessnorm, rc,
                psf_convolve.consts, do_reweight=do_rw)
        else:
            def grad21(x, data=data):
                return psf_convolve(x) - data

            reweighter = None
            if do_rw:
                rms_comps_t = tens(rms_comps)

                def reweighter(x):
                    return l1reweight_func(psiH, rmsfactor, rms_comps_t, x,
                                           alpha)
            model_t, dual_t, l1weight, pd_iters = pd_fn(
                model_t, dual_t, rf * rms, psiH, psiF, hessnorm, l1weight,
                grad21, reweighter=reweighter, nu=nbasis, tol=pd_tol,
                maxit=pd_maxit, positivity=positivity, gamma=gamma,
                verbosity=pd_verbose, report_freq=pd_report_freq)
        model = model_t.to(dtype).cpu().numpy()

        conv = hess(tens(model)).cpu().numpy()
        residual = dirty - conv
        residual_mfs = residual.sum(axis=0)

        rmsp = rms
        rms = np.std(residual_mfs)
        rmax = np.abs(residual_mfs).max()
        eps = np.linalg.norm(model - modelp) / np.linalg.norm(model)
        if rms < best_rms:
            best_rms, best_rmax = rms, rmax
            best_model = model.copy()
        if stats is not None:
            stats["rms"].append(float(rms))
            stats["rmax"].append(float(rmax))
            stats["pd_iters"].append(int(pd_iters))
        if verbose:
            log.info(f"spotless iter {k + 1}: peak residual = {rmax:.3e}, "
                     f"rms = {rms:.3e}, eps = {eps:.3e} "
                     f"(pd iters {int(pd_iters)})")

        if do_rw:
            rms_comps = coeff_rms(residual)

        if write and dds_name is not None:
            dual_np = dual_t.cpu().numpy()
            for i, ds in enumerate(dds):
                b = ds["bandid"]
                arrays = {"RESIDUAL": residual[b] * wsum,
                          "MODEL": model[b],
                          "DUAL": dual_np[b],
                          "MODEL_BEST": best_model[b]}
                if i == 0:
                    arrays["L1WEIGHT"] = l1weight.cpu().numpy()
                attrs = {"niters": k + 1, "best_rms": float(best_rms),
                         "best_rmax": float(best_rmax),
                         "parametrisation": "id"}
                dstore.update_ds(dds_name, i, arrays, attrs)
                ds.update(arrays)
                ds.update(attrs)

        if eps < tol:
            if verbose:
                log.info(f"spotless: converged after {k + 1} iterations")
            break
        if rms > rmsp:
            n_diverge += 1
            if n_diverge > diverge_count:
                log.info("spotless: algorithm diverging, terminating")
                break

    return model, residual
