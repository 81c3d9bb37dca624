"""fwdbwd worker: generalised forward-backward with a nonlinear model
parametrisation x = f(s) (counterpart of pfb_tpu/workers/fwdbwd.py;
reference design pfb/workers/fwdbwd.py:23-474). Per major iteration:

  1. linearised Hessian H_s(v) = 2 dF.H(PSF(dF v)) + sigmainv v around
     the current parameter s (fwdbwd.py:297-299)
  2. power method on H_s for the step size (warm-started)
  3. PCG forward step: H_s delx = dF.H(2 residual)
  4. mode-removal trick for non-identity parametrisations
     (fwdbwd.py:353-364), on the host
  5. primal-dual backward step toward s + gamma delx with the SARA l21
     prior
  6. model = f(s), exact residual, PARAM/MODEL/DUAL/RESIDUAL writeback.

The loop runs in torch on ``device``: the PSF Hessian is torch.fft
(ops/psf.py:make_psf_convolve), as the JAX package's is XLA's FFT; the
exact residual is ``make_hessian_dds`` (for ``backend="pg"`` the spread
K4, the fold K5, the degrid K6 and the transforms K3c / K3r by route).
The ``rscale`` probe draws ``np.random.default_rng(k)``, so both
packages use the same numbers.

Parametrisations (reference setup_parametrisation,
pfb/utils/misc.py:1378-1423): 'id' — frequency-correlated linear model
x = L s (L the Cholesky factor of a squared-exponential band
covariance); 'exp' — correlated log-normal x = exp(L s).
"""

import time
from functools import partial

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.ops.gridder import make_hessian_dds
from pfb_tpu_torch.ops.psf import make_psf_convolve
from pfb_tpu_torch.ops.psi import make_psi, psi_dot, psi_hdot
from pfb_tpu_torch.opt.pcg import pcg
from pfb_tpu_torch.opt.power_method import power_method
from pfb_tpu_torch.opt.primal_dual import primal_dual
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.logging import get_logger
from pfb_tpu_torch.workers.cubes import dds2cubes


def setup_parametrisation(mode="id", minval=1e-5, sigma=1.0, freq=None,
                          lscale=1.0):
    """(func, finv, dfunc, dhfunc) for x = f(s)
    (reference: pfb/utils/misc.py:1378-1423), on tensors of any device
    and dtype: L is made in float64 on the host and cast to its
    argument's."""
    nu = freq / np.mean(freq)
    nband = nu.size
    nudiffsq = (nu[:, None] - nu[None, :]) ** 2
    K = sigma**2 * np.exp(-nudiffsq / (2 * lscale**2))
    L64 = torch.as_tensor(np.linalg.cholesky(K + 1e-10 * np.eye(nband)))
    cache = {}

    def Lof(x):
        key = (x.device, x.dtype)
        if key not in cache:
            cache[key] = L64.to(device=x.device, dtype=x.dtype)
        return cache[key]

    def freqmul(A, x):
        return torch.einsum("ab,bxy->axy", A, x)

    def lsolve(x):
        return torch.linalg.solve_triangular(
            Lof(x), x.reshape(nband, -1), upper=False).reshape(x.shape)

    if mode == "id":
        def func(x):
            return freqmul(Lof(x), x)

        finv = lsolve

        def dfunc(x0, v):
            return freqmul(Lof(v), v)

        def dhfunc(x0, v):
            return freqmul(Lof(v).T, v)
    elif mode == "exp":
        def func(x):
            return torch.exp(freqmul(Lof(x), x))

        def finv(x):
            return torch.log(torch.clamp(torch.abs(lsolve(x)), min=minval))

        def dfunc(x0, v):
            return torch.exp(freqmul(Lof(x0), x0)) * freqmul(Lof(v), v)

        def dhfunc(x0, v):
            return freqmul(Lof(v).T, v * torch.exp(freqmul(Lof(x0), x0)))
    else:
        raise ValueError(f"Unknown parametrisation {mode}")
    return func, finv, dfunc, dhfunc


log = get_logger("FWDBWD")


def _std(t):
    """np.std of a tensor (population, as numpy)."""
    return float(torch.std(t, correction=0))


def _fwdbwd(ddsi=None, output_filename=None, product="I",
            suffix="main", nband=None, niter=5, tol=5e-4,
            parametrisation="id", sigmainv=1e-5, sigma21=None,
            rmsfactor=1.0, gamma=1.0, bases="self,db1,db2", nlevels=2,
            l1reweight_from=5, pm_tol=1e-4, pm_maxit=100,
            pm_verbose=0, pm_report_freq=100, cg_tol=1e-4,
            cg_maxit=100, cg_minit=5, cg_verbose=0, cg_report_freq=10,
            backtrack=True, pd_tol=1e-4, pd_maxit=300, pd_verbose=0,
            pd_report_freq=50, positivity=0, backend="dft",
            epsilon=1e-7, do_wgridding=True, mask=None,
            model_name="MODEL", write=True, verbose=1,
            fits_mfs=False, fits_cubes=False, restart=False, device=None,
            stats=None, **kw):
    """Returns (model, param, residual) as numpy arrays. ``device`` None
    means the card when there is one; ``stats``, when a dict, receives
    ``psinorm``, the per-iteration ``hessnorm`` and MFS residual ``rms``,
    and the seconds of the exact residuals (``t_exact``) and of the
    whole call (``t_loop``)."""
    device = as_device(device)
    t_start = time.perf_counter()
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
    dirty, model, residual, psf, psfhat, beam, wsums, _ = dds2cubes(
        dds, nband, apparent=False, modelname=model_name)
    wsum = wsums.sum()
    if residual is None:
        residual = dirty.copy()
    nx, ny = dirty.shape[-2:]
    dtype = torch.float64 if dirty.dtype == np.float64 else torch.float32
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64

    def tens(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)

    def host(t):
        return t.cpu().numpy()

    mask_im = None
    if mask is not None:
        mask_im = tens((np.any(model > 0, axis=0) if mask == "model"
                        else np.asarray(mask)).astype(dirty.dtype))

    # exact-residual operator built once
    hess = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                            backend=backend, epsilon=epsilon,
                            do_wgridding=do_wgridding, device=device)
    t_exact = [0.0]

    def exact_residual(m):
        t0 = time.perf_counter()
        r = dirty_t - hess(m)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_exact[0] += time.perf_counter() - t0
        return r

    lastsize = dds[0]["PSF"].shape[-1]
    psf_convolve = make_psf_convolve(tens(psfhat, ctype), lastsize)

    bases_t = tuple(bases.split(","))
    nbasis = len(bases_t)
    psi = make_psi(nx, ny, bases_t, nlevels)
    psiH = partial(psi_dot, psi=psi)
    psiF = partial(psi_hdot, psi=psi)

    # Psi Psi.H spectral norm (reference fwdbwd.py:247-259)
    psinorm, _ = power_method(lambda v: psiF(psiH(v)),
                              (nband, nx, ny), tol=pm_tol,
                              maxit=pm_maxit, dtype=dtype, device=device,
                              verbosity=pm_verbose,
                              report_freq=pm_report_freq)
    psinorm = float(psinorm)

    minval = float(np.median(model[model > 0])) if model.any() else 1e-5
    func, finv, dfunc, dhfunc = setup_parametrisation(
        mode=parametrisation, minval=minval, freq=freqs_out)

    dirty_t = tens(dirty)
    # initialise PARAM (reference fwdbwd.py:300-....)
    if "PARAM" in dds[0] and \
            dds[0].get("parametrisation") == parametrisation and \
            not restart:
        x = tens(np.stack([ds["PARAM"] for ds in
                           sorted(dds, key=lambda d: d["bandid"])]))
        model_t, res_t = tens(model), tens(residual)
    elif model.any() and not restart:
        x = finv(tens(model))
        model_t = func(x)
        res_t = exact_residual(model_t)
    else:
        x = torch.zeros_like(dirty_t)
        model_t = func(x)
        res_t = dirty_t.clone()

    dual = torch.zeros((nband, nbasis, psi.Nymax, psi.Nxmax), dtype=dtype,
                       device=device)
    l1weight = torch.ones((nbasis, psi.Nymax, psi.Nxmax), dtype=dtype,
                          device=device)

    hessbeta = None
    if stats is not None:
        stats.update(psinorm=psinorm, hessnorm=[], rms=[])
    if verbose:
        rmfs = res_t.sum(dim=0)
        log.info(f"fwdbwd iter 0: peak residual = "
                 f"{float(rmfs.abs().max()):.3e}, rms = {_std(rmfs):.3e}")

    for k in range(niter):
        xp = x
        df = partial(dfunc, xp)
        dhf = partial(dhfunc, xp)
        res_in = res_t if mask_im is None else res_t * mask_im[None]
        j = dhf(2.0 * res_in)
        sigmainv_k = max(_std(j), sigmainv)

        def hesspsf(v):
            return 2.0 * dhf(psf_convolve(df(v))) + v * sigmainv_k

        hessnorm, hessbeta = power_method(
            hesspsf, (nband, nx, ny), b0=hessbeta, tol=pm_tol,
            maxit=pm_maxit, dtype=dtype, device=device,
            verbosity=pm_verbose, report_freq=pm_report_freq)
        hessnorm = float(hessnorm)

        delx = pcg(hesspsf, j, tol=cg_tol, maxit=cg_maxit,
                   minit=cg_minit, backtrack=backtrack,
                   verbosity=cg_verbose, report_freq=cg_report_freq)

        # threshold scale (reference fwdbwd.py:339-348)
        tmpx = np.random.default_rng(k).standard_normal(dirty.shape)
        rscale = _std(hesspsf(tens(tmpx)))
        sig21 = rmsfactor * _std(j / rscale) \
            if sigma21 is None else sigma21

        if sig21:
            data = xp + gamma * delx
            dmode = 0.0
            if parametrisation != "id":
                # the histogram's mode on the host
                xp_h = host(xp)
                data_h = host(data)
                ref_arr = xp_h if xp_h.any() else data_h
                bedges = np.histogram_bin_edges(ref_arr.ravel(),
                                                bins="fd")
                dhist, _ = np.histogram(data_h.ravel(), bins=bedges)
                dmode = float(bedges[dhist.argmax()])
                data = data - dmode
                xp = xp - dmode

            def grad21(v, data=data):
                return hesspsf(v - data)

            xn, dual, l1weight, _ = primal_dual(
                xp, dual, sig21, psiH, psiF, hessnorm, l1weight,
                grad21, nu=psinorm, tol=pd_tol, maxit=pd_maxit,
                positivity=positivity, gamma=gamma,
                verbosity=pd_verbose, report_freq=pd_report_freq)
            x = xn + dmode
        else:
            x = xp + gamma * delx

        model_t = func(x)
        res_t = exact_residual(model_t)
        rmfs = res_t.sum(dim=0)
        rms = _std(rmfs)
        rmax = float(rmfs.abs().max())
        eps = float(torch.linalg.vector_norm(x - xp)
                    / torch.linalg.vector_norm(x))
        if stats is not None:
            stats["hessnorm"].append(hessnorm)
            stats["rms"].append(rms)
        if verbose:
            log.info(f"fwdbwd iter {k + 1}: peak residual = {rmax:.3e}, "
                     f"rms = {rms:.3e}, eps = {eps:.3e}")

        if write and dds_name is not None:
            dual_np, x_np = host(dual), host(x)
            model_np, res_np = host(model_t), host(res_t)
            for i, ds in enumerate(dds):
                b = ds["bandid"]
                arrays = {"RESIDUAL": res_np[b] * wsum,
                          "MODEL": model_np[b], "DUAL": dual_np[b],
                          "PARAM": x_np[b]}
                attrs = {"parametrisation": parametrisation}
                dstore.update_ds(dds_name, i, arrays, attrs)
                ds.update(arrays)
                ds.update(attrs)

        if eps < tol:
            if verbose:
                log.info(f"fwdbwd: converged after {k + 1} iterations")
            break

    model, x, residual = host(model_t), host(x), host(res_t)

    # fits products (reference fwdbwd.py fits-mfs/fits-cubes options)
    if (fits_mfs or fits_cubes) and output_filename is not None:
        from pfb_tpu_torch.utils.fits import dds2fits, dds2fits_mfs
        base = f"{output_filename}_{product.upper()}_{suffix}"
        for col, norm in (("RESIDUAL", True), ("MODEL", False)):
            if fits_mfs:
                dds2fits_mfs(dds, col, base, norm_wsum=norm)
            if fits_cubes:
                dds2fits(dds, col, base, norm_wsum=norm)

    if stats is not None:
        stats.update(t_exact=t_exact[0],
                     t_loop=time.perf_counter() - t_start)
    return model, x, residual
