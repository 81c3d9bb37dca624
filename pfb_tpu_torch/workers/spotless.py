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
``primal_dual_hostloop``.

:func:`_spotless_dist` runs the major cycle on a device mesh
(parallel/), with band and space sharding.
"""

from functools import partial

import numpy as np
import torch

from pfb_tpu_torch.config import as_device, kernel_dtype, to_host
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
from pfb_tpu_torch.utils.profiling import count, span, traced
from pfb_tpu_torch.workers.cubes import dds2cubes, write_deconv_fits

log = get_logger("SPOTLESS")


@traced("spotless.call")
def _spotless(ddsi=None, output_filename=None, product="I",
              suffix="main", nband=None, niter=5, tol=5e-4,
              rmsfactor=1.0, init_factor=0.5, gamma=1.0,
              bases="self,db1,db2", nlevels=3, l1reweight_from=5,
              alpha=4.0, hessnorm=None, pm_tol=1e-5, pm_maxit=100,
              pm_verbose=0, pm_report_freq=100, pd_tol=1e-5, pd_maxit=500,
              pd_verbose=0, pd_report_freq=50, positivity=1,
              epsilon=1e-7, do_wgridding=True, backend="dft",
              engine="fft", plane_block=0, diverge_count=3, write=True,
              band_chunk=None, verbose=1, fits_mfs=False, fits_cubes=False,
              device=None, stats=None, **kw):
    """Returns (model, residual_cube) as numpy arrays and writes back
    into the dds store (and, with an ``output_filename``, RESIDUAL and
    MODEL as FITS files for ``fits_mfs`` and ``fits_cubes``). ``stats``,
    when a dict, receives ``hessnorm``,
    ``engine`` (the operator that ran: "pallas" for the kernels, "fft"),
    ``pd_solver`` ("fused", "primal_dual_hostloop" or "primal_dual") and
    per-major-iteration ``rms``, ``rmax`` and ``pd_iters``.

    While a torch profiler runs (utils/profiling.py) the call is span
    ``spotless.call``, with children ``spotless.cubes``, ``.psf_prep``,
    ``.power_method``, ``.sara_setup``, ``.plan``, ``.pd_setup`` and,
    a major, ``spotless.major`` (children ``spotless.data``, ``.pd``,
    ``.residual``, ``.host``)."""
    device = as_device(device)
    with span("spotless.cubes"):
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
        nx, ny = dds[0]["DIRTY"].shape
        nx_psf, ny_psf = dds[0]["PSF"].shape[-2:]

        dirty, model, residual, psf, psfhat, beam, wsums, dual = \
            dds2cubes(dds, nband, apparent=False)
        dtype = torch.float64 if dirty.dtype == np.float64 else \
            torch.float32
        wsum = wsums.sum()
        psf_mfs = psf.sum(axis=0)
        if not (psf_mfs.max() - 1.0) < 2 * epsilon:
            raise ValueError(f"PSF peak {psf_mfs.max()} is not 1 "
                             "(reference spotless.py:149)")
        if residual is None:
            residual = dirty.copy()
        residual_mfs = residual.sum(axis=0)
        iter0 = int(dds[0].get("niters", 0))

    def tens(a, dt=dtype):
        a = np.ascontiguousarray(a)
        count("copy.h2d_bytes", a.nbytes)
        count("sync.h2d")
        return torch.as_tensor(a).to(device=device, dtype=dt)

    aligned = nx % 128 == 0 and ny % 128 == 0 and nx_psf % 128 == 0 and \
        ny_psf % 128 == 0
    use_kernels = engine == "pallas" and aligned
    with span("spotless.psf_prep"):
        if use_kernels:
            # K1 where the JAX package runs v3, K11 elsewhere (no .apply)
            psf_convolve = make_psf_convolve_pallas(tens(psf), nx, ny)
        else:
            if engine == "pallas":
                log.warning(
                    "engine='pallas' unsupported for shapes nx=%d ny=%d "
                    "psf=%dx%d (needs 128-aligned); falling back to "
                    "engine='fft' host-loop solvers", nx, ny, nx_psf,
                    ny_psf)
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
        with span("spotless.power_method"):
            gen = torch.Generator(device=device).manual_seed(42)
            if use_fused:
                pm = make_power_method_fused(psf_convolve.apply, tol=pm_tol,
                                             maxit=pm_maxit,
                                             verbosity=pm_verbose,
                                             report_freq=pm_report_freq)
                b0 = torch.randn((nband, nx, ny), generator=gen,
                                 dtype=dtype, device=device)
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

    with span("spotless.sara_setup"):
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
            coeffs = to_host(psiH(tens(tmp / pix_per_beam)))
            return np.std(coeffs.sum(axis=0), axis=(-1, -2))[:, None, None]

        rms_comps = coeff_rms(residual)

        if dual is None or dual.shape[1] != nbasis:
            dual = np.zeros((nband, nbasis, psi.Nymax, psi.Nxmax),
                            dirty.dtype)
        if "L1WEIGHT" in dds[0]:
            l1weight = tens(np.asarray(dds[0]["L1WEIGHT"]))
        else:
            l1weight = torch.ones((nbasis, psi.Nymax, psi.Nxmax),
                                  dtype=dtype, device=device)

        rms = np.std(residual_mfs)
        rmax = np.abs(residual_mfs).max()
        best_rms, best_rmax = rms, rmax
        best_model = model.copy()
        n_diverge = 0
        if verbose:
            log.info(f"spotless iter {iter0}: peak residual = {rmax:.3e}, "
                     f"rms = {rms:.3e}")

    with span("spotless.plan"):
        hess = make_hessian_dds(dds, nband, wsum, nx, ny, use_beam=False,
                                backend=backend, epsilon=epsilon,
                                do_wgridding=do_wgridding,
                                plane_block=plane_block or None,
                                device=device)

    with span("spotless.pd_setup"):
        if use_fused:
            pd_solve = make_primal_dual_fused(
                psf_convolve.apply, psiH, psiF, nbasis, rmsfactor,
                alpha=alpha, tol=pd_tol, maxit=pd_maxit,
                positivity=positivity, gamma=gamma, verbosity=pd_verbose,
                report_freq=pd_report_freq)
        dual_t = tens(dual)

    for k in range(iter0, iter0 + niter):
        with span("spotless.major", k=k):
            with span("spotless.data"):
                modelp = model.copy()
                model_t = tens(model)
                data = tens(residual) + psf_convolve(model_t)
                rf = init_factor * rmsfactor if k == iter0 else rmsfactor
                do_rw = k + 1 - iter0 >= l1reweight_from
                if use_fused:
                    rc = tens(rms_comps) if do_rw else \
                        torch.ones((1, 1, 1), dtype=dtype, device=device)
                elif do_rw:
                    rms_comps_t = tens(rms_comps)

            with span("spotless.pd"):
                if use_fused:
                    model_t, dual_t, l1weight, pd_iters = pd_solve(
                        model_t, dual_t, data, l1weight, rf * rms, hessnorm,
                        rc, psf_convolve.consts, do_reweight=do_rw)
                else:
                    def grad21(x, data=data):
                        return psf_convolve(x) - data

                    reweighter = None
                    if do_rw:
                        def reweighter(x):
                            return l1reweight_func(psiH, rmsfactor,
                                                   rms_comps_t, x, alpha)
                    model_t, dual_t, l1weight, pd_iters = pd_fn(
                        model_t, dual_t, rf * rms, psiH, psiF, hessnorm,
                        l1weight, grad21, reweighter=reweighter, nu=nbasis,
                        tol=pd_tol, maxit=pd_maxit, positivity=positivity,
                        gamma=gamma, verbosity=pd_verbose,
                        report_freq=pd_report_freq)

            with span("spotless.residual"):
                model = to_host(model_t.to(dtype))
                conv = to_host(hess(tens(model)))

            with span("spotless.host"):
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
                    log.info(f"spotless iter {k + 1}: peak residual = "
                             f"{rmax:.3e}, rms = {rms:.3e}, eps = {eps:.3e}"
                             f" (pd iters {int(pd_iters)})")

                if do_rw:
                    rms_comps = coeff_rms(residual)

                if write and dds_name is not None:
                    dual_np = to_host(dual_t)
                    for i, ds in enumerate(dds):
                        b = ds["bandid"]
                        arrays = {"RESIDUAL": residual[b] * wsum,
                                  "MODEL": model[b],
                                  "DUAL": dual_np[b],
                                  "MODEL_BEST": best_model[b]}
                        if i == 0:
                            arrays["L1WEIGHT"] = to_host(l1weight)
                        attrs = {"niters": k + 1,
                                 "best_rms": float(best_rms),
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

    with span("spotless.host"):
        write_deconv_fits(dds, output_filename, product, suffix, fits_mfs,
                          fits_cubes)
    return model, residual


def _spotless_dist(mesh=None, ddsi=None, output_filename=None, product="I",
                   suffix="main", nband=None, niter=5, tol=5e-4,
                   rmsfactor=1.0, init_factor=0.5, gamma=1.0,
                   bases="self,db1,db2", nlevels=3, l1reweight_from=5,
                   alpha=4.0, hessnorm=None, pm_tol=1e-5, pm_maxit=100,
                   pd_tol=1e-5, pd_maxit=500, positivity=1, epsilon=1e-7,
                   do_wgridding=True, backend="dft", engine="fft",
                   plane_block=0, space_shards=0, write=True, verbose=1,
                   stats=None, **kw):
    """Mesh-resident spotless major cycle (counterpart of
    pfb_tpu/workers/spotless.py:_spotless_dist). Returns (model,
    residual_cube) as numpy arrays.

    DIRTY, MODEL, DUAL and RESIDUAL stay band-sharded on the mesh
    (parallel/mesh.py; ``mesh`` None: every visible device, ``nspace =
    space_shards``) across the major iterations; the data step, the power
    method, the primal-dual backward step, the coefficient rms and the
    exact residual run on it (parallel/dist.py), communicating through
    sums over the shards. ``space_shards`` > 1 (the mesh's space axis)
    also shards the primal-dual step: image rows and the dual cube's
    packed rows, the halo-exchange Psi, and a space-distributed PSF
    convolution. The band-local steps run once per band row and device.

    Routing is the JAX package's. engine="pallas" runs K1 on the
    band-local steps where the PSF is twice the image and v3_supported
    holds, else everything falls back to "fft" (the dist path has no K11
    route). With nspace > 1 the primal-dual gradient runs K10 where
    v3_space_supported holds, else the distributed rFFT2 convolve.
    backend "pg" evaluates the exact residual through the pg gridder
    (plane_block: the w-plane-blocked engine); every other backend runs
    the exact DFT (test scale). ``stats``, when a dict, receives
    ``hessnorm``, ``engine`` (band-local steps), ``pd_engine`` (the
    primal-dual gradient: "pallas" K1 or K10, or "fft"), ``psi_method``
    and per major iteration ``rms``, ``rmax`` and ``pd_iters``."""
    from pfb_tpu_torch.ops.psf import (prep_h, prep_h_space, v3_space_supported,
                                       v3_supported)
    from pfb_tpu_torch.parallel.dist import (coeff_rms_dist,
                                             hessian_psf_dist,
                                             make_hessian_dds_dist,
                                             power_method_dist,
                                             prep_psfhat_space,
                                             primal_dual_dist,
                                             primal_dual_space_dist)
    from pfb_tpu_torch.parallel.mesh import Sharded, make_mesh, shard, smap

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

    if mesh is None:
        mesh = make_mesh(nspace=int(space_shards) or 1)
    elif space_shards and mesh.shape["space"] != int(space_shards):
        raise ValueError(
            f"explicit mesh has space axis {mesh.shape['space']} but "
            f"space_shards={space_shards} was also given; drop one")
    nb_mesh = mesh.shape["band"]
    nspace = mesh.shape["space"]
    if nband % nb_mesh:
        raise ValueError(f"nband {nband} not divisible by mesh band axis "
                         f"{nb_mesh}")
    if nspace > 1 and nx % nspace:
        raise ValueError(f"nx {nx} not divisible by mesh space axis "
                         f"{nspace}")
    pd_engine = engine
    if nspace > 1 and engine == "pallas" and \
            not v3_space_supported(nx, ny, nspace):
        log.info(f"spotless-dist: space-sharded engine='pallas' "
                 f"unsupported for image ({nx}, {ny}) on {nspace} space "
                 f"shards (needs ny divisible by nspace*128); falling back "
                 f"to engine='fft'")
        engine = pd_engine = "fft"

    dirty, model, residual, psf, psfhat, beam, wsums, dual = dds2cubes(
        dds, nband, apparent=False)
    dtype = torch.float64 if dirty.dtype == np.float64 else torch.float32
    wsum = wsums.sum()
    psf_mfs = psf.sum(axis=0)
    if residual is None:
        residual = dirty.copy()
    iter0 = int(dds[0].get("niters", 0))
    dev0 = mesh.devices[0]

    def tens(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev0,
                                                           dtype=dt)

    bands = ("band", None, None)
    dirty_d = shard(tens(dirty), mesh, bands)
    model_d = shard(tens(model), mesh, bands)
    resid_d = shard(tens(residual), mesh, bands)

    # the fused v3 engine needs psf_oversize 2 and v3_supported; say so
    # when it falls back (the dist path has no K11 route)
    if engine == "pallas" and not (nx_psf == 2 * nx and ny_psf == 2 * ny
                                   and v3_supported(nx, ny)):
        log.info(f"spotless-dist: engine='pallas' unsupported for image "
                 f"({nx}, {ny}) / psf ({nx_psf}, {ny_psf}) (needs "
                 f"psf_oversize=2 and v3_supported); falling back to "
                 f"engine='fft'")
        engine = pd_engine = "fft"
    kdt = kernel_dtype(dev0, dtype)
    if engine == "pallas":
        hr, hi = prep_h(tens(psf), nx, ny, kdt)
        hargs = (hr,) if hi is None else (hr, hi)
        hargs = tuple(shard(h, mesh, bands) for h in hargs)
        del hr, hi
        ekw = dict(engine="pallas")
    else:
        ekw = dict(engine="fft", lastsize=ny_psf)
        hargs = (shard(tens(psfhat, torch.complex128 if dtype ==
                            torch.float64 else torch.complex64), mesh,
                       bands),)

    psf_convolve = hessian_psf_dist(mesh, **ekw)
    if hessnorm is None:
        pm = power_method_dist(mesh, tol=pm_tol, maxit=pm_maxit, **ekw)
        b0 = np.random.default_rng(42).normal(
            size=(nband, nx, ny)).astype(dirty.dtype)
        beta, _ = pm(shard(tens(b0), mesh, bands), *hargs)
        hessnorm = float(beta) * 1.05  # reference spotless.py:193
    if verbose:
        log.info(f"spotless-dist: hessnorm = {hessnorm:.3e}")

    bases_t = tuple(bases.split(","))
    nbasis = len(bases_t)
    psi = make_psi(nx, ny, bases_t, nlevels)
    GaussPar = fitcleanbeam(psf_mfs[None], level=0.5, pixsize=1.0)[0]
    pix_per_beam = GaussPar[0] * GaussPar[1] * np.pi / 4

    fsel = wsums > 0
    bandw = np.ones(nband, dirty.dtype)  # empty bands pass through
    bandw[fsel] = wsum / wsums[fsel]
    bandw_d = shard(tens(bandw), mesh, ("band",))
    coeff_rms = coeff_rms_dist(mesh, psi, pix_per_beam)
    rms_comps = coeff_rms(resid_d, bandw_d).cpu().numpy()

    if dual is None or dual.shape[1] != nbasis:
        dual = np.zeros((nband, nbasis, psi.Nymax, psi.Nxmax), dirty.dtype)
    dual_d = shard(tens(dual), mesh, ("band", None, None, None))
    if "L1WEIGHT" in dds[0]:
        l1weight = np.asarray(dds[0]["L1WEIGHT"], dirty.dtype)
    else:
        l1weight = np.ones((nbasis, psi.Nymax, psi.Nxmax), dirty.dtype)
    l1w_d = tens(l1weight)

    pkw = dict(nu=nbasis, tol=pd_tol, maxit=pd_maxit, positivity=positivity,
               gamma=gamma, rmsfactor=rmsfactor, alpha=alpha)
    psi_method = "local"
    if nspace > 1:
        # primal-dual over ("band", "space"): K10 with all-to-all stage
        # transposes for engine "pallas", else the distributed rFFT2
        if engine == "pallas":
            hr_s, hi_s = prep_h_space(tens(psf), nx, ny, nspace, kdt)
            pd_h = tuple(shard(h, mesh, ("band", "space", None))
                         for h in ((hr_s,) if hi_s is None else
                                   (hr_s, hi_s)))
            del hr_s, hi_s
            pd = primal_dual_space_dist(mesh, psi, engine="pallas", **pkw)
        else:
            pd = primal_dual_space_dist(mesh, psi, ny_psf, **pkw)
            pd_h = shard(prep_psfhat_space(hargs[0].gather(), nspace), mesh,
                         ("band", None, "space"))
        psi_method = pd.psi_method
    else:
        pd = primal_dual_dist(mesh, psi, **pkw, **ekw)
        pd_h = hargs
    hess_exact = make_hessian_dds_dist(mesh, dds, nband, wsum, nx, ny,
                                       use_beam=False, backend=backend,
                                       epsilon=epsilon,
                                       do_wgridding=do_wgridding,
                                       plane_block=plane_block or None)
    if stats is not None:
        stats.update(hessnorm=hessnorm, engine=engine, pd_engine=pd_engine,
                     psi_method=psi_method, rms=[], rmax=[], pd_iters=[])

    residual_mfs = resid_d.gather().sum(dim=0).cpu().numpy()
    rms = np.std(residual_mfs)
    rmax = np.abs(residual_mfs).max()
    best_rms, best_rmax = rms, rmax
    best_model = model.copy()
    n_diverge = 0
    if verbose:
        log.info(f"spotless-dist iter {iter0}: peak residual = {rmax:.3e}, "
                 f"rms = {rms:.3e}")

    for k in range(iter0, iter0 + niter):
        modelp = model
        conv = psf_convolve(model_d, *hargs)
        data = smap(lambda r, c: r + c, resid_d.parts, conv.parts)
        data = Sharded(mesh, bands, resid_d.shape, data)
        del conv
        rf = init_factor * rmsfactor if k == iter0 else rmsfactor
        do_rw = k + 1 - iter0 >= l1reweight_from
        rc = tens(rms_comps[:, None, None] *
                  np.ones((1, psi.Nymax, psi.Nxmax), dirty.dtype)) \
            if do_rw else None
        model_d, dual_d, l1w_d, pd_iters = pd(
            model_d, dual_d, data, pd_h, l1w_d, rf * rms, hessnorm,
            rms_comps=rc, do_reweight=do_rw)
        del data
        conv = hess_exact(model_d)
        resid_d = Sharded(mesh, bands, dirty_d.shape,
                          smap(lambda a, c: a - c, dirty_d.parts,
                               conv.parts))
        del conv
        model = model_d.gather().to(dtype).cpu().numpy()
        residual_mfs = resid_d.gather().sum(dim=0).cpu().numpy()

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
            log.info(f"spotless-dist iter {k + 1}: peak residual = "
                     f"{rmax:.3e}, rms = {rms:.3e}, eps = {eps:.3e} "
                     f"(pd iters {int(pd_iters)})")

        if do_rw:
            rms_comps = coeff_rms(resid_d, bandw_d).cpu().numpy()

        if write and dds_name is not None:
            dual_np = dual_d.gather().cpu().numpy()
            residual = resid_d.gather().cpu().numpy()
            l1w_np = l1w_d.gather().cpu().numpy()
            for i, ds in enumerate(dds):
                b = ds["bandid"]
                arrays = {"RESIDUAL": residual[b] * wsum,
                          "MODEL": model[b],
                          "DUAL": dual_np[b],
                          "MODEL_BEST": best_model[b]}
                if i == 0:
                    arrays["L1WEIGHT"] = l1w_np
                attrs = {"niters": k + 1, "best_rms": float(best_rms),
                         "best_rmax": float(best_rmax),
                         "parametrisation": "id"}
                dstore.update_ds(dds_name, i, arrays, attrs)
                ds.update(arrays)
                ds.update(attrs)

        if eps < tol:
            if verbose:
                log.info(f"spotless-dist: converged after {k + 1} "
                         "iterations")
            break
        if rms > rmsp:
            n_diverge += 1
            if n_diverge > 3:
                log.info("spotless-dist: algorithm diverging, terminating")
                break

    return model, resid_d.gather().cpu().numpy()
