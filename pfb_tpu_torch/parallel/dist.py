"""Distributed (band- and space-sharded) solver steps (counterpart of
pfb_tpu/parallel/dist.py).

The JAX package writes these as ``shard_map`` programs. Here each is
written in lockstep over the shards of a :class:`~.mesh.Mesh`: map over
the shards (:func:`~.mesh.smap`), then a collective along an axis
(parallel/collectives.py through :func:`~.mesh.along`), then map again.
The JAX package's ``lax.while_loop`` solvers become host loops with the
same condition, read every iteration. The communication is the JAX
package's:

- sums of scalars (norms, Rayleigh quotients, eps) over the mesh;
- the sum over "band" of the (nbasis, Nymax, Nxmax) band-sums of dual
  coefficients (the MFS prox ratio);
- on the space axis, the all-to-all transposes of the distributed
  convolutions and of the halo-exchange wavelet transform.

Cubes are (nband, nx, ny); a band-sharded cube is replicated over
"space", which on virtual shards of one device is one tensor and one
computation per band row.

Across processes (a mesh from ``set_client(coordinator=...)``) each
process runs the same host loop on its own shards, and the collectives of
the groups that cross processes move tensors between them; the sums stay
in mesh order, so a two-process run gives the one-process mesh's numbers.
The JAX package runs these across processes: the band-sharded Hessian,
power method, PCG and primal-dual, and the space-sharded Hessian. The
space-sharded primal-dual, whose halo wavelet transform indexes every
shard of its band row, runs in one process.

Engines of the PSF Hessian: ``"fft"`` (torch.fft on PSFHAT) and
``"pallas"`` (the name is the JAX package's): K1 per band shard
(ops/psf.py:psf_convolve_h) on the band-local steps, and K10
(psf_stage_cols_fwd / psf_stage_rows / psf_stage_cols_inv) with
all-to-all transposes between its stages on the space-sharded ones.
"""

import torch

from pfb_tpu_torch.config import kernel_dtype
from pfb_tpu_torch.ops.psf import (hessian_psf_cube, psf_convolve_h,
                                   psf_stage_cols_fwd, psf_stage_cols_inv,
                                   psf_stage_rows)
from pfb_tpu_torch.ops.psi import psi_dot, psi_hdot
from pfb_tpu_torch.parallel import collectives as coll
from pfb_tpu_torch.parallel.mesh import Sharded, along, as_sharded, smap

CUBE = ("band", None, None)
CUBE_S = ("band", "space", None)
COEFF = ("band", None, None, None)
COEFF_S = ("band", None, "space", None)
WSPEC = ()
WSPEC_S = (None, "space", None)
PSFHAT_S = ("band", None, "space")  # PSFHAT columns for the fft method


def _parts(a, mesh, spec, pad_value=0.0):
    return as_sharded(a, mesh, spec, pad_value=pad_value).parts


def _hargs(hargs):
    return hargs if isinstance(hargs, (tuple, list)) else (hargs,)


def _sum_over(mesh, axis, vals):
    return along(mesh, axis, coll.psum, vals)


def _scalar_sums(mesh, axis, fn, *lists):
    """Sum over ``axis`` of the per-shard scalars fn(*shard args)."""
    return _sum_over(mesh, axis, smap(fn, *lists))


def _band_parts(hargs, mesh):
    """Per-shard lists of the band-sharded transfer-function operands."""
    return [_parts(h, mesh, CUBE) for h in hargs]


def _hessian_engine(engine, *, lastsize=None, sigmainv=0.0):
    """Per-shard PSF-Hessian matvec of the band-sharded steps,
    ``local(x, hargs)`` on a shard's band block, with ``hargs`` the
    band-sharded transfer-function operands: ``(psfhat,)`` for engine
    "fft", ``(hr,)`` or ``(hr, hi)`` (ops/psf.py:prep_h, K1's H) for
    engine "pallas". The kernel runs in float32 on CUDA and in the cube's
    dtype on the CPU."""
    if engine == "pallas":
        def local(x, hargs):
            hi = hargs[1] if len(hargs) > 1 else None
            kdt = kernel_dtype(x.device, x.dtype)
            out = psf_convolve_h(x.to(kdt).contiguous(), hargs[0],
                                 hi).to(x.dtype)
            if sigmainv:
                out = out + x * sigmainv
            return out

        return local
    if engine != "fft":
        raise ValueError(f"unknown engine {engine!r}")
    if lastsize is None:
        raise ValueError("engine='fft' needs lastsize (the PSF's last "
                         "axis)")

    def local(x, hargs):
        return hessian_psf_cube(x, hargs[0], lastsize=lastsize,
                                sigmainv=sigmainv)

    return local


def hessian_psf_dist(mesh, lastsize=None, sigmainv=0.0, engine="fft"):
    """Band-sharded PSF-Hessian matvec, local per shard. The returned
    function takes ``(x, *hargs)`` (see :func:`_hessian_engine`) and
    returns the band-sharded result."""
    local = _hessian_engine(engine, lastsize=lastsize, sigmainv=sigmainv)

    def run(x, *hargs):
        x = as_sharded(x, mesh, CUBE)
        hs = _band_parts(hargs, mesh)
        out = smap(lambda xl, *h: local(xl, h), x.parts, *hs)
        return Sharded(mesh, CUBE, x.shape, out)

    return run


def power_method_dist(mesh, lastsize=None, tol=1e-5, maxit=200,
                      sigmainv=0.0, engine="fft"):
    """Distributed power method: local matvecs and band-summed norms
    (the JAX package's while_loop as a host loop with its condition
    ``eps > tol and k < maxit``). ``run(b0, *hargs)`` returns (beta, b)."""
    hess = _hessian_engine(engine, lastsize=lastsize, sigmainv=sigmainv)

    def run(b0, *hargs):
        b0 = as_sharded(b0, mesh, CUBE)
        hs = _band_parts(hargs, mesh)
        nrm = _scalar_sums(mesh, "band", lambda v: torch.sum(v * v),
                           b0.parts)
        b = smap(lambda v, n: v / torch.sqrt(n), b0.parts, nrm)
        beta = smap(lambda v: torch.ones((), dtype=v.dtype,
                                         device=v.device), b)
        eps, k = 1.0, 0
        while eps > tol and k < maxit:
            bnew = smap(lambda v, *h: hess(v, h), b, *hs)
            betap = beta
            num = _scalar_sums(mesh, "band", lambda p, q: torch.sum(p * q),
                               b, bnew)
            den = _scalar_sums(mesh, "band", lambda p: torch.sum(p * p), b)
            beta = smap(lambda p, q: p / q, num, den)
            nn = _scalar_sums(mesh, "band", lambda q: torch.sum(q * q),
                              bnew)
            b = smap(lambda q, n: q / torch.sqrt(n), bnew, nn)
            epsl = smap(lambda p, q: torch.abs(p - q) / q, beta, betap)
            eps = float(epsl[0])
            k += 1
        return beta[0], Sharded(mesh, CUBE, b0.shape, b)

    return run


def pcg_dist(mesh, lastsize=None, sigmainv=0.0, tol=1e-5, maxit=500,
             minit=10, engine="fft"):
    """Band-sharded PCG: the per-band systems are independent, so each
    shard runs :func:`pfb_tpu_torch.opt.pcg.pcg_bands` on its bands with
    no communication. ``run(b, x0, *hargs)``."""
    from pfb_tpu_torch.opt.pcg import pcg_bands

    hess = _hessian_engine(engine, lastsize=lastsize, sigmainv=sigmainv)
    M = (lambda x: x / sigmainv) if sigmainv > 0 else None

    def run(b, x0, *hargs):
        b = as_sharded(b, mesh, CUBE)
        hs = _band_parts(hargs, mesh)

        def local(bl, xl, *h):
            return pcg_bands(lambda x: hess(x, h), bl, x0=xl, M=M, tol=tol,
                             maxit=maxit, minit=minit)

        out = smap(local, b.parts, _parts(x0, mesh, CUBE), *hs)
        return Sharded(mesh, CUBE, b.shape, out)

    return run


def _dual_update_dist(mesh, vp, v, lam, sigma, weight):
    """MFS dual update with the band sum taken over the "band" shards,
    the one communication of the band-sharded primal-dual (reference
    get_ratio). Lists of per-shard tensors in and out."""
    vtilde = smap(lambda a, b: a + sigma * b, vp, v)
    gsum = _sum_over(mesh, "band", smap(lambda t: torch.sum(t, dim=0),
                                        vtilde))

    def scaled(vt, gs, w):
        vsum = torch.abs(gs) / sigma
        soft = torch.clamp(vsum - lam * w / sigma, min=0.0)
        nz = vsum != 0
        scale = torch.where(
            nz, 1.0 - soft / torch.where(nz, vsum, torch.ones_like(vsum)),
            torch.ones_like(vsum))
        return vt * scale[None]

    return smap(scaled, vtilde, gsum, weight)


def _apply_positivity_dist(mesh, xs, positivity):
    """Twin of opt.primal_dual.apply_positivity: mode 2 (zero every
    pixel where ANY band is <= 0) sums the any-band mask over the "band"
    shards, which a shard-local test would miss."""
    if positivity == 1:
        return smap(lambda x: torch.clamp(x, min=0.0), xs)
    if positivity == 2:
        msk = _sum_over(mesh, "band", smap(
            lambda x: torch.any(x <= 0.0, dim=0,
                                keepdim=True).to(torch.int32), xs))
        return smap(lambda x, m: torch.where(m > 0, torch.zeros_like(x), x),
                    xs, msk)
    return xs


def _pd_loop(mesh, xs, vs, ds, ws, rcs, psi_dot_l, psi_hdot_l, grad_l,
             norm_axis, lam, L, nu, tol, maxit, positivity, gamma,
             rmsfactor, alpha, maxreweight, do_reweight):
    """The primal-dual iteration of :func:`primal_dual_dist` and
    :func:`primal_dual_space_dist` on lists of shards: ``psi_dot_l``,
    ``psi_hdot_l`` and ``grad_l`` map shard lists to shard lists (with
    their own collectives); norms are summed over ``norm_axis``."""
    lam, L = float(lam), float(L)
    sigma = L / (2.0 * gamma) / nu
    tau = 0.9 / (L / (2.0 * gamma) + sigma * nu**2)

    def reweight(x):
        mfs = _sum_over(mesh, "band", smap(lambda a: torch.sum(a, dim=0),
                                           psi_dot_l(x)))
        return smap(lambda m, rc: (1 + rmsfactor) /
                    (1 + torch.abs(m)**alpha / rc**alpha), mfs, rcs)

    nrw, k, done = 0, 0, False
    while not done and k < maxit:
        vnew = _dual_update_dist(mesh, vs, psi_dot_l(xs), lam, sigma, ws)
        hd = psi_hdot_l(smap(lambda a, b: 2.0 * a - b, vnew, vs))
        g = grad_l(xs)
        xout = smap(lambda h, gr, d: h + (gr - d), hd, g, ds)
        xnew = _apply_positivity_dist(
            mesh, smap(lambda x, o: x - tau * o, xs, xout), positivity)
        num = _scalar_sums(mesh, norm_axis,
                           lambda a, b: torch.sum((a - b) ** 2), xnew, xs)
        den = _scalar_sums(mesh, norm_axis, lambda a: torch.sum(a * a),
                           xnew)
        eps = float(torch.sqrt(num[0] / (1e-12 + den[0])))
        converged = eps < tol
        do_rw = converged and do_reweight and nrw < maxreweight
        if do_rw:
            ws = reweight(xnew)
            nrw += 1
        done = converged and not do_rw
        xs, vs = xnew, vnew
        k += 1
    return xs, vs, ws, k


def primal_dual_dist(mesh, psi, lastsize=None, nu=None, tol=1e-5,
                     maxit=500, positivity=1, gamma=1.0, rmsfactor=1.0,
                     alpha=4.0, maxreweight=50, engine="fft"):
    """Band-sharded primal-dual backward step with the single-device
    solver's reweight-on-converge restart. Returns

        run(x, v, data, hargs, l1weight, lam, L, rms_comps=None,
            do_reweight=False) -> (x, v, l1weight, niters)

    with x, data (nband, nx, ny) and v (nband, nbasis, Nymax, Nxmax)
    band-sharded (tensors are laid out on the way in), ``hargs`` the
    engine's operand tuple (a bare PSFHAT for "fft"), l1weight and
    rms_comps (nbasis, Nymax, Nxmax) replicated."""
    hess = _hessian_engine(engine, lastsize=lastsize)
    if nu is None:
        nu = psi.nbasis

    def run(x, v, data, hargs, l1weight, lam, L, rms_comps=None,
            do_reweight=False):
        x = as_sharded(x, mesh, CUBE)
        v = as_sharded(v, mesh, COEFF)
        hs = _band_parts(_hargs(hargs), mesh)
        ds = _parts(data, mesh, CUBE)
        l1weight = as_sharded(l1weight, mesh, WSPEC)
        if rms_comps is None:
            rms_comps = torch.ones(l1weight.shape, dtype=l1weight.dtype)
        rcs = _parts(rms_comps, mesh, WSPEC)

        def grad_l(xs):
            return smap(lambda xl, *h: hess(xl, h), xs, *hs)

        xs, vs, ws, k = _pd_loop(
            mesh, x.parts, v.parts, ds, l1weight.parts, rcs,
            lambda xs: smap(lambda xl: psi_dot(xl, psi), xs),
            lambda a: smap(lambda al: psi_hdot(al, psi), a), grad_l, "band",
            lam, L, nu, tol, maxit, positivity, gamma, rmsfactor, alpha,
            maxreweight, do_reweight)
        return (Sharded(mesh, CUBE, x.shape, xs),
                Sharded(mesh, COEFF, v.shape, vs),
                Sharded(mesh, WSPEC, l1weight.shape, ws), k)

    return run


def coeff_rms_dist(mesh, psi, pix_per_beam):
    """Coefficient-space rms of a weighted residual cube, the MFS band
    sum taken over the shards (twin of the coeff_rms closure of
    workers/spotless.py). ``run(resid, bandw)`` with ``bandw`` (nband,)
    the per-band wsum / wsums weights -> (nbasis,) tensor."""
    def run(resid, bandw):
        rs = _parts(resid, mesh, CUBE)
        bw = _parts(bandw, mesh, ("band",))

        def local(r, w):
            coeffs = psi_dot(r * w[:, None, None] / pix_per_beam, psi)
            return torch.sum(coeffs, dim=0)

        mfs = _sum_over(mesh, "band", smap(local, rs, bw))
        return torch.std(mfs[0], dim=(-1, -2), correction=0)

    return run


# ---------------------------------------------------------------------
# space-sharded PSF Hessian


def prep_psfhat_space(psfhat, nspace):
    """PSFHAT for the distributed-FFT convolve: the spectral column axis
    zero-padded to a multiple of the space shard count (the all-to-all
    needs equal splits). Lay it out ("band", None, "space")."""
    nyw = psfhat.shape[-1]
    pad = nspace * (-(-nyw // nspace)) - nyw
    return torch.nn.functional.pad(torch.as_tensor(psfhat), (0, pad))


def _space_kernel_conv(xs, hargs, devs, sigmainv=0.0):
    """K10 across the shards of one band row (counterpart of
    _space_pallas_conv_local): xs are the row shards (nbl, nx / ps, ny)
    and hargs (hr[, hi]) lists of the H row shards (nbl, rows / ps, 2ny).

    rows -> (all-to-all) columns -> stage 1 -> (all-to-all) spectrum rows
    -> stage 2 -> (all-to-all) columns -> stage 3 -> (all-to-all) rows.
    Float32 on CUDA (the kernels' type), the cube's dtype on the CPU."""
    ps = coll.group_size(devs)
    nx, ny = xs[0].shape[1] * ps, xs[0].shape[2]
    NX, NY = 2 * nx, 2 * ny
    hr = hargs[0]
    hi = hargs[1] if len(hargs) > 1 else [None] * ps
    rows = hr[0].shape[1] * ps
    kdt = kernel_dtype(xs[0].device, xs[0].dtype)
    xc = coll.all_to_all([x.to(kdt) for x in xs], devs, 2, 1)
    z = [psf_stage_cols_fwd(x, NX, rows) for x in xc]
    del xc
    zr = coll.all_to_all([a for a, _ in z], devs, 1, 2)
    zi = coll.all_to_all([b for _, b in z], devs, 1, 2)
    del z
    w = [psf_stage_rows(a, b, h, g) for a, b, h, g in zip(zr, zi, hr, hi)]
    del zr, zi
    wr = coll.all_to_all([a for a, _ in w], devs, 2, 1)
    wi = coll.all_to_all([b for _, b in w], devs, 2, 1)
    del w
    oc = [psf_stage_cols_inv(a, b, nx, NX, NY) for a, b in zip(wr, wi)]
    del wr, wi
    out = coll.all_to_all(oc, devs, 1, 2)
    return [o.to(x.dtype) + x * sigmainv if sigmainv else o.to(x.dtype)
            for o, x in zip(out, xs)]


def _space_fft_conv(xs, psfhat_ps, devs, lastsize, sigmainv=0.0):
    """Distributed-rFFT2 PSF convolve across the shards of one band row
    (counterpart of _space_fft_conv_local): y transform of the owned
    rows, an all-to-all so the x transform is local, the product with the
    owned PSFHAT columns, the inverse x transform, an all-to-all back and
    the inverse y transform. The JAX package's band chunks (``nsplit``),
    which only let XLA overlap the collectives with compute, are left
    out: the lockstep mesh runs the collectives in turn either way."""
    ps = coll.group_size(devs)
    nyp = lastsize
    nyw = nyp // 2 + 1
    nxl, ny = xs[0].shape[-2:]
    nxp, nyw_l = psfhat_ps[0].shape[-2:]
    nx = nxl * ps
    pad = torch.nn.functional.pad
    xf = [pad(torch.fft.rfft(pad(x, (0, nyp - ny)), dim=-1),
              (0, nyw_l * ps - nyw)) for x in xs]
    xf = coll.all_to_all(xf, devs, 2, 1)          # (nbl, nx, nyw_l)
    xf = [torch.fft.ifft(torch.fft.fft(pad(f, (0, 0, 0, nxp - nx)),
                                       dim=-2) * p, dim=-2)[:, :nx]
          for f, p in zip(xf, psfhat_ps)]
    xf = coll.all_to_all(xf, devs, 1, 2)          # (nbl, nxl, nyw_l ps)
    out = [torch.fft.irfft(f[..., :nyw], n=nyp, dim=-1)[..., :ny]
           for f in xf]
    if sigmainv:
        out = [o + x * sigmainv for o, x in zip(out, xs)]
    return [o.to(x.dtype) for o, x in zip(out, xs)]


def _space_allgather_conv(xs, psfhats, devs, lastsize, sigmainv=0.0):
    """Gather the band row's image rows, convolve whole, keep the own
    rows (the all-gather method; O(cube) received per shard)."""
    nxl = xs[0].shape[1]
    r0 = coll.as_group(devs).first
    full = coll.all_gather(xs, devs, 1)
    out = smap(lambda f, p: hessian_psf_cube(f, p, lastsize=lastsize,
                                             sigmainv=sigmainv), full,
               psfhats)
    return [o[:, r * nxl:(r + 1) * nxl] for r, o in enumerate(out, r0)]


def _need_lastsize(lastsize, what):
    if lastsize is None:
        raise ValueError(f"{what} with the fft convolve needs lastsize (the "
                         "PSF's last axis); None would fail later inside "
                         "the FFT")


def _check_rows(nx, mesh):
    ps = mesh.shape["space"]
    if nx % ps:
        raise ValueError(
            f"image rows nx={nx} not divisible by the mesh space axis {ps} "
            "(required by the all-to-all / psum_scatter transposes)")


def hessian_psf_space_dist(mesh, lastsize=None, sigmainv=0.0, method="fft"):
    """Band- and space-sharded PSF-Hessian matvec: ``run(x, *hargs)``
    with x laid out ("band", "space", None), its rows divisible by the
    space axis.

    method "pallas": K10 with all-to-all transposes between its stages
    (:func:`_space_kernel_conv`); hargs (hr[, hi]) from
    ops/psf.py:prep_h_space, laid out ("band", "space", None).
    method "fft": the distributed rFFT2 convolve; hargs (PSFHAT padded by
    :func:`prep_psfhat_space`), laid out ("band", None, "space").
    method "allgather": each shard gathers its band row's image and
    convolves it whole; hargs (PSFHAT,) band-sharded."""
    if method == "pallas":
        def fn(xs, *rest):
            return _space_kernel_conv(xs, rest[:-1], rest[-1],
                                      sigmainv=sigmainv)
        hspec = CUBE_S
    elif method == "allgather":
        _need_lastsize(lastsize, "hessian_psf_space_dist")

        def fn(xs, p, devs):
            return _space_allgather_conv(xs, p, devs, lastsize,
                                         sigmainv=sigmainv)
        hspec = CUBE
    elif method == "fft":
        _need_lastsize(lastsize, "hessian_psf_space_dist")

        def fn(xs, p, devs):
            return _space_fft_conv(xs, p, devs, lastsize, sigmainv=sigmainv)
        hspec = PSFHAT_S
    else:
        raise ValueError(f"unknown method {method!r}")

    def run(x, *hargs):
        _check_rows(x.shape[1], mesh)
        x = as_sharded(x, mesh, CUBE_S)
        hs = [_parts(h, mesh, hspec) for h in hargs]
        return Sharded(mesh, CUBE_S, x.shape,
                       along(mesh, "space", fn, x.parts, *hs))

    return run


# ---------------------------------------------------------------------
# space-sharded primal-dual


def _psi_dot_space(xs, devs, psi, qy):
    """Gather method of the space-sharded SARA analysis: every shard
    gathers its band row's image, transforms it whole and keeps its qy
    packed coefficient rows. (nbl, nxl, ny) -> (nbl, nbasis, qy, Nxmax)."""
    ps = len(xs)
    full = coll.all_gather(xs, devs, 1)
    coeffs = smap(lambda f: torch.nn.functional.pad(
        psi_dot(f, psi), (0, 0, 0, qy * ps - psi.Nymax)), full)
    return [c[:, :, r * qy:(r + 1) * qy] for r, c in enumerate(coeffs)]


def _psi_hdot_space(als, devs, psi, qy):
    """Gather method of the synthesis: each shard zero-pads its packed
    rows back to the full layout and reconstructs (idwt is linear in the
    packed array), and a psum_scatter gives every shard its image rows
    summed over the coefficient shards."""
    ps = len(als)
    imgs = []
    for r, al in enumerate(als):
        full = torch.zeros(al.shape[:2] + (qy * ps, al.shape[-1]),
                           dtype=al.dtype, device=al.device)
        full[:, :, r * qy:(r + 1) * qy] = al
        imgs.append(psi_hdot(full[:, :, :psi.Nymax], psi))
    return coll.psum_scatter(imgs, devs, 1)


def primal_dual_space_dist(mesh, psi, lastsize=None, nu=None, tol=1e-5,
                           maxit=500, positivity=1, gamma=1.0,
                           rmsfactor=1.0, alpha=4.0, maxreweight=50,
                           psi_method="auto", engine="fft"):
    """Band- and space-sharded primal-dual backward step: the image cube
    laid out ("band", "space", None), the dual cube ("band", None,
    "space", None) over its packed coefficient rows, padded to qy per
    shard (qy = ceil(Nymax / nspace)).

    psi_method: "halo" (parallel/dwt_halo.py, the filter-length halo
    exchange and packed-aligned all-to-alls), "gather" (each shard
    transforms its band row's whole image), "auto" (halo where its shape
    preconditions hold, else gather).
    engine: "fft" (the distributed rFFT2 convolve; PSFHAT through
    :func:`prep_psfhat_space`; ``lastsize`` required) or "pallas" (K10;
    H through ops/psf.py:prep_h_space).

    Returns ``run(x, v, data, hargs, l1weight, lam, L, rms_comps=None,
    do_reweight=False) -> (x, v, l1weight, niters)``. v, l1weight and
    rms_comps may come unpadded; the v and l1weight returned are laid out
    padded (their ``gather()`` cuts the padding) and pass through the
    next call unchanged."""
    if engine == "fft":
        _need_lastsize(lastsize, "primal_dual_space_dist")
    elif engine != "pallas":
        raise ValueError(f"unknown engine {engine!r}")
    if mesh.nproc > 1:
        raise NotImplementedError(
            "primal_dual_space_dist runs in one process (its wavelet "
            "transforms index every shard of a band row)")
    if nu is None:
        nu = psi.nbasis
    ps = mesh.shape["space"]
    _check_rows(psi.nx, mesh)
    qy = -(-psi.Nymax // ps)

    halo_plan = None
    if psi_method in ("auto", "halo"):
        from pfb_tpu_torch.parallel.dwt_halo import make_halo_plan
        try:
            halo_plan = make_halo_plan(psi, ps, qy)
        except ValueError:
            if psi_method == "halo":
                raise
    elif psi_method != "gather":
        raise ValueError(f"unknown psi_method {psi_method!r}")

    if halo_plan is not None:
        from pfb_tpu_torch.parallel.dwt_halo import (halo_psi_dot,
                                                     halo_psi_hdot)

        def psi_dot_g(xs, devs):
            return halo_psi_dot(xs, devs, halo_plan)

        def psi_hdot_g(als, devs):
            return halo_psi_hdot(als, devs, halo_plan)
    else:
        def psi_dot_g(xs, devs):
            return _psi_dot_space(xs, devs, psi, qy)

        def psi_hdot_g(als, devs):
            return _psi_hdot_space(als, devs, psi, qy)

    if engine == "pallas":
        hspec = CUBE_S

        def conv(xs, *rest):
            return _space_kernel_conv(xs, rest[:-1], rest[-1])
    else:
        hspec = PSFHAT_S

        def conv(xs, p, devs):
            return _space_fft_conv(xs, p, devs, lastsize)

    def run(x, v, data, hargs, l1weight, lam, L, rms_comps=None,
            do_reweight=False):
        x = as_sharded(x, mesh, CUBE_S)
        v = as_sharded(v, mesh, COEFF_S)
        ds = _parts(data, mesh, CUBE_S)
        hs = [_parts(h, mesh, hspec) for h in _hargs(hargs)]
        l1weight = as_sharded(l1weight, mesh, WSPEC_S)
        if rms_comps is None:
            rms_comps = torch.ones(l1weight.shape, dtype=l1weight.dtype)
        # pad rows of rms_comps are ones: 0**alpha / 0**alpha would be nan
        rcs = _parts(rms_comps, mesh, WSPEC_S, pad_value=1.0)

        xs, vs, ws, k = _pd_loop(
            mesh, x.parts, v.parts, ds, l1weight.parts, rcs,
            lambda xs: along(mesh, "space", psi_dot_g, xs),
            lambda a: along(mesh, "space", psi_hdot_g, a),
            lambda xs: along(mesh, "space", conv, xs, *hs),
            ("band", "space"), lam, L, nu, tol, maxit, positivity, gamma,
            rmsfactor, alpha, maxreweight, do_reweight)
        return (Sharded(mesh, CUBE_S, x.shape, xs),
                Sharded(mesh, COEFF_S, v.shape, vs),
                Sharded(mesh, WSPEC_S, l1weight.shape, ws), k)

    run.psi_method = "gather" if halo_plan is None else "halo"
    return run


# ---------------------------------------------------------------------
# gridding on the mesh


def make_vis2dirty_rowdist(mesh, uvw, freq, *, nx, ny, cellx, celly,
                           epsilon=1e-7, do_wgridding=True, x0=0.0, y0=0.0,
                           axis="space", capacity=128):
    """Row-sharded R.H through the pg gridder: the visibility rows are
    split into equal blocks over the ``axis`` shards; each shard spreads
    and folds its rows into the (2 nw, Nx, Ny) grids (K4, K5), one sum
    over the axis adds the grids (the only communication, independent of
    the row count), and the w planes go to the image on the summed grids.
    Every shard's plan shares the global w geometry and tiles and is
    padded to one entry count.

    Returns ``(run, split)``: ``split(arr)`` lays a host (nrow, ...) array
    out as the per-shard (rows_per, ...) blocks (the ragged tail
    zero-padded) and ``run(vr, vi, wgt=None)`` gives the (nx, ny) dirty
    image (on shard 0's device)."""
    import numpy as np

    from pfb_tpu_torch.ops.pgridder import (_auto_tiles,
                                            _grid_to_image_from_plan,
                                            _spread_fold_from_plan,
                                            pgrid_plan, w_geometry)
    from pfb_tpu_torch.ops.wgridder import _grid_setup, kernel_params

    uvw = np.asarray(uvw)
    freq = np.asarray(freq)
    nsh = mesh.shape[axis]
    nrow = uvw.shape[0]
    rows_per = -(-nrow // nsh)
    k, _ = kernel_params(epsilon)
    wp = w_geometry(uvw, freq, nx, ny, cellx, celly, x0, y0, 2.0, k,
                    do_wgridding)
    tu = tv = None
    if nrow * freq.shape[0] >= (1 << 18):
        Nx_, Ny_ = _grid_setup(nx, ny, cellx, celly, 2.0)
        tu, tv = _auto_tiles(uvw, freq, Nx_, Ny_, cellx, celly, k, capacity)

    def block(s):
        u = uvw[s * rows_per:(s + 1) * rows_per]
        return np.pad(u, ((0, rows_per - u.shape[0]), (0, 0)))

    def plan(s, dev, nentries_to=None):
        return pgrid_plan(block(s), freq, nx=nx, ny=ny, cellx=cellx,
                          celly=celly, epsilon=epsilon,
                          do_wgridding=do_wgridding, capacity=capacity,
                          x0=x0, y0=y0, w_params=wp, tile_u=tu, tile_v=tv,
                          nentries_to=nentries_to, device=dev)

    keys = [(mesh.index(i, axis), str(d))
            for i, d in zip(mesh.local, mesh.devices)]
    built = {}
    for (s, _), d in zip(keys, mesh.devices):
        if (s, str(d)) not in built:
            built[(s, str(d))] = plan(s, d)
    nent = max(p["nentries"] for p in built.values())
    built = {key: p if p["nentries"] == nent else
             plan(key[0], torch.device(key[1]), nentries_to=nent)
             for key, p in built.items()}
    plans = [built[key] for key in keys]
    # the image step runs once per device with any of its plans (one
    # geometry)
    first = {}
    for p, d in zip(plans, mesh.devices):
        first.setdefault(str(d), p)
    rdt = plans[0]["rdtype"]

    def split(arr):
        a = torch.as_tensor(np.asarray(arr))
        a = torch.nn.functional.pad(
            a, [0, 0] * (a.dim() - 1) + [0, nsh * rows_per - nrow])
        blocks = {}
        out = []
        for (s, dkey), d in zip(keys, mesh.devices):
            if (s, dkey) not in blocks:
                blocks[(s, dkey)] = a[s * rows_per:(s + 1) * rows_per].to(
                    device=d, dtype=rdt)
            out.append(blocks[(s, dkey)])
        return out

    def run(vr, vi, wgt=None):
        ws = split(wgt) if wgt is not None else \
            split(np.ones((nrow, freq.shape[0])))
        folded = smap(_spread_fold_from_plan, plans, split(vr), split(vi),
                      ws)
        tot = along(mesh, axis, coll.psum, folded)
        imgs = smap(lambda f: _grid_to_image_from_plan(first[str(f.device)],
                                                       f), tot)
        return imgs[0]

    return run, split


def make_hessian_dds_dist(mesh, dds, nband, wsum, nx, ny, sigmainv=0.0,
                          use_beam=True, mask_image=None, backend="dft",
                          epsilon=1e-7, do_wgridding=True, plane_block=None):
    """Band-sharded exact vis-space Hessian over datasets (the
    distributed twin of ops/gridder.py:make_hessian_dds): each band shard
    holds its bands' datasets and applies R.H W R to its block with no
    communication. Shards of one band row on one device share one
    operator.

    backend "pg": the pg gridder over plans with one shared geometry
    (ops/pgridder.py:stack_pg_plans, K4-K6), or with ``plane_block`` and
    w-gridding the w-plane-blocked engine
    (ops/pg_stream.py:stack_pg_plans_wblocked, K7-K9). Every other backend
    runs the exact DFT, as in the JAX package (O(Npix Nvis): test scale
    only). ``matvec(x)`` returns the band-sharded result."""
    nb_mesh = mesh.shape["band"]
    if nband % nb_mesh:
        raise ValueError(f"nband {nband} not divisible by the mesh band "
                         f"axis {nb_mesh}")
    nbl = nband // nb_mesh
    wsum = float(wsum)

    def build(b, dev):
        bands = set(range(b * nbl, (b + 1) * nbl))
        band0 = b * nbl
        if backend == "pg":
            if plane_block and do_wgridding:
                from pfb_tpu_torch.ops.pg_stream import (
                    _consts, _hessian_pg_cube_local_wblocked,
                    stack_pg_plans_wblocked)
                st = stack_pg_plans_wblocked(
                    dds, nx=nx, ny=ny, epsilon=epsilon,
                    plane_block=int(plane_block), use_beam=use_beam,
                    mask_image=mask_image, bands=bands, device=dev)
                items = st["items"]
                if not items:
                    return None
                rdt = items[0][1]["p0"]["rdtype"]
                consts = _consts(items[0][1])

                def conv(x):
                    return _hessian_pg_cube_local_wblocked(
                        x.to(rdt), items, consts, band0=band0)
            else:
                from pfb_tpu_torch.ops.pgridder import (
                    _hessian_pg_cube_local, plan_consts, stack_pg_plans)
                st = stack_pg_plans(
                    dds, nx=nx, ny=ny, epsilon=epsilon,
                    do_wgridding=do_wgridding, use_beam=use_beam,
                    mask_image=mask_image, bands=bands, device=dev)
                if st["p0"] is None:
                    return None
                rdt = st["p0"]["rdtype"]
                consts = plan_consts(st["p0"])

                def conv(x):
                    return _hessian_pg_cube_local(x.to(rdt), st["items"],
                                                  consts, band0=band0)
        else:
            from pfb_tpu_torch.ops.gridder import (_hessian_stacked_local,
                                                   stack_dds)
            st = stack_dds(dds, nband, use_beam=use_beam,
                           mask_image=mask_image, bands=bands, device=dev)

            def conv(x):
                return _hessian_stacked_local(x, st, nx=nx, ny=ny,
                                              band0=band0)
        return conv

    ops = {}
    shard_ops = []
    for i, d in zip(mesh.local, mesh.devices):
        key = (mesh.index(i, "band"), str(d))
        if key not in ops:
            ops[key] = build(key[0], d)
        shard_ops.append(ops[key])

    def local(x, conv):
        out = (torch.zeros_like(x) if conv is None else
               conv(x).to(x.dtype)) / wsum
        if sigmainv:
            out = out + x * sigmainv**2
        return out

    def matvec(x):
        x = as_sharded(x, mesh, CUBE)
        return Sharded(mesh, CUBE, x.shape, smap(local, x.parts, shard_ops))

    return matvec
