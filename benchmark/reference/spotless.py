"""Plain spotless: SARA-regularised deconvolution in major cycles.

Each major cycle solves, from the model and the residual,
  argmin_x (xbar - x).H A (xbar - x) / 2 + lam ||Psi.H x||_21,  x >= 0,
with A the PSF convolution, xbar the data step, lam = rf * rms(residual
MFS) and the l21 norm over the band sum of each coefficient, by
Chambolle-Pock (sigma = L / (2 gamma) / nu, tau = 0.9 / (L / (2 gamma)
+ sigma nu^2), nu the number of bases, L 1.05 x the power method's
estimate of ||A||), then forms the exact residual dirty - R.H W R x /
wsum. The start vector of the power method is the system's documented
one: normal draws from a torch.Generator seeded 42 on the device, in
float32. ``Numerics`` sets the type and rounding of the arithmetic: the
reference is float64, the control float32 with every operand of the
transforms rounded to TF32.
"""

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from reference.sara import Sara


def tf32(x):
    """Round float32 values to TF32 (10 mantissa bits, to nearest
    even)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@dataclass
class Numerics:
    dtype: torch.dtype = torch.float64
    rnd: Callable = staticmethod(lambda t: t)


REFERENCE = Numerics()
CONTROL = Numerics(torch.float32, tf32)


def psf_operator(psf, nx, ny, num):
    """x (nb, nx, ny) -> crop(irfft2(rfft2(pad(x)) psfhat)), psfhat =
    rfft2(ifftshift(psf))."""
    NX, NY = psf.shape[-2:]
    psfhat = torch.fft.rfft2(torch.fft.ifftshift(
        num.rnd(psf.to(num.dtype)), dim=(-2, -1)))

    def A(x):
        xp = torch.nn.functional.pad(num.rnd(x.to(num.dtype)),
                                     (0, NY - ny, 0, NX - nx))
        return torch.fft.irfft2(torch.fft.rfft2(xp) * psfhat,
                                s=(NX, NY))[..., :nx, :ny]
    return A


def power_method(A, shape, device, dtype, tol=1e-5, maxit=100):
    gen = torch.Generator(device=device).manual_seed(42)
    b = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device).to(dtype)
    b = b / torch.linalg.vector_norm(b)
    beta = torch.ones((), dtype=dtype, device=device)
    eps, k = 1.0, 0
    while eps > tol and k < maxit:
        bnew = A(b)
        betap = beta
        beta = torch.sum(b * bnew) / torch.sum(b * b)
        b = bnew / torch.linalg.vector_norm(bnew)
        eps = float(torch.abs(beta - betap) / betap)
        k += 1
    return float(beta), k


def dual_update(vp, v, lam, sigma):
    """vt = vp + sigma v, shrunk by the soft threshold of |sum_b vt| /
    sigma at lam / sigma."""
    vt = vp + sigma * v
    s = vt.sum(dim=0).abs() / sigma
    soft = torch.clamp(s - lam / sigma, min=0.0)
    ratio = torch.where(s != 0, soft / torch.where(s != 0, s,
                                                   torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt * (1.0 - ratio)[None]


def primal_dual(x, v, data, A, psi, lam, L, maxit, num, gamma=1.0):
    nu = psi.nbasis
    sigma = L / (2.0 * gamma) / nu
    tau = 0.9 / (L / (2.0 * gamma) + sigma * nu ** 2)
    for _ in range(maxit):
        vnew = dual_update(v, psi.dot(num.rnd(x).to(num.dtype)), lam, sigma)
        xout = psi.hdot(num.rnd(2.0 * vnew - v).to(num.dtype)) + A(x) - data
        x = torch.clamp(x - tau * xout, min=0.0)
        v = vnew
    return x, v


def spotless(obs, niter=3, pd_maxit=100, rmsfactor=1.0, init_factor=0.5,
             bases=("self", "db1", "db2"), nlevels=3, tol=5e-4, pm_tol=1e-5,
             pm_maxit=100, num=REFERENCE):
    """The model and residual cubes (float64 numpy) after ``niter``
    majors of fixed ``pd_maxit`` iterations (pd tolerance 0), the first
    major's model and its exact-Hessian image, and the rms after each
    major, from an :class:`reference.imaging.Observation`."""
    dev = obs.device
    dt = num.dtype
    nb, nx, ny = obs.dirty.shape
    dirty = num.rnd(obs.dirty.to(dt))
    A = psf_operator(obs.psf, nx, ny, num)
    beta, pm_iters = power_method(A, (nb, nx, ny), dev, dt, pm_tol,
                                  pm_maxit)
    L = beta * 1.05
    psi = Sara(nx, ny, tuple(bases), nlevels)
    model = torch.zeros((nb, nx, ny), dtype=dt, device=dev)
    residual = dirty.clone()
    dual = torch.zeros((nb, sum(psi.sizes)), dtype=dt, device=dev)
    rms = float(torch.std(residual.sum(0).double(), correction=0))
    out = dict(rms=[], hessnorm=L, pm_iters=pm_iters)
    for k in range(niter):
        modelp = model
        data = residual + A(model)
        rf = init_factor * rmsfactor if k == 0 else rmsfactor
        model, dual = primal_dual(model, dual, data, A, psi, rf * rms, L,
                                  pd_maxit, num)
        conv = obs.hessian(model, num.rnd).to(dt)
        if k == 0:
            out["model1"] = model.double().cpu().numpy()
            out["hess1"] = conv.double().cpu().numpy()
        residual = dirty - conv
        rms = float(torch.std(residual.sum(0).double(), correction=0))
        out["rms"].append(rms)
        eps = float(torch.linalg.vector_norm(model - modelp) /
                    torch.linalg.vector_norm(model))
        if eps < tol:
            break
    out["dirty_max"] = float(obs.dirty.abs().max())
    out["model"] = model.double().cpu().numpy()
    out["residual"] = residual.double().cpu().numpy()
    return out


def compare(model, residual, ref):
    """The numbers that decide ``correct``: the model's l2 gap relative
    to the reference model's norm, and the residual's largest gap
    relative to the largest magnitude of the reference's dirty image
    (the scale of what the residual subtracts)."""
    m, r = ref["model"], ref["residual"]
    return dict(
        model_gap=float(np.linalg.norm(model - m) / np.linalg.norm(m)),
        resid_gap=float(np.abs(residual - r).max() / ref["dirty_max"]))
