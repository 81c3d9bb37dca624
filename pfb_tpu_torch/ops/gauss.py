"""Gaussian-process operator: squared-exponential FFT convolution and
Kronecker covariance matvecs (counterpart of pfb_tpu/ops/gauss.py;
reference pfb/operators/gauss.py and the kron helpers of
pfb/utils/misc.py:63-93), used by the fwdbwd nonlinear parametrisation
(correlated log-normal fields).

The kernels and covariance factors are built with numpy on the host;
the convolution and the matvecs run in torch on the device of their
input."""

import numpy as np
import torch

from pfb_tpu_torch.ops.fft import make_psfhat, psf_convolve_cube
from pfb_tpu_torch.utils.misc import kron_matvec


def make_kernel(nx_psf, ny_psf, sigma0, length_scale):
    """Squared-exponential kernel image centred on the padded grid
    (reference gauss.py make_kernel)."""
    v = np.arange(-nx_psf // 2, nx_psf // 2)
    u = np.arange(-ny_psf // 2, ny_psf // 2)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    return (sigma0**2 * np.exp(-(uu**2 + vv**2) /
                               (2 * length_scale**2)))


def sq_exp_kernel(x, xp, sigmaf, l):
    """Squared-exponential covariance matrix K(x, x')."""
    xx = np.abs(x[:, None] - xp[None, :])
    return sigmaf**2 * np.exp(-xx**2 / (2 * l**2))


class Gauss:
    """FFT convolution with a squared-exponential kernel + Kronecker
    (band x X x Y) covariance matvec/inverse
    (reference: pfb/operators/gauss.py:11-115). The factors live on
    ``device`` (None: the CPU) in float64."""

    def __init__(self, sigma0, nband, nx, ny, length_scale=1.0,
                 device=None):
        self.nband, self.nx, self.ny = nband, nx, ny
        dev = torch.device("cpu") if device is None else torch.device(device)
        nx_psf = 2 * nx
        ny_psf = 2 * ny
        kern = make_kernel(nx_psf, ny_psf, sigma0, length_scale)
        self.khat = make_psfhat(torch.as_tensor(kern[None]).to(dev))
        self.lastsize = ny_psf

        # Kronecker factors for the covariance
        tb = np.arange(nband) / max(nband - 1, 1) if nband > 1 else \
            np.zeros(1)
        tx = np.arange(nx) / (nx - 1)
        ty = np.arange(ny) / (ny - 1)
        self.Kv = sq_exp_kernel(tb, tb, sigma0, 0.25) + \
            1e-10 * np.eye(nband)
        self.Kx = sq_exp_kernel(tx, tx, 1.0, length_scale / nx) + \
            1e-10 * np.eye(nx)
        self.Ky = sq_exp_kernel(ty, ty, 1.0, length_scale / ny) + \
            1e-10 * np.eye(ny)
        Ks = (self.Kv, self.Kx, self.Ky)

        def tens(a):
            return torch.as_tensor(a).to(dev)

        self.K = tuple(tens(Kd) for Kd in Ks)
        self.Kinv = tuple(tens(np.linalg.inv(Kd)) for Kd in Ks)
        self.L = tuple(tens(np.linalg.cholesky(Kd)) for Kd in Ks)

    def convolve(self, x):
        """FFT convolution with the SE kernel (per band)."""
        khat = self.khat.to(x.device).expand(
            (x.shape[0],) + self.khat.shape[1:])
        return psf_convolve_cube(x, khat, self.lastsize)

    def dot(self, x):
        """Covariance matvec K x (Kronecker)."""
        return kron_matvec(self.K, x)

    def idot(self, x):
        """Inverse covariance matvec K^-1 x."""
        return kron_matvec(self.Kinv, x)

    def sqrtdot(self, xi):
        """Sample transform L xi with K = L L.T."""
        return kron_matvec(self.L, xi)
