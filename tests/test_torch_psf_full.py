"""pfb_tpu_torch's general PSF convolution (K11, ops/psf.py:
psf_convolve_full) and CG-fused PSF convolution (K2, psf_convolve_h_cg)
against pfb_tpu: the plain versions against the JAX Pallas kernels in
interpret mode, the full transfer function (ops/mmfft.py), and the
routing of make_psf_convolve_pallas.

Tolerances: 1e-5 relative between two float32 FFT pipelines (~1e-6 log
N); 1e-12 where both sides are float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops.mmfft import make_full_psfhat as make_full_psfhat_j
from pfb_tpu.ops.pallas_fft import (psf_convolve_pallas,
                                    psf_convolve_pallas_cube,
                                    psf_convolve_pallas_v3_cube_cg)
from pfb_tpu.ops.psf import make_psf_convolve_pallas as mpcp_j
from pfb_tpu.ops.psf import prep_pallas_hessian
from pfb_tpu_torch.ops.mmfft import make_full_psfhat
from pfb_tpu_torch.ops.psf import (h_from_jax_full, h_from_jax_v3,
                                   make_psf_convolve_pallas, prep_h_full,
                                   psf_convolve_full, psf_convolve_h_cg,
                                   psf_convolve_h_cg_plain)

torch.set_num_threads(1)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _psf(nb, n, seed=0):
    """(nb, n, n) PSF-like cube: a Gaussian main lobe, a spike at the
    centre and an odd ripple (complex transfer function)."""
    xg = np.arange(n) - n // 2
    xx, yy = np.meshgrid(xg, xg, indexing="ij")
    psf = np.zeros((nb, n, n))
    for b in range(nb):
        psf[b] = 0.4 * np.exp(-0.5 * (xx**2 + yy**2) / (3.0 + b) ** 2)
        psf[b, n // 2, n // 2] += 0.6
        psf[b] += 0.05 * np.sin(2 * np.pi * (xx + 2 * yy) / 37.0) * \
            np.exp(-0.5 * (xx**2 + yy**2) / 20.0**2)
    return psf


@pytest.mark.parametrize("shape", [(2, 192, 192), (1, 96, 160)])
def test_make_full_psfhat(shape):
    """Against the JAX package's float32 build (1e-6 of max) and, in
    float64, against torch.fft.fft2 (1e-12)."""
    psf = np.random.default_rng(0).normal(size=shape)
    hr_j, hi_j = make_full_psfhat_j(jnp.asarray(psf, jnp.float32))
    hr, hi = make_full_psfhat(torch.as_tensor(psf, dtype=torch.float32))
    scale = np.abs(np.asarray(hr_j)).max()
    assert np.abs(hr.numpy() - np.asarray(hr_j)).max() < 1e-6 * scale
    assert np.abs(hi.numpy() - np.asarray(hi_j)).max() < 1e-6 * scale
    hr, hi = make_full_psfhat(torch.as_tensor(psf))
    ref = torch.fft.fft2(torch.fft.ifftshift(torch.as_tensor(psf),
                                             dim=(-2, -1)))
    assert _rel(hr.numpy(), ref.real.numpy()) < 1e-12
    assert _rel(hi.numpy(), ref.imag.numpy()) < 1e-12


def test_k11_plain_matches_jax_pallas_cube():
    """nx = 64 at psf_oversize 3 (NX = NY = 192), a real PSF: the JAX
    band loop psf_convolve_pallas_cube on make_full_psfhat's transposed
    operands, in interpret mode."""
    nx = 64
    psf = _psf(2, 3 * nx).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(2, nx, nx)).astype(
        np.float32)
    hr_j, hi_j = make_full_psfhat_j(jnp.asarray(psf))
    HrT, HiT = jnp.swapaxes(hr_j, -1, -2), jnp.swapaxes(hi_j, -1, -2)
    out_j = np.asarray(psf_convolve_pallas_cube(
        jnp.asarray(x), HrT, HiT, nx, nx, lane_block=64, row_block=64,
        interpret=True))
    hr, hi = h_from_jax_full(HrT, HiT)
    out_t = psf_convolve_full(torch.as_tensor(x), torch.as_tensor(hr),
                              torch.as_tensor(hi))
    assert _rel(out_t.numpy(), out_j) < 1e-5
    # the port's own build of H gives the same operator
    hr_t, hi_t = prep_h_full(torch.as_tensor(psf), torch.float32)
    out_p = psf_convolve_full(torch.as_tensor(x), hr_t, hi_t)
    assert _rel(out_p.numpy(), out_j) < 1e-5


@pytest.mark.parametrize("nx,ny,NX,NY", [(64, 64, 192, 192),
                                         (96, 64, 128, 192)])
def test_k11_plain_matches_jax_pallas_random_h(nx, ny, NX, NY):
    """A random H that is not the transform of a real PSF (the kernel
    takes the real part of the product), one band through the JAX
    single-band pipeline; the second case has nx > NX / 2."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(nx, ny)).astype(np.float32)
    Hr, Hi = (rng.normal(size=(NX, NY)).astype(np.float32)
              for _ in range(2))
    out_j = np.asarray(psf_convolve_pallas(
        jnp.asarray(x), jnp.asarray(Hr.T), jnp.asarray(Hi.T), nx, ny,
        lane_block=64, row_block=64, interpret=True))
    hr, hi = h_from_jax_full(Hr.T[None], Hi.T[None])
    out_t = psf_convolve_full(torch.as_tensor(x)[None], torch.as_tensor(hr),
                              torch.as_tensor(hi))[0]
    assert _rel(out_t.numpy(), out_j) < 1e-5


def test_general_route_matches_jax():
    """make_psf_convolve_pallas outside v3 (psf = 3x image): both packages
    take the general pipeline, whose matvec has no .apply; with wsum and
    sigmainv, the port in float64 against JAX's float32 interpret run."""
    nx = 128
    psf = _psf(2, 3 * nx).astype(np.float32)
    x = np.random.default_rng(3).normal(size=(2, nx, nx))
    ws = np.array([1.0, 1.5])[:, None, None]
    conv_j = mpcp_j(jnp.asarray(psf), nx, nx, sigmainv=1e-2,
                    wsum=jnp.asarray(ws, jnp.float32))
    conv_t = make_psf_convolve_pallas(
        torch.as_tensor(psf, dtype=torch.float64), nx, nx, sigmainv=1e-2,
        wsum=torch.as_tensor(ws))
    assert not hasattr(conv_j, "apply") and not hasattr(conv_t, "apply")
    out_j = np.asarray(conv_j(jnp.asarray(x, jnp.float32)))
    out_t = conv_t(torch.as_tensor(x)).numpy()
    assert _rel(out_t, out_j) < 1e-5


def test_v3_route_exposes_apply_cg():
    """psf = 2x image on a v3 shape: K1 with .apply, and without a beam
    the CG-fused .apply_cg and .cg_scale, as in the JAX package."""
    nx = 128
    psf = torch.as_tensor(_psf(2, 2 * nx))
    conv = make_psf_convolve_pallas(psf, nx, nx, sigmainv=1e-2, wsum=2.0)
    assert hasattr(conv, "apply") and hasattr(conv, "apply_cg")
    assert conv.cg_scale == (2.0, 1e-2)
    assert make_psf_convolve_pallas(psf, nx, nx).cg_scale == (None, None)
    beam = torch.ones((2, nx, nx), dtype=torch.float64)
    assert not hasattr(make_psf_convolve_pallas(psf, nx, nx, beam=beam),
                       "apply_cg")


@pytest.mark.parametrize("real_transfer", [False, True])
def test_k2_plain_matches_jax_cg(real_transfer):
    """nx = 128, 2 bands: p, conv(p) and [p.conv(p), p.p] against
    psf_convolve_pallas_v3_cube_cg in interpret mode, complex and real
    H."""
    nb, nx = 2, 128
    rng = np.random.default_rng(4)
    psf = rng.normal(size=(nb, 2 * nx, 2 * nx)).astype(np.float32)
    phrT, phiT, rb = prep_pallas_hessian(jnp.asarray(psf), nx, nx,
                                         real_transfer=real_transfer)
    pp, r = (rng.normal(size=(nb, nx, nx)).astype(np.float32)
             for _ in range(2))
    beta = rng.uniform(0.1, 1.0, size=(nb, 1, 1)).astype(np.float32)
    out_j = psf_convolve_pallas_v3_cube_cg(
        jnp.asarray(pp), jnp.asarray(r), jnp.asarray(beta), phrT, phiT, nx,
        nx, row_block=rb, interpret=True)
    hr, hi = h_from_jax_v3(phrT, phiT, nx, nx)
    assert (hi is None) == real_transfer
    out_t = psf_convolve_h_cg(
        torch.as_tensor(pp), torch.as_tensor(r), torch.as_tensor(beta),
        torch.as_tensor(hr), None if hi is None else torch.as_tensor(hi))
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) < 1e-5


def test_wrappers_reject_mismatched_operands():
    x = torch.zeros((2, 64, 64))
    with pytest.raises(ValueError):  # NX < nx
        psf_convolve_full(x, torch.zeros((2, 48, 128)))
    with pytest.raises(ValueError):  # odd NX
        psf_convolve_full(x, torch.zeros((2, 129, 128)))
    h = torch.zeros((2, 65, 128))
    with pytest.raises(ValueError):  # beta not (nb, 1, 1)
        psf_convolve_h_cg(x, x, torch.zeros(2), h)
    p, conv, pap = psf_convolve_h_cg_plain(x, x, torch.zeros((2, 1, 1)), h,
                                           None)
    assert pap.shape == (2, 1, 2)
