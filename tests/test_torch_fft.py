"""pfb_tpu_torch ops/fft.py, ops/mmfft.py:make_full_psfhat and
ops/psf.py:hessian_psf_slice against pfb_tpu on the same numpy inputs,
float64 on the CPU (the JAX package's own make_full_psfhat works in
float32, so that one is held at 1e-6 of max, and in float64 to the
port's unchunked result).

Shapes and oversampling are tests/test_fft_psf.py's; band_chunk runs at
None, 1 and 3 on 8 bands."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops import fft as fft_j
from pfb_tpu.ops import mmfft as mmfft_j
from pfb_tpu.ops import psf as psf_j
from pfb_tpu_torch.ops import fft as fft_t
from pfb_tpu_torch.ops import mmfft as mmfft_t
from pfb_tpu_torch.ops import psf as psf_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
T = torch.as_tensor
NBAND = 8


def _close(got, ref, tol):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(got) - ref).max() <= tol * np.abs(ref).max()


@pmp("shape", [(16, 16), (12, 16), (3, 16, 16)])
def test_fft2d_and_fft_cube_match_jax(shape):
    x = np.random.default_rng(1).normal(size=shape)
    _close(fft_t.fft2d(T(x)).numpy(), fft_j.fft2d(jnp.asarray(x)), 1e-10)
    _close(fft_t.fft_cube(T(x)).numpy(), fft_j.fft_cube(jnp.asarray(x)),
           1e-10)


def test_fft2d_axes_match_jax():
    x = np.random.default_rng(2).normal(size=(12, 3, 16))
    _close(fft_t.fft2d(T(x), axes=(0, 2)).numpy(),
           fft_j.fft2d(jnp.asarray(x), axes=(0, 2)), 1e-10)


@pmp("nx,ny,osf", [(16, 16, 2), (12, 16, 2)])
def test_psf_convolve_slice_matches_jax(nx, ny, osf):
    rng = np.random.default_rng(42)
    psf = rng.normal(size=(osf * nx, osf * ny))
    x = rng.normal(size=(nx, ny))
    ph_j = fft_j.make_psfhat(jnp.asarray(psf))
    ph_t = fft_t.make_psfhat(T(psf))
    _close(ph_t.numpy(), ph_j, 1e-10)
    out_j = fft_j.psf_convolve_slice(jnp.asarray(x), ph_j, osf * ny)
    out_t = fft_t.psf_convolve_slice(T(x), ph_t, osf * ny)
    assert out_t.shape == (nx, ny)
    _close(out_t.numpy(), out_j, 1e-10)


def _cube(seed=0, n=32):
    return np.random.default_rng(seed).normal(size=(NBAND, 2 * n, 2 * n))


@pmp("band_chunk", [None, 1, 3])
def test_make_psfhat_band_chunk_matches_jax(band_chunk):
    psf = _cube()
    got = fft_t.make_psfhat(T(psf), band_chunk=band_chunk).numpy()
    _close(got, fft_j.make_psfhat(jnp.asarray(psf), band_chunk=band_chunk),
           1e-10)
    _close(got, fft_t.make_psfhat(T(psf)).numpy(), 1e-12)


@pmp("band_chunk", [None, 1, 3])
def test_make_full_psfhat_band_chunk_matches_jax(band_chunk):
    psf = _cube(1)
    hr_j, hi_j = mmfft_j.make_full_psfhat(jnp.asarray(psf, jnp.float32),
                                          band_chunk=band_chunk)
    hr, hi = mmfft_t.make_full_psfhat(T(psf, dtype=torch.float32),
                                      band_chunk=band_chunk)
    scale = np.abs(np.asarray(hr_j)).max()
    assert np.abs(hr.numpy() - np.asarray(hr_j)).max() < 1e-6 * scale
    assert np.abs(hi.numpy() - np.asarray(hi_j)).max() < 1e-6 * scale
    hr, hi = mmfft_t.make_full_psfhat(T(psf), band_chunk=band_chunk)
    hr0, hi0 = mmfft_t.make_full_psfhat(T(psf))
    assert hr.dtype == torch.float64
    _close(hr.numpy(), hr0.numpy(), 1e-12)
    _close(hi.numpy(), hi0.numpy(), 1e-12)


@pmp("opts", ["plain", "beam", "wsum", "sigmainv", "all"])
def test_hessian_psf_slice_matches_jax_and_cube_band(opts):
    n = 16
    rng = np.random.default_rng(3)
    psf = _cube(4, n)[:3]
    x = rng.normal(size=(3, n, n))
    beam = rng.random((3, n, n)) + 0.5
    kw = {"plain": {}, "beam": dict(beam=beam), "wsum": dict(wsum=7.5),
          "sigmainv": dict(sigmainv=0.3),
          "all": dict(beam=beam, wsum=7.5, sigmainv=0.3)}[opts]
    ph_t = fft_t.make_psfhat(T(psf))
    ph_j = fft_j.make_psfhat(jnp.asarray(psf))
    cube = psf_t.hessian_psf_cube(
        T(x), ph_t, **{k: T(v) if k == "beam" else v
                       for k, v in kw.items()}).numpy()
    for b in range(3):
        kb = {k: v[b] if k == "beam" else v for k, v in kw.items()}
        got = psf_t.hessian_psf_slice(
            T(x[b]), ph_t[b], **{k: T(v) if k == "beam" else v
                                 for k, v in kb.items()}).numpy()
        ref = psf_j.hessian_psf_slice(
            jnp.asarray(x[b]), ph_j[b], **{k: jnp.asarray(v) if k == "beam"
                                            else v for k, v in kb.items()})
        _close(got, ref, 1e-10)
        _close(got, cube[b], 1e-12)


def test_hessian_psf_slice_default_lastsize_is_the_cube_default():
    """lastsize defaults to psfhat.shape[-2] in both forms (a square PSF
    makes that the PSF's last size)."""
    n = 16
    psf = _cube(5, n)[0]
    x = np.random.default_rng(6).normal(size=(n, n))
    ph = fft_t.make_psfhat(T(psf))
    got = psf_t.hessian_psf_slice(T(x), ph).numpy()
    _close(got, psf_t.hessian_psf_slice(T(x), ph, lastsize=2 * n).numpy(),
           0.0)
    _close(got, psf_t.hessian_psf_cube(T(x[None]), ph[None]).numpy()[0],
           1e-12)
