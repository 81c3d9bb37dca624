"""pfb_tpu_torch/ops/pallas_fft.py against pfb_tpu/ops/pallas_fft.py: the
single-band PSF convolutions (K12 psf_convolve_pallas_v3, K13
psf_convolve_pallas_v2, K14 psf_convolve_pallas_opt) and the v3 column
transforms (K15, _k1h_kernel / _k3h_kernel), the port's plain versions in
float64 against the JAX Pallas kernels in interpret mode (float32), at the
shapes of tests/test_pallas_fft.py. Tolerance: 1e-5 of max, the JAX
tests' own gate."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import pfb_tpu.ops.pallas_fft as pf
from pfb_tpu.ops.mmfft import make_full_psfhat
from pfb_tpu_torch.ops import pallas_fft as pt
from pfb_tpu_torch.ops.psf import (h_from_jax_full, h_from_jax_v3,
                                   psf_stage_rows)

torch.set_num_threads(1)
TOL = 1e-5


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _t(a):
    return None if a is None else torch.as_tensor(np.asarray(a, np.float64))


def _even_psf(rng, N):
    """tests/test_pallas_fft.py:_even_psf: even in the FFT sense, so its
    transfer function is real."""
    q = rng.normal(size=(N, N))
    idx = (-np.arange(N)) % N
    q = 0.5 * (q + q[idx][:, idx])
    return np.fft.fftshift(q)


def _case(seed, nx, even=False):
    rng = np.random.default_rng(seed)
    psf = _even_psf(rng, 2 * nx) if even else rng.normal(size=(2 * nx,
                                                               2 * nx))
    img = rng.normal(size=(nx, nx)).astype(np.float32)
    phr, phi = make_full_psfhat(jnp.asarray(psf, jnp.float32)[None])
    return img, phr[0].T, phi[0].T


def test_k14_opt_matches_jax():
    """tests/test_pallas_fft.py:44 (nx = 64): the transposed full H."""
    nx = 64
    img, HrT, HiT = _case(2, nx)
    ref = pf.psf_convolve_pallas_opt(jnp.asarray(img), HrT, HiT, nx, nx,
                                     lane_block=64, row_block=64,
                                     interpret=True)
    hr, hi = h_from_jax_full(HrT, HiT)
    got = pt.psf_convolve_pallas_opt(_t(img), _t(hr), _t(hi), nx, nx)
    assert got.shape == (nx, nx)
    assert _rel(got, ref) < TOL


def test_k13_v2_matches_jax():
    """tests/test_pallas_fft.py:60 (nx = 128): the scrambled full H,
    unscrambled by h_from_jax_v2."""
    nx = 128
    img, HrT, HiT = _case(3, nx)
    Hsr, Hsi = pf.scramble_HT(HrT), pf.scramble_HT(HiT)
    ref = pf.psf_convolve_pallas_v2(jnp.asarray(img), Hsr, Hsi, nx, nx,
                                    interpret=True)
    hr, hi = pt.h_from_jax_v2(Hsr, Hsi)
    assert hr.shape == (2 * nx, 2 * nx)
    got = pt.psf_convolve_pallas_v2(_t(img), _t(hr), _t(hi), nx, nx)
    assert _rel(got, ref) < TOL


@pytest.mark.parametrize("seed, nx, row_block, even", [
    (7, 128, 48, False),   # tests/test_pallas_fft.py:77, complex H
    (13, 128, 48, True),   # :141, even PSF, real H (Hsi=None)
    (11, 256, 96, False),  # :194, NX = 512 -> (32, 16), NXH = 288
])
def test_k12_v3_matches_jax(seed, nx, row_block, even):
    """K12 against the JAX v3 pipeline on its half-height scrambled H,
    converted by h_from_jax_v3 (3-D, no band axis)."""
    img, HrT, HiT = _case(seed, nx, even)
    Hsr = pf.prep_H_v3(HrT)
    Hsi = None if even else pf.prep_H_v3(HiT)
    if even:
        assert float(jnp.max(jnp.abs(HiT)) / jnp.max(jnp.abs(HrT))) < 1e-5
    ref = pf.psf_convolve_pallas_v3(jnp.asarray(img), Hsr, Hsi, nx, nx,
                                    row_block=row_block, interpret=True)
    hr, hi = h_from_jax_v3(Hsr, Hsi, nx, nx)
    assert hr.shape == (nx + 1, 2 * nx) and (hi is None) == even
    got = pt.psf_convolve_pallas_v3(_t(img), _t(hr), _t(hi), nx, nx)
    assert _rel(got, ref) < TOL


def test_port_prep_through_k12_k13_matches_jax_prep():
    """The port's prep_H_v3 / scramble_HT of the transposed full H, fed
    through K12 / K13, against the JAX functions fed the JAX prep."""
    nx = 128
    img, HrT, HiT = _case(5, nx)
    x = _t(img)
    ref3 = pf.psf_convolve_pallas_v3(jnp.asarray(img), pf.prep_H_v3(HrT),
                                     pf.prep_H_v3(HiT), nx, nx,
                                     row_block=48, interpret=True)
    got3 = pt.psf_convolve_pallas_v3(x, pt.prep_H_v3(_t(HrT)),
                                     pt.prep_H_v3(_t(HiT)), nx, nx)
    assert _rel(got3, ref3) < TOL
    ref2 = pf.psf_convolve_pallas_v2(jnp.asarray(img), pf.scramble_HT(HrT),
                                     pf.scramble_HT(HiT), nx, nx,
                                     interpret=True)
    got2 = pt.psf_convolve_pallas_v2(x, pt.scramble_HT(_t(HrT)),
                                     pt.scramble_HT(_t(HiT)), nx, nx)
    assert _rel(got2, ref2) < TOL
    # the JAX v3 H unscrambled is the port's prep, rows kx <= NX/2
    hr, _ = h_from_jax_v3(pf.prep_H_v3(HrT), None, nx, nx)
    np.testing.assert_array_equal(hr, pt.prep_H_v3(_t(HrT)).numpy())


def test_cube_and_band_names_are_k11():
    """psf_convolve_pallas / _cube (the JAX names of K11) against the
    JAX single-band and band-loop pipelines (tests/test_pallas_fft.py:13,
    :28 shapes)."""
    rng = np.random.default_rng(1)
    nb, nx = 2, 32
    psf = rng.normal(size=(nb, 2 * nx, 2 * nx))
    img = rng.normal(size=(nb, nx, nx)).astype(np.float32)
    phr, phi = make_full_psfhat(jnp.asarray(psf, jnp.float32))
    HrT, HiT = jnp.swapaxes(phr, -1, -2), jnp.swapaxes(phi, -1, -2)
    ref = pf.psf_convolve_pallas_cube(jnp.asarray(img), HrT, HiT, nx, nx,
                                      lane_block=32, row_block=32,
                                      interpret=True)
    hr, hi = h_from_jax_full(HrT, HiT)
    got = pt.psf_convolve_pallas_cube(_t(img), _t(hr), _t(hi), nx, nx)
    assert _rel(got, ref) < TOL
    one = pt.psf_convolve_pallas(_t(img[0]), _t(hr[0]), _t(hi[0]), nx, nx)
    assert _rel(one, np.asarray(ref)[0]) < TOL


def _k15_jax(x, nx, inverse):
    """_k1h_kernel (forward) or _k3h_kernel (inverse) in interpret mode,
    as scripts/wl_kernel_lab.py:86-93, 108-115 call them, lane block
    128."""
    NX = 2 * nx
    N1, N2 = pf._factor(NX)
    NXH = N1 * (N2 // 2 + 1)
    nb, ny, L = x[0].shape[0], x[0].shape[-1], 128
    in_strip = pl.BlockSpec((1, nx, L), lambda b, j: (b, 0, j),
                            memory_space=pltpu.VMEM)
    h_strip = pl.BlockSpec((1, NXH, L), lambda b, j: (b, 0, j),
                           memory_space=pltpu.VMEM)
    kw = dict(grid=(nb, ny // L), interpret=True)
    if not inverse:
        return pl.pallas_call(
            partial(pf._k1h_kernel, N=NX, L=L),
            in_specs=[in_strip] + pf._const_specs(NX),
            out_specs=(h_strip, h_strip),
            out_shape=(jax.ShapeDtypeStruct((nb, NXH, ny), jnp.float32),) * 2,
            **kw)(*x, *pf.consts_for(NX))
    return pl.pallas_call(
        partial(pf._k3h_kernel, N=NX, L=L),
        in_specs=[h_strip] * 2 + pf._const_specs(NX), out_specs=in_strip,
        out_shape=jax.ShapeDtypeStruct((nb, nx, ny), jnp.float32),
        **kw)(*x, *pf.consts_for(NX))


# NX = 256 -> (16, 16), NXH = 144; NX = 512 -> (32, 16), NXH = 288
@pytest.mark.parametrize("nx", [128, 256])
def test_k15_forward_matches_jax(nx):
    rng = np.random.default_rng(nx)
    x = rng.normal(size=(2, nx, 128)).astype(np.float32)
    zr_j, zi_j = _k15_jax((jnp.asarray(x),), nx, inverse=False)
    zr, zi = pt.v3_cols_fwd(_t(x), nx)
    assert zr.shape == (2, pt.v3_rows(2 * nx), 128)
    scale = max(np.abs(np.asarray(zr_j)).max(), np.abs(np.asarray(zi_j)).max())
    assert np.abs(zr.numpy() - np.asarray(zr_j)).max() < TOL * scale
    assert np.abs(zi.numpy() - np.asarray(zi_j)).max() < TOL * scale


@pytest.mark.parametrize("nx, spectrum", [(128, "forward"), (256, "forward"),
                                          (128, "random"), (256, "random")])
def test_k15_inverse_matches_jax(nx, spectrum):
    """The inverse on the forward's spectrum and on a random
    non-Hermitian (NXH, ny) one, where rows NX/2+1 .. NXH-1 and the
    mirror rule (rows 1 .. NX/2 - N1) decide the answer."""
    rng = np.random.default_rng(nx + 1)
    NXH = pt.v3_rows(2 * nx)
    if spectrum == "forward":
        x = rng.normal(size=(2, nx, 128)).astype(np.float32)
        w = [np.asarray(a) for a in _k15_jax((jnp.asarray(x),), nx, False)]
    else:
        w = [rng.normal(size=(2, NXH, 128)).astype(np.float32)
             for _ in range(2)]
    ref = _k15_jax(tuple(jnp.asarray(a) for a in w), nx, inverse=True)
    got = pt.v3_cols_inv(_t(w[0]), _t(w[1]), nx)
    assert got.shape == (2, nx, 128)
    assert _rel(got, ref) < TOL
    if spectrum == "forward":
        assert _rel(got, x) < TOL
    else:
        # the mirror rule matters: a Hermitian-half reading differs
        half = pt.psf_stage_cols_inv_plain(_t(w[0]), _t(w[1]), nx, 2 * nx, 1)
        assert _rel(half, ref) > 1e-2


def test_rows_stage_on_k15_layout_matches_k2v():
    """The lab's rows stage: psf_stage_rows on the NXH rows against the
    NXH-row H (h_from_jax_v3 with rows=NXH), scaled by 1 / NY, against
    _k2v_kernel (scripts/wl_kernel_lab.py:131) in interpret mode."""
    nb, nx = 2, 128
    NX = NY = 2 * nx
    NXH, M = pt.v3_rows(NX), 48
    rng = np.random.default_rng(9)
    psf = rng.normal(size=(nb, NX, NY))
    phr, phi = make_full_psfhat(jnp.asarray(psf, jnp.float32))
    Hsr = pf.prep_H_v3(jnp.swapaxes(phr, -1, -2))
    Hsi = pf.prep_H_v3(jnp.swapaxes(phi, -1, -2))
    z = [rng.normal(size=(nb, NXH, nx)).astype(np.float32) for _ in range(2)]
    N1y = NY // 128
    rows = pl.BlockSpec((1, M, nx), lambda b, i: (b, i, 0),
                        memory_space=pltpu.VMEM)
    hspec = pl.BlockSpec((1, N1y, M, 128), lambda b, i: (b, 0, i, 0),
                         memory_space=pltpu.VMEM)
    wr_j, wi_j = pl.pallas_call(
        partial(pf._k2v_kernel, N=NY, M=M), grid=(nb, NXH // M),
        in_specs=[rows] * 2 + [hspec] * 2 + pf._const_specs_lane(NY),
        out_specs=(rows, rows),
        out_shape=(jax.ShapeDtypeStruct((nb, NXH, nx), jnp.float32),) * 2,
        interpret=True)(*(jnp.asarray(a) for a in z), Hsr, Hsi,
                        *pf.consts_lane_for(NY))
    hr, hi = h_from_jax_v3(Hsr, Hsi, nx, nx, rows=NXH)
    wr, wi = psf_stage_rows(_t(z[0]), _t(z[1]), _t(hr), _t(hi))
    scale = np.abs(np.asarray(wr_j)).max()
    assert np.abs(wr.numpy() / NY - np.asarray(wr_j)).max() < TOL * scale
    assert np.abs(wi.numpy() / NY - np.asarray(wi_j)).max() < TOL * scale


@pytest.mark.parametrize("call", ["v3_shape", "v3_h_rows", "opt_oversize",
                                  "v2_oversize", "cols_factor"])
def test_unsupported_shapes_raise(call):
    """ValueError where the JAX functions assert."""
    z = torch.zeros
    with pytest.raises(ValueError):
        if call == "v3_shape":      # NY = 192: not v3_supported
            pt.psf_convolve_pallas_v3(z(96, 96), z(97, 192), None, 96, 96)
        elif call == "v3_h_rows":   # H of another height (NY != 2 ny)
            pt.psf_convolve_pallas_v3(z(128, 128), z(129, 512), None, 128,
                                      128)
        elif call == "opt_oversize":  # psf_oversize 1.5
            pt.psf_convolve_pallas_opt(z(64, 64), z(96, 96), z(96, 96), 64,
                                       64)
        elif call == "v2_oversize":
            pt.psf_convolve_pallas_v2(z(64, 64), z(128, 96), None, 64, 64)
        else:                       # NX = 96 -> (12, 8): 8 does not divide 12
            pt.v3_cols_fwd(z(1, 48, 128), 48)
    assert not pt.v3_supported(96, 96) and pt.v3_supported(128, 128)
    assert pt._factor_lane(256) == (2, 128)
