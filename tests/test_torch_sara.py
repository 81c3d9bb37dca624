"""pfb_tpu_torch SARA pieces (ops/wavelets.py, ops/psi.py, ops/prox.py)
against pfb_tpu, float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops import prox as prox_j
from pfb_tpu.ops import psi as psi_j
from pfb_tpu.ops import wavelets as wav_j
from pfb_tpu_torch.ops import prox as prox_t
from pfb_tpu_torch.ops import psi as psi_t
from pfb_tpu_torch.ops import wavelets as wav_t

torch.set_num_threads(1)
NX, NY = 64, 48


def _img(seed=0, shape=(NX, NY)):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("wavelet", ["db1", "db2", "db3"])
def test_dwt_perfect_reconstruction_and_parity(wavelet):
    x = _img(1)
    s_t = wav_t.make_spec(wavelet, NX, NY, 3)
    c = wav_t.dwt2d(torch.as_tensor(x), s_t)
    np.testing.assert_allclose(wav_t.idwt2d(c, s_t).numpy(), x, atol=1e-12)
    s_j = wav_j.make_spec(wavelet, NX, NY, 3)
    np.testing.assert_allclose(c.numpy(),
                               np.asarray(wav_j.dwt2d(jnp.asarray(x), s_j)),
                               atol=1e-12)


def test_psi_round_trip_and_parity():
    """hdot(dot(x)) = nbasis x (1e-11, as tests/test_psi_prox.py), and
    both directions match the JAX package at 1e-12."""
    bases = ("self", "db1", "db2")
    x = np.stack([_img(2), _img(3)])
    p_t = psi_t.make_psi(NX, NY, bases, 3)
    p_j = psi_j.make_psi(NX, NY, bases, 3)
    a = psi_t.psi_dot(torch.as_tensor(x), p_t)
    np.testing.assert_allclose(psi_t.psi_hdot(a, p_t).numpy(),
                               len(bases) * x, atol=1e-11)
    a_j = np.asarray(psi_j.psi_dot(jnp.asarray(x), p_j))
    np.testing.assert_allclose(a.numpy(), a_j, atol=1e-12)
    coeffs = np.random.default_rng(4).normal(size=a_j.shape)
    np.testing.assert_allclose(
        psi_t.psi_hdot(torch.as_tensor(coeffs), p_t).numpy(),
        np.asarray(psi_j.psi_hdot(jnp.asarray(coeffs), p_j)), atol=1e-12)


def test_prox_and_dual_update_match_jax():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, 2, 8, 9))
    vp = rng.normal(size=v.shape)
    w = rng.random((2, 8, 9)) + 0.5
    for fn in ("prox_21", "prox_21m"):
        np.testing.assert_allclose(
            getattr(prox_t, fn)(torch.as_tensor(v), 0.7,
                                torch.as_tensor(w)).numpy(),
            np.asarray(getattr(prox_j, fn)(jnp.asarray(v), 0.7,
                                           jnp.asarray(w))), atol=1e-13)
    np.testing.assert_allclose(
        prox_t.dual_update_21m(torch.as_tensor(vp), torch.as_tensor(v),
                               0.9, sigma=1.3,
                               weight=torch.as_tensor(w)).numpy(),
        np.asarray(prox_j.dual_update_21m(jnp.asarray(vp), jnp.asarray(v),
                                          0.9, sigma=1.3,
                                          weight=jnp.asarray(w))),
        atol=1e-13)
    # zero band-sum leaves the dual untouched in both
    z = np.zeros_like(v)
    np.testing.assert_array_equal(
        prox_t.dual_update_21m(torch.as_tensor(z), torch.as_tensor(z),
                               0.9).numpy(), z)


@pytest.mark.parametrize("zero_columns", [False, True])
def test_dual_update_21_matches_jax(zero_columns):
    """tests/test_psi_prox.py:73's case (3 bands, 2 bases, 6 x 7, lam
    0.25, sigma 1.7, a weight a coefficient) within 1e-12 relative; with
    ``zero_columns`` some coefficients are 0 in every band, where both
    leave the dual at 0."""
    rng = np.random.default_rng(2)
    nband, nbasis, ny, nx = 3, 2, 6, 7
    vp = rng.normal(size=(nband, nbasis, ny, nx))
    v = rng.normal(size=(nband, nbasis, ny, nx))
    w = np.abs(rng.normal(size=(nbasis, ny, nx)))
    if zero_columns:
        vp[:, 0, :2] = v[:, 0, :2] = 0.0
        vp[:, 1, :, 3] = v[:, 1, :, 3] = 0.0
    got = prox_t.dual_update_21(torch.as_tensor(vp), torch.as_tensor(v),
                                0.25, sigma=1.7,
                                weight=torch.as_tensor(w)).numpy()
    ref = np.asarray(prox_j.dual_update_21(jnp.asarray(vp), jnp.asarray(v),
                                           0.25, sigma=1.7,
                                           weight=jnp.asarray(w)))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    if zero_columns:
        assert not got[:, 0, :2].any() and not got[:, 1, :, 3].any()
        assert np.isfinite(got).all()
    # default sigma and weight
    np.testing.assert_allclose(
        prox_t.dual_update_21(torch.as_tensor(vp), torch.as_tensor(v),
                              0.4).numpy(),
        np.asarray(prox_j.dual_update_21(jnp.asarray(vp), jnp.asarray(v),
                                         0.4)), rtol=1e-12, atol=1e-14)
