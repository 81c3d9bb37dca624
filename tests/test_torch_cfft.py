"""pfb_tpu_torch w-plane c2c transforms (ops/cfft.py, the plain versions
of the CUDA kernels on the CPU: the line kernel's and the cluster column
kernel's steps at C = 2, 4, 8 and 16) against pfb_tpu/ops/pallas_cfft.py
in interpret mode. Both run float32; tolerance 1e-5 of max|ref| (f32
four-step DFTs, ~1e-6 log2 N)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops.pallas_cfft import fft2_c2c_pruned as fft2_j
from pfb_tpu.ops.pallas_cfft import fftx_c2c as fftx_j
from pfb_tpu_torch.ops.cfft import (_factor, cfft_supported, cluster_route,
                                    cluster_shape, fft2_c2c_pruned, fftx_c2c,
                                    fftx_c2c_cluster, fftx_c2c_cluster_plain)

torch.set_num_threads(1)
N = 256


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(got) - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_fftx_matches_jax(mode, inverse):
    in_rolled, out_rolled = mode == "in_rolled", mode == "out_rolled"
    xr, xi = _rand((2, N // 2 if in_rolled else N, 128), seed=7)
    yr_j, yi_j = fftx_j(jnp.asarray(xr), jnp.asarray(xi), N=N,
                        inverse=inverse, in_rolled=in_rolled,
                        out_rolled=out_rolled, interpret=True)
    yr, yi = fftx_c2c(torch.as_tensor(xr), torch.as_tensor(xi), N=N,
                      inverse=inverse, in_rolled=in_rolled,
                      out_rolled=out_rolled)
    _close(yr.numpy(), yr_j)
    _close(yi.numpy(), yi_j)


@pytest.mark.parametrize("pruned", ["in", "out"])
def test_fft2_pruned_matches_jax(pruned):
    pin = pruned == "in"
    n = N // 2 if pin else N
    xr, xi = _rand((2, n, n), seed=8)
    kw = dict(Nx=N, Ny=N, inverse=not pin, pruned_in=pin,
              pruned_out=not pin)
    yr_j, yi_j = fft2_j(jnp.asarray(xr), jnp.asarray(xi),
                        interpret=True, **kw)
    yr, yi = fft2_c2c_pruned(torch.as_tensor(xr), torch.as_tensor(xi), **kw)
    _close(yr.numpy(), yr_j)
    _close(yi.numpy(), yi_j)


def test_supported_lengths_match_jax():
    from pfb_tpu.ops.pallas_cfft import cfft_supported as sup_j
    from pfb_tpu.ops.pallas_fft import _factor as factor_j
    for n in (256, 512, 2304, 4096, 6144, 8192, 1000, 640):
        assert cfft_supported(n) == sup_j(n)
        assert _factor(n) == factor_j(n)


def test_real_input_and_shape_checks():
    xr, _ = _rand((1, N, 4), seed=9)
    t = torch.as_tensor(xr)
    yr, yi = fftx_c2c(t, None, N=N)
    ref = np.fft.fft(xr.astype(np.float64), axis=-2)
    _close(yr.numpy(), ref.real)
    _close(yi.numpy(), ref.imag)
    with pytest.raises(ValueError):
        fftx_c2c(t, t, N=N, in_rolled=True)


# ---------------------------------------------------------------------
# the cluster column kernel's plain version (csrc/cfft_cols.cu's steps)

_JAX_REF = {}


def _jax_ref(N, mode, inverse, L):
    """JAX fftx_c2c(interpret=True) on seeded inputs, once per case (the
    reference does not depend on C); lane_block=L takes a ragged L."""
    key = (N, mode, inverse, L)
    if key not in _JAX_REF:
        in_rolled, out_rolled = mode == "in_rolled", mode == "out_rolled"
        xr, xi = _rand((2, N // 2 if in_rolled else N, L), seed=N + L)
        ref = fftx_j(jnp.asarray(xr), jnp.asarray(xi), N=N, inverse=inverse,
                     in_rolled=in_rolled, out_rolled=out_rolled,
                     lane_block=min(L, 128), interpret=True)
        _JAX_REF[key] = (xr, xi, np.asarray(ref[0]), np.asarray(ref[1]))
    return _JAX_REF[key]


@pytest.mark.parametrize("N", [512, 640, 2304])
@pytest.mark.parametrize("C", [2, 4, 8, 16])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_cluster_plain_matches_jax(N, C, mode, inverse):
    xr, xi, rr, ri = _jax_ref(N, mode, inverse, 128)
    yr, yi = fftx_c2c_cluster_plain(
        torch.as_tensor(xr), torch.as_tensor(xi), N=N, C=C, inverse=inverse,
        in_rolled=mode == "in_rolled", out_rolled=mode == "out_rolled")
    _close(yr.numpy(), rr)
    _close(yi.numpy(), ri)


@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_cluster_plain_ragged_matches_jax(mode, inverse):
    """L = 20, not a multiple of the kernel's 8-column tiles: the CPU
    wrapper (the plain version at cluster_shape's C) against JAX with
    lane_block=20."""
    N = 640
    xr, xi, rr, ri = _jax_ref(N, mode, inverse, 20)
    yr, yi = fftx_c2c_cluster(
        torch.as_tensor(xr), torch.as_tensor(xi), N=N, inverse=inverse,
        in_rolled=mode == "in_rolled", out_rolled=mode == "out_rolled")
    _close(yr.numpy(), rr)
    _close(yi.numpy(), ri)


def test_cluster_route_and_shape():
    """The dispatch rule, written once in ops/cfft.py: the strided x pass
    (L > 1) at N >= 4096 takes the cluster kernel where its tile fits;
    the y pass (L = 1), N < 4096, N % 4 != 0 and tiles past a block's
    8192 values keep line_fft_kernel. The shapes the card runs."""
    assert cluster_route(4096, 8) and cluster_route(8192, 4096)
    assert cluster_route(16384, 2) and cluster_route(4100, 2)
    assert not cluster_route(8192, 1) and not cluster_route(2048, 2048)
    assert not cluster_route(6561, 8) and not cluster_route(8748, 8)
    assert not cluster_route(32768, 8)
    assert [cluster_shape(n) for n in (4096, 6144, 8192, 12288, 16384)] \
        == [(4, 8), (8, 8), (8, 8), (8, 4), (8, 4)]
    with pytest.raises(ValueError):
        cluster_shape(6561)
    # a CPU stack keeps the plain route whatever the shape
    xr, xi = _rand((1, 4096, 4), seed=10)
    yr, _ = fftx_c2c(torch.as_tensor(xr), torch.as_tensor(xi), N=4096)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-2)
    _close(yr.numpy(), ref.real)


@pytest.mark.parametrize("N", [2048, 4096, 6144, 8192, 12288, 16384])
def test_cluster_shape_fits_a_block(N):
    """Every shape the route takes is one the kernel launches: a cluster
    of 4 or 8 blocks dividing N, tiles of 4 or 8 columns, at most 8192
    values a block, and each row segment of a tile a whole number of
    16-byte chunks."""
    C, W = cluster_shape(N)
    assert C in (4, 8) and W in (4, 8) and N % C == 0
    assert (N // C) * W <= 8192 and W % 4 == 0
    assert cluster_route(N, 2) == (N >= 4096)


@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
def test_cluster_skeleton_plain_is_the_exchange_permutation(mode):
    """The skeleton (loads, exchange, stores, no FFT passes) writes
    X[k1 + M c] = x[c + C k1]: checked element by element in numpy."""
    N, C, L = 64, 4, 3
    M = N // C
    in_rolled, out_rolled = mode == "in_rolled", mode == "out_rolled"
    xr, xi = _rand((2, N // 2 if in_rolled else N, L), seed=11)
    full = xr + 1j * xi
    if in_rolled:
        full = np.zeros((2, N, L), complex)
        full[:, (np.arange(N // 2) - N // 4) % N] = xr + 1j * xi
    want = np.empty((2, N, L), complex)
    for k1 in range(M):
        for c in range(C):
            want[:, k1 + M * c] = full[:, c + C * k1]
    if out_rolled:
        want = want[:, (np.arange(N // 2) - N // 4) % N]
    assert cluster_shape(N)[0] == C
    yr, yi = fftx_c2c_cluster(torch.as_tensor(xr), torch.as_tensor(xi), N=N,
                              skeleton=True, in_rolled=in_rolled,
                              out_rolled=out_rolled)
    assert np.array_equal(yr.numpy(), want.real.astype(np.float32))
    assert np.array_equal(yi.numpy(), want.imag.astype(np.float32))
